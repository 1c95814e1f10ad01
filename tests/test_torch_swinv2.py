"""Parity of the port's SwinV2 encoder (xpoint_tpu_torch/models/swinv2.py)
with the flax one: the host tables, the blocks, the shift mask, the pad and
crop at sizes that are no multiple of the padding rate, the whole encoder
and a Swin XPoint through the weight bridge. The same flax weights (noise
added, so that no initialiser constant hides a layout fault) and the same
numpy inputs go through both; fp32 to 1e-4, bf16 to 3% of max |ref| (the
tolerance of test_xpoint_net_bf16_matches_flax). Tiny width: depths [2, 2],
embed 24, heads [3, 6], window 4, inputs of at most 64^2."""
import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models import swinv2 as jx_swin

from xpoint_tpu_torch.compat.from_flax import (flax_to_state_dict,
                                               load_flax_variables)
from xpoint_tpu_torch.config import load_yaml
from xpoint_tpu_torch.models import build_xpoint, swinv2

from test_torch_models import _perturb

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"EMBED_DIM": 24, "DEPTHS": [2, 2], "NUM_HEADS": [3, 6],
        "WINDOW_SIZE": 4}


def swin_cfg(mixed_precision=False, **model):
    """configs/cmt.yaml's model section at the tiny width."""
    cfg = copy.deepcopy(load_yaml(os.path.join(ROOT, "configs",
                                               "cmt.yaml"))["model"])
    cfg["use_attention"]["model_parameters"]["MODEL"]["SWINV2"].update(TINY)
    cfg["use_attention"]["pretrained"] = {"check": False}
    cfg["descriptor_size"] = 32
    cfg["mixed_precision"] = mixed_precision
    cfg.update(model)
    return cfg


def _init(module, x, seed, **kw):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw)
    return _perturb(v, seed + 100, scale=0.05)


@pytest.mark.parametrize("ws,pre", [(4, 0), (8, 0), (4, 8), (1, 0)])
def test_host_tables_equal_jax(ws, pre):
    np.testing.assert_array_equal(swinv2._relative_coords_table(ws, pre),
                                  jx_swin._relative_coords_table(ws, pre))
    np.testing.assert_array_equal(swinv2._relative_position_index(ws),
                                  jx_swin._relative_position_index(ws))


@pytest.mark.parametrize("H,W,ws,shift", [(8, 8, 4, 2), (16, 8, 4, 2),
                                          (16, 16, 8, 4), (12, 16, 4, 2)])
def test_shift_mask_and_windows_equal_jax(H, W, ws, shift):
    np.testing.assert_array_equal(swinv2._attn_mask(H, W, ws, shift),
                                  jx_swin._attn_mask(H, W, ws, shift))
    x = np.random.default_rng(0).normal(size=(2, H, W, 5)).astype(np.float32)
    win = swinv2.window_partition(T(x), ws)
    np.testing.assert_array_equal(
        win.numpy(), np.asarray(jx_swin.window_partition(jnp.asarray(x), ws)))
    np.testing.assert_array_equal(
        swinv2.window_reverse(win, ws, H, W).numpy(), x)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_flax(masked):
    """Cosine attention, clamped logit scale (one head above log 100), the
    CPB bias and, with ``masked``, the SW-MSA mask of an 8 x 8 map."""
    rng = np.random.default_rng(1)
    ws, H = 4, 8
    x = rng.normal(size=(2 * 4, ws * ws, 24)).astype(np.float32)
    mask = jx_swin._attn_mask(H, H, ws, 2) if masked else None
    jm = jx_swin.WindowAttention(24, ws, 3)
    v = _init(jm, x, 1, mask=mask)
    v["params"]["logit_scale"] = np.array([[[5.0]], [[1.0]], [[2.5]]],
                                          np.float32)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), mask))
    tm = load_flax_variables(swinv2.WindowAttention(24, 3), v)
    with torch.no_grad():
        out = tm(T(x), ws, None if mask is None else T(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("res,shift", [((8, 8), 0), ((8, 8), 2),
                                       ((8, 12), 2), ((4, 4), 2)])
def test_swin_block_matches_flax(res, shift):
    """A block without and with the shift; at 4 x 4 the window is the map
    and the block does not shift."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, res[0] * res[1], 24)).astype(np.float32)
    jm = jx_swin.SwinBlock(24, res, 3, 4, shift)
    v = _init(jm, x, 2)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(swinv2.SwinBlock(24, 3, 4, shift), v)
    with torch.no_grad():
        out = tm(T(x), res).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_patch_merging_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8 * 12, 24)).astype(np.float32)
    jm = jx_swin.PatchMerging(24, (8, 12))
    v = _init(jm, x, 3)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(swinv2.PatchMerging(24), v)
    with torch.no_grad():
        out = tm(T(x), (8, 12)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(64, 64), (50, 60), (20, 30)])
def test_encoder_matches_flax(hw):
    """The whole tiny encoder: 64^2 needs no pad; 50 x 60 is reflect-padded
    to 64 x 64 and cropped back to 24 x 28 (the padding rate is 16 here);
    at 20 x 30 the last stage is one 4 x 4 window without a shift."""
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, *hw, 1)).astype(np.float32)
    jm = jx_swin.SwinTransformerV2(24, (2, 2), (3, 6), 4)
    v = _init(jm, x, 4)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(swinv2.SwinTransformerV2(24, (2, 2), (3, 6), 4),
                             v).eval()
    with torch.no_grad():
        out = tm(T(x)).numpy()
    assert out.shape == ref.shape == (2, hw[0] // 8 * 4, hw[1] // 8 * 4, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_reflect_pad_is_jnp_reflect():
    x = np.random.default_rng(5).normal(size=(1, 7, 5, 2)).astype(np.float32)
    out = swinv2._reflect_pad_end(T(x), 4, 3).numpy()
    ref = np.pad(x, ((0, 0), (0, 4), (0, 3), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(out, ref)


def _jax_swin_xpoint(cfg, seed=0):
    jm, _ = jx_build_xpoint(cfg)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(seed))
    return jm, _perturb(v, seed + 10, scale=0.05)


def _swin_pair(jm, v, cfg, img_o, img_t):
    ref = jm.apply(v, jnp.asarray(img_o), jnp.asarray(img_t),
                   method=jm.forward_pair)
    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm.forward_pair(T(img_o), T(img_t))
    return tm, ref, out


@pytest.mark.parametrize("hw", [(64, 64), (50, 60)])
def test_swin_xpoint_matches_flax(hw):
    """The Swin XPoint of configs/cmt.yaml at the tiny width, fp32, through
    the bridge: both sides' logits (r = 2: 5 classes), descriptors and
    encoder output, and the RegNet output, within 1e-4."""
    cfg = swin_cfg()
    jm, v = _jax_swin_xpoint(cfg)
    rng = np.random.default_rng(6)
    img_o, img_t = (rng.uniform(size=(2, *hw, 1)).astype(np.float32)
                    for _ in range(2))
    tm, ref, out = _swin_pair(jm, v, cfg, img_o, img_t)
    assert tm.encoder_type == "swin" and tm.encoder_downsample_ratio == 2
    for side in (0, 1):
        for key in ("logits", "desc", "encoder_output"):
            np.testing.assert_allclose(out[side][key].numpy(),
                                       np.asarray(ref[side][key]),
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=f"{side} {key}")
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-4,
                               rtol=1e-4, err_msg="RegNet")


def test_swin_xpoint_bf16_matches_flax():
    """Mixed precision: bf16 patch embedding and qkv, fp32 dense layers,
    logits, softmax and norms, as flax casts them; 3% of max |ref| on the
    logits, descriptors, encoder output and RegNet output."""
    cfg = swin_cfg(mixed_precision=True)
    jm, v = _jax_swin_xpoint(cfg, seed=1)
    rng = np.random.default_rng(7)
    img_o, img_t = (rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
                    for _ in range(2))
    tm, ref, out = _swin_pair(jm, v, cfg, img_o, img_t)
    assert tm.encoder.dtype == torch.bfloat16
    for side in (0, 1):
        for key in ("logits", "desc", "encoder_output"):
            r = np.asarray(ref[side][key])
            assert out[side][key].dtype == torch.float32
            np.testing.assert_allclose(out[side][key].numpy(), r, rtol=0,
                                       atol=0.03 * np.abs(r).max(),
                                       err_msg=f"{side} {key}")
    r = np.asarray(ref[2])
    np.testing.assert_allclose(out[2].numpy(), r, rtol=0,
                               atol=0.03 * np.abs(r).max(), err_msg="RegNet")


def test_swin_init_matches_flax_distributions():
    """The port's initialiser on the Swin XPoint: the flax parameter set
    and shapes, logit_scale log 10, zero q / v biases, and the moments of
    every larger tensor (truncated normal 0.02 for qkv, proj, MLP and
    reduction; lecun_normal for the CPB MLP and the patch embedding)
    within sampling noise: std within 15%, means within 5 standard errors
    of their difference."""
    cfg = swin_cfg()
    jm, _ = jx_build_xpoint(cfg)
    ref = flax_to_state_dict(jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 64, 64, 1), jnp.float32),
        method=jm.init_all))(jax.random.PRNGKey(5)))
    tm, _ = build_xpoint(cfg, device="cpu", seed=5)
    sd = tm.state_dict()
    assert set(sd) == set(ref)
    blk = "encoder.layers_1_blocks_1.attn."
    assert torch.all(sd[blk + "logit_scale"] == np.float32(np.log(10.0)))
    assert not sd[blk + "q_bias"].any() and not sd[blk + "v_bias"].any()
    for k, t in sd.items():
        r = ref[k]
        assert tuple(t.shape) == tuple(r.shape), k
        if t.numel() < 500:
            continue
        np.testing.assert_allclose(float(t.std()), float(r.std()),
                                   rtol=0.15, err_msg=k)
        # 5 standard errors of the difference of the two sample means
        assert abs(float(t.mean()) - float(r.mean())) < 5 * float(
            r.std()) * np.sqrt(2 / t.numel()) + 1e-6, k


def test_cmt_config_builds_at_full_width():
    """configs/cmt.yaml's own model section (SwinV2-T: embed 96, depths
    [2, 2, 6, 2], heads [3, 6, 12, 24], window 8, RegNet, bf16) builds with
    the flax module's parameter shapes, and a 128^2 forward gives the
    (B, 16, 16, 65) logits and the 48-channel encoder output."""
    cfg = load_yaml(os.path.join(ROOT, "configs", "cmt.yaml"))["model"]
    cfg["use_attention"]["pretrained"] = {"check": False}
    tm, merged = build_xpoint(cfg, device="cpu")
    assert tm.encoder.dtype == torch.bfloat16 and merged["takes_pair"]
    jm, _ = jx_build_xpoint(cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 1), jnp.float32),
        method=jm.init_all))
    ref = flax_to_state_dict(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    sd = tm.state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert tuple(sd[k].shape) == tuple(ref[k].shape), k
    with torch.no_grad():
        out = tm(torch.rand(1, 128, 128, 1,
                            generator=torch.Generator().manual_seed(0)))
    assert out["logits"].shape == (1, 16, 16, 65)
    assert out["encoder_output"].shape == (1, 16, 16, 48)
    assert all(torch.isfinite(v).all() for v in out.values())
