"""Parity of the PyTorch port's model modules with the flax ones: the same
flax weights go through the weight bridge (xpoint_tpu_torch.compat) and the
same numpy inputs through both. fp32 on the CPU, TF32 off."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models.vssm import SS2D as JxSS2D
from xpoint_tpu.models.vssm import VSSBlock as JxVSSBlock
from xpoint_tpu.models.vssm import _StridedConv3x3 as JxStridedConv3x3
from __graft_entry__ import VMAMBA_MODEL_CFG as JX_VMAMBA_MODEL_CFG

from xpoint_tpu_torch.compat.from_flax import (_flatten, flax_to_state_dict,
                                               load_flax_variables, to_flax)
from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
from xpoint_tpu_torch.models.xpoint import DEFAULT_CONFIG
from xpoint_tpu_torch.models.vssm import (SS2D, StridedConv3x3, VSSBlock,
                                          build_vssm_from_config)
from torch_env import torch_env  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T = torch.from_numpy


def _perturb(variables, seed, scale=0.1):
    """Add numpy noise to every param so that no initialiser constant
    (A_logs 0, Ds 1, LN 1/0) hides a layout fault; stats stay as they are."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + scale * rng.normal(size=x.shape).astype(
            np.float32), variables["params"])
    return {**variables, "params": params}


def tiny_cfg():
    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24)
    cfg["descriptor_size"] = 32
    cfg["mixed_precision"] = False
    return cfg


def test_flagship_config_is_the_jax_one():
    assert VMAMBA_MODEL_CFG == JX_VMAMBA_MODEL_CFG


@pytest.mark.parametrize("hw", [(16, 24), (9, 13)])
def test_strided_conv_matches_s2d_conv(hw):
    """The plain stride-2 conv equals the JAX space-to-depth form (even
    sizes) and its strided fallback (odd sizes)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    jm = JxStridedConv3x3(7)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = load_flax_variables(StridedConv3x3(5, 7), v)
    with torch.no_grad():
        out = tm(T(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "assoc"])
def test_ss2d_matches_flax(backend):
    """SS2D (v05_noz, N=1) against flax on the Pallas token path (interpret
    mode) and the associative-scan path."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 6, 24)).astype(np.float32)
    jm = JxSS2D(24, scan_backend=backend)
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = load_flax_variables(SS2D(24), v)
    with torch.no_grad():
        out = tm(T(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_vss_block_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 6, 24)).astype(np.float32)
    jm = JxVSSBlock(24, scan_backend="pallas")
    v = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), 3)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = load_flax_variables(VSSBlock(24), v)
    with torch.no_grad():
        out = tm(T(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def _jax_tiny_model(seed=0):
    module, _ = jx_build_xpoint(tiny_cfg(), dtype=jnp.float32,
                                scan_backend="assoc")
    v = jax.jit(lambda r: module.init(
        r, jnp.zeros((1, 64, 64, 1), jnp.float32),
        method=module.init_all))(jax.random.PRNGKey(seed))
    return module, _perturb(v, seed + 10, scale=0.05)


def test_xpoint_net_matches_flax_through_bridge():
    """The whole tiny XPointNet (depths [1,1,1,1], embed 24, descriptor 32,
    fp32, 64^2; JAX on the associative scan) through the weight bridge:
    logits and descriptors within atol 1e-4."""
    jm, v = _jax_tiny_model()
    img = np.random.default_rng(3).uniform(size=(2, 64, 64, 1)).astype(
        np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, "optical"))(v, jnp.asarray(img))
    tm, _ = build_xpoint(tiny_cfg(), device="cpu")
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(img))
    for key in ("logits", "desc", "encoder_output"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_bridge_skips_only_the_homography_head():
    """The bridge skips nothing now: the homography head (RegNet) maps like
    the rest, and to_flax inverts it leaf for leaf. Stray flax leaves and
    missing entries still raise."""
    jm, v = _jax_tiny_model(seed=1)
    sd = flax_to_state_dict(v)
    assert "hm_regressor.fc1.weight" in sd and "hm_regressor" in v["params"]
    assert "hm_regressor.bn1.running_var" in sd
    tm, _ = build_xpoint(tiny_cfg(), device="cpu")
    back = to_flax(load_flax_variables(tm, v))
    assert set(back) == set(v)
    for col in v:
        a = dict(_flatten(v[col]))
        b = dict(_flatten(back[col]))
        assert set(a) == set(b), col
        for path in a:
            np.testing.assert_array_equal(b[path], np.asarray(a[path]),
                                          err_msg="/".join(path))
    extra = {**v, "params": {**v["params"],
                             "stray": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(tm, extra)
    params = dict(v["params"])
    params.pop("descriptor_head")
    with pytest.raises(KeyError, match="descriptor_head"):
        load_flax_variables(tm, {**v, "params": params})


def test_port_init_matches_flax_distributions():
    """The port's own initialiser: same parameter shapes as flax, and the
    same distributions (moments within sampling noise)."""
    jm, v = _jax_tiny_model()
    ref = flax_to_state_dict(jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 64, 64, 1), jnp.float32),
        method=jm.init_all))(jax.random.PRNGKey(5)))
    tm, _ = build_xpoint(tiny_cfg(), device="cpu", seed=5)
    sd = tm.state_dict()
    assert set(sd) == set(ref)
    for k, t in sd.items():
        r = ref[k]
        assert tuple(t.shape) == tuple(r.shape), k
        if t.numel() < 500:
            continue
        # loose: the moments of ~1e3-1e5 draws, a broken scale is >2x off
        np.testing.assert_allclose(float(t.std()), float(r.std()),
                                   rtol=0.15, err_msg=k)
        assert abs(float(t.mean()) - float(r.mean())) < 0.1 * float(r.std()) \
            + 1e-6, k
    # deterministic per seed, different across seeds
    tm2, _ = build_xpoint(tiny_cfg(), device="cpu", seed=5)
    tm3, _ = build_xpoint(tiny_cfg(), device="cpu", seed=6)
    w = "encoder.layers_0_blocks_0.op.x_proj_weight"
    assert torch.equal(tm2.state_dict()[w], sd[w])
    assert not torch.equal(tm3.state_dict()[w], sd[w])


@pytest.mark.parametrize("cfg", [
    {"SSM_FORWARDTYPE": f} for f in ("m0_noz", "xv1a")])
def test_unported_encoder_configs_raise(cfg):
    """The m0 and xv forward types raised NotImplementedError until they
    were ported; the encoder built from the config now matches flax's
    build_vssm_from_config through the bridge (fp32, 1e-4 of max |ref|)."""
    from xpoint_tpu.models.vssm import \
        build_vssm_from_config as jx_build_vssm_from_config
    vcfg = {"DEPTHS": [1, 1, 1, 1], "EMBED_DIM": 24, **cfg}
    x = np.random.default_rng(4).uniform(size=(2, 64, 64, 1)).astype(
        np.float32)
    jm = jx_build_vssm_from_config(vcfg)
    v = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 3,
                 scale=0.05)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = load_flax_variables(build_vssm_from_config(vcfg), v).eval()
    with torch.no_grad():
        out = tm(T(x)).numpy()
    assert out.shape == ref.shape == (2, 8, 8, 12)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["swin", "homographynet",
                                  "pretrained_yaml", "pretrained_type_dir"])
def test_unported_model_configs_raise(case, tmp_path):
    """These configs raised NotImplementedError until they were ported;
    each now builds and matches flax through the bridge, pair forward in
    eval mode, optical_not_warped both ways in one batch, atol 1e-4: the
    Swin encoder (configs/cmt.yaml at the tiny width, RegNet head), the
    HomographyNet head, and the pretrained-encoder YAML merge from an
    existing ``yaml_file`` or the first ``.yaml`` in ``type_dir``: the
    file's MODEL is the base (d_state 2 and MLP ratio 2 here, both left
    out of the inline parameters), the inline parameters override it
    (embed 24 over the file's 48). Without the file, the JAX build merges
    nothing, and the port builds the same parameter shapes."""
    from test_torch_swinv2 import swin_cfg
    (tmp_path / "vssm.yaml").write_text(
        "MODEL:\n  VSSM:\n    SSM_D_STATE: 2\n    MLP_RATIO: 2.0\n"
        "    EMBED_DIM: 48\n")
    cfg = swin_cfg() if case == "swin" else tiny_cfg()
    if case == "homographynet":
        cfg["homography_regression_head"] = {"check": True,
                                             "type": "HomographyNet"}
    elif case.startswith("pretrained"):
        vssm = cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"]
        del vssm["SSM_D_STATE"], vssm["MLP_RATIO"]
        cfg["use_attention"]["pretrained"] = (
            {"check": True, "yaml_file": str(tmp_path / "vssm.yaml")}
            if case == "pretrained_yaml"
            else {"check": True, "type_dir": str(tmp_path)})
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(4))
    v = _perturb(v, 14, scale=0.05)
    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, v)
    if case.startswith("pretrained"):
        op = tm.encoder.layers_0_blocks_0
        assert op.op.A_logs.shape[-1] == 2
        assert op.mlp.Dense_0.weight.shape == (48, 24)
    rng = np.random.default_rng(15)
    img_o, img_t = (rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
                    for _ in range(2))
    not_warped = np.array([True, False])
    ref = jm.apply(v, jnp.asarray(img_o), jnp.asarray(img_t), False,
                   jnp.asarray(not_warped), method=jm.forward_pair)
    with torch.no_grad():
        out = tm.forward_pair(T(img_o), T(img_t),
                              optical_not_warped=T(not_warped))
    for side in (0, 1):
        for key in ("logits", "desc", "encoder_output"):
            np.testing.assert_allclose(out[side][key].numpy(),
                                       np.asarray(ref[side][key]), atol=1e-4,
                                       rtol=1e-4, err_msg=f"{side} {key}")
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]), atol=1e-4,
                               rtol=1e-4, err_msg="homography head")
    if case.startswith("pretrained"):
        # no YAML to merge: the JAX build merges nothing, and so does the
        # port's
        (tmp_path / "vssm.yaml").unlink()
        jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1), jnp.float32),
            method=jm.init_all))
        ref = flax_to_state_dict(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        tm, _ = build_xpoint(cfg, device="cpu")
        assert {k: tuple(t.shape) for k, t in tm.state_dict().items()} == \
            {k: tuple(t.shape) for k, t in ref.items()}
        assert tm.encoder.layers_0_blocks_0.op.A_logs.shape[-1] != 2


@pytest.mark.parametrize("key", ["multispectral", "final_batchnorm",
                                 "reflection_pad", "bn_first"])
def test_ported_model_configs_match_flax(key):
    """The tiny VMamba XPointNet with one model option flipped from the
    flagship's (two encoders, no final BatchNorm, zero padding, BN before
    ReLU) against flax through the bridge, both spectra and a 'mixed'
    batch, eval mode with perturbed running statistics: atol 1e-4, as
    test_xpoint_net_matches_flax_through_bridge."""
    cfg = tiny_cfg()
    cfg[key] = not {**DEFAULT_CONFIG, **VMAMBA_MODEL_CFG}[key]
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(2))
    v = _perturb(v, 12, scale=0.05)
    rng = np.random.default_rng(13)
    v["batch_stats"] = jax.tree.map(
        lambda s: np.asarray(s) + rng.uniform(0.05, 0.2, s.shape).astype(
            np.float32), v["batch_stats"])
    img = rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
    is_optical = np.array([True, False])
    tm, _ = build_xpoint(cfg, device="cpu")
    assert hasattr(tm, "encoder_optical") == (key == "multispectral")
    load_flax_variables(tm, v)
    for spectrum in ("optical", "thermal", "mixed"):
        ref = jm.apply(v, jnp.asarray(img), spectrum, jnp.asarray(is_optical))
        with torch.no_grad():
            out = tm(T(img), spectrum, T(is_optical))
        for k in ("logits", "desc", "encoder_output"):
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=f"{spectrum} {k}")


def test_xpoint_net_bf16_matches_flax():
    """Mixed precision (bf16 activations, fp32 params / norms / scan carry /
    heads) against flax bf16 on the Pallas token path. The two frameworks
    round to bf16 at different places (8-bit mantissa, ~2^-8 relative per
    rounding, some tens of roundings deep): tolerance 3% of max |ref|."""
    cfg = tiny_cfg()
    cfg["mixed_precision"] = True
    jm, _ = jx_build_xpoint(cfg, scan_backend="pallas")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(0))
    v = _perturb(v, 10, scale=0.05)
    img = np.random.default_rng(3).uniform(size=(2, 64, 64, 1)).astype(
        np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, "optical"))(v, jnp.asarray(img))
    tm, _ = build_xpoint(cfg, device="cpu")
    assert tm.encoder.dtype == torch.bfloat16
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(img))
    for key in ("logits", "desc", "encoder_output"):
        r = np.asarray(ref[key])
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), r, rtol=0,
                                   atol=0.03 * np.abs(r).max(), err_msg=key)
