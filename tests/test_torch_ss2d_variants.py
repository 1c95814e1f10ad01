"""The xv (SS2Dv3) and m0 (SS2Dm0 + the chunked SSD scan) VMamba forward
types of the port against the JAX package on the CPU: the same numpy inputs
through both, flax weights carried across by the bridge (perturbed so that
no initialiser constant hides a layout fault). Tolerances: the SSD scan and
every fp32 forward 1e-4 of max |ref|; bf16 forwards 3% of max |ref| (the
gate of the other bf16 parity tests); one train step's gradients 1e-3 of
each leaf's max |g| (+ 1e-7 of the largest); the initialisers' moments as
test_torch_models' (std within 15%, means within 0.1 std)."""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.compat.torch_converter import \
    convert_pretrained_encoder as jx_convert_pretrained_encoder
from xpoint_tpu.losses.xpoint_loss import XPointLoss as JxXPointLoss
from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models.vssm import SS2Dm0 as JxSS2Dm0
from xpoint_tpu.models.vssm import SS2Dv3 as JxSS2Dv3
from xpoint_tpu.ops.ssd import ssd_chunked as jx_ssd_chunked
from xpoint_tpu.parallel.train_step import TrainState as JxTrainState
from xpoint_tpu.parallel.train_step import \
    make_train_step as jx_make_train_step
from xpoint_tpu.trainer import make_optimizer as jx_make_optimizer

from xpoint_tpu_torch.compat.from_flax import (flax_to_state_dict,
                                               load_flax_variables)
from xpoint_tpu_torch.compat.torch_converter import (
    convert_pretrained_encoder, convert_torch_state_dict)
from xpoint_tpu_torch.losses import XPointLoss
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG, build_xpoint
from xpoint_tpu_torch.models.vssm import (SS2D, VSSM, SS2Dm0, SS2Dv3,
                                          build_vssm_from_config)
from xpoint_tpu_torch.ops.ssd import ssd_chunked
from xpoint_tpu_torch.train import TrainState, make_optimizer, make_train_step

from test_torch_models import _perturb, tiny_cfg
from test_torch_baselines import reference_heads
from test_torch_pretrained import _vssm_ref_key
from test_torch_train import (_assert_trees_close, _pair_batch,
                              _port_state_tree, _tiny_train_cfg,
                              _torch_batch)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T = torch.from_numpy


def _close(out, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=what)


# ---- the chunked SSD scan -------------------------------------------------

@pytest.mark.parametrize("L,chunk,init", [(64, 16, False), (100, 32, True),
                                          (77, 16, True), (130, 64, False)])
def test_ssd_chunked_matches_jax(L, chunk, init):
    """y and the final state, with a ragged tail (L not a multiple of the
    chunk: the -1e9 dt padding), groups broadcast over heads, and
    ``initial_states``."""
    rng = np.random.default_rng(L)
    B, H, P, G, N = 2, 6, 4, 2, 3
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    args = (f(B, L, H, P), f(B, L, H), -np.exp(f(H)), f(B, L, G, N),
            f(B, L, G, N), f(H, P), f(H))
    h0 = f(B, 1, H, P, N) if init else None
    yj, sj = jx_ssd_chunked(*map(jnp.asarray, args), chunk_size=chunk,
                            initial_states=None if h0 is None
                            else jnp.asarray(h0))
    yt, st = ssd_chunked(*map(T, args), chunk_size=chunk,
                         initial_states=None if h0 is None else T(h0))
    assert yt.shape == (B, L, H, P) and st.shape == (B, H, P, N)
    _close(yt, yj, 1e-4, "y")
    _close(st, sj, 1e-4, "final state")


# ---- SS2Dv3 and SS2Dm0 ----------------------------------------------------

XV_TYPES = [
    ("xv1a", 1), ("xv2a", 1), ("xv3a", 1), ("xv1a", 2), ("xv3a", 2),
    ("xv1a_onnone", 1), ("xv2a_ondwconv3", 1), ("xv3a_oncnorm", 2),
    ("xv1a_onsoftmax", 1), ("xv2a_onsigmoid", 1), ("xv3a_mul", 1),
    ("xv1a_act", 2), ("xv2a_ca", 1), ("xv3a_ca1", 1), ("xv1a_ocov", 1),
    ("xv2a_ocov2", 2), ("xv3a_ocov_cpos", 1), ("xv1a_ca1_ocov_mul_act", 1),
]


def _ss2d_pair(jm, tm, x, seed, dtype=torch.float32):
    v = _perturb(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed + 1)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)).astype(jnp.float32))
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(x).to(dtype)).float().numpy()
    return out, ref


@pytest.mark.parametrize("ftype,n", XV_TYPES)
def test_ss2dv3_matches_flax(ftype, n):
    """Each mode and a postfix of every family, N = 1 (the fused scan) and
    N = 2 (around the linear recurrence), fp32."""
    x = np.random.default_rng(1).normal(size=(2, 8, 6, 24)).astype(
        np.float32)
    out, ref = _ss2d_pair(JxSS2Dv3(24, n, 1.0, forward_type=ftype),
                          SS2Dv3(24, n, 1.0, forward_type=ftype), x, 3)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("disable_z", [True, False])
def test_ss2dm0_matches_flax(disable_z):
    """With and without the gate, a ragged last chunk (L = 48, chunk 32)."""
    x = np.random.default_rng(2).normal(size=(2, 8, 6, 24)).astype(
        np.float32)
    out, ref = _ss2d_pair(
        JxSS2Dm0(24, 4, 1.0, disable_z=disable_z, chunk_size=32),
        SS2Dm0(24, 4, 1.0, disable_z=disable_z, chunk_size=32), x, 4)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("op", ["xv1a", "xv3a_oncnorm_mul", "m0", "m0_z"])
def test_ss2d_variants_bf16_match_flax(op):
    """bf16 activations, fp32 parameters: in_proj, the dt projection and
    the convs in bf16, the scans and norms in fp32, as flax casts them."""
    x = np.random.default_rng(5).normal(size=(2, 8, 8, 24)).astype(
        np.float32)
    if op.startswith("xv"):
        jm = JxSS2Dv3(24, 1, 1.0, forward_type=op, dtype=jnp.bfloat16)
        tm = SS2Dv3(24, 1, 1.0, forward_type=op)
    else:
        dz = op == "m0"
        jm = JxSS2Dm0(24, 2, 1.0, disable_z=dz, dtype=jnp.bfloat16)
        tm = SS2Dm0(24, 2, 1.0, disable_z=dz)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    ref = np.asarray(jm.apply(v, jnp.asarray(x, jnp.bfloat16)).astype(
        jnp.float32))
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    _close(out.float().numpy(), ref, 0.03)


def test_xv_postfix_conflict_and_unknown_mode_raise():
    with pytest.raises(ValueError, match="conv2d"):
        SS2Dv3(24, 1, 1.0, forward_type="xv1a_cpos_ocov2")
    with pytest.raises(ValueError, match="unknown xv"):
        SS2Dv3(24, 1, 1.0, forward_type="xv4a")


# ---- the encoder from its config, forward and one train step --------------

FORWARD_TYPES = ["xv1a", "xv2a", "xv3a", "m0_noz"]


def _cfg(ftype, d_state=1, train=False):
    cfg = _tiny_train_cfg() if train else tiny_cfg()
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        SSM_FORWARDTYPE=ftype, SSM_D_STATE=d_state)
    return cfg


def _jax_model(cfg, seed, dtype=jnp.float32):
    jm, _ = jx_build_xpoint(cfg, dtype=dtype, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(
        jax.random.PRNGKey(seed))
    return jm, _perturb(jax.device_get(v), seed + 10, scale=0.05)


@pytest.mark.parametrize("ftype", FORWARD_TYPES)
def test_vssm_from_config_builds_the_block(ftype):
    """build_vssm_from_config routes xv* to SS2Dv3 (the whole forward type
    as its mode) and m* to SS2Dm0, with SSM_D_STATE as the state size."""
    enc = build_vssm_from_config({"DEPTHS": [1, 1, 1, 1], "EMBED_DIM": 24,
                                  "SSM_FORWARDTYPE": ftype,
                                  "SSM_D_STATE": 3})
    assert isinstance(enc, VSSM)
    op = enc.layers_2_blocks_0.op
    assert isinstance(op, SS2Dm0 if ftype.startswith("m") else SS2Dv3)
    assert not isinstance(op, SS2D) and op.d_state == 3
    if ftype.startswith("m"):
        assert op.disable_z
    else:
        assert op.mode == ftype


@pytest.mark.parametrize("ftype,dtype", [(f, "fp32") for f in FORWARD_TYPES]
                         + [("xv1a", "bf16"), ("m0_noz", "bf16")])
def test_xpoint_with_forward_type_matches_flax(ftype, dtype):
    """The tiny XPoint (depths [1,1,1,1], embed 24) in each forward type:
    pair forward, eval mode, fp32 1e-4 / bf16 3% of max |ref| on the
    logits and descriptors."""
    cfg = _cfg(ftype)
    jdt = jnp.float32
    if dtype == "bf16":
        cfg["mixed_precision"] = True
        jdt = jnp.bfloat16
    jm, v = _jax_model(cfg, 1, jdt)
    rng = np.random.default_rng(8)
    img_o, img_t = (rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
                    for _ in range(2))
    ref = jm.apply(v, jnp.asarray(img_o), jnp.asarray(img_t),
                   method=jm.forward_pair)
    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm.forward_pair(T(img_o), T(img_t))
    rel = 1e-4 if dtype == "fp32" else 0.03
    for side in (0, 1):
        for key in ("logits", "desc"):
            _close(out[side][key].numpy(), ref[side][key], rel,
                   f"{side} {key}")


@pytest.mark.parametrize("ftype", FORWARD_TYPES)
def test_train_step_forward_type_matches_jax(ftype):
    """One train step of the tiny model, JAX's make_train_step (optax Adam
    1e-4, associative scan) against the port's from the same weights and
    batch: loss components within 1e-5 relative, every gradient leaf
    (Adam's first moment) within 1e-3 of the leaf's max + 1e-7 of the
    largest."""
    cfg = _cfg(ftype, train=True)
    jm, v = _jax_model(cfg, 2)
    loss_cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)
    jtx, _ = jx_make_optimizer({"learningrate": 1e-4})
    jstate = JxTrainState.create(v["params"], v["batch_stats"], jtx)
    jstep = jx_make_train_step(jm, JxXPointLoss(loss_cfg), donate=False)
    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, v)
    tstate = TrainState(tm, make_optimizer({"learningrate": 1e-4})[0])
    tstep = make_train_step(tm, XPointLoss(loss_cfg))
    batch = _pair_batch(4)
    jstate, jc = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                       jax.random.PRNGKey(0))
    tc = tstep(tstate, _torch_batch(batch), torch.Generator().manual_seed(0))
    assert float(tc["skipped_nonfinite"]) == 0.0 and set(tc) == set(jc)
    for k in tc:
        tol = 1.5 / 128 if "ratio" in k else 1e-5 * abs(float(jc[k])) + 1e-6
        assert abs(float(tc[k]) - float(jc[k])) <= tol, k
    _, mu, _ = _port_state_tree(tstate)
    _assert_trees_close(mu, jstate.opt_state[0].mu, 1e-3,
                        "gradients (mu / 0.1)", floor=1e-7)


@pytest.mark.parametrize("ftype", ["xv1a", "xv2a", "m0_noz"])
def test_init_matches_flax_distributions(ftype):
    """The port's initialiser in the xv and m0 families: the flax entry set
    and shapes; xv's dt_projs_weight uniform(+-R^-0.5) (no shift); m0's
    A_logs zeros (K, R), Ds ones (K, R, Dh), dt bias in [0, 0.1); the
    moments of every larger tensor within sampling noise."""
    cfg = _cfg(ftype, d_state=4)
    jm, _ = jx_build_xpoint(cfg)
    ref = flax_to_state_dict(jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 64, 64, 1), jnp.float32),
        method=jm.init_all))(jax.random.PRNGKey(5)))
    tm, _ = build_xpoint(cfg, device="cpu", seed=5)
    sd = tm.state_dict()
    assert set(sd) == set(ref)
    op = "encoder.layers_1_blocks_0.op."
    R = 3                                     # ceil(48 / 16)
    if ftype.startswith("xv"):
        assert (op + "dt_projs_weight" in sd) == (ftype != "xv2a")
        assert sd[op + "A_logs"].shape == (4 * 48, 4)
        if ftype == "xv1a":
            w = sd[op + "dt_projs_weight"]
            assert float(w.min()) < 0 and float(w.abs().max()) <= R ** -0.5
    else:
        assert op + "dt_projs_weight" not in sd
        assert not sd[op + "A_logs"].any() and sd[op + "A_logs"].shape == (
            4, R)
        assert torch.all(sd[op + "Ds"] == 1) and sd[op + "Ds"].shape == (
            4, R, 48 // R)
        b = sd[op + "dt_projs_bias"]
        assert float(b.min()) >= 0 and float(b.max()) < 0.1
    for k, t in sd.items():
        r = ref[k]
        assert tuple(t.shape) == tuple(r.shape), k
        if t.numel() < 500:
            continue
        np.testing.assert_allclose(float(t.std()), float(r.std()),
                                   rtol=0.15, err_msg=k)
        assert abs(float(t.mean()) - float(r.mean())) < 0.1 * float(
            r.std()) + 1e-6, k


# ---- the converter's xv and m0 branches -----------------------------------

def _reference_vssm(module, seed, oncnorm):
    """A reference-named backbone state_dict of ``module``'s encoder."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, t in module.encoder.state_dict().items():
        name = _vssm_ref_key(k)
        if oncnorm:
            name = re.sub(r"\.out_norm\.(weight|bias)$", r".out_norm.0.\1",
                          name)
            name = name.replace(".out_norm_conv.", ".out_norm.2.")
        else:
            name = name.replace(".out_norm_conv.", ".out_norm.1.")
        sd["backbone." + name] = torch.from_numpy(
            rng.normal(size=tuple(t.shape)).astype(np.float32))
    return sd


@pytest.mark.parametrize("ftype", ["xv1a", "xv2a_ondwconv3",
                                   "xv3a_ocov_oncnorm", "m0_noz", "m0"])
def test_convert_vssm_xv_and_m0_match_jax(ftype):
    """Reference-named xv and m0 backbones (no x_proj_weight in xv, no
    dt_projs_weight in m0 and xv2a, oconv2d, the out_norm Sequentials)
    through JAX's convert_pretrained_encoder and the bridge against the
    port's converter, bit for bit; the full-model converter reads the same
    encoder keys under 'encoder.'. Before the xv / m0 branches the port's
    converter raised KeyError on x_proj_weight / dt_projs_weight and read
    neither oconv2d nor out_norm_conv."""
    cfg = _cfg(ftype, d_state=2)
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32)
    tm, _ = build_xpoint(cfg, device="cpu")
    sd = _reference_vssm(tm, 7, "oncnorm" in ftype)
    ref = flax_to_state_dict(jx_convert_pretrained_encoder(
        {k: t.numpy() for k, t in sd.items()}, jm, {"params": {}}))
    want = {k: t for k, t in ref.items() if k.startswith("encoder.")}
    got = convert_pretrained_encoder(sd, tm)
    assert set(got) == set(want) == {k for k in tm.state_dict()
                                     if k.startswith("encoder.")}
    for k, t in want.items():
        np.testing.assert_array_equal(got[k].numpy(), t.numpy(), err_msg=k)
    # the same keys under the full model's 'encoder.' prefix
    full = {f"encoder.{k[len('backbone.'):]}": t for k, t in sd.items()}
    full.update(reference_heads(tm, 8))
    got_full = convert_torch_state_dict(full, tm)
    for k, t in want.items():
        np.testing.assert_array_equal(got_full[k].numpy(), t.numpy(),
                                      err_msg=k)
    assert set(got_full) == {k for k in tm.state_dict()
                             if not k.startswith("hm_regressor.")}
