"""The scan modes and SS2D variants of the PyTorch port (forward types v05,
v051d, v052d, v052dc with the gate, the output GELU, d_state > 1 and the
conv bias) against the JAX package: cross_scan / cross_merge, the
single-direction fused scan's plain version and its gradients against the
Pallas kernel in interpret mode, SS2D and the tiny models whole, forward
and backward. fp32 on the CPU."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models.vssm import SS2D as JxSS2D
from xpoint_tpu.models.vssm import build_vssm_from_config as jx_build_vssm
from xpoint_tpu.ops.cross_scan import cross_merge as jx_cross_merge
from xpoint_tpu.ops.cross_scan import cross_scan as jx_cross_scan
from xpoint_tpu.ops.selective_scan_pallas import \
    selective_scan_fused_bkld as jx_fused_bkld

from xpoint_tpu_torch.compat.from_flax import (_flatten, load_flax_variables,
                                               state_dict_to_flax, to_flax)
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.models.vssm import SS2D
from xpoint_tpu_torch.ops.cross_scan import cross_merge, cross_scan
from xpoint_tpu_torch.ops.selective_scan_cuda import (
    selective_scan_fused_bkld, selective_scan_fused_bkld_plain)

from test_torch_models import _perturb, tiny_cfg
from torch_env import torch_env  # noqa: F401 (autouse)

T = torch.from_numpy


@pytest.mark.parametrize("scans", [0, 1, 2])
def test_cross_scan_equals_jax(scans):
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = cross_scan(T(x), scans).numpy()
    assert got.shape == (2, 4, 35, 3)
    np.testing.assert_array_equal(got, np.asarray(jx_cross_scan(
        jnp.asarray(x), scans)))


@pytest.mark.parametrize("scans", [0, 1, 2])
def test_cross_merge_equals_jax(scans):
    """Small integers, so that the sums are exact in any order."""
    ys = np.random.default_rng(1).integers(-8, 8, size=(2, 4, 35, 3)).astype(
        np.float32)
    got = cross_merge(T(ys), 5, 7, scans).numpy()
    assert got.shape == (2, 5, 7, 3)
    np.testing.assert_array_equal(got, np.asarray(jx_cross_merge(
        jnp.asarray(ys), 5, 7, scans)))


def test_cross_scan_rejects_unknown_mode():
    with pytest.raises(ValueError):
        cross_scan(torch.zeros(1, 2, 2, 1), 3)
    with pytest.raises(ValueError):
        cross_merge(torch.zeros(1, 4, 4, 1), 2, 2, -1)


def _operands(seed, B, K, L, Dim):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(u=f(B, K, L, Dim) * 0.5, dt=f(B, K, L, Dim) * 0.5,
                A=-np.exp(f(K * Dim) * 0.3), Bs=f(B, K, L, 1) * 0.5,
                Cs=f(B, K, L, 1) * 0.5, D=f(K * Dim), bias=f(K * Dim) * 0.2)


def _torch_args(o, dtype):
    return (T(o["u"]).to(dtype), T(o["dt"]).to(dtype), T(o["A"]),
            T(o["Bs"]).to(dtype), T(o["Cs"]).to(dtype), T(o["D"]),
            T(o["bias"]))


def _jax_fused(o, dtype):
    c = lambda k: jnp.asarray(o[k]).astype(dtype)  # noqa: E731
    return jx_fused_bkld(c("u"), c("dt"), jnp.asarray(o["A"]), c("Bs"),
                         c("Cs"), jnp.asarray(o["D"]), jnp.asarray(o["bias"]))


def test_fused_scan_plain_matches_pallas_interpret_fp32():
    """L = 300 is no multiple of the Pallas chunk (256) and M = 192 none of
    its lane block: rtol 1e-4 / atol 1e-5, the sequential fp32 recurrence
    against the in-chunk Hillis-Steele scan."""
    o = _operands(0, 2, 4, 300, 24)
    before = selective_scan_fused_bkld.launches
    got = selective_scan_fused_bkld(*_torch_args(o, torch.float32))
    # a CPU tensor runs the plain version, never the kernel
    assert selective_scan_fused_bkld.launches == before
    assert got.dtype == torch.float32 and got.shape == (2, 4, 300, 24)
    assert torch.equal(got, selective_scan_fused_bkld_plain(
        *_torch_args(o, torch.float32)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_jax_fused(o, jnp.float32)),
                               rtol=1e-4, atol=1e-5)


def test_fused_scan_plain_matches_pallas_interpret_bf16():
    """bf16 operands, fp32 carry, bf16 output: the two fp32 results round to
    the same or a neighbouring bf16 value (one ulp: 2^-7 relative, 1e-2
    absolute near 0)."""
    o = _operands(1, 2, 4, 300, 24)
    got = selective_scan_fused_bkld(*_torch_args(o, torch.bfloat16))
    want = _jax_fused(o, jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("L,Dim", [(8, 4), (300, 24)])
def test_fused_scan_gradients_match_jax(L, Dim):
    """selective_scan_fused_bkld's backward (the unfused composition around
    linear_scan, differentiated on the saved inputs) against jax.grad of
    the JAX function, whose VJP runs the Pallas recurrence reversed: every
    operand's gradient within 1e-4 of its max, fp32. The forward under
    autograd is still the fused scan."""
    o = _operands(2, 2, 4, L, Dim)
    w = np.random.default_rng(L).normal(size=(2, 4, L, Dim)).astype(
        np.float32)
    keys = ("u", "dt", "A", "Bs", "Cs", "D", "bias")
    want = jax.grad(lambda *xs: (jx_fused_bkld(*xs) * w).sum(),
                    argnums=tuple(range(7)))(*(jnp.asarray(o[k])
                                               for k in keys))
    args = [x.requires_grad_() for x in _torch_args(o, torch.float32)]
    y = selective_scan_fused_bkld(*args)
    assert torch.equal(y.detach(), selective_scan_fused_bkld_plain(
        *(x.detach() for x in args)))
    (y * T(w)).sum().backward()
    for k, x, theirs in zip(keys, args, want):
        theirs = np.asarray(theirs)
        assert x.grad.dtype == x.dtype and x.grad.shape == x.shape
        np.testing.assert_allclose(x.grad.numpy(), theirs, rtol=0,
                                   atol=1e-4 * np.abs(theirs).max(),
                                   err_msg=k)


def test_fused_scan_gradients_bf16_and_partial():
    """bf16 operands: the gradient is that of the fp32 function on the
    rounded operands, returned in each operand's dtype (within a bf16 ulp,
    2^-7 of the max); an operand that wants no gradient gets None."""
    o = _operands(4, 1, 4, 40, 8)
    lo = _torch_args(o, torch.bfloat16)
    hi = [x.float().requires_grad_() for x in lo]
    lo = [x.requires_grad_(i != 3) for i, x in enumerate(lo)]
    w = T(np.random.default_rng(0).normal(size=(1, 4, 40, 8)).astype(
        np.float32))
    (selective_scan_fused_bkld(*lo).float() * w).sum().backward()
    (selective_scan_fused_bkld(*hi) * w).sum().backward()
    assert lo[3].grad is None
    for i, (a, b) in enumerate(zip(lo, hi)):
        if i == 3:
            continue
        assert a.grad.dtype == a.dtype
        torch.testing.assert_close(
            a.grad.float(), b.grad, rtol=0,
            atol=2 ** -7 * float(b.grad.abs().max()))


def test_fused_scan_gradcheck_fp64():
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(*s, generator=g,  # noqa: E731
                               dtype=torch.float64)
    args = [f(2, 4, 9, 3) * 0.5, f(2, 4, 9, 3) * 0.5,
            -torch.exp(f(12) * 0.3), f(2, 4, 9, 1), f(2, 4, 9, 1), f(12),
            f(12) * 0.2]
    assert torch.autograd.gradcheck(
        selective_scan_fused_bkld, [x.requires_grad_() for x in args])


def test_fused_scan_checks_its_operands():
    args = list(_torch_args(_operands(3, 1, 4, 8, 4), torch.float32))
    with pytest.raises(ValueError, match="Bs"):
        selective_scan_fused_bkld(*args[:3], args[3][..., 0], *args[4:])
    with pytest.raises(TypeError):
        selective_scan_fused_bkld(args[0].bfloat16(), *args[1:])
    with pytest.raises(TypeError, match="A, D"):
        selective_scan_fused_bkld(*args[:2], args[2].double(), *args[3:])


@pytest.mark.parametrize("backend", ["pallas", "assoc"])
@pytest.mark.parametrize("mode", [1, 2])
def test_ss2d_scan_modes_match_flax(mode, backend):
    """SS2D in the unidi and bidi modes against flax, on the fused Pallas
    scan (interpret mode) and on the associative scan. The perturbed
    per-direction parameters differ between the four directions, so a
    direction fed another's x_proj / dt_projs / A / D rows would show."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 6, 24)).astype(np.float32)
    jm = JxSS2D(24, scan_mode=mode, scan_backend=backend)
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = load_flax_variables(SS2D(24, scan_mode=mode), v)
    with torch.no_grad():
        out = tm(T(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def _cfg(ftype):
    cfg = copy.deepcopy(tiny_cfg())
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"][
        "SSM_FORWARDTYPE"] = ftype
    return cfg


@pytest.mark.parametrize("ftype", ["v051d_noz", "v052d_noz"])
def test_xpoint_net_scan_modes_match_flax_through_bridge(ftype):
    """The whole tiny XPointNet in each forward type (JAX on the fused
    Pallas scan) through the weight bridge: same parameter names and
    shapes as v05_noz, outputs within atol 1e-4; the bridge round-trips."""
    jm, _ = jx_build_xpoint(_cfg(ftype), dtype=jnp.float32,
                            scan_backend="pallas")
    v = jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 64, 64, 1), jnp.float32),
        method=jm.init_all))(jax.random.PRNGKey(0))
    v = _perturb(v, 10, scale=0.05)
    img = np.random.default_rng(3).uniform(size=(2, 64, 64, 1)).astype(
        np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, "optical"))(v, jnp.asarray(img))
    tm, _ = build_xpoint(_cfg(ftype), device="cpu")
    assert tm.encoder.layers_0_blocks_0.op.scan_mode == int(ftype[3])
    base, _ = build_xpoint(tiny_cfg(), device="cpu")
    assert ({k: tuple(t.shape) for k, t in tm.state_dict().items()}
            == {k: tuple(t.shape) for k, t in base.state_dict().items()})
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(img))
    for key in ("logits", "desc", "encoder_output"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    back = to_flax(tm)
    for col in v:
        a, b = dict(_flatten(v[col])), dict(_flatten(back[col]))
        assert set(a) == set(b)
        for path in a:
            np.testing.assert_array_equal(b[path], np.asarray(a[path]))


# (disable_z, disable_z_act, out_act, d_state, conv_bias) by name
_VARIANTS = {
    "plain": (True, False, False, 1, False),
    "gate": (False, False, False, 1, False),
    "gate_nozact": (False, True, False, 1, False),
    "oact": (True, False, True, 1, False),
    "n4": (True, False, False, 4, False),
    "gate_oact_n4_bias": (False, False, True, 4, True),
}


def _ss2d_pair(variant, mode, backend):
    noz, nozact, oact, n, cbias = _VARIANTS[variant]
    jm = JxSS2D(24, d_state=n, conv_bias=cbias, disable_z=noz,
                disable_z_act=nozact, out_act=oact, scan_mode=mode,
                scan_backend=backend)
    tm = SS2D(24, d_state=n, conv_bias=cbias, disable_z=noz,
              disable_z_act=nozact, out_act=oact, scan_mode=mode)
    return jm, tm


@pytest.mark.parametrize("mode", [-1, 0, 1, 2])
@pytest.mark.parametrize("variant", sorted(set(_VARIANTS) - {"plain"}))
def test_ss2d_variants_match_flax(variant, mode):
    """SS2D with the gate (with and without its SiLU), the output GELU,
    d_state 4 and the conv bias, in every scan mode including cascade2d,
    against flax on the Pallas backend (interpret mode; cascade2d with
    N > 1 takes JAX's associative scan) through the bridge: atol 1e-4."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 6, 24)).astype(np.float32)
    jm, tm = _ss2d_pair(variant, mode, "pallas")
    v = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("backend", ["pallas", "assoc"])
def test_ss2d_cascade2d_matches_flax(backend):
    """cascade2d without the gate, N = 1 (the fused scan fed from the
    reference layout): rows, the parameter-free LayerNorm, columns, the
    flipped direction summed without un-reversing. atol 1e-4."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 7, 24)).astype(np.float32)
    jm, tm = _ss2d_pair("plain", -1, backend)
    v = _perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(x)), 5)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("variant,mode", [
    ("plain", 1), ("plain", 2), ("plain", -1), ("gate", 2), ("n4", 0),
    ("n4", 2), ("gate_oact_n4_bias", -1), ("gate_oact_n4_bias", 1)])
def test_ss2d_gradients_match_flax(variant, mode):
    """The input gradient and every parameter gradient of a weighted sum
    of SS2D's output against jax.grad of the flax module on the Pallas
    backend: within 1e-4 of each leaf's max (+ 1e-6 of the largest), fp32
    sums in another order."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 6, 5, 24)).astype(np.float32)
    w = rng.normal(size=(2, 6, 5, 24)).astype(np.float32)
    jm, tm = _ss2d_pair(variant, mode, "pallas")
    v = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)), 7)
    jgp, jgx = jax.jit(jax.grad(
        lambda p, xx: (jm.apply({"params": p}, xx) * w).sum(),
        argnums=(0, 1)))(v["params"], jnp.asarray(x))
    load_flax_variables(tm, v)
    tx = T(x).requires_grad_()
    (tm(tx) * T(w)).sum().backward()
    mine = dict(_flatten(state_dict_to_flax(
        {n: p.grad for n, p in tm.named_parameters()})["params"]))
    theirs = {p: np.asarray(g) for p, g in _flatten(jgp)}
    assert set(mine) == set(theirs)
    top = max(float(np.abs(g).max()) for g in theirs.values())
    for path, g in theirs.items():
        np.testing.assert_allclose(
            mine[path], g, rtol=0, atol=1e-4 * np.abs(g).max() + 1e-6 * top,
            err_msg="/".join(path))
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=0,
                               atol=1e-4 * np.abs(jgx).max())


def test_bridge_refuses_leaves_of_another_variant():
    """The bridge holds a module to the leaves it was built for: a gated
    in_proj or a (K D, 4) A_logs into the plain module is a shape error, a
    conv bias without its parameter an unconsumed leaf, and a missing one
    a missing entry."""
    x = jnp.zeros((1, 4, 4, 24), jnp.float32)
    for variant, exc, match in (("gate", ValueError, "in_proj"),
                                ("n4", ValueError, "x_proj_weight|A_logs"),
                                ("gate_oact_n4_bias", KeyError, "conv2d.bias")):
        jm, _ = _ss2d_pair(variant, 0, "assoc")
        v = jm.init(jax.random.PRNGKey(0), x)
        with pytest.raises(exc, match=match):
            load_flax_variables(SS2D(24), v)
    jm, tm = _ss2d_pair("plain", 0, "assoc")
    with pytest.raises(KeyError, match="conv2d.bias"):
        load_flax_variables(SS2D(24, conv_bias=True),
                            jm.init(jax.random.PRNGKey(0), x))


@pytest.mark.parametrize("ftype,extra", [
    ("v05", {}), ("v051d", {}), ("v052dc_noz", {}), ("v05_noz_oact", {}),
    ("v05_nozact", {}), ("v052d_noz", {"SSM_D_STATE": 2}),
    ("v05_noz", {"SSM_CONV_BIAS": True})])
def test_xpoint_net_forward_types_match_flax_through_bridge(ftype, extra):
    """The whole tiny XPointNet in the forward types and options that
    build_vssm_from_config now accepts (the gate, cascade2d, the output
    GELU, d_state 2, the conv bias), JAX on the Pallas backend, through
    the weight bridge: the parsed options, outputs within atol 1e-4, and
    the bridge's round trip leaf for leaf."""
    cfg = _cfg(ftype)
    vssm = cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"]
    vssm.update(extra)
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="pallas")
    v = jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, 64, 64, 1), jnp.float32),
        method=jm.init_all))(jax.random.PRNGKey(0))
    v = _perturb(v, 10, scale=0.05)
    img = np.random.default_rng(3).uniform(size=(2, 64, 64, 1)).astype(
        np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, "optical"))(v, jnp.asarray(img))
    tm, _ = build_xpoint(cfg, device="cpu")
    op, jenc = tm.encoder.layers_0_blocks_0.op, jx_build_vssm(vssm)
    assert (op.scan_mode, op.d_state, op.disable_z, op.disable_z_act,
            op.out_act) == (jenc.scan_mode, jenc.d_state, jenc.disable_z,
                            jenc.disable_z_act, jenc.out_act)
    assert (op.conv2d.bias is not None) == jenc.ssm_conv_bias
    load_flax_variables(tm, v)
    with torch.no_grad():
        out = tm(T(img))
    for key in ("logits", "desc", "encoder_output"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)
    back = to_flax(tm)
    for col in v:
        a, b = dict(_flatten(v[col])), dict(_flatten(back[col]))
        assert set(a) == set(b)
        for path in a:
            np.testing.assert_array_equal(b[path], np.asarray(a[path]))


@pytest.mark.parametrize("ftype", ["v051d_noz", "v052d_noz", "v052dc"])
def test_scan_mode_models_train_forward_and_backward(ftype):
    """A tiny model of each forward type in train mode: the forward under
    autograd equals the no-grad forward (the fused scan both times), and
    every encoder parameter gets a finite, non-zero gradient."""
    tm, _ = build_xpoint(_cfg(ftype), device="cpu")
    img = torch.rand(1, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    out = tm(img)
    with torch.no_grad():
        assert torch.equal(tm(img)["logits"], out["logits"])
    (out["logits"].square().mean() + out["desc"].square().mean()).backward()
    for name, p in tm.encoder.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert float(p.grad.abs().max()) > 0, name
