"""The unidi / bidi scan modes of the PyTorch port (forward types v051d_noz
and v052d_noz) against the JAX package: cross_scan / cross_merge, the
single-direction fused scan's plain version against the Pallas kernel in
interpret mode, SS2D and the tiny models whole. fp32 on the CPU."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models.vssm import SS2D as JxSS2D
from xpoint_tpu.ops.cross_scan import cross_merge as jx_cross_merge
from xpoint_tpu.ops.cross_scan import cross_scan as jx_cross_scan
from xpoint_tpu.ops.selective_scan_pallas import \
    selective_scan_fused_bkld as jx_fused_bkld

from xpoint_tpu_torch.compat.from_flax import (_flatten, load_flax_variables,
                                               to_flax)
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.models.vssm import SS2D
from xpoint_tpu_torch.ops.cross_scan import cross_merge, cross_scan
from xpoint_tpu_torch.ops.selective_scan_cuda import (
    selective_scan_fused_bkld, selective_scan_fused_bkld_plain)

from test_torch_models import _perturb, tiny_cfg

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


def test_fused_scan_backward_is_not_ported():
    args = list(_torch_args(_operands(2, 1, 4, 8, 4), torch.float32))
    args[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="K6"):
        selective_scan_fused_bkld(*args)
    with torch.no_grad():
        assert selective_scan_fused_bkld(*args).shape == (1, 4, 8, 4)


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


def test_scan_mode_models_train_forward_raises():
    """A gradient through the unidi / bidi scan is not ported: the forward
    raises rather than running a path whose backward is missing."""
    tm, _ = build_xpoint(_cfg("v052d_noz"), device="cpu")
    img = torch.rand(1, 64, 64, 1)
    with pytest.raises(NotImplementedError, match="K6"):
        tm(img)
    with torch.no_grad():
        assert torch.isfinite(tm(img)["logits"]).all()
