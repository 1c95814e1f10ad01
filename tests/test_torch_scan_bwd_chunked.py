"""The span-parallel orders of the bidirectional scan's backward
(``csrc/selective_scan_bidir_bwd.cu``: adjoint span summaries -> carry ->
replay, partial sums in a fixed order) and of the single-direction fused
scan (``csrc/selective_scan_fused.cu``: span summaries -> carry -> replay),
held on the CPU against the sequential plain versions and against the
Pallas kernels in interpret mode.

``selective_scan_bidir_bwd_chunked`` and ``selective_scan_fused_chunked``
are plain PyTorch and exist for these tests: where there is no card they
show that the kernels' orders of operations compute the same functions.
The tail shapes are the kernels': L in {1, 64, 129, 300, 513} (one span,
whole spans, a last span of one token, a short last checkpoint chunk) with
B = 3, Dim = 40 (M = 240 lanes, no multiple of a block's 32, groups that
straddle 32-lane slices).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.ops.selective_scan_pallas import (
    selective_scan_fused_bidir_tok, selective_scan_fused_bkld as jx_fused)

from xpoint_tpu_torch.ops.selective_scan_cuda import (
    selective_scan_bidir_bwd, selective_scan_bidir_bwd_chunked,
    selective_scan_bidir_bwd_plain, selective_scan_bidir_plain,
    selective_scan_fused_bkld, selective_scan_fused_bkld_plain,
    selective_scan_fused_chunked)
from torch_env import torch_env  # noqa: F401 (autouse)

T = torch.from_numpy
LENGTHS = [1, 64, 129, 300, 513]
B, DIM = 3, 40
NAMES = ("du_t", "ddt_t", "dbc_t", "dcc_t", "dA", "dD", "ddelta_bias")


def _bidir_operands(seed, L, batch=B, Dim=DIM):
    """Operands of the bidirectional scan and the cotangents of (y_f, y_r),
    fp32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    args = (f(L, batch, 2, Dim), f(2, L, batch, 2, Dim) * 0.5,
            f(2, L, batch, 2), f(2, L, batch, 2), -np.exp(f(4 * Dim) * 0.3),
            f(4 * Dim), f(4 * Dim) * 0.2)
    return args, (f(L, batch, 2, Dim), f(L, batch, 2, Dim))


def _fused_operands(seed, L, batch=B, Dim=DIM, K=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(batch, K, L, Dim) * 0.5, f(batch, K, L, Dim) * 0.5,
            -np.exp(f(K * Dim) * 0.3), f(batch, K, L, 1) * 0.5,
            f(batch, K, L, 1) * 0.5, f(K * Dim), f(K * Dim) * 0.2)


def _close(mine, ref, rtol=1e-4, atol=1e-5, name=""):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=name)


def _bwd_both(args, gy, dtype=torch.float32):
    """The chunked and the sequential backward from the plain forward's
    checkpoints."""
    targs = [T(x) for x in args]
    targs[:4] = [x.to(dtype) for x in targs[:4]]
    g = [T(x).to(dtype) for x in gy]
    ck = selective_scan_bidir_plain(*targs, emit_ckpt=True)[2:]
    return (selective_scan_bidir_bwd_chunked(*targs, *ck, *g),
            selective_scan_bidir_bwd_plain(*targs, *ck, *g))


@pytest.mark.parametrize("L", LENGTHS)
def test_bwd_chunked_matches_plain(L):
    """fp32: all seven cotangents within rtol 1e-4 / atol 1e-5 of the
    sequential version (only the rounding of the segment and span products
    and the order of the sums differ)."""
    args, gy = _bwd_both(*_bidir_operands(L, L))
    for name, a, b in zip(NAMES, args, gy):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close(a, b, name=name)


@pytest.mark.parametrize("L", LENGTHS)
def test_bwd_chunked_matches_pallas_vjp(L):
    """Against jax.vjp of selective_scan_fused_bidir_tok, which runs the
    Pallas forward with checkpoints and the Pallas backward
    (_fused_bidir_bwd_kernel) in interpret mode: rtol 1e-4 / atol 1e-5.
    Dim = 24 here: the Pallas token layout takes only widths whose lane
    blocks hold whole groups (Dim dividing 384 or a multiple of 128); with
    B = 3 that is still M = 144 lanes, no multiple of 32."""
    args, (g_f, g_r) = _bidir_operands(100 + L, L, Dim=24)
    _, vjp = jax.vjp(selective_scan_fused_bidir_tok, *map(jnp.asarray, args))
    ref = vjp((jnp.asarray(g_f), jnp.asarray(g_r)))
    targs = tuple(map(T, args))
    ck = selective_scan_bidir_plain(*targs, emit_ckpt=True)[2:]
    out = selective_scan_bidir_bwd_chunked(*targs, *ck, T(g_f), T(g_r))
    for name, mine, theirs in zip(NAMES, out, ref):
        assert mine.shape == theirs.shape, name
        _close(mine, theirs, name=name)


def test_bwd_chunked_fp64_is_the_backward_to_roundoff():
    """In fp64 the two orders agree to 1e-12: the difference seen in fp32
    is rounding, not algebra."""
    args, gy = _bidir_operands(7, 600)
    targs = [T(x.astype(np.float64)) for x in args]
    g = [T(x.astype(np.float64)) for x in gy]
    ck = selective_scan_bidir_plain(*targs, emit_ckpt=True)[2:]
    out = selective_scan_bidir_bwd_chunked(*targs, *ck, *g)
    ref = selective_scan_bidir_bwd_plain(*targs, *ck, *g)
    for name, a, b in zip(NAMES, out, ref):
        assert a.dtype == torch.float64, name
        _close(a, b, rtol=1e-12, atol=1e-12, name=name)


@pytest.mark.parametrize("L", [129, 513])
def test_bwd_chunked_bf16_operands(L):
    """bf16 operands and cotangents, fp32 arithmetic: the bf16 planes round
    fp32 values that differ by rounding only, so they agree within one bf16
    ulp (2^-7 relative; atol 1e-4 where sums cancel near 0); the fp32
    dA/dD/dbias within rtol 1e-4 / atol 1e-4."""
    out, ref = _bwd_both(*_bidir_operands(200 + L, L), dtype=torch.bfloat16)
    for i, (name, a, b) in enumerate(zip(NAMES, out, ref)):
        assert a.dtype == b.dtype, name
        if i < 4:
            assert a.dtype == torch.bfloat16, name
            _close(a.float(), b.float(), rtol=2 ** -7, atol=1e-4, name=name)
        else:
            _close(a, b, rtol=1e-4, atol=1e-4, name=name)


@pytest.mark.parametrize("segments,steps", [(8, 8), (4, 8), (2, 4), (16, 16),
                                            (8, 2)])
def test_bwd_chunked_any_span_that_tiles_the_chunk(segments, steps):
    """Spans of 64, 32, 8, 256 and 16 tokens over L = 700 (a short last
    chunk): the same cotangents as the sequential version."""
    args, gy = _bidir_operands(9, 700, batch=1, Dim=5)
    targs, g = tuple(map(T, args)), tuple(map(T, gy))
    ck = selective_scan_bidir_plain(*targs, emit_ckpt=True)[2:]
    out = selective_scan_bidir_bwd_chunked(*targs, *ck, *g, steps=steps,
                                           segments=segments)
    ref = selective_scan_bidir_bwd_plain(*targs, *ck, *g)
    for name, a, b in zip(NAMES, out, ref):
        _close(a, b, name=name)


def test_bwd_chunked_rejects_spans_that_do_not_tile_the_chunk():
    args, gy = _bidir_operands(0, 300, batch=1, Dim=3)
    targs, g = tuple(map(T, args)), tuple(map(T, gy))
    ck = selective_scan_bidir_plain(*targs, emit_ckpt=True)[2:]
    with pytest.raises(ValueError):
        selective_scan_bidir_bwd_chunked(*targs, *ck, *g, steps=5)


def test_bwd_chunked_slow_decay_carries_over_spans_and_chunks():
    """delta near 1e-3 (the flagship's smallest dt): h and the adjoint carry
    over many spans, so the h entries of spans inside a chunk and the
    adjoint entries are far from zero and test both carries."""
    L, Dim = 1300, 4
    args, gy = _bidir_operands(11, L, batch=1, Dim=Dim)
    u, dt, bc, cc, A, D, bias = args
    args = (u, dt * 0.1, bc, cc, -np.ones_like(A), D,
            np.full_like(bias, -6.9))
    out, ref = _bwd_both(args, gy)
    for name, a, b in zip(NAMES, out, ref):
        _close(a, b, name=name)


def test_bwd_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper is the sequential plain version, never the
    kernel, and never the chunked order."""
    args, gy = _bidir_operands(13, 70, batch=1, Dim=8)
    targs, g = tuple(map(T, args)), tuple(map(T, gy))
    ck = selective_scan_bidir_plain(*targs, emit_ckpt=True)[2:]
    before = selective_scan_bidir_bwd.launches
    out = selective_scan_bidir_bwd(*targs, *ck, *g)
    assert selective_scan_bidir_bwd.launches == before
    ref = selective_scan_bidir_bwd_plain(*targs, *ck, *g)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("L", LENGTHS)
def test_fused_chunked_matches_plain(L):
    """fp32: rtol 1e-4 / atol 1e-5 of the sequential recurrence."""
    args = tuple(map(T, _fused_operands(L, L)))
    out = selective_scan_fused_chunked(*args)
    ref = selective_scan_fused_bkld_plain(*args)
    assert out.shape == (B, 4, L, DIM) and out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("L", LENGTHS)
def test_fused_chunked_matches_pallas(L):
    """Against selective_scan_fused_bkld of the JAX package, whose forward
    is the Pallas _fused_scan_kernel in interpret mode: rtol 1e-4 /
    atol 1e-5."""
    args = _fused_operands(300 + L, L)
    ref = jx_fused(*map(jnp.asarray, args))
    out = selective_scan_fused_chunked(*map(T, args))
    _close(out, ref)


@pytest.mark.parametrize("L,steps", [(16, 4), (13, 4), (32, 8), (25, 8),
                                     (64, 16), (50, 16), (8, 1), (128, 16)])
def test_fused_chunked_short_scan_segmentations(L, steps):
    """A scan of one span with the shorter segments K5 takes at L <= 16 and
    L <= 32, and others (L = 128: two spans of 16-step segments): the same
    function."""
    args = tuple(map(T, _fused_operands(L, L, batch=1, Dim=5)))
    _close(selective_scan_fused_chunked(*args, steps=steps),
           selective_scan_fused_bkld_plain(*args))


def test_fused_chunked_fp64_is_the_recurrence_to_roundoff():
    args = tuple(T(x.astype(np.float64)) for x in _fused_operands(15, 600))
    out = selective_scan_fused_chunked(*args)
    assert out.dtype == torch.float64
    _close(out, selective_scan_fused_bkld_plain(*args), rtol=1e-12,
           atol=1e-12)


def test_fused_chunked_bf16_operands():
    """bf16 operands, fp32 carry, bf16 output: within one bf16 ulp (2^-7
    relative, 1e-2 absolute near 0)."""
    args = [T(x) for x in _fused_operands(17, 513)]
    for i in (0, 1, 3, 4):
        args[i] = args[i].bfloat16()
    out = selective_scan_fused_chunked(*args)
    ref = selective_scan_fused_bkld_plain(*args)
    assert out.dtype == torch.bfloat16
    _close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-2)


def test_fused_chunked_long_decay():
    """Large delta and |A| (and an exact a = 0): the segment and span
    products underflow to 0; nothing divides, so the result stays finite and
    equal to the sequential one."""
    u, dt, A, bs, cs, D, bias = _fused_operands(19, 1031, batch=1, Dim=8)
    A = A * 40.0
    A[0] = -1e30
    args = tuple(map(T, (u, dt, A, bs, cs, D, bias + 3.0)))
    out = selective_scan_fused_chunked(*args)
    assert bool(torch.isfinite(out).all())
    _close(out, selective_scan_fused_bkld_plain(*args))


def test_fused_wrapper_on_cpu_runs_the_plain_version():
    args = tuple(map(T, _fused_operands(21, 70, batch=1, Dim=8)))
    before = selective_scan_fused_bkld.launches
    assert torch.equal(selective_scan_fused_bkld(*args),
                       selective_scan_fused_bkld_plain(*args))
    assert selective_scan_fused_bkld.launches == before
