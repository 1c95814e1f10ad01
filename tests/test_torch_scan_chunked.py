"""The chained order of the bidirectional selective scan (segment
summaries -> span summaries -> a chain of spans per direction, each entry
from the exit K positions back folded with the summaries between -> replay),
as ``csrc/selective_scan_bidir.cu`` computes it on the card, held on the CPU
against the sequential plain version and against the Pallas kernel in
interpret mode.

``selective_scan_bidir_chunked`` is plain PyTorch and exists for these
tests: where there is no card they show that the kernel's order of
operations computes the recurrence, that its look-back gives the strict
chain's bits, and that its chunk entries are the checkpoint array the
backward kernel reads.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.ops.selective_scan_pallas import _fused_bidir_tok_impl

from xpoint_tpu_torch.ops.selective_scan_cuda import (
    CKPT_CHUNK, selective_scan_bidir_bwd_plain, selective_scan_bidir_chunked,
    selective_scan_bidir_plain)
from torch_env import torch_env  # noqa: F401 (autouse)

T = torch.from_numpy
LENGTHS = [1, 7, 255, 256, 257, 300, 513, 127, 128, 129, 385]
DIMS = [3, 8]


def _operands(seed, L, B, Dim):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(L, B, 2, Dim), f(2, L, B, 2, Dim) * 0.5, f(2, L, B, 2),
            f(2, L, B, 2), -np.exp(f(4 * Dim) * 0.3), f(4 * Dim),
            f(4 * Dim) * 0.2)


def _close(mine, ref, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(mine), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("Dim", DIMS)
@pytest.mark.parametrize("L", LENGTHS)
def test_chunked_matches_plain(L, Dim):
    """fp32, B=2: outputs rtol 1e-4 / atol 1e-5 (only the rounding of the
    segment and chunk products differs from the sequential loop), the carry
    array equal to the checkpoints within 1e-5."""
    args = tuple(map(T, _operands(L + Dim, L, 2, Dim)))
    out = selective_scan_bidir_chunked(*args)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out[:2], ref[:2]):
        assert a.shape == (L, 2, 2, Dim) and a.dtype == torch.float32
        _close(a, b)
    for a, b in zip(out[2:], ref[2:]):
        assert a.shape == (-(-L // CKPT_CHUNK), 2 * 2 * Dim)
        _close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("Dim", DIMS)
@pytest.mark.parametrize("L", LENGTHS)
def test_chunked_matches_pallas(L, Dim):
    """The same against the Pallas kernel in interpret mode (its (nl, 8, Mp)
    checkpoint blocks hold the state in row 0)."""
    args = _operands(100 + L + Dim, L, 2, Dim)
    (j_f, j_r), (jh_f, jh_r) = jax.jit(
        lambda *a: _fused_bidir_tok_impl(*a, emit_ckpt=True))(
            *map(jnp.asarray, args))
    y_f, y_r, h_f, h_r = selective_scan_bidir_chunked(*map(T, args))
    _close(y_f, j_f)
    _close(y_r, j_r)
    M = 2 * 2 * Dim
    _close(h_f, np.asarray(jh_f)[:, 0, :M], rtol=0, atol=1e-5)
    _close(h_r, np.asarray(jh_r)[:, 0, :M], rtol=0, atol=1e-5)


@pytest.mark.parametrize("L,steps", [(32, 4), (25, 4), (64, 8), (50, 8),
                                     (40, 16), (8, 1), (3, 4)])
def test_chunked_short_scan_segmentations(L, steps):
    """A scan of one span with the shorter segments the kernel takes at
    L <= 32 and L <= 64, and others: the same function."""
    args = tuple(map(T, _operands(L, L, 1, 5)))
    out = selective_scan_bidir_chunked(*args, steps=steps)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out, ref):
        _close(a, b)
    assert float(out[2].abs().max()) == 0 and float(out[3].abs().max()) == 0


@pytest.mark.parametrize("segments,steps", [(16, 16), (8, 16), (8, 8),
                                            (4, 8), (2, 4)])
def test_chunked_any_span_that_tiles_the_chunk(segments, steps):
    """Spans of 256, 128, 64, 32 and 8 tokens over L = 700: the same
    outputs and the same checkpoints, whatever the span."""
    args = tuple(map(T, _operands(1, 700, 1, 5)))
    out = selective_scan_bidir_chunked(*args, steps=steps, segments=segments)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        _close(a, b)


def test_chunked_rejects_spans_that_do_not_tile_the_chunk():
    args = tuple(map(T, _operands(0, 300, 1, 3)))
    with pytest.raises(ValueError):
        selective_scan_bidir_chunked(*args, steps=5, segments=8)


@pytest.mark.parametrize("L", [300, 1031])
def test_chunked_long_decay(L):
    """Large delta and |A|: the segment and chunk products underflow to 0
    (and an exact zero coefficient is among them); nothing divides, so the
    result stays finite and equal to the sequential one."""
    u, dt, bc, cc, A, D, bias = _operands(7, L, 2, 8)
    A = A * 40.0
    bias = bias + 3.0
    A[0] = -1e30                                  # a = exp(-inf) = 0
    args = tuple(map(T, (u, dt, bc, cc, A, D, bias)))
    out = selective_scan_bidir_chunked(*args)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        _close(a, b)


def test_chunked_slow_decay_over_many_chunks():
    """delta near 1e-3 (the flagship's smallest dt): the state carries over
    all spans, so the checkpoints are far from zero and test the carry."""
    L, Dim = 1300, 4
    u, dt, bc, cc, A, D, bias = _operands(9, L, 1, Dim)
    bias = np.full_like(bias, -6.9)
    dt = dt * 0.1
    A = -np.ones_like(A)
    args = tuple(map(T, (u, dt, bc, cc, A, D, bias)))
    out = selective_scan_bidir_chunked(*args)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    assert float(ref[2][-1].abs().min()) > 1e-4     # really carried
    top = float(max(ref[2].abs().max(), ref[3].abs().max()))
    for a, b in zip(out[2:], ref[2:]):
        assert float((a - b).abs().max()) <= 1e-5 * top
    for a, b in zip(out[:2], ref[:2]):
        _close(a, b)


def test_chunked_fp64_is_the_recurrence_to_roundoff():
    """In fp64 the two orders agree to 1e-12: the difference seen in fp32
    is rounding, not algebra."""
    args = tuple(T(x.astype(np.float64)) for x in _operands(11, 600, 2, 3))
    out = selective_scan_bidir_chunked(*args)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out, ref):
        assert a.dtype == torch.float64
        _close(a, b, rtol=1e-12, atol=1e-12)


def test_chunked_bf16_operands():
    """bf16 operands, fp32 carry: outputs round to bf16 from fp32 values
    that differ by rounding only, so they agree within one bf16 ulp (2^-7
    relative, 1e-2 absolute near 0); the fp32 checkpoints within 1e-4."""
    args = [T(x) for x in _operands(13, 300, 2, 8)]
    args[:4] = [x.bfloat16() for x in args[:4]]
    out = selective_scan_bidir_chunked(*args)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out[:2], ref[:2]):
        assert a.dtype == torch.bfloat16
        _close(a.float(), b.float(), rtol=2 ** -7, atol=1e-2)
    for a, b in zip(out[2:], ref[2:]):
        assert a.dtype == torch.float32
        _close(a, b, rtol=1e-4, atol=1e-4)


def test_backward_from_chunked_checkpoints_matches_plain_checkpoints():
    """The backward's plain version fed with the chunked carry array gives
    the cotangents it gives from the sequential checkpoints (1e-5 of each
    output's max): the array is what the backward kernel needs."""
    L, B, Dim = 600, 2, 8
    args = tuple(map(T, _operands(15, L, B, Dim)))
    rng = np.random.default_rng(16)
    g_f, g_r = (T(rng.normal(size=(L, B, 2, Dim)).astype(np.float32))
                for _ in range(2))
    mine = selective_scan_bidir_chunked(*args)[2:]
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)[2:]
    out = selective_scan_bidir_bwd_plain(*args, *mine, g_f, g_r)
    want = selective_scan_bidir_bwd_plain(*args, *ref, g_f, g_r)
    for a, b in zip(out, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("L", [700, 4096, 4001])
@pytest.mark.parametrize("lookback", [2, 4, 7])
def test_chunked_lookback_is_the_strict_chain(L, lookback):
    """The kernel folds exit(k - K) with the summaries of the K - 1
    positions between; that is the strict chain entry(k) = A(k-1) entry(k-1)
    + H(k-1) step for step, so outputs and checkpoints are equal bit for bit
    to lookback=1 (on a slow decay, where the carry crosses every span)."""
    u, dt, bc, cc, A, D, bias = _operands(21, L, 1, 4)
    bias = np.full_like(bias, -6.9)
    A = -np.ones_like(A)
    args = tuple(map(T, (u, dt * 0.1, bc, cc, A, D, bias)))
    strict = selective_scan_bidir_chunked(*args, lookback=1)
    mine = selective_scan_bidir_chunked(*args, lookback=lookback)
    assert float(strict[2][-1].abs().min()) > 0     # the chain carries
    for a, b in zip(mine, strict):
        assert torch.equal(a, b)


def test_chunked_rejects_lookback_below_one():
    args = tuple(map(T, _operands(0, 300, 1, 3)))
    with pytest.raises(ValueError):
        selective_scan_bidir_chunked(*args, lookback=0)


@pytest.mark.parametrize("L", [4096, 4001])
def test_chunked_long_chain_fp64(L):
    """A chain of 32 spans of 128 (L = 4001: the last of 33 partial) in
    fp64 on a slow decay: the sequential recurrence to 1e-12."""
    u, dt, bc, cc, A, D, bias = _operands(23, L, 1, 3)
    bias = np.full_like(bias, -6.9)
    A = -np.ones_like(A)
    args = tuple(T(x.astype(np.float64))
                 for x in (u, dt * 0.1, bc, cc, A, D, bias))
    out = selective_scan_bidir_chunked(*args)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    assert float(ref[2][-1].abs().min()) > 1e-4
    for a, b in zip(out, ref):
        assert a.dtype == torch.float64 and a.shape == b.shape
        _close(a, b, rtol=1e-12, atol=1e-12)


def test_chunked_long_chain_long_decay():
    """L = 4096 (32 spans) with large delta and |A| and an exact a = 0:
    the span products underflow to 0 along the chain; finite and equal to
    the sequential result (fp32, as test_chunked_long_decay)."""
    u, dt, bc, cc, A, D, bias = _operands(25, 4096, 1, 8)
    A = A * 40.0
    bias = bias + 3.0
    A[0] = -1e30
    args = tuple(map(T, (u, dt, bc, cc, A, D, bias)))
    out = selective_scan_bidir_chunked(*args)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        _close(a, b)


class _FakeLib:
    """The workspace size function of the kernel's library (the words the
    C entry point reports), for the wrapper's workspace on the CPU."""

    @staticmethod
    def xp_selective_scan_bidir_workspace(L, M):
        return 2 + 6 * -(-L // 128) * -(-M // 32) * 32


def test_chain_workspace_tags_are_unique_across_threads():
    """Tags handed out for one stream from 8 threads at once (switching
    every few microseconds) are 1 .. n with none lost or repeated: no two
    calls on a stream can take each other's chain words."""
    import sys
    import threading
    from xpoint_tpu_torch.ops import selective_scan_cuda as ssc
    key = (None, 12345)
    ssc._CHAIN.pop(key, None)
    tags, n_threads, per_thread = [], 8, 300
    lock = threading.Lock()

    def work():
        mine = [ssc._chain_workspace(_FakeLib, torch.device("cpu"), 12345,
                                     300, 96)[1] for _ in range(per_thread)]
        with lock:
            tags.extend(mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        ssc._CHAIN.pop(key, None)
    assert sorted(tags) == list(range(1, n_threads * per_thread + 1))


def test_chain_workspace_is_replaced_before_the_tag_wraps(monkeypatch):
    """A larger call, or the last tag, gets a new zeroed buffer and tag 1;
    otherwise a stream keeps its buffer and the tag counts up."""
    from xpoint_tpu_torch.ops import selective_scan_cuda as ssc
    monkeypatch.setattr(ssc, "_LAST_TAG", 3)
    key = (None, 777)
    ssc._CHAIN.pop(key, None)
    cpu = torch.device("cpu")
    try:
        got = [ssc._chain_workspace(_FakeLib, cpu, 777, 300, 96)
               for _ in range(5)]
        assert [t for _, t in got] == [1, 2, 3, 1, 2]
        assert got[0][0] is got[2][0] and got[3][0] is not got[2][0]
        assert int(got[3][0].abs().sum()) == 0
        ws, tag = ssc._chain_workspace(_FakeLib, cpu, 777, 4096, 3072)
        assert tag == 1 and ws.numel() == _FakeLib.\
            xp_selective_scan_bidir_workspace(4096, 3072)
        other = ssc._chain_workspace(_FakeLib, cpu, 778, 300, 96)
        assert other[1] == 1 and other[0] is not ws
    finally:
        ssc._CHAIN.pop(key, None)
        ssc._CHAIN.pop((None, 778), None)
