"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The machine with
the card has no JAX, and tests/conftest.py imports it, so run them there
with

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from xpoint_tpu_torch.geometry.homography import sample_homography
from xpoint_tpu_torch.ops import warp, warp_projective
from xpoint_tpu_torch.ops.linear_scan import (linear_scan,
                                              linear_scan_launch,
                                              linear_scan_plain)
from xpoint_tpu_torch.ops.nms import (box_nms, box_nms_extract, grid_nms_keep,
                                      grid_nms_keep_plain)
from xpoint_tpu_torch.ops.selective_scan_cuda import (
    SelectiveScanBidir, selective_scan_bidir, selective_scan_bidir_bwd,
    selective_scan_bidir_bwd_launch_shape, selective_scan_bidir_bwd_plain,
    selective_scan_bidir_launch_shape, selective_scan_bidir_plain,
    selective_scan_fused_bkld, selective_scan_fused_bkld_plain)
from torch_env import torch_env  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scan_operands(seed, L, B, Dim, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    ops = [f(L, B, 2, Dim) * 0.5, f(2, L, B, 2, Dim) * 0.5,
           f(2, L, B, 2) * 0.5, f(2, L, B, 2) * 0.5]
    consts = [-torch.exp(f(4 * Dim) * 0.3), f(4 * Dim), f(4 * Dim) * 0.2]
    return ([x.to(device, dtype) for x in ops]
            + [x.to(device) for x in consts])


@pytest.mark.parametrize("L,B,Dim", [(300, 2, 24), (37, 3, 40), (1024, 8, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_matches_plain(cuda, L, B, Dim, dtype):
    """fp32: only the rounding of exp/log1p/fma differs (atol 1e-4);
    bf16 outputs: the fp32 results may round to neighbouring bf16 values,
    one ulp (2^-7 relative, 1e-2 absolute near 0)."""
    args = _scan_operands(0, L, B, Dim, dtype, cuda)
    before = selective_scan_bidir.launches
    y_f, y_r = selective_scan_bidir(*args)
    torch.cuda.synchronize()
    assert selective_scan_bidir.launches == before + 1
    p_f, p_r = selective_scan_bidir_plain(*args)
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-2, 2 ** -7)
    for a, b in ((y_f, p_f), (y_r, p_r)):
        assert a.dtype == dtype and a.shape == (L, B, 2, Dim)
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("L,B,Dim", [(300, 2, 24), (513, 2, 64),
                                     (1024, 8, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_checkpoints_match_plain(cuda, L, B, Dim, dtype):
    """emit_ckpt: the fp32 chunk entry states of both lane sets; the carries
    differ from the plain version's by the rounding of exp/log1p/fma only."""
    args = _scan_operands(1, L, B, Dim, dtype, cuda)
    out = selective_scan_bidir(*args, emit_ckpt=True)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    torch.cuda.synchronize()
    for a, b in zip(out[2:], ref[2:]):
        assert a.dtype == torch.float32
        assert a.shape == (-(-L // 256), B * 2 * Dim)
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    # y is the same with and without checkpoints
    y_f, y_r = selective_scan_bidir(*args)
    assert torch.equal(y_f, out[0]) and torch.equal(y_r, out[1])


def _rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("emit_ckpt", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dim", [3, 8, 96, 192])
@pytest.mark.parametrize("L", [1, 7, 255, 256, 257, 300, 513, 63, 64, 65,
                               127, 128, 129, 383, 384, 385])
def test_scan_kernel_chunk_grid(cuda, L, Dim, dtype, emit_ckpt):
    """The chained K1 over scans below, at and across the 256-token chunk
    and its 128-token spans (one span, one span and one token, a last span
    that enters a chunk from the right alone) and the 64 tokens up to which
    the one-span kernel runs, lane counts that are and are not multiples
    of a block's 32 lanes (B=3: M = 18, 48, 576, 1152), with and without
    the checkpoints returned. Tolerances as test_scan_kernel_matches_plain /
    test_scan_kernel_checkpoints_match_plain; a second run on the same
    inputs gives the same bits (every sum is taken in a fixed order)."""
    args = _scan_operands(L + Dim, L, 3, Dim, dtype, cuda)
    before = selective_scan_bidir.launches
    out = selective_scan_bidir(*args, emit_ckpt=emit_ckpt)
    again = selective_scan_bidir(*args, emit_ckpt=emit_ckpt)
    torch.cuda.synchronize()
    assert selective_scan_bidir.launches == before + 2
    assert len(out) == (4 if emit_ckpt else 2)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=emit_ckpt)
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-2, 2 ** -7)
    for a, b in zip(out[:2], ref[:2]):
        assert a.dtype == dtype and a.shape == (L, 3, 2, Dim)
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
    for a, b in zip(out[2:], ref[2:]):
        assert a.dtype == torch.float32
        assert a.shape == (-(-L // 256), 3 * 2 * Dim)
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_scan_kernel_long_decay(cuda):
    """Large delta and |A| (and an exact a = 0): chunk products underflow
    to 0; finite and equal to the plain version (atol 1e-4)."""
    args = _scan_operands(5, 1031, 2, 40, torch.float32, cuda)
    args[4] = args[4] * 40.0
    args[4][0] = -1e30
    args[6] = args[6] + 3.0
    out = selective_scan_bidir(*args, emit_ckpt=True)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _slow_decay(args):
    """The flagship's smallest dt (delta near 1e-3) and A = -1: the carry
    crosses every span, so the chain is what the outputs test."""
    args = list(args)
    args[4] = -torch.ones_like(args[4])
    args[6] = torch.full_like(args[6], -6.9)
    return args


def _check_scan(out, ref, dtype):
    """Outputs as test_scan_kernel_matches_plain, checkpoints 1e-4 of the
    plain version's max."""
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-2, 2 ** -7)
    for a, b in zip(out[:2], ref[:2]):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol)
    for a, b in zip(out[2:], ref[2:]):
        assert _rel_err(a, b) <= 1e-4


@pytest.mark.parametrize("L", [64, 65, 16384])
def test_scan_kernel_launch_shape(cuda, L):
    """One launch a call: up to 64 tokens one block a lane group does both
    directions; beyond, one block a direction, lane group and 128-token
    span. Every launch has at least one resident block an SM."""
    M = 8 * 2 * 96
    groups, spans = -(-M // 32), -(-L // 128)
    shape = selective_scan_bidir_launch_shape(L, M, 96)
    assert shape["blocks"] == (groups if L <= 64 else 2 * groups * spans)
    assert shape["blocks_per_sm"] >= 1 and shape["threads"] in (288, 512)


def test_scan_kernel_more_shared_memory_than_the_last_call(cuda):
    """fp32 calls whose blocks stage B and C of more groups than the call
    before (Dim 96, then 24, then 1: 2, 3 and 32 groups a block) in one
    process: each launches and agrees with the plain version."""
    for Dim, B in ((96, 2), (24, 2), (1, 5)):
        args = _scan_operands(36 + Dim, 300, B, Dim, torch.float32, cuda)
        out = selective_scan_bidir(*args, emit_ckpt=True)
        ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
        _check_scan(out, ref, torch.float32)


def test_scan_kernel_long_chain_few_lanes(cuda):
    """L = 65536 with one lane group (B = 1, Dim = 16: M = 32): a chain of
    512 spans a direction on a slow decay, against the plain version."""
    args = _slow_decay(_scan_operands(31, 65536, 1, 16, torch.float32, cuda))
    out = selective_scan_bidir(*args, emit_ckpt=True)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    assert float(ref[2][-1].abs().min()) > 0
    _check_scan(out, ref, torch.float32)


def test_scan_kernel_grid_many_times_resident(cuda):
    """L = 16384, B = 8, Dim = 768 (M = 12288): 384 lane groups x 128 spans
    x 2 directions, some 90 times the blocks the card holds at once; every
    block waits only on blocks that started before it, so the launch
    finishes, and agrees with the plain version (bf16)."""
    args = _scan_operands(32, 16384, 8, 768, torch.bfloat16, cuda)
    out = selective_scan_bidir(*args, emit_ckpt=True)
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)
    _check_scan(out, ref, torch.bfloat16)


def test_scan_kernel_repeats_bit_equal(cuda):
    """50 calls on the same inputs (the flagship's first training stage,
    L = 4096, B = 16, Dim = 96, with checkpoints) give the same bits: the
    chain composes in a fixed order whatever the timing."""
    args = _slow_decay(_scan_operands(33, 4096, 16, 96, torch.bfloat16, cuda))
    first = selective_scan_bidir(*args, emit_ckpt=True)
    runs = [selective_scan_bidir(*args, emit_ckpt=True) for _ in range(49)]
    torch.cuda.synchronize()
    for out in runs:
        assert all(torch.equal(a, b) for a, b in zip(out, first))
    _check_scan(first, selective_scan_bidir_plain(*args, emit_ckpt=True),
                torch.bfloat16)


def test_scan_kernel_on_two_streams_at_once(cuda):
    """Calls on two streams that overlap on the card (each stream has its
    own chain workspace), alternated ten times without a synchronisation
    between them, and a call after a larger one on the same stream: every
    result equals the default stream's bit for bit."""
    args = _slow_decay(_scan_operands(34, 16384, 2, 96, torch.bfloat16,
                                      cuda))
    small = _slow_decay(_scan_operands(35, 300, 3, 40, torch.bfloat16, cuda))
    want = selective_scan_bidir(*args, emit_ckpt=True)
    want_small = selective_scan_bidir(*small, emit_ckpt=True)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(10):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(selective_scan_bidir(*args, emit_ckpt=True))
                if i == 9:
                    outs.append(selective_scan_bidir(*small, emit_ckpt=True))
    torch.cuda.synchronize()
    for out in outs[:-4] + outs[-4:-3] + outs[-2:-1]:
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    for out in (outs[-3], outs[-1]):
        assert all(torch.equal(a, b) for a, b in zip(out, want_small))


@pytest.mark.parametrize("L,B,Dim", [(64, 2, 24), (513, 2, 64),
                                     (1024, 4, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_from_kernel_checkpoints(cuda, L, B, Dim, dtype):
    """K3 fed with K1's own checkpoints against K3 fed with the plain
    version's: the same cotangents within 1e-4 (fp32) / 2e-2 and 1e-3
    (bf16, as test_scan_bwd_kernel_matches_plain) of each output's max."""
    args = _scan_operands(7, L, B, Dim, dtype, cuda)
    g = torch.Generator(device="cpu").manual_seed(8)
    g_f, g_r = (torch.randn(L, B, 2, Dim, generator=g).to(cuda, dtype)
                for _ in range(2))
    mine = selective_scan_bidir(*args, emit_ckpt=True)[2:]
    ref = selective_scan_bidir_plain(*args, emit_ckpt=True)[2:]
    out = selective_scan_bidir_bwd(*args, *mine, g_f, g_r)
    want = selective_scan_bidir_bwd(*args, *ref, g_f, g_r)
    for i, (a, b) in enumerate(zip(out, want)):
        tol = 1e-4 if dtype == torch.float32 else (2e-2 if i < 4 else 1e-3)
        assert _rel_err(a, b) <= tol, (i, _rel_err(a, b))


@pytest.mark.parametrize("L,B,Dim", [(300, 2, 24), (37, 3, 40), (513, 2, 64),
                                     (1024, 8, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_kernel_matches_plain(cuda, L, B, Dim, dtype):
    """K3 against its plain version on the same checkpoints and cotangents.
    Max abs error relative to max |plain|: fp32 1e-4 (the kernel's
    approximate softplus / exp / sigmoid and its order of sums); bf16
    outputs 2e-2 (a bf16 ulp is 2^-8 relative), the fp32 dA/dD/dbias 1e-3."""
    args = _scan_operands(2, L, B, Dim, dtype, cuda)
    _, _, hck_f, hck_r = selective_scan_bidir_plain(*args, emit_ckpt=True)
    g = torch.Generator(device="cpu").manual_seed(3)
    g_f, g_r = (torch.randn(L, B, 2, Dim, generator=g).to(cuda, dtype)
                for _ in range(2))
    before = selective_scan_bidir_bwd.launches
    out = selective_scan_bidir_bwd(*args, hck_f, hck_r, g_f, g_r)
    torch.cuda.synchronize()
    assert selective_scan_bidir_bwd.launches == before + 1
    ref = selective_scan_bidir_bwd_plain(*args, hck_f, hck_r, g_f, g_r)
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        tol = 1e-4 if dtype == torch.float32 else (2e-2 if i < 4 else 1e-3)
        assert _rel_err(a, b) <= tol, (i, _rel_err(a, b))


@pytest.mark.parametrize("L", [1, 64, 129, 300, 513])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bwd_kernel_tails_and_repeat(cuda, L, dtype):
    """K3 where its blocks have tails: one span of 1 or 64 tokens, 129 (a
    last span of one token), 300 and 513 (chunks entered mid-way), B = 3,
    Dim = 40 (240 lanes: no multiple of a block's 32, groups that straddle
    its 32-lane slices). Against the plain version from K1's own
    checkpoints (tolerances of test_scan_bwd_kernel_matches_plain), and a
    second run on the same inputs bit for bit: no sum depends on the
    order in which blocks run."""
    args = _scan_operands(20 + L, L, 3, 40, dtype, cuda)
    ck = selective_scan_bidir(*args, emit_ckpt=True)[2:]
    g = torch.Generator(device="cpu").manual_seed(21 + L)
    g_f, g_r = (torch.randn(L, 3, 2, 40, generator=g).to(cuda, dtype)
                for _ in range(2))
    before = selective_scan_bidir_bwd.launches
    out = selective_scan_bidir_bwd(*args, *ck, g_f, g_r)
    again = selective_scan_bidir_bwd(*args, *ck, g_f, g_r)
    torch.cuda.synchronize()
    assert selective_scan_bidir_bwd.launches == before + 2
    ref = selective_scan_bidir_bwd_plain(*args, *ck, g_f, g_r)
    for i, (a, b, c) in enumerate(zip(out, again, ref)):
        assert torch.equal(a, b), i
        assert a.dtype == c.dtype and a.shape == c.shape, i
        assert bool(torch.isfinite(a).all()), i
        tol = 1e-4 if dtype == torch.float32 else (2e-2 if i < 4 else 1e-3)
        assert _rel_err(a, c) <= tol, (i, _rel_err(a, c))


@pytest.mark.parametrize("L,B,Dim", [(4096, 16, 96), (1024, 16, 192),
                                     (256, 16, 384), (64, 16, 768)])
def test_scan_bwd_kernel_repeat_at_train_shapes(cuda, L, B, Dim):
    """Two K3 runs at each flagship training stage shape (bf16) give the
    same bits."""
    args = _scan_operands(30, L, B, Dim, torch.bfloat16, cuda)
    ck = selective_scan_bidir(*args, emit_ckpt=True)[2:]
    g = torch.Generator(device=cuda).manual_seed(31)
    g_f, g_r = ((torch.randn(L, B, 2, Dim, generator=g, device=cuda) * 0.1)
                .bfloat16() for _ in range(2))
    out = selective_scan_bidir_bwd(*args, *ck, g_f, g_r)
    again = selective_scan_bidir_bwd(*args, *ck, g_f, g_r)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def _bwd_case(seed, L, B, Dim, dtype, dev, slow=False):
    """K3's operands, K1's own checkpoints of them and cotangents."""
    args = _scan_operands(seed, L, B, Dim, dtype, dev)
    if slow:
        args = _slow_decay(args)
    ck = selective_scan_bidir(*args, emit_ckpt=True)[2:]
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    gy = [torch.randn(L, B, 2, Dim, generator=g).to(dev, dtype)
          for _ in range(2)]
    return (*args, *ck, *gy)


def _check_bwd(out, ref, dtype):
    """The tolerances of test_scan_bwd_kernel_matches_plain, and finite."""
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert bool(torch.isfinite(a).all()), i
        tol = 1e-4 if dtype == torch.float32 else (2e-2 if i < 4 else 1e-3)
        assert _rel_err(a, b) <= tol, (i, _rel_err(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dim", [8, 40, 96])
@pytest.mark.parametrize("L", [63, 64, 65, 127, 128, 129, 255, 256, 257,
                               511, 512, 513])
def test_scan_bwd_kernel_span_boundaries(cuda, L, Dim, dtype):
    """K3 at and across its 256-token spans (one checkpoint chunk each) and
    the 32 and 64 tokens up to which its one-span kernel takes 4 and 8
    steps a thread, with lanes that are and are not multiples of a block's 32
    (B=3: M = 48, 240, 576; Dim 40's groups straddle 32-lane slices): one
    launch a call, against the plain version, and a second run bit for
    bit."""
    args = _bwd_case(L + Dim, L, 3, Dim, dtype, cuda)
    before = selective_scan_bidir_bwd.launches
    out = selective_scan_bidir_bwd(*args)
    again = selective_scan_bidir_bwd(*args)
    torch.cuda.synchronize()
    assert selective_scan_bidir_bwd.launches == before + 2
    _check_bwd(out, selective_scan_bidir_bwd_plain(*args), dtype)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_scan_bwd_kernel_long_chain_few_lanes(cuda):
    """L = 65536 with one lane group (B = 1, Dim = 16: M = 32): a chain of
    256 spans a direction on a slow decay, which carries the adjoint across
    every span, against the plain version (fp32)."""
    args = _bwd_case(40, 65536, 1, 16, torch.float32, cuda, slow=True)
    out = selective_scan_bidir_bwd(*args)
    _check_bwd(out, selective_scan_bidir_bwd_plain(*args), torch.float32)


def test_scan_bwd_kernel_grid_many_times_resident(cuda):
    """L = 16384, B = 8, Dim = 768 (M = 12288): 384 lane groups x 64 spans
    x 2 directions, some 190 times the blocks the card holds at once; a
    block waits only on blocks that started before it, so the launch
    finishes, and agrees with the plain version (bf16)."""
    args = _bwd_case(41, 16384, 8, 768, torch.bfloat16, cuda)
    out = selective_scan_bidir_bwd(*args)
    _check_bwd(out, selective_scan_bidir_bwd_plain(*args), torch.bfloat16)


def test_scan_bwd_kernel_repeats_bit_equal(cuda):
    """50 K3 calls on the same inputs (the flagship's first training stage,
    L = 4096, B = 16, Dim = 96, bf16, slow decay) give the same bits: the
    chain composes in a fixed order whatever the timing, and du, dB, dC,
    dA, dD and dbias are summed in fixed orders."""
    args = _bwd_case(42, 4096, 16, 96, torch.bfloat16, cuda, slow=True)
    first = selective_scan_bidir_bwd(*args)
    runs = [selective_scan_bidir_bwd(*args) for _ in range(49)]
    torch.cuda.synchronize()
    for out in runs:
        assert all(torch.equal(a, b) for a, b in zip(out, first))
    _check_bwd(first, selective_scan_bidir_bwd_plain(*args), torch.bfloat16)


def test_scan_bwd_kernel_on_two_streams_at_once(cuda):
    """K3 calls on two streams that overlap on the card (each stream has its
    own chain workspace), alternated ten times without a synchronisation
    between them, and a one-span call after a chained one on the same
    stream: every result equals the default stream's bit for bit."""
    args = _bwd_case(43, 16384, 2, 96, torch.bfloat16, cuda, slow=True)
    small = _bwd_case(44, 300, 3, 40, torch.bfloat16, cuda)
    want = selective_scan_bidir_bwd(*args)
    want_small = selective_scan_bidir_bwd(*small)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(10):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(selective_scan_bidir_bwd(*args))
                if i == 9:
                    outs.append(selective_scan_bidir_bwd(*small))
    torch.cuda.synchronize()
    for out in outs[:-4] + outs[-4:-3] + outs[-2:-1]:
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    for out in (outs[-3], outs[-1]):
        assert all(torch.equal(a, b) for a, b in zip(out, want_small))


def test_scan_bwd_on_autograd_thread_beside_a_forward_stream(cuda):
    """SelectiveScanBidir's backward (K3, run by autograd's device thread)
    started from a second thread while the main thread runs K1 forwards on
    another stream, with no synchronisation between them: the gradients
    equal those of a run alone and the forwards their outputs alone, bit
    for bit (the workspaces are per stream and kernel, the tags handed out
    under one lock)."""
    import threading
    args = _slow_decay(_scan_operands(45, 4096, 4, 96, torch.bfloat16, cuda))
    other = _slow_decay(_scan_operands(46, 16384, 2, 96, torch.bfloat16,
                                       cuda))

    def grads():
        xs = [x.detach().clone().requires_grad_() for x in args]
        y_f, y_r = SelectiveScanBidir.apply(*xs)
        ((y_f.float() ** 2).sum() + (y_r.float() * 0.5).sum()).backward()
        return [x.grad for x in xs]

    before = selective_scan_bidir_bwd.launches
    want = grads()
    want_fwd = selective_scan_bidir(*other, emit_ckpt=True)
    torch.cuda.synchronize()
    got = {}
    worker = threading.Thread(target=lambda: got.update(g=grads()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    worker.start()
    fwds = []
    with torch.cuda.stream(side):
        for _ in range(10):
            fwds.append(selective_scan_bidir(*other, emit_ckpt=True))
    worker.join(timeout=120)
    assert not worker.is_alive()
    torch.cuda.synchronize()
    assert selective_scan_bidir_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got["g"], want))
    for out in fwds:
        assert all(torch.equal(a, b) for a, b in zip(out, want_fwd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [64, 65, 128, 256, 257, 16384])
def test_scan_bwd_kernel_launch_shape(cuda, L, dtype):
    """One recurrence launch a call: up to 64 tokens one 512-thread block a
    lane group does both directions; beyond, one 544-thread block (16 scan
    warps and a chain warp) a direction, lane group and 256-token span.
    Every launch has at least one resident block an SM."""
    M = 8 * 2 * 96
    groups, spans = -(-M // 32), -(-L // 256)
    shape = selective_scan_bidir_bwd_launch_shape(L, M, 96, dtype)
    one_block = L <= 64
    assert shape["blocks"] == (groups if one_block else 2 * groups * spans)
    assert shape["threads"] == (512 if one_block else 544)
    assert shape["blocks_per_sm"] >= 1 and shape["smem_bytes"] > 0


def test_scan_autograd_on_card_matches_cpu(cuda):
    """SelectiveScanBidir: K1 with checkpoints then K3 on the card against
    the plain forward and backward on the CPU, fp32."""
    cpu = _scan_operands(4, 300, 2, 24, torch.float32, "cpu")
    grads = []
    for dev in ("cpu", cuda):
        xs = [x.detach().to(dev).requires_grad_() for x in cpu]
        y_f, y_r = SelectiveScanBidir.apply(*xs)
        ((y_f ** 2).sum() + (y_r * torch.cos(y_r)).sum()).backward()
        grads.append([x.grad.cpu() for x in xs])
    for a, b in zip(*grads):
        assert _rel_err(b, a) <= 1e-4


def test_scan_kernel_rejects_mixed_dtypes(cuda):
    args = _scan_operands(0, 16, 1, 8, torch.bfloat16, cuda)
    args[1] = args[1].float()
    with pytest.raises(TypeError):
        selective_scan_bidir(*args)


def _nms_planes(seed, n, H, W):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(size=(n, H, W)).astype(np.float32) ** 4
    prob[0, :, : W // 2] = np.linspace(1.0, 0.6, W // 2)[None, :]   # ramps
    prob[-1, H // 2:] = 0.0                                         # sparse
    return torch.from_numpy(prob)


@pytest.mark.parametrize("size,iou,shape", [
    (8, 0.1, (4, 64, 128)), (4, 0.1, (2, 100, 70)), (16, 0.2, (2, 96, 96)),
    (3, 0.5, (3, 33, 65)), (8, 1.0, (1, 32, 32)), (17, 0.1, (2, 80, 72)),
    (24, 0.1, (2, 96, 130)), (32, 0.1, (1, 128, 128)),
    (40, 0.3, (2, 100, 70)), (24, 1.0, (1, 40, 40)),
    (17, 0.3, (1, 45, 77)), (33, 0.1, (2, 96, 100)), (34, 0.1, (1, 100, 130)),
    (34, 0.3, (2, 70, 65)), (48, 0.1, (1, 128, 160)), (48, 0.3, (2, 90, 75)),
    (64, 0.1, (1, 160, 200)), (64, 0.3, (1, 130, 96)),
    (24, 0.1, (2, 20, 27)), (40, 0.3, (1, 64, 20)),
    (2900, 0.1, (1, 16, 2400))])
def test_nms_kernel_equals_plain(cuda, size, iou, shape):
    """Keep masks and sweep counts are exactly the plain version's, for the
    staged instance (size <= 16) and the banded one (larger boxes): halos
    just under and over one tile (17, 33, 34), two tiles each way (40) and
    the largest tables of the tests above (48, 64: 7 levels, 8 rows a
    band), a plane of one partial tile (20 x 27), one narrower than the
    halo (W 20 at a halo of 21 columns, clamped to the plane), and a box so
    wide that a staged row keeps 12 of its 13 table levels (2,372 columns
    each way: a window takes one read every 2,048 columns)."""
    prob = _nms_planes(size, *shape)
    for p, valid in ((prob, prob > 0.015), (prob - 0.5, prob >= 0)):
        ref, ref_sweeps = grid_nms_keep_plain(p, valid, size, iou)
        before = grid_nms_keep.launches
        keep, sweeps = grid_nms_keep(p.to(cuda), valid.to(cuda), size, iou)
        assert grid_nms_keep.launches == before + 1
        assert sweeps == ref_sweeps
        assert torch.equal(keep.cpu(), ref)


def _ramp_plane(H, W, axis):
    """(1, H, W): strictly decreasing along each row (axis -1) or column
    (axis -2), so every box suppresses the next and the fixed point needs
    about two sweeps a box."""
    r = np.linspace(1.0, 0.5, W if axis == -1 else H, dtype=np.float32)
    r = r[None, None, :] if axis == -1 else r[None, :, None]
    return torch.from_numpy(np.broadcast_to(r, (1, H, W)).copy())


def _kernel_against_plain(prob, valid, size, iou):
    ref, ref_sweeps = grid_nms_keep_plain(prob, valid, size, iou)
    before = grid_nms_keep.launches
    keep, sweeps = grid_nms_keep(prob, valid, size, iou)
    assert grid_nms_keep.launches == before + 1
    assert sweeps == ref_sweeps
    assert torch.equal(keep, ref)
    return sweeps


def test_nms_kernel_long_chain(cuda):
    """A ramp along every row of a 512^2 plane at size 8: well over 100
    sweeps, all in one launch, with no cap below H * W."""
    p = _ramp_plane(512, 512, -1).to(cuda)
    assert _kernel_against_plain(p, p > 0, 8, 0.1) >= 100


@pytest.mark.parametrize("size,iou", [(2, 0.1), (24, 0.9)])
@pytest.mark.parametrize("W", [64, 65])
def test_nms_kernel_at_the_sweep_cap(cuda, W, size, iou):
    """A 1 x W row ramp runs into the H * W cap with the last sweep still
    changing pixels: after an odd last sweep (W = 64) the kernel copies its
    mask to the output plane, after an even one not. Size 24 at IoU 0.9
    has the row strip of size 2 at 0.1 (|dx| <= 1) and takes the banded
    instance."""
    p = _ramp_plane(1, W, -1).to(cuda)
    assert _kernel_against_plain(p, p > 0, size, iou) == W


def test_nms_kernel_more_tiles_than_blocks(cuda):
    """The serving shape, 16 planes of 512^2 (4,096 tiles, more than the
    blocks that can be resident at once)."""
    p = _nms_planes(5, 16, 512, 512).to(cuda)
    assert _kernel_against_plain(p, p > 0.015, 8, 0.1) >= 2


@pytest.mark.parametrize("size", [8, 24])
@pytest.mark.parametrize("shape", [(16, 512, 512), (1, 512, 512),
                                   (3, 33, 65)])
def test_nms_kernel_repeat_bit_equal(cuda, shape, size):
    p = _nms_planes(7, *shape).to(cuda)
    first = grid_nms_keep(p, p > 0.015, size, 0.1)
    again = grid_nms_keep(p, p > 0.015, size, 0.1)
    assert torch.equal(first[0], again[0]) and first[1] == again[1]


def test_nms_reads_nothing_back(cuda):
    """box_nms_extract and box_nms on CUDA tensors make no synchronising
    call, and give what they give on the CPU (no ramp: the order of tied
    scores in a top-k may differ between the devices)."""
    rng = np.random.default_rng(9)
    prob = torch.from_numpy(rng.uniform(size=(4, 128, 96)).astype(
        np.float32) ** 4)
    p = prob.to(cuda)
    box_nms_extract(p, 8, 0.015, 0.1, 256)                  # build, warm up
    box_nms(p, 8, 0.015, keep_top_k=100)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kps, scores, mask = box_nms_extract(p, 8, 0.015, 0.1, 256)
        heat = box_nms(p[0], 8, 0.015, keep_top_k=100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = box_nms_extract(prob, 8, 0.015, 0.1, 256)
    for b in range(prob.shape[0]):
        got = {tuple(x) for x, m in zip(kps[b].tolist(), mask[b].tolist())
               if m}
        want = {tuple(x) for x, m in zip(ref[0][b].tolist(),
                                          ref[2][b].tolist()) if m}
        assert got == want
    assert torch.equal(heat.cpu(), box_nms(prob[0], 8, 0.015,
                                           keep_top_k=100))


def test_nms_kernel_takes_large_boxes(cuda):
    """No box size is refused: boxes above 16 take the banded instance, in
    one launch, with the plain version's answer; the serving shape at sizes
    24 and 32, and a ramp at 24 (a long chain)."""
    p = _nms_planes(1, 16, 512, 512).to(cuda)
    for size in (24, 32):
        assert _kernel_against_plain(p, p > 0.015, size, 0.1) >= 2
    ramp = _ramp_plane(128, 256, -1).to(cuda)
    assert _kernel_against_plain(ramp, ramp > 0, 24, 0.1) >= 10


def test_tiny_pipeline_on_card_matches_cpu(cuda):
    """The tiny fp32 model: the card's path (kernels) against the CPU path
    (plain versions) from the same seeded weights."""
    import copy
    from xpoint_tpu_torch.eval import make_pair_pipeline
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint

    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24)
    cfg["descriptor_size"] = 32
    cfg["mixed_precision"] = False
    g = torch.Generator().manual_seed(0)
    imgs = [torch.rand(2, 64, 64, 1, generator=g) for _ in range(2)]
    outs = {}
    for dev in ("cpu", cuda):
        m, _ = build_xpoint(cfg, device=dev)
        outs[str(dev)] = make_pair_pipeline(m, (64, 64), k=64)(
            *(x.to(dev) for x in imgs))
    a, b = outs["cpu"], outs[str(cuda)]
    for s in ("optical", "thermal"):
        torch.testing.assert_close(b[f"prob_{s}"].cpu(), a[f"prob_{s}"],
                                   atol=1e-5, rtol=0)
        assert torch.equal(b[f"mask_{s}"].sum(1).cpu(), a[f"mask_{s}"].sum(1))



def _warp_homographies(seed, n, H, W):
    """n fp32 homographies at (H, W): from the HA sampler (max_angle pi),
    then a rotation 0.05 rad short of 90 degrees about the centre, one whose
    horizon line crosses the canvas, and the identity."""
    rng = np.random.default_rng(seed)
    hs = [sample_homography((H, W), rng=rng, max_angle=np.pi,
                            scaling_amplitude=0.15, patch_ratio=0.9,
                            perspective_amplitude_x=0.15,
                            perspective_amplitude_y=0.15)
          for _ in range(n - 3)]
    cx, cy, th = (W - 1) / 2.0, (H - 1) / 2.0, np.pi / 2 - 0.05
    shift = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]])
    rot = np.array([[np.cos(th), -np.sin(th), 0],
                    [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    horizon = np.linalg.inv(np.array([[1.0, 0, 0], [0, 1.0, 0],
                                      [2.0 / W, 0, -1.0]]))
    hs += [shift @ rot @ np.linalg.inv(shift), horizon, np.eye(3)]
    return torch.from_numpy(np.stack(hs).astype(np.float32))


@pytest.mark.parametrize("padding", ["zeros", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("kind", ["multi", "batch"])
@pytest.mark.parametrize("H,W,C", [(64, 64, 1), (96, 160, 2), (128, 128, 16),
                                   (240, 320, 1), (75, 301, 3), (512, 512, 2)])
def test_warp_kernel_matches_plain(cuda, H, W, C, kind, mode, padding):
    """K4 against the plain gather on the card, same inverse homographies,
    at sizes that are and are not multiples of 32 (the kernel has no tile):
    nearest exactly equal (the coordinates are formed by the same fp32
    operations), bilinear within 1e-5 on [0, 1) images (only the blend's
    FMA contraction differs)."""
    n = 6
    g = torch.Generator().manual_seed(H + C)
    hs = _warp_homographies(C, n, H, W).to(cuda)
    img = torch.rand(2 if kind == "multi" else n, H, W, C,
                     generator=g).to(cuda)
    before = warp_projective.warp_projective.launches
    out = getattr(warp_projective, f"warp_{kind}")(img, hs, mode, padding)
    torch.cuda.synchronize()
    assert warp_projective.warp_projective.launches == before + 1
    ref = getattr(warp, f"warp_image_{kind}")(img, hs, mode, padding)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    if mode == "nearest":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    assert float(out.std()) > 0.01


@pytest.mark.parametrize("padding", ["zeros", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("W", [37, 64, 510, 512])
def test_warp_kernel_row_widths(cuda, W, C, mode, padding):
    """K4's 4-pixel threads over rows that are and are not multiples of 4
    (the vector-store path and the scalar one), H = 45 no multiple of the
    8-row tile, 1, 2 and 3 channels, batch and multi form: bilinear within
    1e-5, nearest exactly equal."""
    H, n = 45, 5
    g = torch.Generator().manual_seed(W + C)
    hs = _warp_homographies(W, n, H, W).to(cuda)
    for kind in ("batch", "multi"):
        img = torch.rand(2 if kind == "multi" else n, H, W, C,
                         generator=g).to(cuda)
        out = getattr(warp_projective, f"warp_{kind}")(img, hs, mode, padding)
        ref = getattr(warp, f"warp_image_{kind}")(img, hs, mode, padding)
        assert out.shape == ref.shape
        if mode == "nearest":
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("C", [1, 2])
def test_warp_kernel_unaligned_source(cuda, C):
    """A source whose first element is not 16-byte aligned takes the scalar
    path of the same kernel: the same values as from an aligned copy."""
    n, H, W = 4, 64, 64
    g = torch.Generator().manual_seed(C)
    hs = _warp_homographies(1, n, H, W).to(cuda)
    flat = torch.rand(n * H * W * C + 1, generator=g).to(cuda)
    img = flat[1:].view(n, H, W, C)
    assert img.data_ptr() % 16 != 0 and img.is_contiguous()
    for mode in ("bilinear", "nearest"):
        out = warp_projective.warp_batch(img, hs, mode, "zeros")
        ref = warp_projective.warp_batch(img.clone(), hs, mode, "zeros")
        assert torch.equal(out, ref)
        torch.testing.assert_close(
            out, warp.warp_image_batch(img, hs, mode, "zeros"),
            atol=1e-5, rtol=0)


def test_warp_kernel_rejects_other_dtypes(cuda):
    img = torch.rand(1, 32, 32, 1, device=cuda).bfloat16()
    with pytest.raises(TypeError):
        warp_projective.warp_multi(img, torch.eye(3, device=cuda)[None])


def _fused_operands(seed, B, L, Dim, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    K = 4
    u, dt = f(B, K, L, Dim) * 0.5, f(B, K, L, Dim) * 0.5
    A = -torch.exp(f(K * Dim) * 0.3)
    bs, cs = f(B, K, L, 1) * 0.5, f(B, K, L, 1) * 0.5
    D, bias = f(K * Dim), f(K * Dim) * 0.2
    return [u.to(device, dtype), dt.to(device, dtype), A.to(device),
            bs.to(device, dtype), cs.to(device, dtype), D.to(device),
            bias.to(device)]


@pytest.mark.parametrize("L,B,Dim", [(300, 2, 96), (100, 2, 192),
                                     (77, 1, 384), (37, 1, 768),
                                     (1024, 8, 96), (50, 3, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_scan_kernel_matches_plain(cuda, L, B, Dim, dtype):
    """K5 over the flagship widths, L no multiple of 256. fp32: only the
    rounding of exp/log1p/fma differs (atol 1e-4); bf16 outputs may round
    to neighbouring values (one ulp: 2^-7 relative, 1e-2 absolute)."""
    args = _fused_operands(5, B, L, Dim, dtype, cuda)
    before = selective_scan_fused_bkld.launches
    y = selective_scan_fused_bkld(*args)
    torch.cuda.synchronize()
    assert selective_scan_fused_bkld.launches == before + 1
    p = selective_scan_fused_bkld_plain(*args)
    assert y.dtype == dtype and y.shape == (B, 4, L, Dim)
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-2, 2 ** -7)
    torch.testing.assert_close(y.float(), p.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("L", [1, 64, 129, 300, 513])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_scan_kernel_tails_and_repeat(cuda, L, dtype):
    """K5 where its blocks have tails (one span of 1 or 64 tokens, a last
    span of 1, 44 or 1 tokens of 64), B = 3, Dim = 40 (a (b, k) group of
    40 d: one full 32-lane block and one of 8): against the plain version
    (tolerances of test_fused_scan_kernel_matches_plain) and a second run
    bit for bit."""
    args = _fused_operands(40 + L, 3, L, 40, dtype, cuda)
    y = selective_scan_fused_bkld(*args)
    again = selective_scan_fused_bkld(*args)
    p = selective_scan_fused_bkld_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    atol, rtol = (1e-4, 0) if dtype == torch.float32 else (1e-2, 2 ** -7)
    torch.testing.assert_close(y.float(), p.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("L,B,Dim", [(16384, 8, 96), (4096, 16, 96),
                                     (1024, 8, 384), (64, 16, 768)])
def test_fused_scan_kernel_repeat_at_path_shapes(cuda, L, B, Dim):
    """Two K5 runs at serving and training stage shapes (bf16) give the
    same bits, and agree with the plain version (2e-2: one bf16 ulp)."""
    args = _fused_operands(41, B, L, Dim, torch.bfloat16, cuda)
    y = selective_scan_fused_bkld(*args)
    assert torch.equal(y, selective_scan_fused_bkld(*args))
    p = selective_scan_fused_bkld_plain(*args)
    assert float((y.float() - p.float()).abs().max()) <= 2e-2


def test_fused_scan_gradients_on_card_match_cpu(cuda):
    """SelectiveScanFusedBkld: K5 forward, then K6 twice in the backward
    (h rebuilt, then the reversed scan), against the plain versions on the
    CPU, fp32: every gradient within 1e-4 of its max."""
    cpu = _fused_operands(6, 2, 300, 24, torch.float32, "cpu")
    grads = []
    for dev in ("cpu", cuda):
        xs = [x.detach().to(dev).requires_grad_() for x in cpu]
        k5, k6 = selective_scan_fused_bkld.launches, linear_scan.launches
        y = selective_scan_fused_bkld(*xs)
        (y * torch.cos(y)).sum().backward()
        if dev != "cpu":
            assert selective_scan_fused_bkld.launches == k5 + 1
            assert linear_scan.launches == k6 + 2
        grads.append([x.grad.cpu() for x in xs])
    for a, b in zip(*grads):
        assert _rel_err(b, a) <= 1e-4


def _recurrence_planes(seed, shape, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.exp(-torch.rand(shape, generator=g) * 1.5)
    b = torch.randn(shape, generator=g)
    return a.to(device, dtype), b.to(device, dtype)


@pytest.mark.parametrize("reverse,shift", [(False, 0), (True, 0), (True, 1),
                                           (False, -1)])
@pytest.mark.parametrize("shape,dim", [
    ((1, 96), 0), ((7, 96), 0), ((255, 192), 0), ((256, 288), 0),
    ((257, 96), 0), ((513, 37), 0), ((1031, 480), 0),
    ((2, 4, 300, 96), 2), ((3, 77, 5), 1), ((2, 3, 19), 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_scan_kernel_matches_plain(cuda, shape, dim, reverse, shift,
                                          dtype):
    """K6 over lane counts that are multiples of 96 and not of 32, L of 1,
    below, at and beyond its span of 256 steps and odd, along the first, a
    middle and the last dim, forward, reversed and with the coefficient
    shifted either way: within 1e-5 of max |plain| (the segments are
    combined in scan order; only the rounding of a segment's product and
    the FMA contraction differ)."""
    a, b = _recurrence_planes(sum(shape) + dim, shape, dtype, cuda)
    before = linear_scan.launches
    h = linear_scan_launch(a, b, reverse=reverse, shift=shift, dim=dim)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    p = linear_scan_plain(a, b, reverse=reverse, shift=shift, dim=dim)
    assert h.dtype == torch.float32 and h.shape == a.shape
    assert _rel_err(h, p) <= 1e-5


def test_linear_scan_kernel_long_decay(cuda):
    """Coefficients whose products underflow to 0 (and exact zeros): finite
    and equal to the plain version within 1e-5 of its max."""
    g = torch.Generator().manual_seed(1)
    a = (torch.rand(4096, 64, generator=g) * 0.2).to(cuda)
    a[:, 0] = 0.0
    b = torch.randn(4096, 64, generator=g).to(cuda)
    h = linear_scan_launch(a, b)
    assert bool(torch.isfinite(h).all())
    assert _rel_err(h, linear_scan_plain(a, b)) <= 1e-5


def test_linear_scan_autograd_on_card_matches_cpu(cuda):
    """LinearScan on the card (K6 forward, K6 reversed) against the CPU's
    plain versions, fp32, along dim 0 and along an inner dim."""
    for shape, dim in (((300, 96), 0), ((2, 4, 130, 24), 2)):
        cpu = _recurrence_planes(3, shape, torch.float32, "cpu")
        grads = []
        for dev in ("cpu", cuda):
            a, b = (x.detach().to(dev).requires_grad_() for x in cpu)
            h = linear_scan(a, b, dim=dim)
            (h * torch.cos(h)).sum().backward()
            grads.append((a.grad.cpu(), b.grad.cpu()))
        for x, y in zip(*grads):
            assert _rel_err(y, x) <= 1e-5


def test_linear_scan_kernel_rejects_mixed_dtypes(cuda):
    a, b = _recurrence_planes(0, (16, 32), torch.float32, cuda)
    with pytest.raises(ValueError):
        linear_scan_launch(a, b.bfloat16())
    with pytest.raises(TypeError):
        linear_scan_launch(a.half(), b.half())


@pytest.mark.parametrize("ftype,d_state", [("v052d_noz", 1), ("v05", 4),
                                           ("v052dc", 2)])
def test_tiny_forward_types_on_card_match_cpu(cuda, ftype, d_state):
    """The tiny fp32 model in a forward type that runs K5 + K6 (v052d_noz),
    the general scan on K6 (gated v05, d_state 4) and cascade2d: logits and
    descriptors (atol 1e-4) and every encoder gradient (1e-3 of the leaf's
    max + 1e-6 of the largest) on the card against the CPU."""
    import copy
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint

    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24, SSM_FORWARDTYPE=ftype,
        SSM_D_STATE=d_state)
    cfg.update(descriptor_size=32, mixed_precision=False)
    img = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    res = []
    for dev in ("cpu", cuda):
        m, _ = build_xpoint(cfg, device=dev)
        before = linear_scan.launches
        out = m(img.to(dev))
        (out["logits"].square().mean() + out["desc"].square().mean()
         ).backward()
        if dev != "cpu":
            assert linear_scan.launches > before
        res.append(({k: out[k].detach().cpu() for k in ("logits", "desc")},
                    {n: p.grad.cpu() for n, p in
                     m.encoder.named_parameters()}))
    (o_cpu, g_cpu), (o_gpu, g_gpu) = res
    for k in o_cpu:
        torch.testing.assert_close(o_gpu[k], o_cpu[k], atol=1e-4, rtol=0)
    top = max(float(g.abs().max()) for g in g_cpu.values())
    for n, g in g_cpu.items():
        tol = 1e-3 * float(g.abs().max()) + 1e-6 * top
        assert float((g_gpu[n] - g).abs().max()) <= tol, n


def test_tiny_ha_on_card_matches_cpu(cuda):
    """The tiny fp32 model's HA: the card's path (K4, K1) against the CPU
    path (plain versions), compared where both hold the same count."""
    import copy
    from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
    from xpoint_tpu_torch.selfsup.export import make_prob_fn
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        make_ha_fn, sample_ha_homographies)

    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24)
    cfg.update(descriptor_size=32, mixed_precision=False)
    g = torch.Generator().manual_seed(0)
    img_o, img_t = (torch.rand(2, 64, 64, 1, generator=g) for _ in range(2))
    outs = []
    for dev in ("cpu", cuda):
        m, _ = build_xpoint(cfg, device=dev)
        run, merged = make_ha_fn(make_prob_fn(m), {"aggregation": "window",
                                                   "num": 4, "min_count": 2})
        hs = torch.from_numpy(sample_ha_homographies(
            merged, (64, 64), np.random.default_rng(1)))
        out = run(img_o.to(dev), img_t.to(dev), hs.to(dev))
        outs.append({k: v.cpu() for k, v in out.items() if v is not None})
    a, b = outs
    same = a["count"] == b["count"]
    assert same.float().mean() > 0.995
    for k in ("prob_optical", "prob_thermal"):
        assert float(a[k].max()) > 0
        torch.testing.assert_close(b[k][same], a[k][same], atol=1e-5, rtol=0)


def test_ha_on_card_launches_the_warp_kernel_at_any_size(cuda):
    """HA's warps go by the device alone: at 48 x 80 (no multiple of 32)
    every step on the card makes its three K4 launches, and the result
    agrees with the CPU's (plain warps) where both hold the same count."""
    from xpoint_tpu_torch.selfsup.homographic_adaptation import (
        make_ha_fn, sample_ha_homographies)

    g = torch.Generator().manual_seed(2)
    k = torch.randn(1, 1, 5, 5, generator=g)

    def prob_fn(img, is_optical):
        x = img.permute(0, 3, 1, 2) - 0.5
        y = torch.nn.functional.conv2d(x, k.to(img.device), padding=2)
        return torch.sigmoid(y if is_optical else -y)[:, 0]

    H, W = 48, 80
    img_o, img_t = (torch.rand(2, H, W, 1, generator=g) for _ in range(2))
    run, merged = make_ha_fn(prob_fn, {"num": 6, "min_count": 2,
                                       "erosion_radius": 2}, warp_batch=2)
    hs = torch.from_numpy(sample_ha_homographies(
        merged, (H, W), np.random.default_rng(3)))
    a = run(img_o, img_t, hs)
    before = warp_projective.warp_projective.launches
    b = run(img_o.to(cuda), img_t.to(cuda), hs.to(cuda))
    assert warp_projective.warp_projective.launches == before + 3 * 3
    same = a["count"] == b["count"].cpu()
    assert same.float().mean() > 0.995
    assert float(a["prob"].max()) > 0
    torch.testing.assert_close(b["prob"].cpu()[same], a["prob"][same],
                               atol=1e-5, rtol=0)
