"""The work of a computation on the card: floating-point operations, bytes
and transcendental operations, for ``eval.benchmark.model_cost`` and the
roofline tool.

A torch FLOP counter sees the operators a program issues, not the work
inside the hand-written kernels, which it reaches only through ctypes. So
each kernel's work is counted from its shapes, by the functions below:
the bytes it must move (each input read once, each output written once)
and the operations it does, as ``chip_smoke.py`` counts them for the
kernels' bounds (PERF.md section 6). Each kernel wrapper records its call
with :func:`record` and issues its work under :func:`uncounted`, on the
card's route and on the plain version's alike, so a count is the same
whichever route runs; the plain scan's step-by-step arithmetic is never
counted as the kernel's work.

The rest is counted operator by operator under :func:`count`:
``torch.utils.flop_counter.FlopCounterMode`` gives the FLOPs (the
products: matmuls, convolutions, attention), split here by the operands'
dtype; the bytes of an operator are its tensor operands and results
(views move none); its transcendental operations are one per output
element of exp, log, tanh, sigmoid, erf and their kin (two for softplus).

The card's peaks the bounds divide by (NVIDIA H100 SXM5 80 GB data sheet;
NVIDIA H100 80GB HBM3 at 700 W): HBM 3.35e12 B/s, fp32 outside the tensor
cores 67e12 FLOP/s, dense bf16 on the tensor cores 989e12 FLOP/s.
"""
import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

_ACTIVE = []        # the counters of the running count() blocks


def _work(nbytes, flops, transcendentals=0):
    return {"bytes": int(nbytes), "flops": int(flops),
            "transcendentals": int(transcendentals)}


# ---- each kernel's work from its shapes ------------------------------------
#
# L is the scanned length, M = B * K * Dim the lanes, G = B * K the groups
# that share B and C, Dim the channels.

def scan_bidir(L, M, G, Dim, emit_ckpt=False):
    """K1 (``csrc/selective_scan_bidir.cu``): u, dt_f, dt_r in and y_f,
    y_r out (bf16 planes of L x M), the compact B and C of both directions
    (L x G each); serving reads A, D, delta_bias (three fp32 (4 Dim,)
    vectors, as the serving bound counts them), training writes the fp32
    chunk entry states of both directions (256-token chunks). 14 fp32
    operations a lane a step a direction; softplus (two) and exp(delta A)
    (one) a lane a step a direction."""
    if emit_ckpt:
        nbytes = 2 * (5 * L * M + 4 * L * G) + 4 * 2 * -(-L // 256) * M
    else:
        nbytes = 2 * (5 * L * M + 4 * L * G) + 3 * 4 * 4 * Dim
    return _work(nbytes, 2 * 14 * L * M, 2 * 3 * L * M)


def scan_bidir_bwd(L, M, G):
    """K3 (``csrc/selective_scan_bidir_bwd.cu``): u, dt_f, dt_r, g_f, g_r,
    the compact B and C and the checkpoints in, du, ddt_f, ddt_r and the
    compact dB and dC out; 40 operations a lane a step a direction, and
    the forward's three transcendentals rebuilt."""
    nbytes = 2 * (8 * L * M + 8 * L * G) + 4 * 2 * -(-L // 256) * M
    return _work(nbytes, 2 * 40 * L * M, 2 * 3 * L * M)


def scan_fused(L, M, G, Dim):
    """K5 (``csrc/selective_scan_fused.cu``): one direction, u and dt in,
    y out (L x M), Bs and Cs (L x G), three fp32 (4 Dim,) vectors; 14
    operations and three transcendentals a lane a step."""
    nbytes = 2 * (3 * L * M + 2 * L * G) + 3 * 4 * 4 * Dim
    return _work(nbytes, 14 * L * M, 3 * L * M)


def linear_scan(L, M):
    """K6 (``csrc/linear_scan.cu``): fp32 a and b in, h out (L x M); one
    multiply-add a lane a step."""
    return _work(12 * L * M, 2 * L * M)


def nms_compares(size, iou):
    """K2's comparisons a pixel a sweep: the running maxima over |dx| <=
    the widest overlap, the combine over the rows with a strip, the test
    against p."""
    from ..ops.nms import overlap_widths
    widths = overlap_widths(size, iou)
    return 2 * max(widths) + 2 * sum(w >= 0 for w in widths) - 1


def nms(n_px, sweeps, size, iou):
    """K2 (``csrc/nms_sweep.cu``) on n_px pixels: fp32 p and the valid mask
    in, the keep mask out; ``sweeps`` Jacobi sweeps (the data's: the sweep
    count this call took)."""
    return _work(n_px * (4 + 1 + 1), sweeps * n_px * nms_compares(size, iou))


def warp(n_src, n_out, n, H_out, W_out):
    """K4 (``csrc/warp_projective.cu``): fp32 source and output elements,
    n inverse homographies; 8 operations an output element (the bilinear
    blend) and 30 an output pixel a homography (its source coordinates)."""
    return _work(4 * (n_src + n_out + 9 * n), n_out * 8 + n * H_out * W_out
                 * 30)


def bound_ms(work, flop_per_s=FP32_FLOP_PER_S):
    """(ms, 'bytes' or 'operations'): the least time for ``work`` at the
    card's memory rate or at ``flop_per_s``, whichever is longer."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = work["flops"] / flop_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---- recording -------------------------------------------------------------

def counting():
    """True inside a :func:`count` block."""
    return bool(_ACTIVE)


def record(name, work):
    """A kernel wrapper's call with its ``work`` (the dicts above), added
    to the running count, if any."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(name, work)


def uncounted():
    """Around a kernel wrapper's work: inside a :func:`count` block the
    operators it issues are not counted (its work is :func:`record`'s)."""
    if not _ACTIVE:
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()


_TRANSCENDENTAL = {"exp": 1, "exp2": 1, "expm1": 1, "log": 1, "log2": 1,
                   "log10": 1, "log1p": 1, "tanh": 1, "sigmoid": 1,
                   "erf": 1, "gelu": 1, "silu": 1, "softplus": 2,
                   "rsqrt": 1, "sqrt": 1, "sin": 1, "cos": 1,
                   "_softmax": 1, "_log_softmax": 2, "reciprocal": 1}
# no data moves: allocation and metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "detach", "lift_fresh"}


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class Counter:
    """What one :func:`count` block counted."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self.flop_mode = FlopCounterMode(display=False)
        self.flops_by_dtype = defaultdict(int)
        self.bytes = 0
        self.transcendentals = 0
        self.kernels = {}

    def add_kernel(self, name, work):
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0,
                                           "flops": 0, "transcendentals": 0})
        k["launches"] += 1
        for key in ("bytes", "flops", "transcendentals"):
            k[key] += work[key]

    def kernel_total(self, key):
        return sum(k[key] for k in self.kernels.values())

    @property
    def op_flops(self):
        return sum(self.flops_by_dtype.values())

    def result(self):
        """``{"flops", "bytes_accessed", "cost_analysis", "kernels"}``:
        totals, the parts by source as numbers (the JAX function's
        ``cost_analysis`` is XLA's numbers), and each kernel's launches
        and work."""
        kflops = self.kernel_total("flops")
        kbytes = self.kernel_total("bytes")
        ktrans = self.kernel_total("transcendentals")
        analysis = {
            "flops": self.op_flops + kflops,
            "bytes accessed": self.bytes + kbytes,
            "transcendentals": self.transcendentals + ktrans,
            "operator flops": self.op_flops,
            "operator bf16 flops": self.flops_by_dtype.get(torch.bfloat16,
                                                           0),
            "operator bytes accessed": self.bytes,
            "operator transcendentals": self.transcendentals,
            "kernel flops": kflops,
            "kernel bytes accessed": kbytes,
            "kernel transcendentals": ktrans,
            "kernel launches": self.kernel_total("launches"),
        }
        return {"flops": analysis["flops"],
                "bytes_accessed": analysis["bytes accessed"],
                "cost_analysis": analysis,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


class _OperatorMode(TorchDispatchMode):
    """Bytes and transcendentals of every operator, and its FLOPs (read
    from the FlopCounterMode outside this mode) by the operands' dtype."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.counter
        before = c.flop_mode.get_total_flops()
        out = func(*args, **kwargs)
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        flops = c.flop_mode.get_total_flops() - before
        if flops:
            c.flops_by_dtype[ins[0].dtype if ins else None] += flops
        name = func.overloadpacket.__name__.rstrip("_")
        if getattr(func, "is_view", False) or name in _NO_TRAFFIC:
            return out
        outs = _tensors(out)
        c.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if name in _TRANSCENDENTAL:
            c.transcendentals += _TRANSCENDENTAL[name] * sum(
                t.numel() for t in outs)
        return out


@contextlib.contextmanager
def count():
    """Count everything the block runs: ``with count() as c: ...``, then
    ``c.result()``. The kernels' work is counted from their shapes
    (:func:`record`), the rest operator by operator."""
    counter = Counter()
    _ACTIVE.append(counter)
    try:
        with counter.flop_mode, _OperatorMode(counter):
            yield counter
    finally:
        _ACTIVE.remove(counter)
