"""The first-order linear recurrence h_t = a_t h_{t-1} + b_t under the
selective scan, and its gradient (port of ``xpoint_tpu/ops/
selective_scan_pallas.py::_scan_lm`` and the ``linear_scan`` custom VJP).

Operands are contiguous tensors of one shape, scanned along ``dim``, every
other index a lane of its own; with ``dim=0`` on (L, M) planes this is the
JAX function. ``dim`` lets SS2D's (B, K, L, Dim) planes be scanned where
they lie, without the relayout to (L, M) the TPU kernel needs.

On a CUDA tensor :func:`linear_scan_launch` launches the Hopper kernel
``csrc/linear_scan.cu`` (replacing the TPU kernel ``_scan_kernel``; counted
in ``linear_scan.launches``); on a CPU tensor it runs
:func:`linear_scan_plain`, the sequential loop. ``reverse`` walks right to
left and ``shift`` offsets the coefficient's index, so the backward's
``dh_t = g_t + a_{t+1} dh_{t+1}`` needs no flipped or shifted plane.
"""
import ctypes
import math

import torch

from ..kernels import build, cost

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' codes


def _compute_dtype(dtype):
    """fp64 operands (gradcheck, on the CPU) keep fp64; all else is fp32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def linear_scan_plain(a, b, reverse=False, shift=0, dim=0):
    """Plain PyTorch version: the sequential recurrence along ``dim`` in
    fp32 (fp64 for fp64 operands), from a zero state.

    forward: h[t] = c(t) h[t-1] + b[t]; reverse: h[t] = c(t) h[t+1] + b[t],
    walked from the right; c(t) = a[t + shift], 1 outside [0, L)."""
    cd = _compute_dtype(a.dtype)
    L = a.shape[dim]
    h = torch.empty(a.shape, dtype=cd, device=a.device)
    a_t, b_t, h_t = (x.movedim(dim, 0) for x in (a, b, h))
    carry = torch.zeros(h_t.shape[1:], dtype=cd, device=a.device)
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        tc = t + shift
        if 0 <= tc < L:
            carry = torch.addcmul(b_t[t].to(cd), a_t[tc].to(cd), carry)
        else:
            carry = carry + b_t[t].to(cd)
        h_t[t] = carry
    return h


def _check_operands(a, b, dim):
    if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"a and b must share shape, dtype and device, got "
                         f"{tuple(a.shape)} {a.dtype} {a.device} and "
                         f"{tuple(b.shape)} {b.dtype} {b.device}")
    if not -a.ndim <= dim < a.ndim or a.numel() == 0:
        raise ValueError(f"cannot scan dim {dim} of shape {tuple(a.shape)}")
    fp64 = a.dtype == torch.float64 and a.device.type == "cpu"
    if not (a.dtype in _DTYPE_CODE or fp64):
        raise TypeError(f"a and b must be float32 or bfloat16 (float64 on "
                        f"the CPU), got {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linear_scan: unsupported device {a.device}")


def _library():
    """The kernel's library with its entry point typed once."""
    lib = build.load("linear_scan")
    fn = lib.xp_linear_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def _launch(a, b, reverse, shift, dim):
    lib = _library()
    dim %= a.ndim
    L, D = a.shape[dim], math.prod(a.shape[dim + 1:])
    M = math.prod(a.shape[:dim]) * D
    if M >= 2 ** 31:
        raise ValueError(f"linear_scan: {M} lanes exceed the kernel's int")
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    err = lib.xp_linear_scan(
        _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(), h.data_ptr(), L, D,
        M, int(bool(reverse)), int(shift),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "linear_scan launch")
    linear_scan.launches += 1
    return h


def linear_scan_launch(a, b, reverse=False, shift=0, dim=0):
    """The recurrence of :func:`linear_scan_plain`, no gradient: CUDA
    tensors launch the kernel, CPU tensors run the plain version. Returns
    fp32 (fp64 for fp64 operands) of the operands' shape."""
    _check_operands(a, b, dim)
    if cost.counting():
        L = a.shape[dim]
        cost.record("linear_scan", cost.linear_scan(L, a.numel() // L))
    with cost.uncounted():
        if a.device.type == "cpu":
            return linear_scan_plain(a, b, reverse, shift, dim)
        return _launch(a, b, reverse, shift, dim)


class LinearScan(torch.autograd.Function):
    """Differentiable recurrence (the JAX custom VJP): the forward saves
    (a, h); the backward runs the same kernel reversed with the coefficient
    shifted, dh_t = g_t + a_{t+1} dh_{t+1}, and returns (dh * h_{t-1}, dh)."""

    @staticmethod
    def forward(ctx, a, b, dim):
        h = linear_scan_launch(a, b, dim=dim)
        ctx.save_for_backward(a, h)
        ctx.dim = dim
        return h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        dim, L = ctx.dim, a.shape[ctx.dim]
        a_c, g = a, g.contiguous()
        if g.dtype != a.dtype:       # bf16 operands: the cotangent is fp32
            a_c, g = a.to(h.dtype), g.to(h.dtype)
        dh = linear_scan_launch(a_c, g, reverse=True, shift=1, dim=dim)
        # da_t = dh_t h_{t-1}, h_{-1} = 0: a slice of h, not a shifted copy
        da = torch.zeros_like(dh)
        if L > 1:
            torch.mul(dh.narrow(dim, 1, L - 1), h.narrow(dim, 0, L - 1),
                      out=da.narrow(dim, 1, L - 1))
        return da.to(a.dtype), dh.to(a.dtype), None


def linear_scan(a, b, dim=0):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along ``dim``, differentiable
    in a and b. a, b: one shape, float32 or bfloat16 (float64 on the CPU);
    returns fp32 (fp64). CUDA tensors launch ``csrc/linear_scan.cu`` forward
    and, reversed, in the backward (each launch counted in
    ``linear_scan.launches``); CPU tensors run the plain version."""
    return LinearScan.apply(a.contiguous(), b.contiguous(), dim)


linear_scan.launches = 0
