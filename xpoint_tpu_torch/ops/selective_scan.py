"""Selective scan (Mamba S6 recurrence) in the reference argument layout,
any state size N (port of ``xpoint_tpu/ops/selective_scan.py`` and of
``selective_scan_pallas.py::selective_scan_pallas`` /
``_selective_scan_unfused`` / ``selective_scan_fused``):

    delta = softplus(delta + delta_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + delta_t * B_t * u_t      (fp32 state)
    y_t   = <C_t, h_t> + D * u_t

    u, delta: (B, K*C, L);  A: (K*C, N);  Bmat, Cmat: (B, K, N, L)
    D, delta_bias: (K*C,) or None.  Returns y: (B, K*C, L) in float32.

:func:`selective_scan` dispatches as the JAX ``'pallas'`` backend does: N = 1
with softplus goes to the fused single-direction kernel
(``selective_scan_fused_bkld``), everything else to the composition around
the linear-recurrence kernel (``linear_scan``) with M = B*K*C*N lanes. JAX's
``'assoc'`` is XLA's route to the same function and has no counterpart;
``backend="ring"`` is the sequence-parallel scan
(``parallel.ring_scan.ring_selective_scan``: L sharded over the ranks of
the mesh selected with ``parallel.ring_mesh``).
:func:`selective_scan_ref` is the step-by-step oracle.
"""
import torch
import torch.nn.functional as F

from .linear_scan import _compute_dtype, linear_scan
from .selective_scan_cuda import selective_scan_fused_bkld


def _prepare(u, delta, A, Bmat, Cmat, delta_bias, delta_softplus):
    """Common input prep in fp32 (fp64): (u, dt, A, B, C), with dt biased
    and softplus'd and B/C still per group, (B, K, N, L)."""
    cd = _compute_dtype(u.dtype)
    dt = delta.to(cd)
    if delta_bias is not None:
        dt = dt + delta_bias.to(cd)[None, :, None]
    if delta_softplus:
        dt = F.softplus(dt)
    return u.to(cd), dt, A.to(cd), Bmat.to(cd), Cmat.to(cd)


def _finalize(y, u, D):
    if D is not None:
        y = y + u * D.to(u.dtype)[None, :, None]
    return y


def selective_scan_ref(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                       delta_softplus=True):
    """Sequential oracle: reference semantics, step by step over L."""
    u, dt, A, Bg, Cg = _prepare(u, delta, A, Bmat, Cmat, delta_bias,
                                delta_softplus)
    Batch, KC, L = u.shape
    K, N = Bg.shape[1], A.shape[1]
    Cdim = KC // K
    Bx = Bg.repeat_interleave(Cdim, dim=1)                  # (B, KC, N, L)
    Cx = Cg.repeat_interleave(Cdim, dim=1)
    h = torch.zeros(Batch, KC, N, dtype=u.dtype, device=u.device)
    ys = []
    for t in range(L):
        a_t = torch.exp(dt[:, :, t, None] * A)
        h = a_t * h + (dt[:, :, t] * u[:, :, t])[..., None] * Bx[..., t]
        ys.append((h * Cx[..., t]).sum(-1))
    return _finalize(torch.stack(ys, dim=-1), u, D)


def _selective_scan_unfused(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                            delta_softplus=True):
    """The composition around :func:`linear_scan`, differentiable. The
    (L, B, K, C, N) planes a and b are formed time-major by broadcasting
    from the small operands, so the scan's M = B*K*C*N lanes lie contiguous
    per step and no (B, K*C, N, L) plane is transposed."""
    u, dt, A, Bg, Cg = _prepare(u, delta, A, Bmat, Cmat, delta_bias,
                                delta_softplus)
    Batch, KC, L = u.shape
    K, N = Bg.shape[1], A.shape[1]
    Cdim = KC // K
    tm = lambda x: x.permute(2, 0, 1).reshape(L, Batch, K, Cdim, 1)  # noqa
    dt_l, dtu_l = tm(dt), tm(dt * u)
    Bl = Bg.permute(3, 0, 1, 2).reshape(L, Batch, K, 1, N)
    Cl = Cg.permute(3, 0, 1, 2).reshape(L, Batch, K, 1, N)
    a = torch.exp(dt_l * A.reshape(K, Cdim, N))             # (L, B, K, C, N)
    b = dtu_l * Bl
    h = linear_scan(a, b, dim=0)
    y = (h * Cl).sum(-1).reshape(L, Batch, KC).permute(1, 2, 0)
    return _finalize(y, u, D)


def selective_scan_fused(u, delta, A, Bmat, Cmat, D=None, delta_bias=None):
    """N = 1 with softplus through the fused single-direction kernel, fed
    from the reference layout: (B, K*C, L) -> (B, K, L, C) and back. Its
    gradient is the kernel's own (the unfused composition around
    ``linear_scan``). fp32 output."""
    Batch, K, N, L = Bmat.shape
    KC = u.shape[1]
    if N != 1:
        raise ValueError(f"selective_scan_fused needs N = 1, got {N}")
    dtypes = {x.dtype for x in (u, delta, Bmat, Cmat)}
    dtype = dtypes.pop() if len(dtypes) == 1 else _compute_dtype(u.dtype)
    const = _compute_dtype(dtype)
    bkld = lambda x: x.to(dtype).reshape(  # noqa: E731
        Batch, K, KC // K, L).transpose(2, 3).contiguous()
    zeros = torch.zeros(KC, dtype=const, device=u.device)
    y = selective_scan_fused_bkld(
        bkld(u), bkld(delta), A[:, 0].to(const),
        Bmat.to(dtype).reshape(Batch, K, L, 1),
        Cmat.to(dtype).reshape(Batch, K, L, 1),
        zeros if D is None else D.to(const),
        zeros if delta_bias is None else delta_bias.to(const))
    return y.transpose(2, 3).reshape(Batch, KC, L).to(const)


def selective_scan(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                   delta_softplus=True, backend=None):
    """Dispatching entry point (see the module docstring). ``backend``:
    None, or ``"ring"`` for the sequence-parallel scan."""
    if backend == "ring":
        from ..parallel.ring_scan import ring_selective_scan
        return ring_selective_scan(u, delta, A, Bmat, Cmat, D, delta_bias,
                                   delta_softplus)
    if backend is not None:
        raise ValueError(f"unknown selective_scan backend {backend!r}")
    if Bmat.shape[2] == 1 and delta_softplus:
        return selective_scan_fused(u, delta, A, Bmat, Cmat, D, delta_bias)
    return _selective_scan_unfused(u, delta, A, Bmat, Cmat, D, delta_bias,
                                   delta_softplus)


def flops_selective_scan(B=1, L=256, D=768, N=16, with_D=True):
    """FLOP accounting identical to the reference (csms6s.py:139-160)."""
    flops = 9 * B * L * D * N
    if with_D:
        flops += B * D * L
    return flops
