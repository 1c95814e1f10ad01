"""Sequence-parallel linear recurrence: the scan's time axis L sharded over
the ranks of a mesh (port of ``xpoint_tpu/parallel/ring_scan.py``).

Each rank holds L / n consecutive steps and

  1. runs the local scan of its block (``ops.linear_scan``: the Hopper
     kernel ``csrc/linear_scan.cu`` on the card, the plain loop on the
     CPU),
  2. exchanges its summary (prod a, last h) with the others (one
     ``all_gather`` of the (n, ...) summaries, an all-reduce),
  3. folds the summaries of the ranks before it with the scan's combine law
     ((A1, B1) o (A2, B2) = (A1 A2, A2 B1 + B2)) into its incoming state
     and rescans its block with that state folded into b_0
     (h_0 = a_0 h_in + b_0).

Gradients flow through ``LinearScan`` and the exchange (its all-reduce sums
the cotangents of every rank). L must divide by the number of ranks.
"""
import contextlib

import torch

from ..ops.linear_scan import linear_scan
from .mesh import all_gather

_RING_MESH = None


@contextlib.contextmanager
def ring_mesh(mesh):
    """Select the mesh whose ranks the ``'ring'`` scan backend shards the
    sequence over, for the block."""
    global _RING_MESH
    prev = _RING_MESH
    _RING_MESH = mesh
    try:
        yield
    finally:
        _RING_MESH = prev


def get_ring_mesh():
    if _RING_MESH is None:
        raise RuntimeError(
            "scan_backend='ring' needs an active mesh: run the model inside "
            "xpoint_tpu_torch.parallel.ring_mesh(mesh)")
    return _RING_MESH


def _incoming_state(a_last, h_last, mesh):
    """The state entering this rank's block: the exclusive prefix of the
    ranks' (prod a, last h) summaries under the combine law, zero on rank
    0. Every rank folds every summary, keeping the ones before it, so
    that the autograd graph, and with it the order of the collectives in
    the backward, is the same on every rank."""
    A_all = all_gather(a_last, mesh)
    B_all = all_gather(h_last, mesh)
    h_in = torch.zeros_like(h_last)
    for r in range(mesh.size):
        before = torch.full((), r < mesh.rank, device=h_in.device)
        h_in = torch.where(before, A_all[r] * h_in + B_all[r], h_in)
    return h_in


def _seeded_scan(a, b, dim, mesh):
    """The recurrence along ``dim`` of this rank's block of the sequence,
    started from the state the ranks before it hand on."""
    h = linear_scan(a, b, dim=dim)
    a, b = a.to(h.dtype), b.to(h.dtype)          # fp32 (fp64 stays fp64)
    h_in = _incoming_state(torch.prod(a, dim=dim), h.select(dim, -1), mesh)
    first = b.narrow(dim, 0, 1) + a.narrow(dim, 0, 1) * h_in.unsqueeze(dim)
    b_seeded = torch.cat([first, b.narrow(dim, 1, b.shape[dim] - 1)],
                         dim=dim)
    return linear_scan(a, b_seeded, dim=dim)


def _split(x, dim, mesh):
    """This rank's block of the sequence axis ``dim`` (L % size == 0, as
    the JAX ring asserts)."""
    L = x.shape[dim]
    if L % mesh.size:
        raise ValueError(f"L={L} not divisible by the mesh size {mesh.size}")
    n = L // mesh.size
    return x.narrow(dim, mesh.rank * n, n)


def _join(x, dim, mesh):
    """The whole sequence from every rank's block along ``dim``."""
    g = all_gather(x, mesh)                      # (n, ..., L/n, ...)
    return g.movedim(0, dim).flatten(dim, dim + 1)


def ring_linear_scan(a, b, mesh):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 0 of (L, M) arrays,
    with L sharded over ``mesh``: every rank passes the same a and b, scans
    its block of L / size steps and the blocks are gathered, so every rank
    returns the whole h (fp32), as the JAX function returns one global
    array. Gradients follow the train step's convention: the mean over the
    ranks of each rank's gradient is the gradient."""
    h = _seeded_scan(_split(a, 0, mesh).contiguous(),
                     _split(b, 0, mesh).contiguous(), 0, mesh)
    return _join(h, 0, mesh)


def ring_selective_scan(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                        delta_softplus=True, mesh=None):
    """Sequence-parallel selective scan, the arguments and result of
    ``ops.selective_scan`` (u, delta (B, K*C, L); Bmat, Cmat (B, K, N,
    L)), every rank passing the same tensors: each scans its block of L
    on (B, K*C, L / size, N) fp32 planes through ``linear_scan``, the state
    crosses the rank boundaries by ``ring_linear_scan``'s exchange, and the
    blocks of y are gathered (fp32, whole L on every rank). ``mesh``
    defaults to the one of ``ring_mesh``."""
    from ..ops.selective_scan import _finalize, _prepare

    mesh = mesh or get_ring_mesh()
    u32, dt, A32, Bg, Cg = _prepare(u, delta, A, Bmat, Cmat, delta_bias,
                                    delta_softplus)
    KC = u32.shape[1]
    K = Bg.shape[1]
    u_l, dt_l = _split(u32, 2, mesh), _split(dt, 2, mesh)
    Bx = _split(Bg, 3, mesh).repeat_interleave(KC // K, dim=1)
    Cx = _split(Cg, 3, mesh).repeat_interleave(KC // K, dim=1)
    a = torch.exp(dt_l[..., None] * A32[None, :, None, :])  # (B, KC, l, N)
    b = (dt_l * u_l)[..., None] * Bx.transpose(2, 3)
    h = _seeded_scan(a.contiguous(), b.contiguous(), 2, mesh)
    y = _join((h * Cx.transpose(2, 3)).sum(-1), 2, mesh)
    return _finalize(y, u32, D)
