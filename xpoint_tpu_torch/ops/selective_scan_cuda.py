"""N=1 selective scans: the bidirectional scan in token layout, forward and
backward (port of ``xpoint_tpu/ops/selective_scan_pallas.py::
selective_scan_fused_bidir_tok`` and its custom VJP), and the
single-direction fused scan in (B, K, L, Dim) layout with its backward
through the linear recurrence (``selective_scan_fused_bkld``, at the end of
this module).

On a CUDA tensor :func:`selective_scan_bidir` launches the Hopper kernel
``csrc/selective_scan_bidir.cu`` (replacing the TPU kernel
``_fused_bidir_kernel``) and :func:`selective_scan_bidir_bwd` launches
``csrc/selective_scan_bidir_bwd.cu`` (replacing ``_fused_bidir_bwd_kernel``);
on a CPU tensor each runs its plain version, a sequential loop over L in
fp32 (fp64 for fp64 operands, so that ``gradcheck`` can hold
:class:`SelectiveScanBidir`).

Operands (lane m = (b * 2 + j) * Dim + d of an (L, M) plane, M = B*2*Dim):
  u_t (L, B, 2, Dim) token-major input, shared by both directions;
  dt_t (2, L, B, 2, Dim) raw dt for forward (r=0) and reversed (r=1) lanes;
  bc_t, cc_t (2, L, B, 2) compact N=1 B/C scalars, one per (b, j) group;
  A, D, delta_bias (4*Dim,) ordered k = 2r + j:
    [r0 j0 | r0 j1 | r1 j0 | r1 j1].
The forward returns (y_f, y_r), each (L, B, 2, Dim) in the dtype of dt_t, in
base token order (the reversed lanes are scanned right to left, never
flipped). With ``emit_ckpt`` it also returns the checkpoints (hck_f, hck_r),
fp32 (ceil(L / 256), M): each lane's entry state of every 256-token chunk,
from the left on forward lanes and from the right on reversed lanes (the
JAX kernel's (nl, 8, Mp) blocks hold the same values in row 0).
"""
import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build, cost
from .linear_scan import _DTYPE_CODE, _compute_dtype, linear_scan

CKPT_CHUNK = 256


def _softplus(x):
    """log(1 + e^x) in the overflow-free form jax.nn.softplus uses."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _lane_set(r, u_t, dt_t, bc_t, cc_t, A, D, delta_bias):
    """The (L, M) planes of lane set r in the compute dtype: x = dt + bias,
    delta, a, the expanded B and C, and the lane constants A and D."""
    L, B, K2, Dim = u_t.shape
    M, G, HD = B * K2 * Dim, B * K2, K2 * Dim
    cd = _compute_dtype(u_t.dtype)
    lane = lambda v: v[r * HD:(r + 1) * HD].to(cd).repeat(B)  # noqa: E731
    expand = lambda v: (  # noqa: E731
        v[r].reshape(L, G).to(cd).repeat_interleave(Dim, dim=1))
    x = dt_t[r].reshape(L, M).to(cd) + lane(delta_bias)
    delta = _softplus(x)
    A_l = lane(A)
    return x, delta, torch.exp(delta * A_l), expand(bc_t), expand(cc_t), \
        A_l, lane(D)


def _scan_order(r, t0, t1):
    return range(t0, t1) if r == 0 else range(t1 - 1, t0 - 1, -1)


def selective_scan_bidir_plain(u_t, dt_t, bc_t, cc_t, A, D, delta_bias,
                               emit_ckpt=False):
    """Plain PyTorch version: fp32 sequential recurrence over L."""
    L, B, K2, Dim = u_t.shape
    M = B * K2 * Dim
    n_chunks = -(-L // CKPT_CHUNK)
    cd = _compute_dtype(u_t.dtype)
    u = u_t.reshape(L, M).to(cd)
    outs, ckpts = [], []
    for r in (0, 1):
        _, delta, a, bcx, ccx, _, D_l = _lane_set(r, u_t, dt_t, bc_t, cc_t,
                                                  A, D, delta_bias)
        b = delta * u * bcx
        h = torch.empty_like(b)
        hck = torch.zeros(n_chunks, M, dtype=cd, device=u.device)
        carry = torch.zeros(M, dtype=cd, device=u.device)
        for t in _scan_order(r, 0, L):
            if r == 0 and t % CKPT_CHUNK == 0:
                hck[t // CKPT_CHUNK] = carry
            elif r == 1 and (t == L - 1 or (t + 1) % CKPT_CHUNK == 0):
                hck[t // CKPT_CHUNK] = carry
            carry = torch.addcmul(b[t], a[t], carry)
            h[t] = carry
        outs.append((ccx * h + D_l * u).to(dt_t.dtype).reshape(L, B, K2, Dim))
        ckpts.append(hck)
    if emit_ckpt:
        return outs[0], outs[1], ckpts[0], ckpts[1]
    return outs[0], outs[1]


def _segment_steps(L, segments):
    """Steps per segment as K1 and K5 choose them: 16, fewer for a scan of
    one short span."""
    return 4 if L <= 4 * segments else 8 if L <= 8 * segments else 16


def selective_scan_bidir_chunked(u_t, dt_t, bc_t, cc_t, A, D, delta_bias,
                                 steps=None, segments=8):
    """The function of :func:`selective_scan_bidir_plain` with checkpoints,
    computed in the order of ``csrc/selective_scan_bidir.cu``: L is cut into
    spans of ``segments`` segments of ``steps`` steps (128 tokens, two to a
    checkpoint chunk, as the kernel has them); every segment is composed
    from a zero entry to its (product of a, h) summary, the segment
    summaries fold to span summaries, a carry over the spans in scan order
    gives every span's entry state (those through which a chunk is entered
    are the checkpoints), and every segment is replayed from (span entry
    folded with the segments before it). Padded steps are the inert (1, 0).
    For the tests: it shows on the CPU that this order computes the
    sequential recurrence."""
    L, B, K2, Dim = u_t.shape
    M = B * K2 * Dim
    steps = _segment_steps(L, segments) if steps is None else steps
    span = steps * segments
    if CKPT_CHUNK % span and L > span:
        raise ValueError(f"spans of {segments} segments of {steps} steps do "
                         f"not tile a {CKPT_CHUNK}-token chunk and L={L} "
                         f"needs several")
    ns = -(-L // span)
    n_chunks = -(-L // CKPT_CHUNK)
    per_chunk = max(CKPT_CHUNK // span, 1)
    cd = _compute_dtype(u_t.dtype)
    dev = u_t.device
    u = u_t.reshape(L, M).to(cd)
    outs, ckpts = [], []
    for r in (0, 1):
        _, delta, a, bcx, ccx, _, D_l = _lane_set(r, u_t, dt_t, bc_t, cc_t,
                                                  A, D, delta_bias)
        # pad in token order (the spans lie at token positions), then turn
        # the reversed lanes into scan order
        a = F.pad(a, (0, 0, 0, ns * span - L), value=1.0)
        b = F.pad(delta * u * bcx, (0, 0, 0, ns * span - L))
        if r == 1:
            a, b = a.flip(0), b.flip(0)
        a = a.reshape(ns, segments, steps, M)
        b = b.reshape(ns, segments, steps, M)
        seg_a = torch.ones(ns, segments, M, dtype=cd, device=dev)
        seg_h = torch.zeros(ns, segments, M, dtype=cd, device=dev)
        for i in range(steps):
            seg_h = a[:, :, i] * seg_h + b[:, :, i]
            seg_a = seg_a * a[:, :, i]
        span_a = torch.ones(ns, M, dtype=cd, device=dev)
        span_h = torch.zeros(ns, M, dtype=cd, device=dev)
        for j in range(segments):
            span_h = seg_a[:, j] * span_h + seg_h[:, j]
            span_a = span_a * seg_a[:, j]
        entry = torch.zeros(ns, M, dtype=cd, device=dev)
        for s in range(1, ns):
            entry[s] = span_a[s - 1] * entry[s - 1] + span_h[s - 1]
        seg_in = torch.empty(ns, segments, M, dtype=cd, device=dev)
        x = entry
        for j in range(segments):
            seg_in[:, j] = x
            x = seg_a[:, j] * x + seg_h[:, j]
        h = torch.empty(ns, segments, steps, M, dtype=cd, device=dev)
        x = seg_in
        for i in range(steps):
            x = a[:, :, i] * x + b[:, :, i]
            h[:, :, i] = x
        h = h.reshape(ns * span, M)
        if r == 1:                       # back to token order
            h, entry = h.flip(0), entry.flip(0)
        # the span a chunk is entered through: its first from the left, its
        # last (or the scan's last) from the right
        through = [min(c * per_chunk + (per_chunk - 1) * r, ns - 1)
                   for c in range(n_chunks)]
        outs.append((ccx * h[:L] + D_l * u).to(dt_t.dtype)
                    .reshape(L, B, K2, Dim))
        ckpts.append(entry[through])
    return outs[0], outs[1], ckpts[0], ckpts[1]


def selective_scan_bidir_bwd_plain(u_t, dt_t, bc_t, cc_t, A, D, delta_bias,
                                   hck_f, hck_r, g_f, g_r):
    """Plain PyTorch version of the backward: rebuilds h chunk by chunk from
    the checkpoints, then runs the adjoint step by step (fp32 carry).

    g_f, g_r are the cotangents of y_f, y_r. Returns the seven cotangents
    (du_t, ddt_t, dbc_t, dcc_t, dA, dD, ddelta_bias) in the dtypes and
    shapes of the inputs; the per-lane dA/dD/dbias are summed over the batch
    copies of each lane constant."""
    L, B, K2, Dim = u_t.shape
    M, G, HD = B * K2 * Dim, B * K2, K2 * Dim
    cd = _compute_dtype(u_t.dtype)
    u = u_t.reshape(L, M).to(cd)
    du = torch.zeros(L, M, dtype=cd, device=u.device)
    ddt, dbc, dcc, dconst = [], [], [], []
    for r, hck, gy in ((0, hck_f, g_f), (1, hck_r, g_r)):
        x, delta, a, bcx, ccx, A_l, D_l = _lane_set(r, u_t, dt_t, bc_t, cc_t,
                                                    A, D, delta_bias)
        b = delta * u * bcx
        g = gy.reshape(L, M).to(cd)
        # h_t and its predecessor in scan order (h_{t-1} / h_{t+1}), one
        # chunk at a time from its entry state
        h, h_prev = torch.empty_like(b), torch.empty_like(b)
        for c in range(hck.shape[0]):
            carry = hck[c].to(cd)
            for t in _scan_order(r, c * CKPT_CHUNK,
                                 min(L, (c + 1) * CKPT_CHUNK)):
                h_prev[t] = carry
                carry = torch.addcmul(b[t], a[t], carry)
                h[t] = carry
        gC = g * ccx
        dh = torch.empty_like(b)
        e = torch.zeros(M, dtype=cd, device=u.device)     # a_next * dh_next
        for t in _scan_order(1 - r, 0, L):
            dh[t] = gC[t] + e
            e = a[t] * dh[t]
        da = dh * h_prev
        ddt_raw = (dh * u * bcx + da * A_l * a) * torch.sigmoid(x)
        du += g * D_l + dh * delta * bcx
        ddt.append(ddt_raw)
        dbc.append((dh * delta * u).reshape(L, G, Dim).sum(-1))
        dcc.append((g * h).reshape(L, G, Dim).sum(-1))
        dconst.append(torch.stack([(da * a * delta).sum(0), (g * u).sum(0),
                                   ddt_raw.sum(0)]))
    return _cotangents(u_t, dt_t, bc_t, A, du, torch.stack(ddt),
                       torch.stack(dbc), torch.stack(dcc), torch.stack(dconst))


def _group_sums_by_slice(v, Dim, lanes=32):
    """(L, M) -> (L, M / Dim): each group's lanes summed per 32-lane slice
    of the plane, then the slices summed in slice order, as the backward
    kernel sums dB and dC."""
    L, M = v.shape
    out = []
    for g in range(M // Dim):
        lo, hi = g * Dim, (g + 1) * Dim
        total = torch.zeros(L, dtype=v.dtype, device=v.device)
        for start in range(lo - lo % lanes, hi, lanes):
            part = torch.zeros(L, dtype=v.dtype, device=v.device)
            for m in range(max(lo, start), min(hi, start + lanes)):
                part = part + v[:, m]
            total = total + part
        out.append(total)
    return torch.stack(out, 1)


def selective_scan_bidir_bwd_chunked(u_t, dt_t, bc_t, cc_t, A, D, delta_bias,
                                     hck_f, hck_r, g_f, g_r, steps=4,
                                     segments=8):
    """The function of :func:`selective_scan_bidir_bwd_plain`, computed in
    the order of ``csrc/selective_scan_bidir_bwd.cu``: L is cut into spans of
    ``segments`` segments of ``steps`` steps (32 tokens, eight to a
    checkpoint chunk, as the kernel has them). Per direction every segment
    is composed from a zero entry to (product of a, h in scan order, e =
    a dh in adjoint order); the segment summaries fold to span summaries; a
    carry over the spans in adjoint order gives every span's adjoint entry,
    and each chunk's checkpoint carried over its spans in scan order every
    span's h entry; every segment is replayed from its span's entries folded
    with the segments before it. du is summed forward first; dB/dC per
    32-lane slice, then over slices; dA/dD/dbias per segment in adjoint
    order, over segments, then over spans. Padded steps are inert. For the
    tests: it shows on the CPU that this order computes the backward."""
    L, B, K2, Dim = u_t.shape
    M = B * K2 * Dim
    span = steps * segments
    if CKPT_CHUNK % span and L > span:
        raise ValueError(f"spans of {segments} segments of {steps} steps do "
                         f"not tile a {CKPT_CHUNK}-token chunk and L={L} "
                         f"needs several")
    ns = -(-L // span)
    Lp = ns * span
    per_chunk = max(CKPT_CHUNK // span, 1)
    cd = _compute_dtype(u_t.dtype)
    dev = u_t.device
    pad = lambda x, v=0.0: F.pad(x, (0, 0, 0, Lp - L), value=v)  # noqa: E731
    u = pad(u_t.reshape(L, M).to(cd))
    du = torch.zeros(Lp, M, dtype=cd, device=dev)
    ddt, dbc, dcc, dconst = [], [], [], []
    for r, hck, gy in ((0, hck_f, g_f), (1, hck_r, g_r)):
        x, delta, a, bcx, ccx, A_l, D_l = _lane_set(r, u_t, dt_t, bc_t, cc_t,
                                                    A, D, delta_bias)
        g = gy.reshape(L, M).to(cd)
        gc = pad(g * ccx)
        sig, delta = pad(torch.sigmoid(x)), pad(delta)
        bcx, g = pad(bcx), pad(g)
        a = pad(a, 1.0)
        b = delta * u * bcx
        # (spans, segments, steps, M) in token order; scan order runs left to
        # right on forward lanes, the adjoint order the other way
        a4, b4, gc4 = (v.reshape(ns, segments, steps, M) for v in (a, b, gc))
        fwd = lambda n: range(n) if r == 0 else range(n - 1, -1, -1)  # noqa
        bwd = lambda n: reversed(fwd(n))  # noqa: E731
        P = torch.ones(ns, segments, M, dtype=cd, device=dev)
        H = torch.zeros_like(P)
        E = torch.zeros_like(P)
        for i in fwd(steps):
            H = a4[:, :, i] * H + b4[:, :, i]
            P = P * a4[:, :, i]
        for i in bwd(steps):
            E = a4[:, :, i] * (gc4[:, :, i] + E)
        Ps = torch.ones(ns, M, dtype=cd, device=dev)
        Hs = torch.zeros_like(Ps)
        Es = torch.zeros_like(Ps)
        for j in fwd(segments):
            Hs = P[:, j] * Hs + H[:, j]
            Ps = Ps * P[:, j]
        for j in bwd(segments):
            Es = P[:, j] * Es + E[:, j]
        eent = torch.empty_like(Ps)
        xe = torch.zeros(M, dtype=cd, device=dev)
        for s in bwd(ns):
            eent[s] = xe
            xe = Ps[s] * xe + Es[s]
        hent = torch.empty_like(Ps)
        for c in range(hck.shape[0]):
            s0, n = c * per_chunk, min(per_chunk, ns - c * per_chunk)
            xh = hck[c].to(cd)
            for i in fwd(n):
                hent[s0 + i] = xh
                xh = Ps[s0 + i] * xh + Hs[s0 + i]
        h_in, e_in = torch.empty_like(P), torch.empty_like(P)
        xh, xe = hent, eent
        for j in fwd(segments):
            h_in[:, j] = xh
            xh = P[:, j] * xh + H[:, j]
        for j in bwd(segments):
            e_in[:, j] = xe
            xe = P[:, j] * xe + E[:, j]
        h4, hp4, dh4 = (torch.empty_like(a4) for _ in range(3))
        xh, xe = h_in, e_in
        for i in fwd(steps):
            hp4[:, :, i] = xh
            xh = a4[:, :, i] * xh + b4[:, :, i]
            h4[:, :, i] = xh
        for i in bwd(steps):
            dh4[:, :, i] = gc4[:, :, i] + xe
            xe = a4[:, :, i] * dh4[:, :, i]
        h, hp, dh = (v.reshape(Lp, M) for v in (h4, hp4, dh4))
        da = dh * hp
        ddt_raw = (dh * u * bcx + da * A_l * a) * sig
        du = du + (g * D_l + dh * delta * bcx)
        ddt.append(ddt_raw[:L])
        dbc.append(_group_sums_by_slice((dh * delta * u)[:L], Dim))
        dcc.append(_group_sums_by_slice((g * h)[:L], Dim))
        sums = []
        for v in (da * a * delta, g * u, ddt_raw):
            v4 = v.reshape(ns, segments, steps, M)
            seg = torch.zeros(ns, segments, M, dtype=cd, device=dev)
            for i in bwd(steps):
                seg = seg + v4[:, :, i]
            per_span = torch.zeros(ns, M, dtype=cd, device=dev)
            for j in range(segments):
                per_span = per_span + seg[:, j]
            total = torch.zeros(M, dtype=cd, device=dev)
            for s in range(ns):
                total = total + per_span[s]
            sums.append(total)
        dconst.append(torch.stack(sums))
    return _cotangents(u_t, dt_t, bc_t, A, du[:L], torch.stack(ddt),
                       torch.stack(dbc), torch.stack(dcc), torch.stack(dconst))


def _cotangents(u_t, dt_t, bc_t, A, du, ddt, dbc, dcc, dconst):
    """(L, M) du, (2, L, M) ddt, (2, L, G) dbc / dcc and (2, 3, M) dconst
    -> the input layouts and dtypes (the JAX ``_fused_bidir_tok_bwd``
    glue; the kernel writes the planes in their dtypes already, so only the
    plain versions' fp32 planes are cast). dconst: [direction][dA, dD,
    dbias][lane], summed here over the batch copies of each constant."""
    L, B, K2, Dim = u_t.shape
    red = dconst.reshape(2, 3, B, K2 * Dim).sum(2)          # (2, 3, HD)
    dA, dD, dbias = (red[:, i].reshape(-1).to(A.dtype) for i in range(3))
    return (du.to(u_t.dtype).reshape(L, B, K2, Dim),
            ddt.to(dt_t.dtype).reshape(2, L, B, K2, Dim),
            dbc.to(bc_t.dtype).reshape(2, L, B, K2),
            dcc.to(bc_t.dtype).reshape(2, L, B, K2),
            dA, dD, dbias)


def _check_operands(u_t, dt_t, bc_t, cc_t, A, D, delta_bias, extra=None):
    L, B, K2, Dim = u_t.shape
    if K2 != 2:
        raise ValueError(f"u_t must be (L, B, 2, Dim), got {tuple(u_t.shape)}")
    want = {"dt_t": (dt_t, (2, L, B, 2, Dim)), "bc_t": (bc_t, (2, L, B, 2)),
            "cc_t": (cc_t, (2, L, B, 2)), "A": (A, (4 * Dim,)),
            "D": (D, (4 * Dim,)), "delta_bias": (delta_bias, (4 * Dim,))}
    extra = extra or {}
    want.update(extra)
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    for name, x in (("u_t", u_t), *((n, v[0]) for n, v in want.items())):
        if x.device != u_t.device:
            raise ValueError(f"{name} is on {x.device}, u_t on {u_t.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    planes = [u_t, dt_t, bc_t, cc_t] + [x for n, (x, s) in extra.items()
                                        if n.startswith("g_")]
    dtypes = {x.dtype for x in planes}
    fp64 = dtypes == {torch.float64} and u_t.device.type == "cpu"
    if len(dtypes) != 1 or not (u_t.dtype in _DTYPE_CODE or fp64):
        raise TypeError(f"u_t/dt_t/bc_t/cc_t (and the cotangents) must share "
                        f"float32 or bfloat16 (float64 on the CPU), got "
                        f"{sorted(map(str, dtypes))}")
    const = torch.float64 if fp64 else torch.float32
    ckpts = [x for n, (x, s) in extra.items() if n.startswith("hck")]
    if any(x.dtype != const for x in (A, D, delta_bias, *ckpts)):
        raise TypeError(f"A, D, delta_bias (and the checkpoints) must be "
                        f"{const}")


def _device_kind(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def _bidir_library():
    """The forward kernel's library with its two entry points typed (once:
    the pipeline is bound by the host, so the launch path stays short)."""
    lib = build.load("selective_scan_bidir")
    fn = lib.xp_selective_scan_bidir
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.xp_selective_scan_bidir_scratch.restype = ctypes.c_longlong
        lib.xp_selective_scan_bidir_scratch.argtypes = [ctypes.c_int] * 2
    return lib


def _launch(u_t, dt_t, bc_t, cc_t, A, D, delta_bias, emit_ckpt):
    lib = _bidir_library()
    L, B, K2, Dim = u_t.shape
    M = B * K2 * Dim
    dev = u_t.device
    y_f = torch.empty_like(u_t)
    y_r = torch.empty_like(u_t)
    # the chunk entry states are part of the scan's own carry between its
    # spans, so they exist whether or not they are returned; the span
    # summaries and entry states are scratch between the passes
    hck = torch.empty(2, -(-L // CKPT_CHUNK), M, device=dev)
    n_scratch = lib.xp_selective_scan_bidir_scratch(L, M)
    scratch = torch.empty(n_scratch, device=dev) if n_scratch else None
    # the reversed lanes' halves of dt_t, bc_t, cc_t and hck by address
    dt, bc, cc, ck = (x.data_ptr() for x in (dt_t, bc_t, cc_t, hck))
    half = lambda x: x.stride(0) * x.element_size()  # noqa: E731
    err = lib.xp_selective_scan_bidir(
        _DTYPE_CODE[u_t.dtype], u_t.data_ptr(), dt, dt + half(dt_t), bc, cc,
        bc + half(bc_t), cc + half(cc_t), A.data_ptr(), D.data_ptr(),
        delta_bias.data_ptr(), y_f.data_ptr(), y_r.data_ptr(), ck,
        ck + half(hck), None if scratch is None else scratch.data_ptr(),
        L, M, Dim, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "selective_scan_bidir launch")
    selective_scan_bidir.launches += 1
    if emit_ckpt:
        return y_f, y_r, hck[0], hck[1]
    return y_f, y_r


def selective_scan_bidir(u_t, dt_t, bc_t, cc_t, A, D, delta_bias,
                         emit_ckpt=False):
    """Forward and reversed selective scans of one SS2D block (see module
    docstring). CUDA tensors launch the kernel (counted in
    ``selective_scan_bidir.launches``); CPU tensors run the plain version."""
    _check_operands(u_t, dt_t, bc_t, cc_t, A, D, delta_bias)
    if cost.counting():
        L, B, K2, Dim = u_t.shape
        cost.record("selective_scan_bidir", cost.scan_bidir(
            L, B * K2 * Dim, B * K2, Dim, emit_ckpt))
    with cost.uncounted():
        if _device_kind(u_t, "selective_scan_bidir") == "cpu":
            return selective_scan_bidir_plain(u_t, dt_t, bc_t, cc_t, A, D,
                                              delta_bias, emit_ckpt)
        return _launch(u_t, dt_t, bc_t, cc_t, A, D, delta_bias, emit_ckpt)


selective_scan_bidir.launches = 0


def _bwd_library():
    """The backward kernel's library with its entry points typed once."""
    lib = build.load("selective_scan_bidir_bwd")
    fn = lib.xp_selective_scan_bidir_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 20
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.xp_selective_scan_bidir_bwd_scratch.restype = ctypes.c_longlong
        lib.xp_selective_scan_bidir_bwd_scratch.argtypes = [ctypes.c_int] * 3
    return lib


def _launch_bwd(u_t, dt_t, bc_t, cc_t, A, D, delta_bias, hck_f, hck_r, g_f,
                g_r):
    lib = _bwd_library()
    L, B, K2, Dim = u_t.shape
    M, G = B * K2 * Dim, B * K2
    dev = u_t.device
    # every output is written whole, in the operands' dtype: du summed over
    # both directions, dB/dC over each group, by the kernel in a fixed order
    du = torch.empty(L, M, dtype=u_t.dtype, device=dev)
    ddt = torch.empty(2, L, M, dtype=dt_t.dtype, device=dev)
    dbcc = torch.empty(2, 2, L, G, dtype=bc_t.dtype, device=dev)  # dB, dC
    dconst = torch.empty(2, 3, M, device=dev)
    scratch = torch.empty(lib.xp_selective_scan_bidir_bwd_scratch(L, M, Dim),
                          device=dev)
    err = lib.xp_selective_scan_bidir_bwd(
        _DTYPE_CODE[u_t.dtype], u_t.data_ptr(), dt_t[0].data_ptr(),
        dt_t[1].data_ptr(), bc_t[0].data_ptr(), cc_t[0].data_ptr(),
        bc_t[1].data_ptr(), cc_t[1].data_ptr(), g_f.data_ptr(),
        g_r.data_ptr(), hck_f.data_ptr(), hck_r.data_ptr(), A.data_ptr(),
        D.data_ptr(), delta_bias.data_ptr(), du.data_ptr(),
        ddt[0].data_ptr(), ddt[1].data_ptr(), dbcc.data_ptr(),
        dconst.data_ptr(), scratch.data_ptr(), L, M, Dim,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "selective_scan_bidir_bwd launch")
    selective_scan_bidir_bwd.launches += 1
    return _cotangents(u_t, dt_t, bc_t, A, du, ddt, dbcc[0], dbcc[1], dconst)


def selective_scan_bidir_bwd(u_t, dt_t, bc_t, cc_t, A, D, delta_bias,
                             hck_f, hck_r, g_f, g_r):
    """Backward of :func:`selective_scan_bidir` from its inputs, its
    checkpoints and the cotangents g_f, g_r of (y_f, y_r). CUDA tensors
    launch the kernel (counted in ``selective_scan_bidir_bwd.launches``);
    CPU tensors run the plain version."""
    L, B, K2, Dim = u_t.shape
    ck = (-(-L // CKPT_CHUNK), B * K2 * Dim)
    _check_operands(u_t, dt_t, bc_t, cc_t, A, D, delta_bias, extra={
        "hck_f": (hck_f, ck), "hck_r": (hck_r, ck),
        "g_f": (g_f, tuple(u_t.shape)), "g_r": (g_r, tuple(u_t.shape))})
    if cost.counting():
        cost.record("selective_scan_bidir_bwd", cost.scan_bidir_bwd(
            L, B * K2 * Dim, B * K2))
    with cost.uncounted():
        if _device_kind(u_t, "selective_scan_bidir_bwd") == "cpu":
            return selective_scan_bidir_bwd_plain(
                u_t, dt_t, bc_t, cc_t, A, D, delta_bias, hck_f, hck_r, g_f,
                g_r)
        return _launch_bwd(u_t, dt_t, bc_t, cc_t, A, D, delta_bias, hck_f,
                           hck_r, g_f, g_r)


selective_scan_bidir_bwd.launches = 0


class SelectiveScanBidir(torch.autograd.Function):
    """Differentiable :func:`selective_scan_bidir` (the JAX custom VJP): the
    forward runs the scan with checkpoints and saves only the inputs and the
    checkpoints; the backward runs :func:`selective_scan_bidir_bwd`."""

    @staticmethod
    def forward(ctx, u_t, dt_t, bc_t, cc_t, A, D, delta_bias):
        y_f, y_r, hck_f, hck_r = selective_scan_bidir(
            u_t, dt_t, bc_t, cc_t, A, D, delta_bias, emit_ckpt=True)
        ctx.save_for_backward(u_t, dt_t, bc_t, cc_t, A, D, delta_bias,
                              hck_f, hck_r)
        return y_f, y_r

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_f, g_r):
        saved = ctx.saved_tensors
        u_t = saved[0]
        g_f = torch.zeros_like(u_t) if g_f is None else g_f.contiguous()
        g_r = torch.zeros_like(u_t) if g_r is None else g_r.contiguous()
        return selective_scan_bidir_bwd(*saved, g_f, g_r)


def scan_bidir(u_t, dt_t, bc_t, cc_t, A, D, delta_bias):
    """The scan as SS2D calls it: through :class:`SelectiveScanBidir` when a
    gradient is wanted, else the plain forward without checkpoints."""
    args = (u_t, dt_t, bc_t, cc_t, A, D, delta_bias)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return SelectiveScanBidir.apply(*args)
    return selective_scan_bidir(*args)


# ---- single-direction fused scan, (B, K, L, Dim) layout -------------------

def selective_scan_fused_bkld_plain(u, dt, A, Bs, Cs, D, delta_bias):
    """Plain PyTorch version of :func:`selective_scan_fused_bkld`: fp32
    sequential recurrence over L (fp64 for fp64 operands)."""
    B, K, L, Dim = u.shape
    cd = _compute_dtype(u.dtype)
    const = lambda v: v.to(cd).reshape(1, K, 1, Dim)  # noqa: E731
    uf = u.to(cd)
    delta = _softplus(dt.to(cd) + const(delta_bias))
    a = torch.exp(delta * const(A))
    b = delta * uf * Bs.to(cd)
    h = torch.empty_like(b)
    carry = torch.zeros(B, K, Dim, dtype=cd, device=u.device)
    for t in range(L):
        carry = torch.addcmul(b[:, :, t], a[:, :, t], carry)
        h[:, :, t] = carry
    return (Cs.to(cd) * h + const(D) * uf).to(dt.dtype)


def selective_scan_fused_chunked(u, dt, A, Bs, Cs, D, delta_bias,
                                 steps=None, segments=4):
    """The function of :func:`selective_scan_fused_bkld_plain`, computed in
    the order of ``csrc/selective_scan_fused.cu``: L is cut into spans of
    ``segments`` segments of ``steps`` steps (64 tokens); every segment is
    composed from a zero entry to its (product of a, h) summary, the segment
    summaries fold to span summaries, a carry over the spans gives every
    span's entry state, and every segment is replayed from (span entry
    folded with the segments before it). Padded steps are the inert (1, 0).
    For the tests: it shows on the CPU that this order computes the
    sequential recurrence."""
    B, K, L, Dim = u.shape
    steps = _segment_steps(L, segments) if steps is None else steps
    span = steps * segments
    ns = -(-L // span)
    cd = _compute_dtype(u.dtype)
    dev = u.device
    const = lambda v: v.to(cd).reshape(1, K, 1, Dim)  # noqa: E731
    uf = u.to(cd)
    delta = _softplus(dt.to(cd) + const(delta_bias))
    pad = lambda x, v: F.pad(x, (0, 0, 0, ns * span - L), value=v)  # noqa
    a = pad(torch.exp(delta * const(A)), 1.0)
    b = pad(delta * uf * Bs.to(cd), 0.0)
    a = a.reshape(B, K, ns, segments, steps, Dim)
    b = b.reshape(B, K, ns, segments, steps, Dim)
    seg_a = torch.ones(B, K, ns, segments, Dim, dtype=cd, device=dev)
    seg_h = torch.zeros_like(seg_a)
    for i in range(steps):
        seg_h = a[..., i, :] * seg_h + b[..., i, :]
        seg_a = seg_a * a[..., i, :]
    span_a = torch.ones(B, K, ns, Dim, dtype=cd, device=dev)
    span_h = torch.zeros_like(span_a)
    for j in range(segments):
        span_h = seg_a[:, :, :, j] * span_h + seg_h[:, :, :, j]
        span_a = span_a * seg_a[:, :, :, j]
    entry = torch.zeros_like(span_a)
    for s in range(1, ns):
        entry[:, :, s] = (span_a[:, :, s - 1] * entry[:, :, s - 1]
                          + span_h[:, :, s - 1])
    seg_in = torch.empty_like(seg_a)
    x = entry
    for j in range(segments):
        seg_in[:, :, :, j] = x
        x = seg_a[:, :, :, j] * x + seg_h[:, :, :, j]
    h = torch.empty_like(a)
    x = seg_in
    for i in range(steps):
        x = a[..., i, :] * x + b[..., i, :]
        h[..., i, :] = x
    h = h.reshape(B, K, ns * span, Dim)[:, :, :L]
    return (Cs.to(cd) * h + const(D) * uf).to(dt.dtype)


def _fused_library():
    """The fused scan's library with its entry points typed once."""
    lib = build.load("selective_scan_fused")
    fn = lib.xp_selective_scan_fused
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.xp_selective_scan_fused_scratch.restype = ctypes.c_longlong
        lib.xp_selective_scan_fused_scratch.argtypes = [ctypes.c_int] * 2
    return lib


def _launch_fused(u, dt, A, Bs, Cs, D, delta_bias):
    lib = _fused_library()
    B, K, L, Dim = u.shape
    M = B * K * Dim
    y = torch.empty_like(u)
    # span summaries and entry states, scratch between the kernel's passes
    n_scratch = lib.xp_selective_scan_fused_scratch(L, M)
    scratch = torch.empty(n_scratch, device=u.device) if n_scratch else None
    err = lib.xp_selective_scan_fused(
        _DTYPE_CODE[u.dtype], u.data_ptr(), dt.data_ptr(), Bs.data_ptr(),
        Cs.data_ptr(), A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(),
        y.data_ptr(), None if scratch is None else scratch.data_ptr(), L, M,
        Dim, K * Dim, torch.cuda.current_stream(u.device).cuda_stream)
    build.check(lib, err, "selective_scan_fused launch")
    selective_scan_fused_bkld.launches += 1
    return y


def _fused_bkld_forward(u, dt, A, Bs, Cs, D, delta_bias):
    """Checks and the forward alone: K5 on CUDA tensors, plain on the CPU."""
    args = (u, dt, A, Bs, Cs, D, delta_bias)
    B, K, L, Dim = u.shape
    want = {"dt": (dt, (B, K, L, Dim)), "Bs": (Bs, (B, K, L, 1)),
            "Cs": (Cs, (B, K, L, 1)), "A": (A, (K * Dim,)),
            "D": (D, (K * Dim,)), "delta_bias": (delta_bias, (K * Dim,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")
    dtypes = {x.dtype for x in (u, dt, Bs, Cs)}
    fp64 = dtypes == {torch.float64} and u.device.type == "cpu"
    if len(dtypes) != 1 or not (u.dtype in _DTYPE_CODE or fp64):
        raise TypeError(f"u/dt/Bs/Cs must share float32 or bfloat16 "
                        f"(float64 on the CPU), got "
                        f"{sorted(map(str, dtypes))}")
    const = torch.float64 if fp64 else torch.float32
    if any(x.dtype != const for x in (A, D, delta_bias)):
        raise TypeError(f"A, D, delta_bias must be {const}")
    if cost.counting():
        cost.record("selective_scan_fused_bkld", cost.scan_fused(
            L, B * K * Dim, B * K, Dim))
    with cost.uncounted():
        if _device_kind(u, "selective_scan_fused_bkld") == "cpu":
            return selective_scan_fused_bkld_plain(*args)
        return _launch_fused(*(x.contiguous() for x in args))


def _unfused_bkld(u, dt, A, Bs, Cs, D, delta_bias):
    """The function of :func:`selective_scan_fused_bkld` composed around
    :func:`linear_scan` in fp32 (fp64), differentiable: what the backward
    differentiates (port of ``_unfused_bkld_ref``). The planes stay in
    (B, K, L, Dim) and are scanned along L where they lie."""
    B, K, L, Dim = u.shape
    cd = _compute_dtype(u.dtype)
    const = lambda v: v.to(cd).reshape(1, K, 1, Dim)  # noqa: E731
    uf = u.to(cd)
    # F.softplus: the same values as _softplus, and sigmoid as gradient
    # also at 0, where clamp and abs have a kink
    delta = F.softplus(dt.to(cd) + const(delta_bias))
    a = torch.exp(delta * const(A))
    b = delta * uf * Bs.to(cd)
    h = linear_scan(a, b, dim=2)
    return Cs.to(cd) * h + const(D) * uf


class SelectiveScanFusedBkld(torch.autograd.Function):
    """Differentiable :func:`selective_scan_fused_bkld` (the JAX custom
    VJP): the forward is the fused scan and saves only its inputs; the
    backward differentiates :func:`_unfused_bkld` on them, with the
    cotangent cast to fp32, so the gradient is that of the fp32 function."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _fused_bkld_forward(*args)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        with torch.enable_grad():
            args = [x.detach().requires_grad_(need) for x, need in
                    zip(ctx.saved_tensors, ctx.needs_input_grad)]
            y = _unfused_bkld(*args)
            wanted = [x for x in args if x.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g.to(y.dtype)))
        return tuple(next(grads).to(x.dtype) if x.requires_grad else None
                     for x in args)


def selective_scan_fused_bkld(u, dt, A, Bs, Cs, D, delta_bias):
    """Single-direction fused N=1 selective scan in SS2D's layout (port of
    ``selective_scan_pallas.py::selective_scan_fused_bkld``).

    u, dt: (B, K, L, Dim); Bs, Cs: (B, K, L, 1); A, D, delta_bias: (K*Dim,)
    fp32. Per lane: delta = softplus(dt + bias), h_t = exp(delta A) h_{t-1}
    + delta u Bs, y = Cs h + D u with an fp32 carry; returns (B, K, L, Dim)
    in the operands' dtype. CUDA tensors launch ``csrc/
    selective_scan_fused.cu`` (replacing the TPU kernel
    ``_fused_scan_kernel``; counted in
    ``selective_scan_fused_bkld.launches``); CPU tensors run the plain
    version. When a gradient is wanted it goes through
    :class:`SelectiveScanFusedBkld`, whose backward runs the
    linear-recurrence kernel twice (``ops/linear_scan.py``): once to
    rebuild h, once reversed."""
    args = (u, dt, A, Bs, Cs, D, delta_bias)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return SelectiveScanFusedBkld.apply(*args)
    return _fused_bkld_forward(*args)


selective_scan_fused_bkld.launches = 0
