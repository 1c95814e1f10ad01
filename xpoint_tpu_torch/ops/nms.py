"""Grid box-NMS and keypoint extraction (port of ``xpoint_tpu/ops/nms.py``).

Greedy equal-box NMS runs as a fixed point on the heatmap (see
``grid_nms_keep_plain``). On a CUDA tensor one call is one launch of the
Hopper kernel ``csrc/nms_sweep.cu`` (replacing the TPU kernel
``xpoint_tpu/ops/nms.py::_nms_sweep_kernel``), which runs every sweep on the
device at any box size: boxes up to 16 on planes that fit, in calls of
enough planes to fill a quarter of the card (the serving calls), keep each
plane in a thread-block cluster's shared memory, one cluster a plane, each
stopping at its own fixed point (``grid_nms_keep_cluster_mirror`` is that
decomposition on the CPU, for the tests); other calls take a cooperative
launch with a grid barrier between sweeps. ``box_nms`` and
``box_nms_extract`` read nothing back from the device. On a CPU tensor the
plain PyTorch version below runs the same sweeps.
"""
import ctypes
import functools

import torch

from ..kernels import build, cost
from .gridops import device_constant


def overlap_widths(size, iou):
    """Allowed |dx| for each |dy| < size: boxes at offset (dy, dx) suppress
    iff (s-|dy|)(s-|dx|) / (2 s^2 - inter) > iou; -1 where none does."""
    s = float(size)
    thr = 2.0 * iou * s * s / (1.0 + iou)
    widths = []
    for dy in range(size):
        w = -1
        for dx in range(size):
            if (s - dy) * (s - dx) > thr:
                w = dx
        widths.append(w)
    return widths


def _shift(a, d, dim):
    """out[..., i, ...] = a[..., i + d, ...] along ``dim`` (-1 or -2),
    -inf where i + d leaves the plane (everywhere when |d| >= its size)."""
    n = a.shape[dim]
    fill_shape = list(a.shape)
    fill_shape[dim] = min(abs(d), n)
    fill = torch.full(fill_shape, float("-inf"), dtype=a.dtype,
                      device=a.device)
    if abs(d) >= n:
        return fill
    if d > 0:
        return torch.cat([a.narrow(dim, d, n - d), fill], dim)
    return torch.cat([fill, a.narrow(dim, 0, n + d)], dim)


def _neighbor_max(S, widths, size):
    """Max of S over each pixel's overlap strip set: horizontal running
    maxima per width, then shifted vertical combines (nms.py:70-84)."""
    max_w = max((w for w in widths if w >= 0), default=0)
    row_max = {0: S}
    for w in range(1, max_w + 1):
        row_max[w] = torch.maximum(row_max[w - 1], torch.maximum(
            _shift(S, w, -1), _shift(S, -w, -1)))
    out = torch.full_like(S, float("-inf"))
    for dy in range(-(size - 1), size):
        w = widths[abs(dy)]
        if w < 0:
            continue
        r = row_max[w]
        out = torch.maximum(out, r if dy == 0 else _shift(r, dy, -2))
    return out


def grid_nms_keep_plain(prob, valid, size, iou):
    """Plain PyTorch greedy box-NMS fixed point (the XLA formulation of
    ``xpoint_tpu/ops/nms.py::_grid_nms_keep``).

    keep <- valid & ~(a kept neighbour in the overlap set scores strictly
    higher), Jacobi sweeps until nothing changes, at most H*W sweeps.
    prob, valid: (B, H, W). Returns (keep bool (B, H, W), sweeps).
    """
    widths = overlap_widths(size, iou)
    p = prob.float()
    neg = torch.full((), float("-inf"), device=p.device)
    keep, prev = valid, ~valid
    sweeps = 0
    while sweeps < p.shape[1] * p.shape[2] and bool((keep != prev).any()):
        S = torch.where(keep, p, neg)
        keep, prev = valid & ~(_neighbor_max(S, widths, size) > p), keep
        sweeps += 1
    return keep, sweeps


def _changed_near(boxes, o0, o1, ch, split):
    """Whether a pixel within the strip set's reach of the tile of rows
    [o0, o1) and column chunk ``ch`` changed in the sweep before, as the
    kernel tells it: each tile near it gives the first and last row and
    32-column word where its pixels changed (``boxes``: {(block, seg,
    chunk): (row_lo, row_hi, word_lo, word_hi)})."""
    H, rows, seg, chunk, nch, hy, hx = split
    x_lo, x_hi = max(0, ch * chunk - hx), ch * chunk + chunk - 1 + hx
    c_hi = min(nch - 1, x_hi // chunk)
    near = {(y // rows, y % rows // seg)
            for y in range(max(0, o0 - hy), min(H, o1 + hy))}
    for b, q in near:
        for cc in range(x_lo // chunk, c_hi + 1):
            box = boxes.get((b, q, cc))
            if (box and box[0] <= o1 - 1 + hy and box[1] >= o0 - hy
                    and box[2] <= x_hi // 32 and box[3] >= x_lo // 32):
                return True
    return False


def grid_nms_keep_cluster_mirror(prob, valid, size, iou, blocks, seg=None,
                                 chunk=128):
    """The card kernel's resident decomposition in plain PyTorch, for the
    tests: :func:`grid_nms_keep_plain`'s answer, computed as
    ``csrc/nms_sweep.cu``'s cluster computes it.

    Each plane is swept on its own until a sweep changes nothing (that sweep
    counts) or H * W sweeps ran; the count returned is the largest of a
    plane's. The rows are split into ``blocks`` runs of ceil(H / blocks)
    (fewer blocks where that leaves one without rows); a block sees its own
    rows and the halo rows above and below it through the sweep before's
    mask, in two ping-pong buffers. Each block's rows are cut into tiles of
    ``seg`` rows (default: about 8 tiles a block; the kernel plans its own)
    by ``chunk`` columns; from the third sweep on a tile is computed only
    where a pixel within the strip set's reach changed in the sweep before,
    as told by the rows and 32-column words where each tile changed, else
    it keeps what its buffer holds (the mask of two sweeps ago). Returns
    (keep bool (B, H, W), sweeps)."""
    widths = overlap_widths(size, iou)
    B, H, W = prob.shape
    hy = max((d for d, w in enumerate(widths) if w >= 0), default=0)
    hx = max((w for w in widths if w >= 0), default=0)
    rows = -(-H // blocks)
    blocks = -(-H // rows)
    nch = -(-W // chunk)
    if seg is None:
        seg = -(-rows // max(1, min(rows, -(-8 // nch))))
    nseg = -(-rows // seg)
    split = (H, rows, seg, chunk, nch, hy, hx)
    neg = torch.full((), float("-inf"))
    keeps, counts = [], []
    for p, v in zip(prob.float(), valid):
        bufs = [v.clone(), torch.zeros_like(v)]
        boxes = [{}, {}]                  # by sweep parity
        sweeps = 0
        while True:
            kin, kout = bufs[sweeps & 1], bufs[(sweeps + 1) & 1]
            before, now = boxes[(sweeps + 1) & 1], boxes[sweeps & 1]
            now.clear()
            for b in range(blocks):
                r0, r1 = b * rows, min(b * rows + rows, H)
                lo, hi = max(0, r0 - hy), min(H, r1 + hy)
                S = torch.where(kin[lo:hi], p[lo:hi], neg)
                nm = _neighbor_max(S[None], widths, size)[0]
                for q in range(nseg):
                    o0, o1 = r0 + q * seg, min(r0 + q * seg + seg, r1)
                    for ch in range(nch if o0 < o1 else 0):
                        if sweeps >= 2 and not _changed_near(before, o0, o1,
                                                             ch, split):
                            continue
                        cols = slice(ch * chunk, ch * chunk + chunk)
                        new = v[o0:o1, cols] & ~(nm[o0 - lo:o1 - lo, cols]
                                                 > p[o0:o1, cols])
                        ys, xs = torch.nonzero(new != kin[o0:o1, cols],
                                               as_tuple=True)
                        if len(ys):
                            xs = (xs + ch * chunk) // 32
                            now[b, q, ch] = (o0 + int(ys.min()),
                                             o0 + int(ys.max()),
                                             int(xs.min()), int(xs.max()))
                        kout[o0:o1, cols] = new
            sweeps += 1
            if not now or sweeps >= H * W:
                break
        keeps.append(bufs[sweeps & 1])
        counts.append(sweeps)
    return torch.stack(keeps), max(counts, default=0)


@functools.lru_cache(maxsize=None)
def _widths_arg(size, iou):
    widths = overlap_widths(size, iou)        # none for a size below 1
    return (ctypes.c_int * len(widths))(*widths)


@functools.lru_cache(maxsize=None)
def _widths_device(size, iou, device):
    """The widths table on ``device`` for the kernel's banded instance
    (copied once, through pinned memory: the host does not wait)."""
    return device_constant(overlap_widths(size, iou), device, torch.int32)


# boxes up to this size take the resident or the staged instance
# (csrc/nms_sweep.cu kMaxSize, xp_nms); larger ones the banded instance
RESIDENT_MAX_SIZE = 16


def _nms_library():
    """The kernel's library with its entry points typed once."""
    lib = build.load("nms_sweep")
    fn = lib.xp_nms
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        lib.xp_nms_banded.restype = ctypes.c_int
        lib.xp_nms_banded.argtypes = fn.argtypes[:-1] + [ctypes.c_void_p] * 2
        lib.xp_nms_scratch.restype = ctypes.c_longlong
        lib.xp_nms_scratch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.xp_nms_fit_rows.restype = ctypes.c_int
        lib.xp_nms_fit_rows.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.xp_nms_last_launch.restype = None
        lib.xp_nms_last_launch.argtypes = [ctypes.c_void_p]
    return lib


def last_launch_shape():
    """The shape of the kernel's last launch in this process (for
    reports): dynamic shared memory bytes a block, resident blocks an SM,
    blocks launched; the banded instance's band rows, table levels and
    staged columns; the resident instance's blocks a cluster (one cluster a
    plane), rows a block, clusters resident at once, waves and rows a tile.
    Keys an instance does not have hold 0."""
    out = (ctypes.c_longlong * 11)()
    _nms_library().xp_nms_last_launch(out)
    keys = ("smem_bytes", "blocks_per_sm", "blocks", "band_rows",
            "table_levels", "staged_columns", "cluster", "rows_per_block",
            "clusters_resident", "waves", "tile_rows")
    return dict(zip(keys, out))


def resident_fit_rows(W, size, iou=0.1):
    """The largest H of an (H, W) plane that the kernel keeps in one
    cluster's shared memory at this box (0 if none): the fit rule, read
    from the current CUDA device. A call takes the resident instance where
    its planes fit and their clusters hold a quarter of the SMs or more."""
    n = _nms_library().xp_nms_fit_rows(W, size, _widths_arg(size, iou))
    if n < 0:
        raise RuntimeError("nms_sweep: CUDA error while planning a launch")
    return n


def _grid_nms_keep_cuda(prob, valid, size, iou):
    """One launch of the kernel (counted in ``grid_nms_keep.launches``):
    returns the keep mask and the sweep count as a 0-d int32 tensor on the
    device. Reads nothing back; a refused launch raises."""
    lib = _nms_library()
    B, H, W = prob.shape
    dev = prob.device
    p = prob.float().contiguous()
    valid = valid.contiguous()
    widths = _widths_arg(size, iou)
    keep = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.xp_nms_scratch(B, H, W, size, widths),
                          dtype=torch.uint8, device=dev)
    state = torch.empty(4, dtype=torch.int32, device=dev)
    args = (p.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            scratch.data_ptr(), state.data_ptr(), B, H, W, size, widths)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if 1 <= size <= RESIDENT_MAX_SIZE:
        err = lib.xp_nms(*args, stream)
    else:
        err = lib.xp_nms_banded(*args,
                                _widths_device(size, iou, dev).data_ptr(),
                                stream)
    build.check(lib, err, "nms_sweep launch")
    grid_nms_keep.launches += 1
    return keep, state[3]


def _grid_nms_keep_async(prob, valid, size, iou):
    """(keep, sweeps) with no read from the device: on a CUDA tensor sweeps
    is a 0-d int32 tensor there; on a CPU tensor the plain version runs."""
    if prob.shape != valid.shape or prob.dim() != 3:
        raise ValueError(f"prob/valid must be (B, H, W), got "
                         f"{tuple(prob.shape)} / {tuple(valid.shape)}")
    if valid.dtype != torch.bool or prob.device != valid.device:
        raise ValueError(f"valid must be bool on prob's device, got "
                         f"{valid.dtype} on {valid.device}")
    if prob.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_nms_keep: unsupported device {prob.device}")
    with cost.uncounted():
        if prob.device.type == "cpu":
            keep, sweeps = grid_nms_keep_plain(prob, valid, size, iou)
            sweeps = torch.tensor(sweeps, dtype=torch.int32)
        else:
            keep, sweeps = _grid_nms_keep_cuda(prob, valid, size, iou)
    if cost.counting():
        # the work depends on the data: the sweeps this call took (read
        # back only while counting)
        cost.record("grid_nms_keep", cost.nms(prob.numel(), int(sweeps),
                                              size, iou))
    return keep, sweeps


def grid_nms_keep(prob, valid, size, iou):
    """Greedy box-NMS keep mask and sweep count for (B, H, W) heatmaps.

    A CPU tensor runs :func:`grid_nms_keep_plain`; a CUDA tensor runs one
    launch of the ``nms_sweep`` kernel, all sweeps included (counted in
    ``grid_nms_keep.launches``), and reads the sweep count back once.
    """
    keep, sweeps = _grid_nms_keep_async(prob, valid, size, iou)
    return keep, int(sweeps)


grid_nms_keep.launches = 0


def box_nms(prob, size, min_prob, iou=0.1, keep_top_k=0):
    """NMS a heatmap; returns the heatmap with suppressed scores zeroed
    (``xpoint_tpu/ops/nms.py::box_nms``).

    prob: (H, W) or (B, H, W). min_prob (>= 0: 0 is the suppressed
    sentinel) is the detection threshold applied before NMS; with
    keep_top_k > 0 only the k highest surviving scores of each map stay."""
    squeeze = prob.dim() == 2
    p = prob[None] if squeeze else prob
    keep, _ = _grid_nms_keep_async(p, p > min_prob, size, iou)
    out = torch.where(keep, p, torch.zeros((), dtype=p.dtype,
                                           device=p.device))
    if keep_top_k and keep_top_k > 0:
        B, H, W = out.shape
        flat = out.reshape(B, H * W)
        scores, idx = torch.topk(flat, min(keep_top_k, H * W), dim=1)
        out = torch.zeros_like(flat).scatter_(1, idx, scores).reshape(B, H, W)
    return out[0] if squeeze else out


def nms_block_edge(size, iou, H, W):
    """Largest power-of-2 block edge b (<= 8) such that two NMS survivors
    never share a b x b block; 0 if none >= 2 divides the grid
    (``xpoint_tpu/ops/nms.py::_nms_block_edge``)."""
    thr = 2.0 * iou * size * size / (1.0 + iou)
    b = 0
    for cand in (2, 4, 8):
        if (H % cand or W % cand
                or (size - (cand - 1)) ** 2 <= thr or cand > size):
            break
        b = cand
    return b


def box_nms_extract(prob, size, min_prob, iou=0.1, k=1024):
    """NMS + top-k keypoint extraction for (B, H, W) heatmaps
    (``xpoint_tpu/ops/nms.py::box_nms_extract``, batched).

    min_prob must be >= 0 (0 is the suppressed sentinel). Returns
    keypoints (B, k, 2) int32 (row, col), scores (B, k) and mask (B, k);
    padding rows hold zeros. The order of exactly tied scores may differ
    from ``jax.lax.top_k``'s.
    """
    B, H, W = prob.shape
    keep, _ = _grid_nms_keep_async(prob, prob > min_prob, size, iou)
    kept = torch.where(keep, prob, torch.zeros((), dtype=prob.dtype,
                                               device=prob.device))
    kk = min(k, H * W)
    b = nms_block_edge(size, iou, H, W)
    if b and (H // b) * (W // b) >= kk:
        # survivors are <= 1 per b x b block: an exact top-k over the block
        # maxima gives the same keypoint set; the position is the smallest
        # flat index in the block that holds the block's positive maximum
        blocks = kept.reshape(B, H // b, b, W // b, b).permute(0, 1, 3, 2, 4)
        blocks = blocks.reshape(B, (H // b) * (W // b), b * b)
        bmax = blocks.amax(-1)
        top_scores, bidx = torch.topk(bmax, kk, dim=1)
        flat = torch.arange(H * W, device=prob.device).reshape(
            H // b, b, W // b, b).permute(0, 2, 1, 3).reshape(-1, b * b)
        cand = torch.where((blocks == bmax[..., None]) & (blocks > 0),
                           flat, torch.full((), H * W, device=prob.device))
        cidx = cand.amin(-1)
        idx = torch.gather(cidx, 1, bidx)
        idx = torch.where(idx == H * W, torch.zeros_like(idx), idx)
    else:
        top_scores, idx = torch.topk(kept.reshape(B, H * W), kk, dim=1)
    mask = top_scores > min_prob
    kps = torch.stack([idx // W, idx % W], dim=-1).int()
    kps = torch.where(mask[..., None], kps, torch.zeros_like(kps))
    scores = torch.where(mask, top_scores, torch.zeros_like(top_scores))
    if k > kk:
        pad = k - kk
        kps = torch.nn.functional.pad(kps, (0, 0, 0, pad))
        scores = torch.nn.functional.pad(scores, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return kps, scores, mask


def extract_keypoints(prob_nms, k, min_prob=0.0):
    """The k highest scores of an NMS'd (H, W) or (B, H, W) heatmap
    (``xpoint_tpu/ops/nms.py::extract_keypoints``): keypoints (..., k, 2)
    int32 (row, col), scores (..., k) and mask (..., k), padding rows
    zero. Ties take the lower flat index first, as ``jax.lax.top_k`` does
    (a stable descending sort; ``torch.topk`` promises no tie order)."""
    H, W = prob_nms.shape[-2:]
    flat = prob_nms.reshape(*prob_nms.shape[:-2], H * W)
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = scores[..., :k], idx[..., :k]
    mask = scores > min_prob
    kps = torch.stack([idx // W, idx % W], dim=-1).int()
    kps = torch.where(mask[..., None], kps, torch.zeros_like(kps))
    scores = torch.where(mask, scores, torch.zeros_like(scores))
    return kps, scores, mask
