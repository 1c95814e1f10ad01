"""Grid box-NMS and keypoint extraction (port of ``xpoint_tpu/ops/nms.py``).

Greedy equal-box NMS runs as a fixed point on the heatmap (see
``grid_nms_keep_plain``). On a CUDA tensor one call is one cooperative
launch of the Hopper kernel ``csrc/nms_sweep.cu`` (replacing the TPU kernel
``xpoint_tpu/ops/nms.py::_nms_sweep_kernel``), which runs every sweep on the
device with a grid barrier between sweeps, at any box size (boxes up to 16
stage their neighbourhood in shared memory, larger ones read it from device
memory); ``box_nms`` and
``box_nms_extract`` read nothing back from the device. On a CPU tensor the
plain PyTorch version below runs the same sweeps.
"""
import ctypes
import functools

import torch

from ..kernels import build
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
    -inf where i + d leaves the plane."""
    n = a.shape[dim]
    fill_shape = list(a.shape)
    fill_shape[dim] = abs(d)
    fill = torch.full(fill_shape, float("-inf"), dtype=a.dtype,
                      device=a.device)
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


@functools.lru_cache(maxsize=None)
def _widths_arg(size, iou):
    return (ctypes.c_int * size)(*overlap_widths(size, iou))


@functools.lru_cache(maxsize=None)
def _widths_device(size, iou, device):
    """The widths table on ``device`` for the kernel's direct instance
    (copied once, through pinned memory: the host does not wait)."""
    return device_constant(overlap_widths(size, iou), device, torch.int32)


# boxes up to this size stage their neighbourhood in shared memory
# (csrc/nms_sweep.cu kMaxSize); larger ones take the direct instance
STAGED_MAX_SIZE = 16


def _nms_library():
    """The kernel's library with its entry points typed once."""
    lib = build.load("nms_sweep")
    fn = lib.xp_nms
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 2)
        lib.xp_nms_direct.restype = ctypes.c_int
        lib.xp_nms_direct.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_void_p] * 2)
        lib.xp_nms_scratch.restype = ctypes.c_longlong
        lib.xp_nms_scratch.argtypes = [ctypes.c_int] * 3
    return lib


def _grid_nms_keep_cuda(prob, valid, size, iou):
    """One launch of the kernel (counted in ``grid_nms_keep.launches``):
    returns the keep mask and the sweep count as a 0-d int32 tensor on the
    device. Reads nothing back; a refused launch raises."""
    lib = _nms_library()
    B, H, W = prob.shape
    dev = prob.device
    p = prob.float().contiguous()
    valid = valid.contiguous()
    keep = torch.empty((B, H, W), dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.xp_nms_scratch(B, H, W), dtype=torch.uint8,
                          device=dev)
    state = torch.empty(4, dtype=torch.int32, device=dev)
    args = (p.data_ptr(), valid.data_ptr(), keep.data_ptr(),
            scratch.data_ptr(), state.data_ptr(), B, H, W, size)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if 1 <= size <= STAGED_MAX_SIZE:
        err = lib.xp_nms(*args, _widths_arg(size, iou), stream)
    else:
        max_w = max([0, *overlap_widths(size, iou)])
        err = lib.xp_nms_direct(*args, max_w,
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
    if prob.device.type == "cpu":
        keep, sweeps = grid_nms_keep_plain(prob, valid, size, iou)
        return keep, torch.tensor(sweeps, dtype=torch.int32)
    if prob.device.type != "cuda":
        raise ValueError(f"grid_nms_keep: unsupported device {prob.device}")
    return _grid_nms_keep_cuda(prob, valid, size, iou)


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
