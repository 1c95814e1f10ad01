"""Cell logits -> full-resolution heatmap, and subpixel keypoint refinement
(port of ``xpoint_tpu/ops/detector.py``)."""
import torch

from .gridops import depth_to_space


def prob_from_logits(logits, ratio=8):
    """(B, Hc, Wc, r^2+1) logits -> (B, H, W) fp32 probability heatmap:
    softmax over the cell classes, dustbin dropped, depth-to-space."""
    prob = torch.softmax(logits.float(), dim=-1)[..., :-1]
    return depth_to_space(prob, ratio)[..., 0]


def _quadratic_peak_offset(pm, p0, pp):
    """Argmax of the parabola through (-1, pm), (0, p0), (1, pp), clamped
    to [-0.5, 0.5]; 0 where the curvature vanishes."""
    denom = pm - 2.0 * p0 + pp
    safe = denom.abs() > 1e-12
    off = 0.5 * (pm - pp) / torch.where(safe, denom, torch.ones_like(denom))
    return torch.where(safe, off, torch.zeros_like(off)).clamp(-0.5, 0.5)


def refine_keypoints_subpixel(prob, kps, valid=None):
    """Per-axis quadratic peak interpolation of integer keypoints on the
    raw (pre-NMS) heatmap.

    prob: (H, W) heatmap; kps: (K, 2) integer (row, col); valid: (K,) bool
    or None for all valid. Returns (K, 2) fp32 (row, col); invalid rows
    pass through unchanged. Along an axis where a keypoint lies on the
    image border it stays on the integer grid (the clamped neighbour would
    duplicate the centre and push it out of the image)."""
    H, W = prob.shape
    r = kps[:, 0].long()
    c = kps[:, 1].long()

    def at(dr, dc):
        return prob[(r + dr).clamp(0, H - 1), (c + dc).clamp(0, W - 1)].float()

    p0 = at(0, 0)
    dy = _quadratic_peak_offset(at(-1, 0), p0, at(1, 0))
    dx = _quadratic_peak_offset(at(0, -1), p0, at(0, 1))
    dy = torch.where((r > 0) & (r < H - 1), dy, torch.zeros_like(dy))
    dx = torch.where((c > 0) & (c < W - 1), dx, torch.zeros_like(dx))
    out = kps.float() + torch.stack([dy, dx], dim=-1)
    if valid is None:
        return out
    return torch.where(valid[:, None], out, kps.float())
