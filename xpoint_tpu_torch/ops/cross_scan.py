"""Cross-scan / cross-merge: expand a (B, H, W, C) feature map into the four
directional 1-D scan orders of SS2D, and the inverse sum-merge (port of
``xpoint_tpu/ops/cross_scan.py``). Pure layout.

scans:
    0 cross2d: row-major, column-major, both reversed
    1 unidi:   row-major replicated 4x
    2 bidi:    row-major x2, row-major-reversed x2
"""
import torch


def cross_scan(x, scans=0):
    """(B, H, W, C) -> (B, 4, L, C)."""
    B, H, W, C = x.shape
    row = x.reshape(B, H * W, C)
    if scans == 0:
        col = x.transpose(1, 2).reshape(B, H * W, C)
        return torch.stack([row, col, row.flip(1), col.flip(1)], dim=1)
    if scans == 1:
        return torch.stack([row, row, row, row], dim=1)
    if scans == 2:
        rev = row.flip(1)
        return torch.stack([row, row, rev, rev], dim=1)
    raise ValueError(f"unknown scan mode {scans}")


def cross_merge(ys, H, W, scans=0):
    """(B, 4, L, C) -> (B, H, W, C): invert each scan order and sum."""
    B, K, L, C = ys.shape
    if scans == 0:
        fwd = ys[:, 0:2] + ys[:, 2:4].flip(2)
        col = fwd[:, 1].reshape(B, W, H, C).transpose(1, 2).reshape(B, L, C)
        return (fwd[:, 0] + col).reshape(B, H, W, C)
    if scans == 1:
        return ys.sum(dim=1).reshape(B, H, W, C)
    if scans == 2:
        merged = ys[:, 0:2].sum(1) + ys[:, 2:4].sum(1).flip(1)
        return merged.reshape(B, H, W, C)
    raise ValueError(f"unknown scan mode {scans}")
