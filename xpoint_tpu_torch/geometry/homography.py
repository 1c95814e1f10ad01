"""Homography helpers on tensors (port of
``xpoint_tpu/geometry/homography.py:206-256``: ``compute_valid_mask_device``
and ``warp_points``)."""
import torch
import torch.nn.functional as F

from ..ops.warp import _source_coords


def compute_valid_mask_device(homographies, image_shape, erosion_radius=0,
                              mask_border=False):
    """Valid-pixel mask of a warp, batched: (n, 3, 3) -> (n, H, W) fp32.

    The warped all-ones image is analytic: a bounds test on the rounded
    inverse-mapped sample coordinates (cv2 INTER_NEAREST). Erosion by the
    square (2r+1)^2 kernel is a min-pool whose border does not shrink the
    mask (cv2.erode's default); with ``mask_border`` the image edge counts
    as invalid."""
    Hh, Ww = image_shape
    ys, xs = _source_coords(homographies, Hh, Ww)
    yi = torch.round(ys)
    xi = torch.round(xs)
    m = (yi >= 0) & (yi <= Hh - 1) & (xi >= 0) & (xi <= Ww - 1)
    m = m.float().reshape(-1, 1, Hh, Ww)
    if erosion_radius > 0:
        k = 2 * erosion_radius + 1
        if mask_border:
            m = F.pad(m, (1, 1, 1, 1))
        # min-pool as -max_pool(-m); max_pool pads with -inf, so the padding
        # never wins the min
        m = -F.max_pool2d(-m, k, stride=1, padding=erosion_radius)
        if mask_border:
            m = m[:, :, 1:-1, 1:-1]
    return m[:, 0]


def warp_points(points, homography):
    """(B, N, 2) (row, col) points warped by (B, 3, 3) pixel homographies
    acting on (x, y, 1) column vectors -> (B, N, 2) (row, col). Elementwise
    fp32 products, no matrix unit (the JAX side asks for "highest")."""
    xy = torch.flip(points, dims=(-1,))
    homog = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    warped = (homography.to(points.dtype)[:, None, :, :]
              * homog[:, :, None, :]).sum(-1)               # (B, N, 3)
    warped = warped[..., :2] / warped[..., 2:]
    return torch.flip(warped, dims=(-1,))
