"""Homography image warping, batched (port of ``xpoint_tpu/ops/warp.py:
34-150``: ``warp_image_batch`` and its helpers).

Convention: a homography ``H`` maps SOURCE pixel coords to DESTINATION
pixel coords in cv2 (x=col, y=row) order, as cv2.warpPerspective does. The
warp samples ``out[y, x] = src(H^-1 @ [x, y, 1])`` at exact pixel positions
(align_corners=True), bilinear (the only mode the train path uses).

Padding modes: 'zeros' and 'reflection' (mirror about pixel centers,
cv2.BORDER_REFLECT_101). This is an explicit gather: ``F.grid_sample``'s
'reflection' padding and its normalised coordinates are not this
convention.
"""
import torch

# Projective division gives inf where the homography's horizon line crosses
# the output canvas and nan at its principal point; one such pixel would
# NaN a train step. cv2 saturates these coords to finite values; so does
# this (a finite out-of-image magnitude, exact in fp32).
_COORD_MAX = 1e7


def _finite_coords(c):
    c = torch.nan_to_num(c, nan=-_COORD_MAX, posinf=_COORD_MAX,
                         neginf=-_COORD_MAX)
    return c.clamp(-_COORD_MAX, _COORD_MAX)


def _reflect_101(coord, size):
    """Reflect a coordinate into [0, size-1] without repeating the edge."""
    period = 2.0 * (size - 1.0)
    coord = torch.remainder(coord, period)
    return torch.where(coord > (size - 1.0), period - coord, coord)


def _source_coords(homographies, H_out, W_out):
    """(n, 3, 3) -> per-homography source sample positions (ys, xs), each
    (n, H_out*W_out), fp32."""
    Hinv = torch.linalg.inv(homographies.float())
    dev = Hinv.device
    ys_d, xs_d = torch.meshgrid(
        torch.arange(H_out, dtype=torch.float32, device=dev),
        torch.arange(W_out, dtype=torch.float32, device=dev), indexing="ij")
    xs_d = xs_d.reshape(-1)
    ys_d = ys_d.reshape(-1)
    h = lambda i, j: Hinv[:, i, j, None]  # noqa: E731
    denom = h(2, 0) * xs_d + h(2, 1) * ys_d + h(2, 2)
    xs_s = _finite_coords((h(0, 0) * xs_d + h(0, 1) * ys_d + h(0, 2)) / denom)
    ys_s = _finite_coords((h(1, 0) * xs_d + h(1, 1) * ys_d + h(1, 2)) / denom)
    return ys_s, xs_s


def _gather(flat, yi, xi, H, W, padding_mode):
    """flat (B, H*W, C); yi/xi (B, P) int -> (B, P, C), zero outside the
    image in 'zeros' mode."""
    yc = yi.clamp(0, H - 1)
    xc = xi.clamp(0, W - 1)
    idx = (yc * W + xc).unsqueeze(-1).expand(-1, -1, flat.shape[-1])
    vals = torch.gather(flat, 1, idx)
    if padding_mode == "zeros":
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        vals = vals * inb.unsqueeze(-1).to(vals.dtype)
    return vals


def warp_image_batch(images, homographies, padding_mode="zeros"):
    """images (B, H, W, C), homographies (B, 3, 3) -> (B, H, W, C),
    bilinear."""
    if padding_mode not in ("zeros", "reflection"):
        raise ValueError(f"unknown padding mode: {padding_mode}")
    B, H, W, C = images.shape
    ys, xs = _source_coords(homographies, H, W)
    if padding_mode == "reflection":
        ys = _reflect_101(ys, H)
        xs = _reflect_101(xs, W)
    flat = images.reshape(B, H * W, C)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0).unsqueeze(-1)
    wx = (xs - x0).unsqueeze(-1)
    y0i = y0.long()
    x0i = x0.long()
    g = lambda yi, xi: _gather(flat, yi, xi, H, W,  # noqa: E731
                               padding_mode)
    top = g(y0i, x0i) * (1 - wx) + g(y0i, x0i + 1) * wx
    bot = g(y0i + 1, x0i) * (1 - wx) + g(y0i + 1, x0i + 1) * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(B, H, W, C)
