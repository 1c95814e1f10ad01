"""Homography image warping by explicit gather (port of
``xpoint_tpu/ops/warp.py``: ``warp_image_batch``, ``warp_image_multi`` and
their helpers).

Convention: a homography ``H`` maps SOURCE pixel coords to DESTINATION
pixel coords in cv2 (x=col, y=row) order, as cv2.warpPerspective does. The
warp samples ``out[y, x] = src(H^-1 @ [x, y, 1])`` at exact pixel positions
(align_corners=True), bilinear or nearest (round half to even).

Padding modes: 'zeros' and 'reflection' (mirror about pixel centers,
cv2.BORDER_REFLECT_101). This is an explicit gather in pixel coordinates.
``F.grid_sample`` with ``align_corners=True`` computes the same function
from normalised coordinates (its 'reflection' padding then mirrors about
the border pixels' centres, which is REFLECT_101; its 'nearest' rounds half
to even); the port does not call it, ``chip_smoke.py`` times it beside the
kernel.

These functions are also the plain versions of the projective-warp kernel
(``ops/warp_projective.py``, ``csrc/warp_projective.cu``): the kernel forms the
source coordinates with the same fp32 operations in the same order, so that
the nearest-mode rounding and the bounds tests agree pixel for pixel.
"""
import torch

# Projective division gives inf where the homography's horizon line crosses
# the output canvas and nan at its principal point; one such pixel would
# NaN a train step. cv2 saturates these coords to finite values; so does
# this (a finite out-of-image magnitude, exact in fp32).
_COORD_MAX = 1e7
MODES = ("bilinear", "nearest")
PADDING_MODES = ("zeros", "reflection")


def _finite_coords(c):
    c = torch.nan_to_num(c, nan=-_COORD_MAX, posinf=_COORD_MAX,
                         neginf=-_COORD_MAX)
    return c.clamp(-_COORD_MAX, _COORD_MAX)


def _reflect_101(coord, size):
    """Reflect a coordinate into [0, size-1] without repeating the edge."""
    period = 2.0 * (size - 1.0)
    coord = torch.remainder(coord, period)
    return torch.where(coord > (size - 1.0), period - coord, coord)


def inverse_homographies(homographies):
    """(n, 3, 3) -> the fp32 inverses the warps sample through."""
    return torch.linalg.inv(homographies.float())


def _source_coords_from_inverse(Hinv, H_out, W_out):
    """(n, 3, 3) inverse homographies -> source sample positions (ys, xs),
    each (n, H_out*W_out), fp32. Every product, sum and quotient is rounded
    on its own, left to right."""
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


def _source_coords(homographies, H_out, W_out):
    """(n, 3, 3) -> per-homography source sample positions (ys, xs), each
    (n, H_out*W_out), fp32."""
    return _source_coords_from_inverse(inverse_homographies(homographies),
                                       H_out, W_out)


def _gather(flat, yi, xi, H, W, padding_mode):
    """flat (n, H*W, C); yi/xi (n, P) int -> (n, P, C), zero outside the
    image in 'zeros' mode."""
    yc = yi.clamp(0, H - 1)
    xc = xi.clamp(0, W - 1)
    idx = (yc * W + xc).unsqueeze(-1).expand(-1, -1, flat.shape[-1])
    vals = torch.gather(flat, 1, idx)
    if padding_mode == "zeros":
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        vals = vals * inb.unsqueeze(-1).to(vals.dtype)
    return vals


def check_modes(mode, padding_mode):
    if mode not in MODES:
        raise ValueError(f"unknown interpolation mode: {mode}")
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unknown padding mode: {padding_mode}")


def warp_from_inverse(src, Hinv, mode, padding_mode):
    """src (n, H, W, C) (an expanded view will do), Hinv (n, 3, 3) fp32
    inverse homographies -> (n, H, W, C)."""
    check_modes(mode, padding_mode)
    n, H, W, C = src.shape
    ys, xs = _source_coords_from_inverse(Hinv, H, W)
    if padding_mode == "reflection":
        ys = _reflect_101(ys, H)
        xs = _reflect_101(xs, W)
    flat = src.reshape(n, H * W, C)
    g = lambda yi, xi: _gather(flat, yi, xi, H, W,  # noqa: E731
                               padding_mode)
    if mode == "nearest":
        out = g(torch.round(ys).long(), torch.round(xs).long())
    else:
        y0 = torch.floor(ys)
        x0 = torch.floor(xs)
        wy = (ys - y0).unsqueeze(-1)
        wx = (xs - x0).unsqueeze(-1)
        y0i = y0.long()
        x0i = x0.long()
        top = g(y0i, x0i) * (1 - wx) + g(y0i, x0i + 1) * wx
        bot = g(y0i + 1, x0i) * (1 - wx) + g(y0i + 1, x0i + 1) * wx
        out = top * (1 - wy) + bot * wy
    return out.reshape(n, H, W, C)


def warp_image_batch(images, homographies, mode="bilinear",
                     padding_mode="zeros"):
    """Per-sample warp: images (n, H, W, C), homographies (n, 3, 3) ->
    (n, H, W, C)."""
    return warp_from_inverse(images, inverse_homographies(homographies),
                             mode, padding_mode)


def multi_source(images, n):
    """(B, H, W, C) -> the (n, H, W, B*C) expanded view in which a warp of
    the same image batch by n homographies is a per-sample warp: the index
    maps are shared over batch and channel."""
    B, H, W, C = images.shape
    return images.permute(1, 2, 0, 3).reshape(1, H, W, B * C).expand(
        n, H, W, B * C)


def warp_image_multi(images, homographies, mode="bilinear",
                     padding_mode="zeros"):
    """Warp the SAME image batch by MANY homographies (the homographic-
    adaptation inner loop): images (B, H, W, C), homographies (n, 3, 3) ->
    (n, B, H, W, C)."""
    B, H, W, C = images.shape
    n = homographies.shape[0]
    out = warp_from_inverse(multi_source(images, n),
                            inverse_homographies(homographies), mode,
                            padding_mode)
    return out.reshape(n, H, W, B, C).permute(0, 3, 1, 2, 4)
