"""space_to_depth / depth_to_space in NHWC (port of
``xpoint_tpu/ops/gridops.py``).

The depth channel order is (i, j, c) with c minor: channel
``(i * r + j) * C + c`` holds spatial offset (i, j), channel c. That is
not ``nn.PixelShuffle``'s / ``F.pixel_unshuffle``'s (c, i, j) order; the two
agree only for C == 1.
"""


def space_to_depth(x, block_size):
    """(B, H, W) or (B, H, W, C) -> (B, H/r, W/r, r*r*C)."""
    if x.ndim == 3:
        x = x[..., None]
    B, H, W, C = x.shape
    r = block_size
    x = x.reshape(B, H // r, r, W // r, r, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // r, W // r, r * r * C)


def depth_to_space(x, block_size):
    """(B, H', W', r*r*C) -> (B, H'*r, W'*r, C)."""
    B, Hc, Wc, C = x.shape
    r = block_size
    c_out = C // (r * r)
    x = x.reshape(B, Hc, Wc, r, r, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hc * r, Wc * r, c_out)
