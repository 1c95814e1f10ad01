"""Inputs made on the device from the seed: structured image pairs whose
thermal side is a random homography and a photometric change of the
optical side, and training batches built from them.

Every pair of a pool is distinct. Both the program and the reference are
handed the same tensors.
"""
import torch
import torch.nn.functional as F


def sub_seed(seed, tag):
    """The seed of one use (``tag``) of a run's ``--seed``: weights 1,
    inputs 2, the checked calls 3, the window's steps 9, the checked steps
    10 onwards."""
    return (int(seed) * 1000003 + tag) % (2 ** 63)


def _rand(gen, *shape, device):
    return torch.rand(shape, generator=gen, device=device)


def structured_images(n, H, W, gen, device, rects=12):
    """(n, H, W) in [0, 1]: blocks at two scales, a smooth field, random
    rectangles (edges and corners) and fine noise."""
    blocks = F.interpolate(_rand(gen, n, 1, H // 16, W // 16, device=device),
                           size=(H, W), mode="nearest")
    smooth = F.interpolate(_rand(gen, n, 1, max(H // 64, 2), max(W // 64, 2),
                                 device=device),
                           size=(H, W), mode="bilinear", align_corners=True)
    img = 0.45 * blocks[:, 0] + 0.35 * smooth[:, 0]
    ys = torch.arange(H, device=device)[None, :, None]
    xs = torch.arange(W, device=device)[None, None, :]
    box = _rand(gen, rects, n, 5, device=device)
    for r in range(rects):
        y0, x0 = box[r, :, 0] * H * 0.8, box[r, :, 1] * W * 0.8
        h = (0.05 + 0.3 * box[r, :, 2]) * H
        w = (0.05 + 0.3 * box[r, :, 3]) * W
        inside = ((ys >= y0[:, None, None]) & (ys < (y0 + h)[:, None, None])
                  & (xs >= x0[:, None, None]) & (xs < (x0 + w)[:, None, None]))
        img = torch.where(inside, 0.6 * img + 0.4 * box[r, :, 4, None, None],
                          img)
    img = img + 0.03 * torch.randn(n, H, W, generator=gen, device=device)
    return img.clamp(0.0, 1.0)


def random_homographies(n, H, W, gen, device):
    """(n, 3, 3) maps of optical pixels (x, y, 1) to thermal pixels: a
    rotation of up to 0.3 rad, a scale in [0.85, 1.15], a perspective
    term and a shift of up to 6% of the side, about the image centre."""
    r = _rand(gen, n, 7, device=device) * 2.0 - 1.0
    ang, s = 0.3 * r[:, 0], 1.0 + 0.15 * r[:, 1]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    cos, sin = torch.cos(ang) * s, torch.sin(ang) * s
    z, o = torch.zeros_like(ang), torch.ones_like(ang)
    A = torch.stack([cos, -sin, z, sin, cos, z, z, z, o], -1).reshape(n, 3, 3)
    A[:, 2, 0] = 0.3 * r[:, 2] / W
    A[:, 2, 1] = 0.3 * r[:, 3] / H
    T = torch.eye(3, device=device).repeat(n, 1, 1)
    T[:, 0, 2], T[:, 1, 2] = cx + 0.06 * W * r[:, 4], cy + 0.06 * H * r[:, 5]
    C = torch.eye(3, device=device).repeat(n, 1, 1)
    C[:, 0, 2], C[:, 1, 2] = -cx, -cy
    return T @ A @ C


def _source_coords(h, H, W):
    """Pixel (x, y) of the source of each output pixel under h^-1."""
    ys, xs = torch.meshgrid(torch.arange(H, device=h.device, dtype=h.dtype),
                            torch.arange(W, device=h.device, dtype=h.dtype),
                            indexing="ij")
    p = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    q = torch.linalg.inv(h) @ p.T                              # (n, 3, HW)
    return (q[:, 0] / q[:, 2]).reshape(-1, H, W), (q[:, 1] / q[:, 2]).reshape(
        -1, H, W)


def warp(img, h):
    """out(q) = img(h^-1 q), bilinear, reflected at the border; and the
    mask of output pixels whose source lies inside the image."""
    n, H, W = img.shape
    sx, sy = _source_coords(h, H, W)
    grid = torch.stack([2.0 * sx / (W - 1) - 1.0, 2.0 * sy / (H - 1) - 1.0],
                       -1)
    out = F.grid_sample(img[:, None], grid, mode="bilinear",
                        padding_mode="reflection", align_corners=True)[:, 0]
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    return out, inside.float()


def pairs(n, H, W, gen, device, chunk=32):
    """n structured pairs: optical, thermal (n, H, W), the homographies
    (n, 3, 3) and the thermal side's valid mask (n, H, W); made ``chunk``
    at a time."""
    if n > chunk:
        parts = [pairs(min(chunk, n - i), H, W, gen, device)
                 for i in range(0, n, chunk)]
        return tuple(torch.cat(p) for p in zip(*parts))
    opt = structured_images(n, H, W, gen, device)
    h = random_homographies(n, H, W, gen, device)
    th, valid = warp(opt, h)
    g = _rand(gen, n, 2, device=device)
    th = (0.9 + 0.2 * g[:, :1, None]) * (1.0 - th ** 1.5) + 0.1 * g[:, 1:,
                                                                    None]
    th = th + 0.02 * torch.randn(n, H, W, generator=gen, device=device)
    return opt, th.clamp(0.0, 1.0), h, valid


def serve_pool(n_batches, batch, H, W, gen, device):
    """(n_batches, batch, H, W, 1) optical and thermal images."""
    opt, th, _, _ = pairs(n_batches * batch, H, W, gen, device)
    shape = (n_batches, batch, H, W, 1)
    return opt.reshape(shape), th.reshape(shape)


def _keypoint_map(pts, H, W):
    """(n, k, 2) (row, col) points, those inside the image set to 1 in an
    (n, H, W) map."""
    n, k, _ = pts.shape
    r, c = pts[..., 0].round().long(), pts[..., 1].round().long()
    ok = (r >= 0) & (r < H) & (c >= 0) & (c < W)
    flat = torch.where(ok, r * W + c, torch.zeros_like(r))
    m = torch.zeros(n, H * W, device=pts.device)
    m.scatter_(1, flat, ok.float())
    return m.reshape(n, H, W)


def _warp_pts(pts, h):
    xy = pts.flip(-1)
    hom = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    w = hom @ h.transpose(1, 2)
    return (w[..., :2] / w[..., 2:]).flip(-1)


def train_pool(n_batches, batch, H, W, n_kp, gen, device, hm_patch=128):
    """n_batches pair batches as the train step takes them: for each side
    'image' (B, H, W, 1), 'keypoints' and 'valid_mask' (B, H, W) and
    'homography' (B, 3, 3) (the identity on the optical side), and
    'hfour_points' (B, 4, 2), the centred patch's corner offsets."""
    n = n_batches * batch
    opt, th, h, valid = pairs(n, H, W, gen, device)
    pts = _rand(gen, n, n_kp, 2, device=device) * torch.tensor(
        [H - 1, W - 1], device=device, dtype=torch.float32)
    kp_o = _keypoint_map(pts, H, W)
    kp_t = _keypoint_map(_warp_pts(pts, h), H, W)
    ph, pw = min(hm_patch, H), min(hm_patch, W)
    x0, y0 = W // 2 - pw // 2, H // 2 - ph // 2
    corners = torch.tensor([[x0, y0], [x0 + pw, y0], [x0 + pw, y0 + ph],
                            [x0, y0 + ph]], device=device, dtype=torch.float32)
    moved = _warp_pts(corners.flip(-1)[None].expand(n, 4, 2), h).flip(-1)
    hfour = moved - corners
    eye = torch.eye(3, device=device).expand(n, 3, 3)
    out = []
    for i in range(n_batches):
        s = slice(i * batch, (i + 1) * batch)
        out.append({
            "optical": {"image": opt[s, ..., None].contiguous(),
                        "keypoints": kp_o[s], "valid_mask":
                        torch.ones_like(valid[s]),
                        "homography": eye[s].contiguous()},
            "thermal": {"image": th[s, ..., None].contiguous(),
                        "keypoints": kp_t[s], "valid_mask": valid[s],
                        "homography": h[s].contiguous()},
            "hfour_points": hfour[s].contiguous()})
    return out


def pick(gen_seed, n, k):
    """k distinct indices of range(n), drawn from ``gen_seed`` on the
    host, sorted."""
    g = torch.Generator().manual_seed(gen_seed)
    return sorted(torch.randperm(n, generator=g)[:k].tolist())

