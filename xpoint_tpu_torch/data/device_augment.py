"""On-device homographic augmentation for the pair train step (port of
``xpoint_tpu/data/device_augment.py:27-306``).

Homography sampling, image warping, valid masks, keypoint maps and the
RegNet input prep run on the device of the batch, batched over samples.
The quirks the JAX docstrings name are kept: keypoint casts truncate toward
zero, the unwarped side gets a dummy all-ones mask, and the HM corners are
mapped with NO homogeneous division. Draws come from the ``torch.Generator``
passed in; they follow the JAX sampler's distributions (transform set,
amplitudes, random order), not its bits.
"""
import math

import torch

from ..geometry.homography import compute_valid_mask_device
from ..ops.gridops import device_constant
from ..ops.warp import warp_image_batch

HM_PATCH = 128      # the host's RegNet input patch side


def _solve_h4(pts_src, pts_dst):
    """4-point homography fit (cv2.getPerspectiveTransform), batched: solve
    the 8x8 DLT system for H mapping pts_src -> pts_dst, both (n, 4, 2) in
    (x, y) pixel coords. Returns (n, 3, 3)."""
    x, y = pts_src[..., 0], pts_src[..., 1]
    u, v = pts_dst[..., 0], pts_dst[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=1)                   # (n, 8, 8)
    b = torch.cat([u, v], dim=1)                             # (n, 8)
    h = torch.linalg.solve_ex(A, b)[0]    # no error check: no host read
    return torch.cat([h, torch.ones_like(h[:, :1])], dim=1).reshape(-1, 3, 3)


def _uniform(gen, lo, hi):
    """U(min(lo, hi), max(lo, hi)) per element (the host sampler tolerates
    hi < lo)."""
    lo_, hi_ = torch.minimum(lo, hi), torch.maximum(lo, hi)
    return lo_ + (hi_ - lo_) * torch.rand(lo_.shape, generator=gen,
                                          device=lo_.device)


def _choose(gen, valid):
    """Index of a uniformly chosen True entry per row of (n, k) ``valid``
    (0 where a row has none)."""
    score = torch.rand(valid.shape, generator=gen, device=valid.device)
    return torch.where(valid, score, -1.0).argmax(1)


def _pick(options, idx):
    """options (n, k, 4, 2), idx (n,) -> (n, 4, 2)."""
    return options[torch.arange(options.shape[0], device=idx.device), idx]


def sample_homography_device(gen, n, image_shape, perspective=True,
                             scaling=True, rotation=True, translation=True,
                             n_scales=10, n_angles=25, scaling_amplitude=0.2,
                             perspective_amplitude_x=0.1,
                             perspective_amplitude_y=0.1, patch_ratio=0.8,
                             max_angle=math.pi / 2, allow_artifacts=True,
                             translation_overflow=0.1, **_ignored):
    """n random homographies (n, 3, 3) fp32 on the generator's device,
    mapping original -> warped pixel coords in cv2 (x=col, y=row)
    convention. The enabled transforms are applied to the patch corners in
    a random order per sample: every slot computes each transform for all
    samples and keeps the one the sample's permutation names (the JAX
    ``lax.switch`` under ``vmap``)."""
    dev = gen.device
    rand = lambda *shape: torch.rand(shape, generator=gen,  # noqa: E731
                                     device=dev)

    def t_perspective(points):
        t_min = -points.amin(1)
        t_max = 1.0 - points.amax(1)
        ty = torch.minimum(t_min[:, 1].abs(), t_max[:, 1].abs())
        amp = device_constant([perspective_amplitude_x,
                               perspective_amplitude_y],
                              dev).expand(points.shape[0], 2)
        amp_min, amp_max = -amp, amp
        if not allow_artifacts:
            t_min = torch.stack([t_min[:, 0], -ty], 1)
            t_max = torch.stack([t_max[:, 0], ty], 1)
            amp_min = torch.maximum(amp_min, t_min)
            amp_max = torch.minimum(amp_max, t_max)
        persp = _uniform(gen, amp_min[:, 1], amp_max[:, 1])
        h_left = _uniform(gen, amp_min[:, 0], amp_max[:, 0])
        h_right = _uniform(gen, amp_min[:, 0], amp_max[:, 0])
        disp = torch.stack([torch.stack([h_left, persp], 1),
                            torch.stack([h_left, -persp], 1),
                            torch.stack([h_right, persp], 1),
                            torch.stack([h_right, -persp], 1)], 1)
        return points + disp

    def t_scale(points):
        scales = 1.0 + (2 * rand(points.shape[0], n_scales) - 1) \
            * scaling_amplitude
        center = points.mean(1, keepdim=True)
        scaled = ((points - center)[:, None] * scales[:, :, None, None]
                  + center[:, None])                        # (n, S, 4, 2)
        if allow_artifacts:
            idx = torch.randint(0, n_scales, (points.shape[0],),
                                generator=gen, device=dev)
            return _pick(scaled, idx)
        valid = (scaled.amax((2, 3)) < 1.0) & (scaled.amin((2, 3)) >= 0.0)
        chosen = _pick(scaled, _choose(gen, valid))
        return torch.where(valid.any(1)[:, None, None], chosen, points)

    def t_translation(points):
        t_min = -points.amin(1)
        t_max = 1.0 - points.amax(1)
        if allow_artifacts:
            t_min = t_min - translation_overflow
            t_max = t_max + translation_overflow
        return points + _uniform(gen, t_min, t_max)[:, None, :]

    def t_rotation(points):
        angles = (2 * rand(points.shape[0], n_angles) - 1) * max_angle
        # the appended zero angle is the fallback slot (host parity)
        angles = torch.cat([angles, torch.zeros_like(angles[:, :1])], 1)
        center = points.mean(1, keepdim=True)
        c, s = torch.cos(angles), torch.sin(angles)
        rot = torch.stack([c, -s, s, c], -1).reshape(*angles.shape, 2, 2)
        rotated = (points - center)[:, None] @ rot + center[:, None]
        if allow_artifacts:
            idx = torch.randint(0, n_angles, (points.shape[0],),
                                generator=gen, device=dev)
            return _pick(rotated, idx)
        valid = (rotated.amax((2, 3)) < 1.0) & (rotated.amin((2, 3)) >= 0.0)
        return _pick(rotated, _choose(gen, valid))     # angle 0 always valid

    fns = [f for f, on in ((t_perspective, perspective), (t_scale, scaling),
                           (t_translation, translation),
                           (t_rotation, rotation)) if on]
    pts1 = device_constant([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]],
                           dev)
    margin = (1.0 - patch_ratio) * 0.5
    pts2 = (margin + patch_ratio * pts1).expand(n, 4, 2)
    if fns:
        perm = rand(n, len(fns)).argsort(1)
        for slot in range(len(fns)):
            options = torch.stack([f(pts2) for f in fns], 1)
            pts2 = _pick(options, perm[:, slot])
    # unit square -> pixels; (H, W) -> (x, y) = (W, H)
    shape = device_constant([image_shape[1], image_shape[0]], dev)
    return _solve_h4((pts1 * shape).expand(n, 4, 2), pts2 * shape)


def warp_keypoint_map(coords, valid, homography, image_shape):
    """Warp padded (row, col) keypoint coords (B, K, 2) by (B, 3, 3)
    homographies and scatter them to binary (B, H, W) maps: cv2 x/y
    convention, trunc-toward-zero int cast (homographies.py:479-495),
    bounds filter, padding mask ``valid`` (B, K)."""
    Hh, Ww = image_shape
    B = coords.shape[0]
    xy = torch.flip(coords.float(), dims=(-1,))
    p = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)     # (B, K, 3)
    p = (homography.float()[:, None] * p[:, :, None, :]).sum(-1)
    p = p[..., :2] / p[..., 2:3]
    rc = torch.flip(p, dims=(-1,))
    rci = rc.to(torch.int32)                                  # trunc to zero
    inb = ((rc[..., 0] >= 0) & (rc[..., 1] >= 0) & (rc[..., 0] < Hh)
           & (rc[..., 1] < Ww) & valid)
    flat = (rci[..., 0].clamp(0, Hh - 1).long() * Ww
            + rci[..., 1].clamp(0, Ww - 1).long())
    kp = torch.zeros(B, Hh * Ww, device=coords.device)
    kp.scatter_reduce_(1, flat, inb.float(), reduce="amax")
    return kp.reshape(B, Hh, Ww)


def keypoint_map_from_coords(coords, valid, image_shape):
    """Unwarped padded coords -> binary maps (generate_keypoint_map)."""
    eye = torch.eye(3, device=coords.device).expand(coords.shape[0], 3, 3)
    return warp_keypoint_map(coords, valid, eye, image_shape)


def prep_hm_input_device(optical, thermal, h_optical, h_thermal, top_left,
                         patch_size):
    """Batched port of ImagePairDataset.prep_hm_regression_input
    (image_pair.py:284-309) with its quirks: the corners are displaced by
    M = H_o @ H_t with NO homogeneous division and an int truncation, and
    the SAME crop window is cut from both augmented images.

    optical/thermal (B, H, W, 1) augmented images; h_* (B, 3, 3);
    top_left (x, y) as the host passes it; patch_size (h, w). Returns
    (hm_input (B, ph, pw, 2), hfour (B, 4, 2))."""
    ph, pw = patch_size
    a, b = top_left
    corners = device_constant([[a, b], [a + pw, b], [a + pw, b + ph],
                               [a, b + ph]], optical.device)  # tl tr br bl
    M = h_optical.float() @ h_thermal.float()
    ch = torch.cat([corners, torch.ones_like(corners[:, :1])], 1)  # (4, 3)
    p = (M[:, None] * ch[None, :, None, :]).sum(-1)[..., :2]
    hfour = p.to(torch.int32).float() - corners
    patch_o = optical[:, b:b + ph, a:a + pw]
    patch_t = thermal[:, b:b + ph, a:a + pw]
    return torch.cat([patch_o, patch_t], dim=-1), hfour


def make_pair_augment(image_shape, params, border_reflect=True,
                      valid_border_margin=0, mask_border=True,
                      hm_input=False):
    """Batched augmentation fn(gen, batch) -> batch for the pair train path
    (the host ImagePairDataset homographic branch): per sample ONE side
    (coin flip) is warped by a fresh random homography, the other keeps the
    identity. Keypoint maps come from the padded coords in the batch
    ('keypoint_coords' / 'keypoint_valid' per side), valid masks are
    analytic, and with ``hm_input`` the RegNet inputs 'hm_input' /
    'hfour_points' are prepared too."""
    Hh, Ww = image_shape
    pad_mode = "reflection" if border_reflect else "zeros"
    # the host's centred 128^2 patch, clamped to smaller images
    hm_patch = (min(HM_PATCH, Hh), min(HM_PATCH, Ww))
    hm_top_left = (Hh // 2 - hm_patch[0] // 2, Ww // 2 - hm_patch[1] // 2)

    def augment(gen, batch):
        B = batch['optical']['image'].shape[0]
        dev = batch['optical']['image'].device
        hs = sample_homography_device(gen, B, image_shape, **params)
        warp_optical = torch.rand(B, generator=gen, device=dev) < 0.5
        eye = torch.eye(3, device=dev).expand(B, 3, 3)
        sel = warp_optical[:, None, None]
        h_o = torch.where(sel, hs, eye)
        h_t = torch.where(sel, eye, hs)

        out = {'optical': dict(batch['optical']),
               'thermal': dict(batch['thermal'])}
        for side, h_side, warped in (('optical', h_o, warp_optical),
                                     ('thermal', h_t, ~warp_optical)):
            out[side]['image'] = warp_image_batch(
                batch[side]['image'], h_side, padding_mode=pad_mode)
            # the NON-warped side gets a dummy all-ones mask (host parity,
            # image_pair.py:238,242): no border erosion there
            mask = compute_valid_mask_device(
                h_side, image_shape, valid_border_margin * 2, mask_border)
            out[side]['valid_mask'] = torch.where(warped[:, None, None], mask,
                                                  torch.ones_like(mask))
            out[side]['homography'] = h_side
            if 'keypoint_coords' in batch[side]:
                out[side]['keypoints'] = warp_keypoint_map(
                    batch[side]['keypoint_coords'],
                    batch[side]['keypoint_valid'], h_side, image_shape)
                out[side].pop('keypoint_coords')
                out[side].pop('keypoint_valid')
        if hm_input:
            out['hm_input'], out['hfour_points'] = prep_hm_input_device(
                out['optical']['image'], out['thermal']['image'], h_o, h_t,
                hm_top_left, hm_patch)
        for k, v in batch.items():
            if k not in ('optical', 'thermal'):
                out.setdefault(k, v)
        return out

    return augment
