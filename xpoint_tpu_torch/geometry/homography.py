"""Homography sampling and point warping (port of
``xpoint_tpu/geometry/homography.py``).

Host side (numpy and cv2, for the data path and homographic adaptation):
``sample_homography`` and ``sample_homography_corner`` (the same draws from
the same ``np.random.Generator`` in the same order as the JAX package's,
and the same ``cv2.getPerspectiveTransform`` fit, so one seed gives the
same matrix bit for bit), ``warp_keypoints``, ``filter_points`` and
``compute_valid_mask``.

Device side (tensors): ``compute_valid_mask_device`` and ``warp_points``.
"""
from math import pi

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import _source_coords


def sample_homography(image_shape, perspective=True, scaling=True,
                      rotation=True, translation=True, n_scales=10,
                      n_angles=25, scaling_amplitude=0.2,
                      perspective_amplitude_x=0.1,
                      perspective_amplitude_y=0.1, patch_ratio=0.8,
                      max_angle=pi / 2, allow_artifacts=True,
                      translation_overflow=0.1, rng=None):
    """Sample a random homography as a perturbation of the unit square.

    The output patch corners start as a centered ``patch_ratio`` square and
    are perturbed by perspective / scale / translation / rotation transforms
    applied in a random order; the result is rescaled to pixel units and
    fitted with a 4-point perspective transform.

    Args:
        image_shape: (H, W) of the image the homography will warp.
        rng: ``np.random.Generator``; None seeds one from the global
            ``np.random`` stream, as the JAX package does.

    Returns:
        (3, 3) float64 homography mapping original -> warped pixel coords
        in cv2 (x=col, y=row) convention.
    """
    if rng is None:
        rng = np.random.default_rng(np.random.randint(0, 2**31))

    def _uniform(lo, hi):
        # Generator.uniform does not take hi < lo
        return rng.uniform(min(lo, hi), max(lo, hi))

    def transform_perspective(points):
        t_min, t_max = -points.min(axis=0), 1.0 - points.max(axis=0)
        t_max[1] = min(abs(t_min[1]), abs(t_max[1]))
        t_min[1] = -t_max[1]
        amp = np.array([perspective_amplitude_x, perspective_amplitude_y])
        if not allow_artifacts:
            amp_min = np.maximum(-amp, t_min)
            amp_max = np.minimum(amp, t_max)
        else:
            amp_min, amp_max = -amp, amp
        persp_disp = _uniform(amp_min[1], amp_max[1])
        h_left = _uniform(amp_min[0], amp_max[0])
        h_right = _uniform(amp_min[0], amp_max[0])
        return points + np.array([[h_left, persp_disp],
                                  [h_left, -persp_disp],
                                  [h_right, persp_disp],
                                  [h_right, -persp_disp]])

    def transform_scale(points):
        scales = rng.uniform(-scaling_amplitude, scaling_amplitude,
                             n_scales) + 1.0
        center = points.mean(axis=0)
        scaled = (points - center)[None] * scales[:, None, None] + center
        if allow_artifacts:
            valid = np.arange(n_scales)
        else:
            valid = [i for i in range(n_scales)
                     if scaled[i].max() < 1.0 and scaled[i].min() >= 0.0]
            if not valid:
                return points
        return scaled[rng.choice(valid)]

    def transform_translation(points):
        t_min, t_max = -points.min(axis=0), 1.0 - points.max(axis=0)
        if allow_artifacts:
            t_min = t_min - translation_overflow
            t_max = t_max + translation_overflow
        return points + np.array([_uniform(t_min[0], t_max[0]),
                                  _uniform(t_min[1], t_max[1])])

    def transform_rotation(points):
        angles = rng.uniform(-max_angle, max_angle, n_angles)
        angles = np.append(angles, 0)  # fallback: no rotation
        center = points.mean(axis=0)
        rot = np.stack([np.cos(angles), -np.sin(angles),
                        np.sin(angles), np.cos(angles)],
                       axis=1).reshape(-1, 2, 2)
        rotated = np.matmul((points - center)[None], rot) + center
        if allow_artifacts:
            valid = np.arange(n_angles)
        else:
            valid = [i for i in range(len(angles))
                     if rotated[i].max() < 1.0 and rotated[i].min() >= 0.0]
        return rotated[rng.choice(valid)]

    pts1 = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]])
    margin = (1 - patch_ratio) * 0.5
    pts2 = margin + patch_ratio * pts1

    functions = []
    if perspective:
        functions.append(transform_perspective)
    if scaling:
        functions.append(transform_scale)
    if translation:
        functions.append(transform_translation)
    if rotation:
        functions.append(transform_rotation)

    for idx in rng.permutation(len(functions)):
        pts2 = functions[idx](pts2)

    # rescale unit square to pixel units; shape is (H, W) -> (x, y) = (W, H)
    shape = np.asarray(image_shape)[::-1]
    pts1 = (pts1 * shape).astype(np.float32)
    pts2 = (pts2 * shape).astype(np.float32)
    return cv2.getPerspectiveTransform(pts1, pts2).astype(np.float64)


def sample_homography_corner(image_shape, config, rng=None):
    """DeepHomography-style +-rho corner jitter of a random patch of
    ``config['patch_size']``; returns the INVERSE of the patch's
    homography, as the JAX package does. ``rng``: ``np.random.Generator``;
    None seeds one from the global ``np.random`` stream."""
    if rng is None:
        rng = np.random.default_rng(np.random.randint(0, 2**31))
    imsize = (image_shape[1], image_shape[0])
    rho = config["rho"]
    patch_size = config["patch_size"]
    pos = (int(rng.integers(rho, imsize[0] - rho - patch_size + 1)),
           int(rng.integers(rho, imsize[1] - rho - patch_size + 1)))
    four_points = [pos,
                   (pos[0] + patch_size, pos[1]),
                   (pos[0] + patch_size, pos[1] + patch_size),
                   (pos[0], pos[1] + patch_size)]
    perturbed = [(p[0] + int(rng.integers(-rho, rho + 1)),
                  p[1] + int(rng.integers(-rho, rho + 1)))
                 for p in four_points]
    H = cv2.getPerspectiveTransform(np.float32(four_points),
                                    np.float32(perturbed))
    return np.linalg.inv(H)


def warp_keypoints(keypoints, homography, return_type=int):
    """(n, 2) (row, col) keypoints warped by a pixel-space homography (cv2
    x/y convention), cast to ``return_type``."""
    if len(keypoints) > 0:
        warped = cv2.perspectiveTransform(
            np.array([keypoints[:, ::-1]], dtype=np.float64), homography)
        return warped[0, :, ::-1].astype(return_type)
    return keypoints


def filter_points(points, shape):
    """The (row, col) points inside [0, shape)."""
    points = points[points[:, 0] >= 0]
    points = points[points[:, 1] >= 0]
    points = points[points[:, 0] < shape[0]]
    points = points[points[:, 1] < shape[1]]
    return points


def compute_valid_mask(image_shape, homography, erosion_radius=0,
                       mask_border=False):
    """Valid-pixel mask of a warp: an all-ones image warped with cv2
    (nearest), eroded by a (2r+1)^2 square, the image edge counted as
    invalid with ``mask_border``. (H, W) float64."""
    mask = cv2.warpPerspective(np.ones(image_shape), homography,
                               image_shape[::-1], flags=cv2.INTER_NEAREST)
    if erosion_radius > 0:
        if mask_border:
            tmp = np.zeros((image_shape[0] + 2, image_shape[1] + 2))
            tmp[1:-1, 1:-1] = mask
            mask = tmp
        kernel = np.ones((erosion_radius * 2 + 1, erosion_radius * 2 + 1),
                         np.float32)
        mask = cv2.erode(mask, kernel, iterations=1)
        if mask_border:
            mask = mask[1:-1, 1:-1]
    return mask


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
