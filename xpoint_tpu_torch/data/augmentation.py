"""Augmentation on the host (own copy of ``xpoint_tpu/data/augmentation.py``):
photometric primitives in a shuffled order; the homographic warp
(BORDER_REFLECT_101 or constant), the valid mask with border erosion,
keypoint warp and filter.

The warp and the mask take the JAX package's default path, the native
engine (``native.homographic_augment``: warp, mask and erosion in one C
call); with ``XPOINT_NO_NATIVE`` set they take its other path,
``cv2.warpPerspective`` and ``compute_valid_mask``. The two differ on
about 1% of the mask's pixels at most, and on warped pixels by cv2's
rounding of sample positions to 1/32 pixel where OpenCV rounds (OpenCV 4,
and OpenCV 5 on float64 images: up to ~2e-2 at edges); the engine samples
exactly. Unlike the JAX package, a failed engine build raises instead of
taking cv2.

Randomness comes from the generators passed in: ``rng``, a
``np.random.RandomState`` in place of the global ``np.random`` stream, and
``py_rng``, a ``random.Random`` in place of the global ``random`` one. Where
the JAX package seeds a ``np.random.Generator`` from the global stream (the
homography samplers), it is seeded here from ``rng`` by the same draw.
"""
import os

import cv2
import numpy as np

from ..geometry.homography import (compute_valid_mask, filter_points,
                                   sample_homography,
                                   sample_homography_corner, warp_keypoints)
from .. import native
from ..utils import parse_primitives
from . import photometric as photoaug


def photometric_augmentation(image, rng, py_rng, primitives='all',
                             params=None, random_order=True, enable=True):
    prims = parse_primitives(primitives, photoaug.augmentations)
    configs = [(params or {}).get(p, {}) for p in prims]
    order = list(range(len(prims)))
    if random_order:
        py_rng.shuffle(order)
    for idx in order:
        image = getattr(photoaug, prims[idx])(image, rng, **configs[idx])
    return image


def homographic_augmentation(image, rng, keypoints=None,
                             return_homography=False, params=None,
                             border_reflect=True, valid_border_margin=0,
                             mask_border=True, enable=True):
    params = dict(params or {})
    corner = params.pop('corner_homography', None)
    image_shape = image.shape
    sampler_rng = np.random.default_rng(rng.randint(0, 2**31))
    if corner and corner.get('enable'):
        homography = sample_homography_corner(image_shape, corner['params'],
                                              rng=sampler_rng)
    else:
        homography = sample_homography(image_shape, rng=sampler_rng,
                                       **params)

    if not os.environ.get('XPOINT_NO_NATIVE'):
        warped_image, valid_mask = native.homographic_augment(
            image, homography, border_reflect, valid_border_margin * 2,
            mask_border)
    else:
        border_mode = (cv2.BORDER_REFLECT_101 if border_reflect
                       else cv2.BORDER_CONSTANT)
        warped_image = cv2.warpPerspective(image, homography,
                                           image.shape[::-1],
                                           borderMode=border_mode)
        valid_mask = compute_valid_mask(image_shape, homography,
                                        valid_border_margin * 2, mask_border)

    if keypoints is not None and np.size(keypoints) > 0:
        warped_points = warp_keypoints(keypoints, homography)
        warped_points = filter_points(warped_points, image_shape)
    else:
        warped_points = keypoints

    if return_homography:
        return warped_image, warped_points, valid_mask, homography
    return warped_image, warped_points, valid_mask


def dummy_valid_mask(image_shape):
    return np.ones(image_shape)
