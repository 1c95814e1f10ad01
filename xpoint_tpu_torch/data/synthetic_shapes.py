"""SyntheticShapes: on-the-fly SuperPoint synthetic images with exact corner
ground truth, or their replay from a file (own copy of
``xpoint_tpu/data/synthetic_shapes.py``; the replay file, ``hdf5-file``, is
HDF5 or ``.npz`` by its suffix, ``data/group_file.py``).

A random blob background and one primitive at ``generation_size``, a
Gaussian blur (and an extra one for a simulated thermal image), a resize to
``image_size`` with the keypoints rescaled, then photometric and homographic
augmentation. Samples are numpy dicts: image (H, W, 1) float32 in [0, 1],
keypoints an (H, W) bool map or (n, 2) (row, col) coordinates, valid_mask
(H, W) bool, is_optical (1,) bool.

``sample(index, rng, py_rng)`` draws from the generators passed in, in the
JAX package's order (see ``data/seeding.py``).
"""
import copy

import cv2
import numpy as np

from ..utils import dict_update, generate_keypoint_map, parse_primitives
from . import draw_primitives
from .augmentation import (dummy_valid_mask, homographic_augmentation,
                           photometric_augmentation)
from .group_file import open_group_file
from .seeding import SeededSamples

DEFAULT_CONFIG = {
    'length': 1000,
    'primitives': 'all',
    'on-the-fly': True,
    'hdf5-file': None,
    'generation_size': [960, 1280],
    'image_size': [240, 320],
    'keypoints_as_map': True,
    'generation': {
        'min_contrast': 0.1,
        'generate_background': {
            'min_kernel_size': 150, 'max_kernel_size': 500,
            'min_rad_ratio': 0.02, 'max_rad_ratio': 0.031},
        'draw_lines': {'nb_lines': 10},
        'draw_polygons': {'max_sides': 8},
        'draw_stripes': {'transform_params': (0.1, 0.1)},
        'draw_multiple_polygons': {'kernel_boundaries': (50, 100)},
    },
    'processing': {
        'blur_size': 21,
        'additional_ir_blur': True,
        'additional_ir_blur_size': 51,
    },
    'augmentation': {
        'photometric': {'enable': True, 'primitives': 'all', 'params': {},
                        'random_order': True},
        'homographic': {'enable': True, 'params': {}, 'border_reflect': True,
                        'valid_border_margin': 0, 'mask_border': True},
    },
}

ALL_PRIMITIVES = [
    'draw_lines', 'draw_polygon', 'draw_multiple_polygons', 'draw_ellipses',
    'draw_star', 'draw_checkerboard', 'draw_stripes', 'draw_cube',
    'gaussian_noise',
]


class SyntheticShapes(SeededSamples):
    def __init__(self, config=None):
        self.config = dict_update(copy.deepcopy(DEFAULT_CONFIG), config or {})
        self.primitives = parse_primitives(self.config['primitives'],
                                           ALL_PRIMITIVES)
        if not self.config['on-the-fly']:
            with open_group_file(self.config['hdf5-file']) as f:
                self.memberslist = list(f.keys())
                self.config['length'] = len(self.memberslist)

    def generate_synthetic_image(self, rng, py_rng):
        is_optical = bool(py_rng.randint(0, 1))
        gen = self.config['generation']
        image = draw_primitives.generate_background(
            rng, py_rng, shape=self.config['generation_size'],
            **gen['generate_background'])
        primitive = rng.choice(self.primitives)
        keypoints = getattr(draw_primitives, primitive)(
            image, rng, py_rng, min_contrast=gen['min_contrast'],
            **gen.get(primitive, {}))
        keypoints = np.flip(np.asarray(keypoints).reshape(-1, 2), 1)  # (r, c)

        bs = self.config['processing']['blur_size']
        image = cv2.GaussianBlur(image, (bs, bs), 0)
        if not is_optical and self.config['processing']['additional_ir_blur']:
            ir = self.config['processing']['additional_ir_blur_size']
            image = cv2.GaussianBlur(image, (ir, ir), 0)

        if self.config['generation_size'] != self.config['image_size']:
            image = cv2.resize(image, tuple(self.config['image_size'][::-1]),
                               interpolation=cv2.INTER_LINEAR)
            scale = (np.array(self.config['image_size'], dtype=np.float64)
                     / np.array(self.config['generation_size']))
            keypoints = (scale * keypoints).round().astype(int)
        return image.astype(np.float32), keypoints, is_optical

    def get_hdf5_image(self, index):
        with open_group_file(self.config['hdf5-file'], swmr=True) as f:
            sample = f[self.memberslist[index]]
            image = np.asarray(sample['image'], dtype=np.float32) / 255.0
            keypoints = np.asarray(sample['points'], dtype=np.float32)
        return image, keypoints, True

    def sample(self, index, rng, py_rng):
        if self.config['on-the-fly']:
            image, keypoints, is_optical = self.generate_synthetic_image(
                rng, py_rng)
        else:
            image, keypoints, is_optical = self.get_hdf5_image(index)

        h, w = self.config['image_size']
        if len(keypoints):
            keypoints = keypoints.copy()
            keypoints[keypoints[:, 0] >= h, 0] = h - 1
            keypoints[keypoints[:, 1] >= w, 1] = w - 1

        aug = self.config['augmentation']
        if aug['photometric']['enable']:
            image = photometric_augmentation(image, rng, py_rng,
                                             **aug['photometric'])
        if aug['homographic']['enable']:
            image, keypoints, valid_mask = homographic_augmentation(
                image, rng, keypoints, **aug['homographic'])
        else:
            valid_mask = dummy_valid_mask(image.shape)

        if self.config['keypoints_as_map']:
            keypoints = generate_keypoint_map(keypoints, image.shape)

        return {
            'image': image.astype(np.float32)[..., None],
            'keypoints': np.asarray(keypoints),
            'valid_mask': valid_mask.astype(bool),
            'is_optical': np.array([is_optical]),
        }

    def returns_pair(self):
        return False

    def __len__(self):
        return self.config['length']
