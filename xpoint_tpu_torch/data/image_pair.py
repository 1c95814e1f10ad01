"""ImagePairDataset: optical/thermal pairs from HDF5 or image folders (own
copy of ``xpoint_tpu/data/image_pair.py``):

  * HDF5 layout sample/{optical, thermal, thermal_raw}, or the folder
    layout optical/ + thermal/ (or images/) of PNG/JPG files;
  * optional keypoint labels from HDF5 ('keypoints', or
    'keypoints_optical' + 'keypoints_thermal');
  * a random crop to (h//32*32, w//32*32) with keypoint shift and filter;
  * datasets whose path names ReDFeat resized so that both sides are at
    least 256 (or the crop height);
  * single_image mode picks a random spectrum; pair mode warps ONE randomly
    chosen side with a sampled homography and gives per-side homography,
    valid_mask and keypoint maps plus the homography-regression inputs;
  * random_pairs swaps spectra (the keypoints deliberately stay unswapped,
    as in the JAX package).

Samples are numpy dicts with NHWC images in [0, 1]. ``sample(index, rng,
py_rng)`` draws from the generators passed in, in the JAX package's order
(see ``data/seeding.py``). ``h5py`` is imported where a file is opened: the
folder layout needs only cv2.
"""
import copy
import math
import os

import cv2
import numpy as np

from ..utils import dict_update, generate_keypoint_map
from .augmentation import (dummy_valid_mask, homographic_augmentation,
                           photometric_augmentation)
from .seeding import SeededSamples

DEFAULT_CONFIG = {
    'filename': None,
    'foldername': None,
    'keypoints_filename': None,
    'height': -1,
    'width': -1,
    'raw_thermal': False,
    'single_image': True,
    'random_pairs': False,
    'return_name': True,
    'augmentation': {
        'photometric': {'enable': False, 'primitives': 'all', 'params': {},
                        'random_order': True},
        'homographic': {'enable': False, 'params': {}, 'border_reflect': True,
                        'valid_border_margin': 0, 'mask_border': True},
    },
}


class ImagePairDataset(SeededSamples):
    def __init__(self, config):
        self.config = dict_update(copy.deepcopy(DEFAULT_CONFIG), config or {})
        if ((self.config['filename'] is None)
                == (self.config['foldername'] is None)):
            raise ValueError(
                "ImagePairDataset: filename XOR foldername required")

        self.data_is_file = self.config['filename'] is not None
        if self.data_is_file:
            import h5py
            self.data_path = self.config['filename']
            with h5py.File(self.data_path, 'r') as f:
                self.memberslist = list(f.keys())
        else:
            root = self.config['foldername']
            optical_dir = os.path.join(root, 'optical')
            thermal_dir = os.path.join(root, 'thermal')
            images_dir = os.path.join(root, 'images')
            if os.path.isdir(optical_dir) and os.path.isdir(thermal_dir):
                self.data_path = (optical_dir, thermal_dir)
            elif os.path.isdir(images_dir):
                self.data_path = (images_dir, images_dir)
            else:
                raise ValueError(
                    f"Folder structure is not correct under {root}: expected "
                    "optical/ + thermal/ or images/")
            self.memberslist = sorted(
                f for f in os.listdir(self.data_path[0])
                if f.endswith('.jpg') or f.endswith('.png'))
        self.num_files = len(self.memberslist)

        # every member needs a label group of its own name
        if self.config['keypoints_filename'] is not None:
            import h5py
            with h5py.File(self.config['keypoints_filename'], 'r') as kf:
                keys = set(kf.keys())
            missing = [m for m in self.memberslist if m not in keys]
            if missing:
                raise IndexError(
                    f"Labels missing for {len(missing)} samples "
                    f"(first 10: {missing[:10]})")

    def _load_images(self, index):
        if self.data_is_file:
            import h5py
            with h5py.File(self.data_path, 'r', swmr=True) as f:
                sample = f[self.memberslist[index]]
                optical = sample['optical'][...]
                if 'thermal' in sample or 'thermal_raw' in sample:
                    key = ('thermal_raw' if self.config['raw_thermal']
                           else 'thermal')
                    thermal = sample[key][...]
                else:
                    thermal = optical.copy()
        else:
            def read_gray(d, name):
                img = cv2.imread(os.path.join(d, name))
                return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) / 255.0
            optical = read_gray(self.data_path[0], self.memberslist[index])
            thermal = read_gray(self.data_path[1], self.memberslist[index])
        if thermal.shape != optical.shape:
            raise ValueError("optical and thermal images must share a shape")
        return np.asarray(optical, np.float64), np.asarray(thermal, np.float64)

    def _load_keypoints(self, index):
        if self.config['keypoints_filename'] is None:
            return None
        import h5py
        with h5py.File(self.config['keypoints_filename'], 'r',
                       swmr=True) as kf:
            grp = kf[self.memberslist[index]]
            if 'keypoints_optical' in grp:
                return [np.array(grp['keypoints_optical']),
                        np.array(grp['keypoints_thermal'])]
            return np.array(grp['keypoints'])

    @staticmethod
    def resize_image_and_keypoints(image, keypoints=None, min_size=256):
        """Upscale so that both sides are >= min_size; keypoints (x, y)
        scaled with the image and clipped to it."""
        h, w = image.shape[:2]
        if h >= min_size and w >= min_size:
            if keypoints is not None and len(keypoints):
                keypoints = keypoints.copy()
                keypoints[:, 0] = np.clip(keypoints[:, 0], 0, w - 1)
                keypoints[:, 1] = np.clip(keypoints[:, 1], 0, h - 1)
            return image, keypoints
        scale = max(min_size / h if h < min_size else 1,
                    min_size / w if w < min_size else 1)
        new_w = max(int(math.ceil(w * scale)), min_size)
        new_h = max(int(math.ceil(h * scale)), min_size)
        resized = cv2.resize(image, (new_w, new_h),
                             interpolation=cv2.INTER_LINEAR)
        if keypoints is not None and len(keypoints):
            kp = keypoints.astype(np.float64).copy()
            kp[:, 0] = np.clip(kp[:, 0] * (new_w / w), 0, new_w - 1)
            kp[:, 1] = np.clip(kp[:, 1] * (new_h / h), 0, new_h - 1)
            keypoints = kp.astype(np.int64)
        return resized, keypoints

    def _crop(self, optical, thermal, keypoints, py_rng):
        """Random crop to multiples of 32 with keypoint shift/filter."""
        if self.config['height'] > 0:
            h = self.config['height'] // 32 * 32
        else:
            h = thermal.shape[0]
        if self.config['width'] > 0:
            w = self.config['width'] // 32 * 32
        else:
            w = thermal.shape[1]
        if w > thermal.shape[1] or h > thermal.shape[0]:
            raise ValueError("requested crop exceeds image size")
        i_h = py_rng.randint(0, thermal.shape[0] - h)
        i_w = py_rng.randint(0, thermal.shape[1] - w)
        optical = optical[i_h:i_h + h, i_w:i_w + w]
        thermal = thermal[i_h:i_h + h, i_w:i_w + w]

        def shift_filter(kp):
            if kp is None or len(kp) == 0:
                return kp
            kp = kp - np.array([[i_h, i_w]])
            keep = ((kp[:, 0] >= 0) & (kp[:, 0] < h)
                    & (kp[:, 1] >= 0) & (kp[:, 1] < w))
            return kp[keep]

        if keypoints is not None:
            if isinstance(keypoints, list):
                keypoints = [shift_filter(keypoints[0]),
                             shift_filter(keypoints[1])]
            else:
                keypoints = shift_filter(keypoints)
        return optical, thermal, keypoints, (h, w)

    def sample(self, index, rng, py_rng):
        optical, thermal = self._load_images(index)
        keypoints = self._load_keypoints(index)
        path = (self.config['filename'] if self.data_is_file
                else self.config['foldername'])

        if 'redfeat' in str(path).lower():
            minsize = self.config['height'] if self.config['height'] > 0 \
                else 256
            if isinstance(keypoints, list):
                optical, keypoints[0] = self.resize_image_and_keypoints(
                    optical, keypoints[0], minsize)
                thermal, keypoints[1] = self.resize_image_and_keypoints(
                    thermal, keypoints[1], minsize)
            else:
                optical, keypoints = self.resize_image_and_keypoints(
                    optical, keypoints, minsize)
                thermal, _ = self.resize_image_and_keypoints(thermal, None,
                                                             minsize)

        if self.config['height'] > 0 or self.config['width'] > 0:
            optical, thermal, keypoints, (h, w) = self._crop(
                optical, thermal, keypoints, py_rng)
        else:
            h, w = thermal.shape[:2]

        aug = self.config['augmentation']
        out = {}
        if self.config['single_image']:
            is_optical = bool(py_rng.randint(0, 1))
            image = optical if is_optical else thermal
            kp = None
            if keypoints is not None:
                kp = keypoints[0 if is_optical else 1] \
                    if isinstance(keypoints, list) else keypoints
            if aug['photometric']['enable']:
                image = photometric_augmentation(image, rng, py_rng,
                                                 **aug['photometric'])
            if aug['homographic']['enable']:
                image, kp, valid_mask = homographic_augmentation(
                    image, rng, kp, **aug['homographic'])
            else:
                valid_mask = dummy_valid_mask(image.shape)
            out['image'] = image.astype(np.float32)[..., None]
            out['valid_mask'] = valid_mask.astype(bool)
            out['is_optical'] = np.array([is_optical])
            if kp is not None:
                out['keypoints'] = generate_keypoint_map(kp, (h, w))
        else:
            out['optical'], out['thermal'] = {}, {}
            optical_is_optical, thermal_is_optical = True, False
            if self.config['random_pairs']:
                tmp_o, tmp_t = optical, thermal
                if bool(py_rng.randint(0, 1)):
                    optical, optical_is_optical = tmp_t, False
                if bool(py_rng.randint(0, 1)):
                    thermal, thermal_is_optical = tmp_o, True

            if aug['photometric']['enable']:
                optical = photometric_augmentation(optical, rng, py_rng,
                                                   **aug['photometric'])
                thermal = photometric_augmentation(thermal, rng, py_rng,
                                                   **aug['photometric'])

            kp_pair = keypoints if isinstance(keypoints, list) \
                else [keypoints, keypoints]
            if aug['homographic']['enable']:
                if bool(py_rng.randint(0, 1)):
                    # warp the optical side
                    vm_t = dummy_valid_mask(thermal.shape)
                    kp_t = kp_pair[1]
                    optical, kp_o, vm_o, H = homographic_augmentation(
                        optical, rng, kp_pair[0], return_homography=True,
                        **aug['homographic'])
                    out['optical']['homography'] = H.astype(np.float32)
                    out['thermal']['homography'] = np.eye(3, dtype=np.float32)
                else:
                    vm_o = dummy_valid_mask(optical.shape)
                    kp_o = kp_pair[0]
                    thermal, kp_t, vm_t, H = homographic_augmentation(
                        thermal, rng, kp_pair[1], return_homography=True,
                        **aug['homographic'])
                    out['thermal']['homography'] = H.astype(np.float32)
                    out['optical']['homography'] = np.eye(3, dtype=np.float32)

                hm_input, hfour = self.prep_hm_regression_input(
                    optical, thermal,
                    out['optical']['homography'], out['thermal']['homography'],
                    top_left_point=[h // 2 - 64, w // 2 - 64],
                    patch_size_h_w=[128, 128])
                out['hm_input'] = hm_input.astype(np.float32)
                out['hfour_points'] = hfour
            else:
                kp_o, kp_t = kp_pair
                vm_o = vm_t = dummy_valid_mask(optical.shape)
                out['optical']['homography'] = np.eye(3, dtype=np.float32)
                out['thermal']['homography'] = np.eye(3, dtype=np.float32)

            out['optical']['image'] = optical.astype(np.float32)[..., None]
            out['optical']['valid_mask'] = vm_o.astype(bool)
            out['optical']['is_optical'] = np.array([optical_is_optical])
            out['thermal']['image'] = thermal.astype(np.float32)[..., None]
            out['thermal']['valid_mask'] = vm_t.astype(bool)
            out['thermal']['is_optical'] = np.array([thermal_is_optical])
            if kp_o is not None:
                out['optical']['keypoints'] = generate_keypoint_map(kp_o,
                                                                    (h, w))
            if kp_t is not None:
                out['thermal']['keypoints'] = generate_keypoint_map(kp_t,
                                                                    (h, w))

        if self.config['return_name']:
            out['name'] = self.memberslist[index]
        return out

    @staticmethod
    def prep_hm_regression_input(optical, thermal, optical_homography,
                                 thermal_homography, top_left_point=(0, 0),
                                 patch_size_h_w=(128, 128)):
        """Homography-regression supervision: the 4-corner displacement of
        a central patch under Ho @ Ht, and the stacked cropped patch."""
        tl = np.asarray(top_left_point)
        tr = tl + [patch_size_h_w[1], 0]
        bl = tl + [0, patch_size_h_w[0]]
        br = tl + [patch_size_h_w[1], patch_size_h_w[0]]
        four_points = [tl, tr, br, bl]

        perturbed = []
        M = optical_homography @ thermal_homography
        for p in four_points:
            ph = M @ np.array([[p[0]], [p[1]], [1.0]])
            # not divided by the homogeneous coordinate: the labels the
            # JAX package (and the reference before it) trains on
            perturbed.append([int(ph[0, 0]), int(ph[1, 0])])
        hfour = np.subtract(np.array(perturbed), np.array(four_points))

        xs = [p[0] for p in four_points]
        ys = [p[1] for p in four_points]
        cropped_o = optical[min(ys):max(ys), min(xs):max(xs)]
        cropped_t = thermal[min(ys):max(ys), min(xs):max(xs)]
        hm_input = np.stack([cropped_o, cropped_t], axis=-1)
        return hm_input, hfour.astype(np.float32)

    def get_name(self, index):
        return self.memberslist[index]

    def returns_pair(self):
        return not self.config['single_image']

    def __len__(self):
        return self.num_files
