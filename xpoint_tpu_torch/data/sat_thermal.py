"""SatThermalGeoDataset: satellite-optical / thermal pairs stored as two
parallel HDF5 files with 'image_data' and 'image_name' arrays (own copy of
``xpoint_tpu/data/sat_thermal.py``): BGR to gray, /255, then the crop,
augmentation, pair warp and homography-regression input of
ImagePairDataset, inherited. Each file, the labels included, is HDF5 or
``.npz`` by its suffix (``data/group_file.py``)."""
import copy

import cv2
import numpy as np

from ..utils import dict_update
from .group_file import open_group_file
from .image_pair import DEFAULT_CONFIG as PAIR_DEFAULTS
from .image_pair import ImagePairDataset

DEFAULT_CONFIG = dict(copy.deepcopy(PAIR_DEFAULTS), filename_thermal=None)


class SatThermalGeoDataset(ImagePairDataset):
    def __init__(self, config):
        cfg = dict_update(copy.deepcopy(DEFAULT_CONFIG), config or {})
        if cfg['filename'] is None or cfg['filename_thermal'] is None:
            raise ValueError(
                "SatThermalGeoDataset needs filename + filename_thermal")
        # not ImagePairDataset.__init__: the layout differs
        self.config = cfg
        self.data_is_file = True
        self.data_path = cfg['filename']
        self.thermal_path = cfg['filename_thermal']
        with open_group_file(self.data_path) as f:
            names = list(f['image_name'])
            self.memberslist = [n.decode() if isinstance(n, bytes) else str(n)
                                for n in names]
        self.num_files = len(self.memberslist)

        if cfg['keypoints_filename'] is not None:
            with open_group_file(cfg['keypoints_filename']) as kf:
                keys = set(kf.keys())
            missing = [m for m in self.memberslist if m not in keys]
            if missing:
                raise IndexError(f"Labels missing for {len(missing)} samples")

    def _load_images(self, index):
        with open_group_file(self.data_path, swmr=True) as fo:
            optical = fo['image_data'][index]
        with open_group_file(self.thermal_path, swmr=True) as ft:
            thermal = ft['image_data'][index]
        if optical.ndim == 3:
            optical = cv2.cvtColor(optical, cv2.COLOR_BGR2GRAY)
        if thermal.ndim == 3:
            thermal = cv2.cvtColor(thermal, cv2.COLOR_BGR2GRAY)
        optical = np.asarray(optical, np.float64) / 255.0
        thermal = np.asarray(thermal, np.float64) / 255.0
        if thermal.shape != optical.shape:
            raise ValueError("optical and thermal images must share a shape")
        return optical, thermal
