"""Keypoint-map helper (own copy of ``xpoint_tpu/utils/keypoints.py``)."""
import numpy as np


def generate_keypoint_map(keypoints, image_shape):
    """Binary (H, W) map with True at integer keypoint (row, col) positions."""
    keypoint_map = np.zeros(image_shape, dtype=bool)
    if keypoints is not None and len(keypoints) > 0:
        tmp = np.asarray(keypoints).astype(np.int64)
        keypoint_map[tmp[:, 0], tmp[:, 1]] = True
    return keypoint_map
