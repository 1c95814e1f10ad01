"""Homography helpers (sampling, warps of points, valid masks) and RANSAC
on the device."""
from .homography import (
    compute_valid_mask,
    compute_valid_mask_device,
    filter_points,
    sample_homography,
    sample_homography_corner,
    warp_keypoints,
    warp_points,
)

__all__ = [
    "sample_homography",
    "sample_homography_corner",
    "compute_valid_mask",
    "compute_valid_mask_device",
    "warp_keypoints",
    "filter_points",
    "warp_points",
]
