"""Tensor ops of the serving path, with the kernel wrappers. The names the
JAX package's ``ops`` exports are exported here too."""
from .descriptor import interpolate_descriptors
from .detector import prob_from_logits
from .gridops import depth_to_space, space_to_depth
from .matching import descriptor_distance_matrix, mnn_match
from .nms import box_nms
from .warp import warp_image, warp_image_batch, warp_image_multi

__all__ = [
    "space_to_depth",
    "depth_to_space",
    "warp_image",
    "warp_image_batch",
    "warp_image_multi",
    "box_nms",
    "prob_from_logits",
    "interpolate_descriptors",
    "mnn_match",
    "descriptor_distance_matrix",
]
