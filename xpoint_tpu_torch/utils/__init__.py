"""Host-side helpers (own copies of ``xpoint_tpu/utils/dicttools.py`` and
``keypoints.py``)."""
from .dicttools import (dict_to_obj, dict_update, div0,  # noqa: F401
                        get_new_filename, parse_primitives)
from .keypoints import generate_keypoint_map  # noqa: F401
