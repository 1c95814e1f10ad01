"""Self-supervision: homographic adaptation and the label export."""
from .homographic_adaptation import (HA_DEFAULT_CONFIG,
                                     homographic_adaptation,
                                     homographic_adaptation_multispectral,
                                     make_ha_fn, sample_ha_homographies,
                                     search_window)

__all__ = ["homographic_adaptation_multispectral", "homographic_adaptation",
           "search_window", "HA_DEFAULT_CONFIG", "make_ha_fn",
           "sample_ha_homographies"]
