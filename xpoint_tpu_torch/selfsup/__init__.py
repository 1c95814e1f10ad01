"""Self-supervision: homographic adaptation and the label export."""
from .homographic_adaptation import (HA_DEFAULT_CONFIG,  # noqa: F401
                                     make_ha_fn, sample_ha_homographies)
