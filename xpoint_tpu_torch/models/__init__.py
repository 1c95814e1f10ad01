"""Models of the serving and training paths (VMamba XPoint, RegNet)."""
from .xpoint import (VMAMBA_MODEL_CFG, VMAMBA_TRAIN_CFG,  # noqa: F401
                     XPointNet, build_xpoint)
