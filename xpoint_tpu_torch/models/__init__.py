"""Models of the serving and training paths: the XPoint with a CNN, VMamba
or SwinV2 encoder and the RegNet or HomographyNet homography head."""
from .xpoint import (VMAMBA_MODEL_CFG, VMAMBA_TRAIN_CFG,  # noqa: F401
                     XPointNet, build_xpoint)
