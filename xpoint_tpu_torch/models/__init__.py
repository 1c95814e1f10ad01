"""Models of the serving and training paths: the XPoint with a CNN, VMamba
or SwinV2 encoder and the RegNet or HomographyNet homography head; the
baselines (MagicLeap SuperPoint, the classical detectors) through
:func:`get_model`."""
from .xpoint import (VMAMBA_MODEL_CFG, VMAMBA_TRAIN_CFG,  # noqa: F401
                     XPointNet, build_xpoint)


def get_model(config, device="cuda", seed=0):
    """A model by ``config['type']`` (port of
    ``xpoint_tpu.models.get_model``): (module, config) for XPoint and
    SuperPointMagicLeap, seeded from ``seed`` on ``device``;
    (ClassicDetectors, config) for the host-side classical baselines.
    Any other type raises ValueError."""
    mtype = config.get("type", "XPoint")
    if mtype == "XPoint":
        return build_xpoint(config, device=device, seed=seed)
    if mtype == "SuperPointMagicLeap":
        from .superpoint import build_superpoint
        return build_superpoint(config, device=device, seed=seed)
    if mtype == "ClassicDetectors":
        from .classic import ClassicDetectors
        return ClassicDetectors(config), config
    raise ValueError(f"unknown model type: {mtype}")
