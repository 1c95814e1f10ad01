"""Training losses."""
from .xpoint_loss import XPointLoss, descriptor_loss, detector_loss

__all__ = ["XPointLoss", "detector_loss", "descriptor_loss"]
