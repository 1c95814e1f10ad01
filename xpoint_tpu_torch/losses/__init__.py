"""Training losses."""
from .xpoint_loss import XPointLoss  # noqa: F401
