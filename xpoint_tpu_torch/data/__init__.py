"""Training data: the host datasets and loader, the device-resident data
path and augmentation, and a seeded synthetic corpus."""
from .image_pair import ImagePairDataset  # noqa: F401
from .loader import DataLoader, collate  # noqa: F401
from .synthetic_shapes import SyntheticShapes  # noqa: F401


def get_dataset(config):
    """The dataset named by ``config['type']`` (the JAX package's
    ``data.get_dataset``)."""
    dtype = config.get("type", "ImagePairDataset")
    if dtype == "ImagePairDataset":
        return ImagePairDataset(config)
    if dtype == "SyntheticShapes":
        return SyntheticShapes(config)
    if dtype == "SatThermalGeoDataset":
        from .sat_thermal import SatThermalGeoDataset
        return SatThermalGeoDataset(config)
    raise ValueError(f"unknown dataset type: {dtype}")
