"""Training data: the host loader, the device-resident data path and
augmentation, and a seeded synthetic corpus."""
from .loader import DataLoader, collate  # noqa: F401

_HOST_TYPES = ("ImagePairDataset", "SyntheticShapes", "SatThermalGeoDataset")


def get_dataset(config):
    """The dataset named by ``config['type']`` (the JAX package's
    ``data.get_dataset``). Its dataset types read HDF5 files and run cv2
    augmentation on the host, which is not ported yet (ROADMAP.md Queue 1
    item 4), so every known type raises NotImplementedError; callers that
    can take a dataset object (``Trainer(dataset=...)``) pass one with the
    same surface."""
    dtype = config.get("type", "ImagePairDataset")
    if dtype in _HOST_TYPES:
        raise NotImplementedError(
            f"dataset type {dtype}: the host data path is not ported yet "
            f"(ROADMAP.md Queue 1 item 4); pass a dataset object")
    raise ValueError(f"unknown dataset type: {dtype}")
