"""Parity of the port's synthetic shapes with the JAX package's on the CPU:
the background, each of the nine drawing primitives, and SyntheticShapes
generated on the fly (at a small generation size) and replayed from an
HDF5 file.

The JAX side draws from the global ``np.random`` / ``random`` streams after
``np.random.seed(s); random.seed(s)`` with ``XPOINT_NO_NATIVE=1`` (its cv2
path); the port side from a ``np.random.RandomState(s)`` and a
``random.Random(s)`` passed in. Tolerances as in test_torch_host_data.py:
images 1e-6 absolute, keypoints, maps and masks exactly, and the same
generator state afterwards.
"""
import random

import h5py
import numpy as np
import pytest

import xpoint_tpu.data.draw_primitives as jx_draw
from xpoint_tpu.data import SyntheticShapes as JxSyntheticShapes
from xpoint_tpu.data.synthetic_shapes import ALL_PRIMITIVES
from xpoint_tpu.data.synthetic_shapes import DEFAULT_CONFIG as JX_DEFAULTS

import xpoint_tpu_torch.data.draw_primitives as draw
from xpoint_tpu_torch.data import SyntheticShapes, get_dataset

from test_torch_host_data import assert_same, both, cv2_path  # noqa: F401
from torch_env import torch_env  # noqa: F401 (autouse)

GEN = JX_DEFAULTS["generation"]
SMALL = {
    "length": 6,
    "generation_size": [120, 160],
    "image_size": [60, 80],
    "augmentation": {
        "photometric": {"enable": True},
        "homographic": {"enable": True, "valid_border_margin": 2},
    },
}


def _background(seed, shape=(120, 160)):
    """A background drawn by the JAX package from the seeded global
    streams (the primitives draw on it)."""
    np.random.seed(seed)
    random.seed(seed)
    return jx_draw.generate_background(shape=shape,
                                       **GEN["generate_background"])


@pytest.mark.parametrize("shape,kw", [
    ((120, 160), GEN["generate_background"]), ((60, 80), {})])
def test_generate_background_matches_jax(shape, kw):
    for seed in range(3):
        img = both(seed, lambda: jx_draw.generate_background(shape=shape,
                                                             **kw),
                   lambda rng, py: draw.generate_background(
                       rng, py, shape=shape, **kw))
        assert img.dtype == np.float32 and img.shape == shape


@pytest.mark.parametrize("primitive", ALL_PRIMITIVES)
def test_primitive_matches_jax(primitive):
    """Image (drawn in place) and (x, y) keypoints, at SyntheticShapes'
    settings for the primitive."""
    kw = dict(GEN.get(primitive, {}), min_contrast=GEN["min_contrast"])
    n_points = 0
    for seed in range(4):
        bg = _background(seed)

        def jax_fn():
            img = bg.copy()
            return img, np.asarray(getattr(jx_draw, primitive)(img, **kw))

        def port_fn(rng, py):
            img = bg.copy()
            return img, np.asarray(getattr(draw, primitive)(img, rng, py,
                                                            **kw))
        img, points = both(10 + seed, jax_fn, port_fn)
        n_points += len(points)
        if primitive == "gaussian_noise":
            assert not np.array_equal(img, bg)
    if primitive not in ("draw_ellipses", "gaussian_noise"):
        assert n_points > 0


@pytest.mark.parametrize("name,extra", [
    ("augmented", {}),
    ("plain_coordinates", {"keypoints_as_map": False, "augmentation": {
        "photometric": {"enable": False},
        "homographic": {"enable": False}}}),
    ("corners_same_size", {"primitives": ["draw_checkerboard", "draw_cube"],
                           "generation_size": [64, 96],
                           "image_size": [64, 96]}),
    ("no_ir_blur", {"processing": {"additional_ir_blur": False},
                    "primitives": "draw_lines"}),
])
def test_synthetic_shapes_on_the_fly_matches_jax(name, extra):
    cfg = {**SMALL, **extra}
    jx_ds, ds = JxSyntheticShapes(cfg), SyntheticShapes(cfg)
    assert len(ds) == len(jx_ds) == 6 and not ds.returns_pair()
    kinds = set()
    for seed in range(6):
        s = both(seed, lambda: jx_ds[seed % 6],
                 lambda rng, py: ds.sample(seed % 6, rng, py))
        kinds.add(bool(s["is_optical"][0]))
        h, w = cfg["image_size"]
        assert s["image"].shape == (h, w, 1)
        if cfg.get("keypoints_as_map", True):
            assert s["keypoints"].shape == (h, w)
    assert kinds == {False, True}


def test_synthetic_shapes_from_hdf5_matches_jax(tmp_path):
    """The replay mode the full cycle's pretrain uses (on-the-fly false):
    images and points from the file, then the same augmentation."""
    path = str(tmp_path / "shapes.hdf5")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        for i in range(4):
            g = f.create_group(f"{i:05d}")
            g.create_dataset("image", data=rng.integers(
                0, 256, size=(60, 80)).astype(np.uint8))
            g.create_dataset("points", data=rng.uniform(
                0, 70, size=(12, 2)).astype(np.float32))
    cfg = {**SMALL, "on-the-fly": False, "hdf5-file": path, "length": 99}
    jx_ds = JxSyntheticShapes(cfg)
    ds = get_dataset(dict(cfg, type="SyntheticShapes"))
    assert len(ds) == len(jx_ds) == 4
    for seed, index in ((0, 0), (5, 3), (2, 1)):
        s = both(seed, lambda: jx_ds[index],
                 lambda rng, py: ds.sample(index, rng, py))
        assert s["is_optical"][0]


def test_synthetic_shapes_getitem_is_seeded():
    ds = SyntheticShapes(SMALL)
    a = ds[2]
    assert_same(ds[2], a)
    assert_same(ds.sample(2, *ds.generators(2)), a)
    ds.set_epoch(1)
    assert not np.array_equal(ds[2]["image"], a["image"])
