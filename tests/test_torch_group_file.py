"""Files of named groups of arrays (``xpoint_tpu_torch/data/group_file.py``):
the same groups written as HDF5 and as ``.npz`` give the port's datasets
the same samples bit for bit (ImagePairDataset in pair and single modes
with labels of one and of two sides, the cached SyntheticShapes,
SatThermalGeoDataset, the device-resident corpus), and those samples equal
the JAX package's datasets on the HDF5 at the same seeds, bit for bit. The
JAX side draws from the global streams seeded as in
test_torch_host_data.py (its cv2 path)."""
import os
import random
import zipfile

import h5py
import numpy as np
import pytest

import xpoint_tpu.data as jx_data

import xpoint_tpu_torch.data as data
from xpoint_tpu_torch.data import group_file
from xpoint_tpu_torch.data.device_dataset import load_resident_pair_data
from xpoint_tpu_torch.data.group_file import (NpzGroupFile, open_group_file,
                                              write_npz_groups)
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
from xpoint_tpu_torch.selfsup.export import NumpySink, open_sink

from test_torch_host_data import cv2_path, run_jax, run_port  # noqa: F401
from torch_env import torch_env  # noqa: F401 (autouse)

FLAGSHIP_AUG = VMAMBA_TRAIN_CFG["dataset"]["augmentation"]


def assert_exact(got, want, path="sample"):
    """The same keys, types, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_exact(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_exact(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def write_both(base, groups, arrays=None):
    """``groups`` ({group: {dataset: array}}) and top-level ``arrays`` as
    ``base.hdf5`` and ``base.npz``; returns both paths."""
    with h5py.File(f"{base}.hdf5", "w") as f:
        for name, g in groups.items():
            grp = f.create_group(name)
            for k, v in g.items():
                grp.create_dataset(k, data=v)
        for k, v in (arrays or {}).items():
            f.create_dataset(k, data=v)
    np.savez(f"{base}.npz", **{f"{n}/{k}": v for n, g in groups.items()
                               for k, v in g.items()}, **(arrays or {}))
    return f"{base}.hdf5", f"{base}.npz"


def _corpus(tmp_path, n=3, shape=(80, 72), seed=1):
    rng = np.random.default_rng(seed)
    # names out of order: both formats list them sorted
    names = [f"s{i:02d}" for i in (2, 0, 1, 3)[:n]]
    groups = {name: {"optical": rng.uniform(size=shape),
                     "thermal": rng.uniform(size=shape) ** 2}
              for name in names}
    return write_both(str(tmp_path / "pairs"), groups), sorted(names)


def _labels(tmp_path, names, shape, form, seed=2):
    rng = np.random.default_rng(seed)
    hw = np.array(shape)
    sides = ("keypoints",) if form == "one" else ("keypoints_optical",
                                                  "keypoints_thermal")
    groups = {name: {s: (rng.uniform(size=(25, 2)) * hw).astype(np.int64)
                     for s in sides} for name in names}
    return write_both(str(tmp_path / f"labels_{form}"), groups)


PAIR_CASES = {
    # name: (labels, config)
    "pair_homographic_one_side": ("one", {
        "single_image": False, "height": 64, "width": 64,
        "augmentation": {"homographic": dict(FLAGSHIP_AUG["homographic"],
                                             enable=True)}}),
    "pair_random_pairs_two_sides": ("two", {
        "single_image": False, "random_pairs": True, "height": 64,
        "width": 64, "augmentation": {
            "photometric": dict(FLAGSHIP_AUG["photometric"], enable=True),
            "homographic": {"enable": True, "valid_border_margin": 2}}}),
    "single_two_sides": ("two", {
        "single_image": True, "height": 64, "width": 32, "augmentation": {
            "photometric": {"enable": True},
            "homographic": {"enable": True}}}),
    "single_one_side": ("one", {"single_image": True}),
    "pair_no_labels": (None, {"single_image": False}),
}


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_image_pair_dataset_npz_equals_hdf5_and_jax(case, tmp_path):
    labels, extra = PAIR_CASES[case]
    (h5, npz), names = _corpus(tmp_path)
    cfgs = [dict(extra, filename=h5), dict(extra, filename=npz)]
    if labels:
        lh5, lnpz = _labels(tmp_path, names, (80, 72), labels)
        cfgs[0]["keypoints_filename"], cfgs[1]["keypoints_filename"] = \
            lh5, lnpz
    ds_h5, ds_npz = (data.ImagePairDataset(c) for c in cfgs)
    jx_ds = jx_data.ImagePairDataset(cfgs[0])
    assert ds_npz.memberslist == ds_h5.memberslist == jx_ds.memberslist \
        == names
    for seed, index in ((0, 0), (3, 2), (7, 1)):
        want, jx_state = run_jax(seed, lambda: jx_ds[index])
        got, state = run_port(seed, lambda r, p: ds_npz.sample(index, r, p))
        assert_exact(got, want)
        assert state == jx_state
        assert_exact(ds_npz.sample(index, np.random.RandomState(seed),
                                   random.Random(seed)),
                     ds_h5.sample(index, np.random.RandomState(seed),
                                  random.Random(seed)))
    assert_exact(ds_npz[1], ds_h5[1])


def test_cached_synthetic_shapes_npz_equals_hdf5_and_jax(tmp_path):
    """The replay mode of the cycle's pretrain (on-the-fly false)."""
    rng = np.random.default_rng(3)
    groups = {f"s{i:05d}": {
        "image": rng.integers(0, 256, size=(60, 80)).astype(np.uint8),
        "points": rng.uniform(0, 70, size=(12, 2)).astype(np.float32)}
        for i in range(4)}
    h5, npz = write_both(str(tmp_path / "synthetic"), groups)
    cfg = {"on-the-fly": False, "length": 99, "image_size": [60, 80],
           "augmentation": {"photometric": {"enable": True},
                            "homographic": {"enable": True}}}
    ds_npz = data.get_dataset(dict(cfg, type="SyntheticShapes",
                                   **{"hdf5-file": npz}))
    ds_h5 = data.SyntheticShapes(dict(cfg, **{"hdf5-file": h5}))
    jx_ds = jx_data.SyntheticShapes(dict(cfg, **{"hdf5-file": h5}))
    assert len(ds_npz) == len(ds_h5) == len(jx_ds) == 4
    for seed, index in ((0, 0), (5, 3), (2, 1)):
        want, jx_state = run_jax(seed, lambda: jx_ds[index])
        got, state = run_port(seed, lambda r, p: ds_npz.sample(index, r, p))
        assert_exact(got, want)
        assert state == jx_state
        assert_exact(ds_h5.sample(index, np.random.RandomState(seed),
                                  random.Random(seed)), got)


@pytest.mark.parametrize("single_image", [False, True])
def test_sat_thermal_npz_equals_hdf5_and_jax(single_image, tmp_path):
    rng = np.random.default_rng(5)
    names = [f"tile_{i}" for i in range(3)]
    paths = {}
    for side in ("optical", "thermal"):
        arrays = {"image_data": rng.integers(0, 256, size=(3, 72, 80, 3)
                                             ).astype(np.uint8),
                  "image_name": np.array([s.encode() for s in names])}
        paths[side] = write_both(str(tmp_path / f"sat_{side}"), {}, arrays)
    lh5, lnpz = _labels(tmp_path, names, (72, 80), "two", seed=6)
    base = {"single_image": single_image, "height": 64, "width": 64,
            "augmentation": {"homographic": {"enable": True}}}
    cfg_h5 = dict(base, filename=paths["optical"][0],
                  filename_thermal=paths["thermal"][0],
                  keypoints_filename=lh5, type="SatThermalGeoDataset")
    cfg_npz = dict(base, filename=paths["optical"][1],
                   filename_thermal=paths["thermal"][1],
                   keypoints_filename=lnpz, type="SatThermalGeoDataset")
    ds_h5, ds_npz = data.get_dataset(cfg_h5), data.get_dataset(cfg_npz)
    jx_ds = jx_data.get_dataset(cfg_h5)
    assert ds_npz.memberslist == ds_h5.memberslist == names
    for seed, index in ((0, 0), (4, 2)):
        want, jx_state = run_jax(seed, lambda: jx_ds[index])
        got, state = run_port(seed, lambda r, p: ds_npz.sample(index, r, p))
        assert_exact(got, want)
        assert state == jx_state
        assert_exact(ds_h5.sample(index, np.random.RandomState(seed),
                                  random.Random(seed)), got)


@pytest.mark.parametrize("form", ["one", "two"])
def test_resident_corpus_from_npz_equals_hdf5(form, tmp_path):
    """The device-data path reads the corpus and the labels through the
    dataset's loaders, so it takes the .npz files too."""
    (h5, npz), names = _corpus(tmp_path)
    lh5, lnpz = _labels(tmp_path, names, (80, 72), form)
    got, meta = load_resident_pair_data(data.ImagePairDataset(
        {"filename": npz, "keypoints_filename": lnpz}), device="cpu")
    want, want_meta = load_resident_pair_data(data.ImagePairDataset(
        {"filename": h5, "keypoints_filename": lh5}), device="cpu")
    assert meta == want_meta and meta["k"] == 25
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and bool((got[k] == want[k]
                                                       ).all()), k


def test_npz_group_file_reads_as_h5py_lists(tmp_path):
    """Keys in h5py's name order, groups and top-level arrays, a missing
    name, membership, a compressed archive, and the NumpySink file."""
    groups = {"b": {"x": np.arange(6.0).reshape(2, 3), "y": np.int64(3)},
              "a": {"z": np.zeros((0, 2), np.int64)},
              "sample_0010": {"x": np.ones(3, np.float32)},
              "sample_0002": {"x": np.full(3, 2, np.uint8)}}
    arrays = {"image_name": np.array([b"u", b"v"])}
    h5, npz = write_both(str(tmp_path / "g"), groups, arrays)
    with h5py.File(h5, "r") as a, open_group_file(npz) as b:
        assert isinstance(b, NpzGroupFile)
        assert b.keys() == list(a.keys())
        for name in groups:
            assert name in b and b[name].keys() == sorted(a[name].keys())
            for ds in groups[name]:
                assert_exact(b[name][ds], np.asarray(a[name][ds][()]))
                assert ds in b[name]
        assert list(b["image_name"]) == [b"u", b"v"]
        assert "c" not in b and "w" not in b["a"]
        with pytest.raises(KeyError):
            b["c"]
        with pytest.raises(KeyError):
            b["a"]["w"]
    compressed = str(tmp_path / "c.npz")
    np.savez_compressed(compressed, **{"s/x": np.arange(5)})
    with open_group_file(compressed) as f:
        assert_exact(f["s"]["x"], np.arange(5))
    with open_group_file(h5, swmr=True) as f:
        assert isinstance(f, h5py.File)
    assert group_file.is_hdf5("a.H5") and not group_file.is_hdf5("a.npz")


def test_npz_is_reread_after_it_is_replaced(tmp_path):
    """The parsed directory is kept per file version: a file rewritten
    under the same name (NumpySink's flush) is read anew."""
    path = str(tmp_path / "labels.npz")
    write_npz_groups(path, {"s0": {"keypoints": np.arange(4).reshape(2, 2)}})
    with open_group_file(path) as f:
        assert f.keys() == ["s0"]
    write_npz_groups(path, iter([
        ("s0", {"keypoints": np.zeros((1, 2), np.int64)}),
        ("s1", {"keypoints": np.ones((3, 2), np.int64)})]))
    with open_group_file(path) as f:
        assert f.keys() == ["s0", "s1"]
        assert_exact(f["s0"]["keypoints"], np.zeros((1, 2), np.int64))
    with np.load(path) as f:            # numpy reads what it wrote
        assert sorted(f.files) == ["s0/keypoints", "s1/keypoints"]
    assert zipfile.is_zipfile(path)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_numpy_sink_keeps_an_existing_file_as_h5_sink_does(tmp_path):
    """A sink opened on an existing file keeps its samples (HDF5 is
    appended to); ``resume`` records them as done."""
    for suffix in ("npz", "hdf5"):
        path = str(tmp_path / f"labels.{suffix}")
        sink = open_sink(path)
        assert isinstance(sink, NumpySink) == (suffix == "npz")
        sink.write("s0", {"keypoints": np.ones((2, 2), np.int64)})
        sink.flush()
        sink.close()
        again = open_sink(path)
        assert again.names() == {"s0"} and again.done == set()
        again.write("s1", {"keypoints": np.zeros((1, 2), np.int64)})
        again.close()
        resumed = open_sink(path, resume=True)
        assert resumed.names() == resumed.done == {"s0", "s1"}
        resumed.close()
        with open_group_file(path) as f:
            assert list(f.keys()) == ["s0", "s1"]
            assert_exact(np.asarray(f["s0"]["keypoints"]),
                         np.ones((2, 2), np.int64))
