"""Parity of the port's host data path with the JAX package's on the CPU:
photometric primitives and augmentation, the host homography helpers,
homographic augmentation (the cv2 path), ImagePairDataset in its HDF5 and
folder layouts, SatThermalGeoDataset, get_dataset, and a Trainer built from
a config alone.

The JAX side draws from the global ``np.random`` / ``random`` streams after
``np.random.seed(s); random.seed(s)`` with ``XPOINT_NO_NATIVE=1`` (its cv2
path); the port side draws from a ``np.random.RandomState(s)`` and a
``random.Random(s)`` passed in. Tolerances: float images 1e-6 absolute
(the same numpy and cv2 calls run on both sides, so they agree to the bit
in practice); keypoints, keypoint maps, valid masks, homographies and names
exactly; and both sides must leave their generators in the same state.
"""
import os
import random
import shutil

import cv2
import h5py
import numpy as np
import pytest
import torch

import xpoint_tpu.data as jx_data
import xpoint_tpu.data.augmentation as jx_aug
import xpoint_tpu.data.photometric as jx_photo
import xpoint_tpu.geometry.homography as jx_hom
import xpoint_tpu.utils as jx_utils

import xpoint_tpu_torch.data as data
import xpoint_tpu_torch.data.augmentation as aug
import xpoint_tpu_torch.data.photometric as photo
import xpoint_tpu_torch.geometry.homography as hom
from xpoint_tpu_torch.data.sat_thermal import SatThermalGeoDataset
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
from xpoint_tpu_torch.trainer import Trainer
from xpoint_tpu_torch.utils import generate_keypoint_map
from torch_env import torch_env  # noqa: F401 (autouse)

ATOL = 1e-6
FLAGSHIP_AUG = VMAMBA_TRAIN_CFG["dataset"]["augmentation"]


@pytest.fixture(autouse=True)
def cv2_path(monkeypatch):
    """The JAX package's cv2 path, not its optional native engine."""
    monkeypatch.setenv("XPOINT_NO_NATIVE", "1")


def run_jax(seed, fn):
    """fn() after seeding the global streams; also returns a draw from
    each stream afterwards (the streams' state)."""
    np.random.seed(seed)
    random.seed(seed)
    out = fn()
    return out, (np.random.rand(), random.random())


def run_port(seed, fn):
    """fn(rng, py_rng) with generators seeded as run_jax seeds the global
    streams; also returns a draw from each afterwards."""
    rng, py_rng = np.random.RandomState(seed), random.Random(seed)
    out = fn(rng, py_rng)
    return out, (rng.rand(), py_rng.random())


def assert_same(got, want, path="sample"):
    """Float arrays within ATOL absolute, everything else exactly, with the
    same keys, types, dtypes and shapes."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def both(seed, jax_fn, port_fn):
    want, jax_state = run_jax(seed, jax_fn)
    got, port_state = run_port(seed, port_fn)
    assert_same(got, want)
    assert port_state == jax_state, "the generators drew differently"
    return got


def _image(seed, shape=(48, 64)):
    return np.random.default_rng(seed).uniform(size=shape)


# ---- photometric ---------------------------------------------------------

@pytest.mark.parametrize("name", jx_photo.augmentations)
def test_photometric_primitive_matches_jax(name):
    params = FLAGSHIP_AUG["photometric"]["params"].get(name, {})
    for seed in range(3):
        img = _image(seed)
        for kw in ({}, params):
            both(seed, lambda: getattr(jx_photo, name)(img, **kw),
                 lambda rng, py: getattr(photo, name)(img, rng, **kw))


@pytest.mark.parametrize("random_order", [True, False])
def test_photometric_augmentation_matches_jax(random_order):
    cfg = dict(FLAGSHIP_AUG["photometric"], random_order=random_order)
    for seed in range(3):
        img = _image(seed)
        both(seed, lambda: jx_aug.photometric_augmentation(img, **cfg),
             lambda rng, py: aug.photometric_augmentation(img, rng, py,
                                                          **cfg))


# ---- host homography helpers ---------------------------------------------

@pytest.mark.parametrize("params", [
    {}, FLAGSHIP_AUG["homographic"]["params"],
    {"allow_artifacts": False, "max_angle": 0.3}])
def test_sample_homography_from_the_stream_matches_jax(params):
    """The JAX sampler seeds a Generator from the global stream when it is
    given none; the port's callers seed it from their RandomState by the
    same draw: the same matrix bit for bit."""
    kw = {k: v for k, v in params.items() if k != "corner_homography"}
    for seed in range(5):
        both(seed, lambda: jx_hom.sample_homography((48, 64), **kw),
             lambda rng, py: hom.sample_homography(
                 (48, 64), rng=np.random.default_rng(rng.randint(0, 2**31)),
                 **kw))


def test_sample_homography_corner_matches_jax():
    cfg = {"patch_size": 24, "rho": 6}
    for seed in range(5):
        got = both(seed, lambda: jx_hom.sample_homography_corner((48, 64),
                                                                 cfg),
                   lambda rng, py: hom.sample_homography_corner(
                       (48, 64), cfg,
                       rng=np.random.default_rng(rng.randint(0, 2**31))))
        assert got.shape == (3, 3)


@pytest.mark.parametrize("erosion,border", [(0, False), (3, False),
                                            (3, True), (1, True)])
def test_compute_valid_mask_matches_jax(erosion, border):
    for seed in range(3):
        H = jx_hom.sample_homography((40, 56),
                                     rng=np.random.default_rng(seed))
        got = hom.compute_valid_mask((40, 56), H, erosion, border)
        assert_same(got, jx_hom.compute_valid_mask((40, 56), H, erosion,
                                                   border))
        assert 0 < got.sum() < got.size


def test_warp_and_filter_points_match_jax():
    rng = np.random.default_rng(4)
    kp = rng.integers(0, 48, size=(30, 2))
    H = jx_hom.sample_homography((48, 48), rng=rng)
    for rtype in (int, float):
        assert_same(hom.warp_keypoints(kp, H, rtype),
                    jx_hom.warp_keypoints(kp, H, rtype))
    warped = jx_hom.warp_keypoints(kp, H)
    got = hom.filter_points(warped, (48, 48))
    assert_same(got, jx_hom.filter_points(warped, (48, 48)))
    assert 0 < len(got) < len(kp)
    empty = np.zeros((0, 2), int)
    assert_same(hom.warp_keypoints(empty, H), jx_hom.warp_keypoints(empty, H))
    assert_same(generate_keypoint_map(got, (48, 48)),
                jx_utils.generate_keypoint_map(got, (48, 48)))
    assert_same(generate_keypoint_map(None, (4, 5)),
                jx_utils.generate_keypoint_map(None, (4, 5)))


# ---- homographic augmentation ---------------------------------------------

@pytest.mark.parametrize("corner", [False, True])
@pytest.mark.parametrize("margin,reflect", [(0, True), (2, True), (2, False)])
def test_homographic_augmentation_matches_jax(corner, margin, reflect):
    params = dict(FLAGSHIP_AUG["homographic"]["params"])
    params["corner_homography"] = {"enable": corner,
                                   "params": {"patch_size": 24, "rho": 6}}
    cfg = {"params": params, "border_reflect": reflect,
           "valid_border_margin": margin, "mask_border": True}
    for seed in range(3):
        img = _image(seed)
        kp = np.random.default_rng(seed).integers(0, 48, size=(20, 2))
        for keypoints in (kp, None, np.zeros((0, 2), int)):
            got = both(seed, lambda: jx_aug.homographic_augmentation(
                img, keypoints, return_homography=True, **cfg),
                lambda rng, py: aug.homographic_augmentation(
                    img, rng, keypoints, return_homography=True, **cfg))
            if keypoints is kp:
                assert len(got[1]) <= len(kp)
    assert_same(aug.dummy_valid_mask((3, 4)), jx_aug.dummy_valid_mask((3, 4)))


# ---- ImagePairDataset -----------------------------------------------------

def _pairs(n, shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, *shape)),
            rng.uniform(size=(n, *shape)) ** 2)


def _write_hdf5(path, n, shape, seed, raw=False):
    opt, th = _pairs(n, shape, seed)
    with h5py.File(path, "w") as f:
        for i in range(n):
            g = f.create_group(f"s{i:02d}")
            g.create_dataset("optical", data=opt[i])
            g.create_dataset("thermal", data=th[i])
            if raw:
                g.create_dataset("thermal_raw", data=1.0 - th[i])
    return [f"s{i:02d}" for i in range(n)]


def _write_folder(root, n, shape, seed, layout):
    opt, th = _pairs(n, shape, seed)
    dirs = ("optical", "thermal") if layout == "pairs" else ("images",)
    for d in dirs:
        os.makedirs(os.path.join(root, d))
    names = [f"p{i:02d}.png" for i in range(n)]
    for i, name in enumerate(names):
        for d, img in zip(dirs, (opt[i], th[i])):
            cv2.imwrite(os.path.join(root, d, name),
                        np.round(img * 255).astype(np.uint8))
    return names


def _write_labels(path, names, shape, seed, form):
    """(row, col) labels inside the image: one set, or one a spectrum."""
    rng = np.random.default_rng(seed)
    hw = np.array(shape)
    with h5py.File(path, "w") as f:
        for name in names:
            g = f.create_group(name)
            if form == "one":
                g.create_dataset("keypoints", data=(
                    rng.uniform(size=(25, 2)) * hw).astype(np.int64))
            else:
                for side in ("optical", "thermal"):
                    g.create_dataset(f"keypoints_{side}", data=(
                        rng.uniform(size=(25, 2)) * hw).astype(np.int64))


PAIR_CASES = {
    # name: (layout, labels, config)
    "hdf5_pair_homographic": ("hdf5", "one", {
        "single_image": False, "height": 64, "width": 64,
        "augmentation": {"homographic": dict(FLAGSHIP_AUG["homographic"],
                                             enable=True)}}),
    "hdf5_pair_random_pairs_photometric": ("hdf5", "two", {
        "single_image": False, "random_pairs": True, "height": 70,
        "width": 64, "augmentation": {
            "photometric": dict(FLAGSHIP_AUG["photometric"], enable=True),
            "homographic": {"enable": True, "valid_border_margin": 2}}}),
    "hdf5_single": ("hdf5", "two", {
        "single_image": True, "height": 64, "width": 32, "augmentation": {
            "photometric": {"enable": True},
            "homographic": {"enable": True}}}),
    "hdf5_raw_thermal_no_augmentation": ("hdf5_raw", None, {
        "single_image": False, "raw_thermal": True}),
    "folder_pair_corner_homography": ("pairs", "one", {
        "single_image": False, "height": 64, "width": 64,
        "augmentation": {"homographic": {
            "enable": True, "border_reflect": False, "params": {
                "corner_homography": {"enable": True, "params": {
                    "patch_size": 32, "rho": 8}}}}}}),
    "folder_images_single_unnamed": ("images", None, {
        "single_image": True, "return_name": False}),
    "redfeat_pair_resized": ("redfeat", "two", {
        "single_image": False, "height": 96, "width": 96,
        "augmentation": {"homographic": {"enable": True}}}),
    "redfeat_single_resized": ("redfeat", "one", {
        "single_image": True, "height": 96, "width": 64}),
}


def _pair_corpus(tmp_path, layout, labels, n=3):
    """(config entries naming the corpus, member names, image shape)."""
    shape = (60, 72) if layout == "redfeat" else (80, 72)
    if layout.startswith("hdf5"):
        path = str(tmp_path / "pairs.hdf5")
        names = _write_hdf5(path, n, shape, 1, raw=layout == "hdf5_raw")
        cfg = {"filename": path}
    else:
        root = str(tmp_path / ("ReDFeat_small" if layout == "redfeat"
                               else "corpus"))
        names = _write_folder(root, n, shape, 1,
                              "images" if layout == "images" else "pairs")
        cfg = {"foldername": root}
    if labels:
        cfg["keypoints_filename"] = str(tmp_path / "labels.hdf5")
        _write_labels(cfg["keypoints_filename"], names, shape, 2, labels)
    return cfg, names, shape


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_image_pair_dataset_matches_jax(case, tmp_path):
    layout, labels, extra = PAIR_CASES[case]
    cfg, names, _ = _pair_corpus(tmp_path, layout, labels)
    cfg.update(extra)
    jx_ds, ds = jx_data.ImagePairDataset(cfg), data.ImagePairDataset(cfg)
    assert len(ds) == len(jx_ds) == len(names)
    assert ds.returns_pair() == jx_ds.returns_pair()
    assert [ds.get_name(i) for i in range(len(ds))] == jx_ds.memberslist
    for seed, index in ((0, 0), (1, 2), (7, 1), (3, 1)):
        got = both(seed, lambda: jx_ds[index],
                   lambda rng, py: ds.sample(index, rng, py))
        side = got["optical"] if ds.returns_pair() else got
        assert side["image"].min() >= 0 and side["image"].max() <= 1


def test_image_pair_dataset_refuses_as_jax(tmp_path):
    """A root without optical/ + thermal/ or images/, both or neither of
    filename and foldername, and labels missing for a member raise the JAX
    package's errors."""
    os.makedirs(tmp_path / "empty")
    path = str(tmp_path / "pairs.hdf5")
    names = _write_hdf5(path, 2, (40, 40), 0)
    _write_labels(str(tmp_path / "labels.hdf5"), names[:1], (40, 40), 0,
                  "one")
    for cfg, err in (({"foldername": str(tmp_path / "empty")}, ValueError),
                     ({}, ValueError),
                     ({"filename": path, "foldername": str(tmp_path)},
                      ValueError),
                     ({"filename": path,
                       "keypoints_filename": str(tmp_path / "labels.hdf5")},
                      IndexError)):
        with pytest.raises(err):
            jx_data.ImagePairDataset(cfg)
        with pytest.raises(err):
            data.ImagePairDataset(cfg)
    ds = data.ImagePairDataset({"filename": path, "height": 64})
    with pytest.raises(ValueError, match="crop exceeds"):
        ds.sample(0, np.random.RandomState(0), random.Random(0))


def test_prep_hm_regression_input_matches_jax():
    """The undivided homogeneous coordinate is kept, as in the JAX
    package."""
    rng = np.random.default_rng(3)
    o, t = rng.uniform(size=(2, 192, 160))
    Ho = jx_hom.sample_homography((192, 160), rng=rng)
    Ht = jx_hom.sample_homography((192, 160), rng=rng)
    for H1, H2 in ((Ho, np.eye(3)), (np.eye(3), Ht), (Ho, Ht)):
        assert_same(data.ImagePairDataset.prep_hm_regression_input(
            o, t, H1, H2, top_left_point=[32, 16]),
            jx_data.ImagePairDataset.prep_hm_regression_input(
                o, t, H1, H2, top_left_point=[32, 16]))


# ---- SatThermalGeoDataset -------------------------------------------------

def _write_sat_thermal(tmp_path, n=3, shape=(72, 80)):
    rng = np.random.default_rng(5)
    names = [f"tile_{i}" for i in range(n)]
    paths = []
    for side, chans in (("optical", 3), ("thermal", 3)):
        p = str(tmp_path / f"sat_{side}.hdf5")
        with h5py.File(p, "w") as f:
            f.create_dataset("image_data", data=rng.integers(
                0, 256, size=(n, *shape, chans)).astype(np.uint8))
            f.create_dataset("image_name", data=np.array(
                [s.encode() for s in names]))
        paths.append(p)
    return paths, names, shape


@pytest.mark.parametrize("single_image", [False, True])
def test_sat_thermal_matches_jax(single_image, tmp_path):
    (opt, th), names, shape = _write_sat_thermal(tmp_path)
    _write_labels(str(tmp_path / "labels.hdf5"), names, shape, 6, "two")
    cfg = {"filename": opt, "filename_thermal": th,
           "keypoints_filename": str(tmp_path / "labels.hdf5"),
           "single_image": single_image, "height": 64, "width": 64,
           "augmentation": {"homographic": {"enable": True}}}
    jx_ds = jx_data.get_dataset(dict(cfg, type="SatThermalGeoDataset"))
    ds = data.get_dataset(dict(cfg, type="SatThermalGeoDataset"))
    assert isinstance(ds, SatThermalGeoDataset)
    assert len(ds) == len(jx_ds) == 3 and ds.memberslist == names
    for seed, index in ((0, 0), (4, 2)):
        both(seed, lambda: jx_ds[index],
             lambda rng, py: ds.sample(index, rng, py))
    with pytest.raises(ValueError):
        SatThermalGeoDataset({"filename": opt})


# ---- get_dataset and the per-sample generators -----------------------------

def test_get_dataset_builds_the_jax_types(tmp_path):
    cfg, _, _ = _pair_corpus(tmp_path, "hdf5", None)
    for c in ({"type": "SyntheticShapes", "length": 5},
              dict(cfg, type="ImagePairDataset"), dict(cfg)):
        got, want = data.get_dataset(c), jx_data.get_dataset(c)
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want)
    for d in (data, jx_data):
        with pytest.raises(ValueError):
            d.get_dataset({"type": "Nope"})


def test_samples_follow_seed_epoch_and_index(tmp_path):
    """__getitem__(i) is sample(i) with generators of (seed, epoch, i): the
    same sample every time it is asked for, another one for another epoch,
    seed or index."""
    cfg, _, _ = _pair_corpus(tmp_path, "hdf5", "one")
    cfg.update(PAIR_CASES["hdf5_pair_homographic"][2])
    ds = data.ImagePairDataset(cfg)
    first = ds[1]
    assert_same(ds[1], first)
    assert_same(ds.sample(1, *ds.generators(1)), first)
    h = first["optical"]["homography"] @ first["thermal"]["homography"]
    for epoch, seed, index in ((1, 0, 1), (0, 1, 1), (0, 0, 2)):
        ds.set_epoch(epoch, seed)
        other = ds[index]
        assert not np.array_equal(
            other["optical"]["homography"] @ other["thermal"]["homography"],
            h)
    ds.set_epoch(0, 0)
    assert_same(ds[1], first)


# ---- the Trainer from a config alone --------------------------------------

def pair_config(corpus, workers):
    """The full cycle's pair training (chip_smoke.py PAIR_CFG) at a tiny
    width, on the host data path: ImagePairDataset with 64^2 crops and
    homographic augmentation, labels from HDF5, batch 4, two epochs."""
    return {
        "dataset": dict(corpus, type="ImagePairDataset",
                        single_image=False, height=64, width=64,
                        augmentation={"homographic": dict(
                            FLAGSHIP_AUG["homographic"], enable=True)}),
        "model": {"type": "XPoint", "multispectral": True,
                  "descriptor_head": True, "descriptor_size": 16,
                  "final_batchnorm": True, "reflection_pad": True,
                  "takes_pair": True, "channel_version": 2,
                  "spectral_norm_stats": True,
                  "homography_regression_head": {"check": False}},
        "loss": {"type": "XPointLoss", "detector_loss": True,
                 "detector_loss_function": "cross_entropy",
                 "detector_handle_multiple_keypoints": "soft_assignment",
                 "detector_dustbin_loss_weight": 0.025,
                 "descriptor_loss": True, "descriptor_loss_threshold": 4.0,
                 "descriptor_loss_use_mask": True,
                 "sparse_descriptor_loss": False, "positive_margin": 1.0,
                 "negative_margin": 0.2, "lambda_d": 250, "lambda": 1.0},
        "training": {"batchsize": 4, "learningrate": 1e-3, "n_epochs": 2,
                     "save_every_n_epoch": 1, "use_writer": False,
                     "num_worker": workers},
    }


def _trainer_tensors(trainer):
    st = trainer.state
    return [t.clone() for t in (*trainer.module.state_dict().values(),
                                *st.opt_state["mu"], *st.opt_state["nu"],
                                st.opt_state["count"], st.step)]


def test_trainer_from_config_on_host_data(tmp_path):
    """Two epochs of 2 steps on an 8-pair HDF5 corpus with labels, the
    Trainer building its dataset from the config: the same batches and the
    same final state bit for bit with 1 and 4 loader workers, and a run
    resumed from e1 ends bit for bit where the straight run ended."""
    corpus, _, _ = _pair_corpus(tmp_path, "hdf5", "one", n=8)
    runs, batches = {}, {}
    for workers in (1, 4):
        t = Trainer(pair_config(corpus, workers),
                    str(tmp_path / f"w{workers}"), seed=0, device="cpu")
        assert isinstance(t.dataset, data.ImagePairDataset)
        assert t.loader.workers == workers
        # the first batch of epoch 0, from a loader of its own (the
        # trainer's would draw the epoch's shuffle)
        t.dataset.set_epoch(0, 0)
        batches[workers] = next(iter(data.DataLoader(
            t.dataset, 4, shuffle=True, seed=0, workers=workers)))
        t.train()
        runs[workers] = _trainer_tensors(t)
    assert_same(batches[4], batches[1])
    assert all(torch.equal(a, b) for a, b in zip(runs[1], runs[4]))
    assert int(t.state.step) == 4
    os.makedirs(tmp_path / "resumed")
    shutil.copy(tmp_path / "w4" / "e1.pt", tmp_path / "resumed" / "e1.pt")
    r = Trainer(pair_config(corpus, 4), str(tmp_path / "resumed"), seed=0,
                device="cpu")
    assert r.resume("e1") == 1
    r.train()
    resumed = _trainer_tensors(r)
    assert len(resumed) == len(runs[1])
    assert all(torch.equal(a, b) for a, b in zip(resumed, runs[1]))
