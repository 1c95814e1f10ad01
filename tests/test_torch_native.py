"""The port's native augmentation engine (``xpoint_tpu_torch.native``, built
with g++ at first use from its own copy of ``augment.cpp``) against the JAX
package's (``xpoint_tpu.native``, its committed library), and the port's
default homographic augmentation against the JAX package's default, which
is that engine.

Both libraries compile the same source with the same flags
(``-O3 -march=native -ffast-math``); on the same host they give the same
bits, so the tolerance is exact equality (measured: 0 on every case here).
The datasets' default path is held as test_torch_host_data.py holds the cv2
path: the same samples from generators seeded alike, and both sides'
generators in the same state afterwards. A failed build raises.
"""
import numpy as np
import pytest

import xpoint_tpu.data.augmentation as jx_aug
from xpoint_tpu import native as jx_native
from xpoint_tpu.data import SyntheticShapes as JxSyntheticShapes
from xpoint_tpu.geometry import sample_homography

import xpoint_tpu_torch.data.augmentation as aug
from xpoint_tpu_torch import native
from xpoint_tpu_torch.data import SyntheticShapes

from test_torch_host_data import FLAGSHIP_AUG, _image, both
from test_torch_synthetic_shapes import SMALL
from torch_env import torch_env  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def engine_path(monkeypatch):
    """The JAX package's default path: its engine must load, else JAX
    would compare its cv2 path with the port's engine."""
    monkeypatch.delenv("XPOINT_NO_NATIVE", raising=False)
    assert jx_native.available()


@pytest.mark.parametrize("shape", [(96, 96), (128, 160), (200, 256),
                                   (256, 256)])
@pytest.mark.parametrize("reflect", [True, False])
@pytest.mark.parametrize("erosion,border", [(0, True), (6, True),
                                            (6, False)])
def test_engine_matches_jax_engine(shape, reflect, erosion, border):
    for seed in range(3):
        rng = np.random.default_rng(seed)
        img = rng.uniform(size=shape).astype(np.float32)
        H = sample_homography(shape, rng=rng)
        want = jx_native.homographic_augment(img, H, reflect, erosion, border)
        got = native.homographic_augment(img, H, reflect, erosion, border)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert 0 < got[1].sum() < got[1].size


def test_engine_keypoint_warp_matches_jax_engine():
    rng = np.random.default_rng(2)
    kps = rng.uniform(5, 90, size=(20, 2))
    H = sample_homography((96, 96), rng=rng)
    np.testing.assert_array_equal(native.warp_keypoints(kps, H),
                                  jx_native.warp_keypoints(kps, H))
    assert native.warp_keypoints(np.zeros((0, 2)), H) is None


@pytest.mark.parametrize("corner", [False, True])
@pytest.mark.parametrize("margin,reflect", [(0, True), (3, True), (3, False)])
def test_default_homographic_augmentation_matches_jax(corner, margin,
                                                      reflect):
    """Both packages' default path (the engine): image, keypoints, mask
    and homography exactly, float images within 1e-6 (both() of
    test_torch_host_data.py), the generators in the same state."""
    params = dict(FLAGSHIP_AUG["homographic"]["params"])
    params["corner_homography"] = {"enable": corner,
                                   "params": {"patch_size": 24, "rho": 6}}
    cfg = {"params": params, "border_reflect": reflect,
           "valid_border_margin": margin, "mask_border": True}
    for seed in range(3):
        img = _image(seed)
        kp = np.random.default_rng(seed).integers(0, 48, size=(20, 2))
        for keypoints in (kp, None):
            got = both(seed, lambda: jx_aug.homographic_augmentation(
                img, keypoints, return_homography=True, **cfg),
                lambda rng, py: aug.homographic_augmentation(
                    img, rng, keypoints, return_homography=True, **cfg))
            # the engine's output, not cv2's (which keeps float64)
            assert got[0].dtype == np.float32


def test_default_path_is_the_engine_and_the_switch_is_cv2(monkeypatch):
    """The same draw through the two paths (test_native.py's case: a
    float32 image, the sampler's default homography): they differ, within
    test_native.py's limits (2e-3 inside a 10-pixel border, 2% of the
    eroded mask)."""
    img = _image(7, (96, 128)).astype(np.float32)
    rng = np.random.RandomState(7)
    warped_n, _, mask_n = aug.homographic_augmentation(
        img, rng, valid_border_margin=3)
    monkeypatch.setenv("XPOINT_NO_NATIVE", "1")
    rng = np.random.RandomState(7)
    warped_c, _, mask_c = aug.homographic_augmentation(
        img, rng, valid_border_margin=3)
    assert not np.array_equal(warped_n, warped_c)
    inner = np.zeros(img.shape, bool)
    inner[10:-10, 10:-10] = True
    assert np.abs(warped_n - warped_c)[inner].max() < 2e-3
    assert (mask_n != mask_c).mean() < 0.02


def test_synthetic_shapes_default_path_matches_jax():
    """SyntheticShapes on the fly with homographic augmentation (the
    cycle's pretrain data), both packages on their default path."""
    jx_ds, ds = JxSyntheticShapes(SMALL), SyntheticShapes(SMALL)
    for seed in range(4):
        s = both(seed, lambda: jx_ds[seed], lambda rng, py: ds.sample(
            seed, rng, py))
        assert 0 < s["valid_mask"].sum() < s["valid_mask"].size


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails: the engine raises with its message, and the
    augmentation raises too instead of taking cv2."""
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    with pytest.raises(RuntimeError, match="failed"):
        aug.homographic_augmentation(_image(0), np.random.RandomState(0))
    assert not list(tmp_path.iterdir())


def test_failed_compile_raises(monkeypatch, tmp_path):
    """g++ on a source that does not compile (its target probe passes, so
    the compile step is what fails): the error carries g++'s diagnostic,
    the augmentation raises instead of taking cv2, and no library,
    finished or partial, is left in the build directory."""
    build_dir = tmp_path / "build"
    bad = tmp_path / "broken_engine.cpp"
    bad.write_text('extern "C" int homographic_augment() '
                   '{ return not_declared_anywhere; }\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native engine"
                       ) as err:
        native.load()
    msg = str(err.value)
    assert "broken_engine.cpp" in msg and "not_declared_anywhere" in msg
    assert "error" in msg
    with pytest.raises(RuntimeError, match="failed"):
        aug.homographic_augmentation(_image(0), np.random.RandomState(0))
    assert build_dir.is_dir() and not list(build_dir.iterdir())
