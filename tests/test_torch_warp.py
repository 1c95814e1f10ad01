"""Parity of the PyTorch port's warps and host homography helpers with the
JAX package's, on the same numpy inputs, on the CPU. The port's device-
dispatching entry points (ops/warp_projective.py) run their plain gather
here (the projective-warp kernel needs the card); the JAX tiled warps take
their XLA two-pass path."""
from math import pi

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from xpoint_tpu.geometry.homography import \
    sample_homography as jx_sample_homography
from xpoint_tpu.geometry.homography import compute_valid_mask
from xpoint_tpu.ops import warp as jx_warp
from xpoint_tpu.ops import warp_tiled as jx_tiled

from xpoint_tpu_torch.geometry.homography import sample_homography
from xpoint_tpu_torch.ops import warp, warp_projective
from xpoint_tpu_torch.selfsup.homographic_adaptation import (
    EXPORT_HA_CONFIG, HA_DEFAULT_CONFIG)
from torch_env import torch_env  # noqa: F401 (autouse)

T = torch.from_numpy
HA_SAMPLER = HA_DEFAULT_CONFIG["homographies"]
SAMPLERS = {"ha": HA_SAMPLER, "export": EXPORT_HA_CONFIG["homographies"],
            "no_artifacts": dict(allow_artifacts=False, max_angle=pi / 3)}


def _homs(seed, n, shape, **kw):
    rng = np.random.default_rng(seed)
    return np.stack([jx_sample_homography(np.array(shape), rng=rng, **kw)
                     for _ in range(n)]).astype(np.float32)


def _both(kind, img, h, mode, padding):
    """(port, JAX) outputs of warp_image_<kind> on the same inputs."""
    got = getattr(warp, f"warp_image_{kind}")(T(img), T(h), mode,
                                              padding).numpy()
    want = np.asarray(getattr(jx_warp, f"warp_image_{kind}")(
        jnp.asarray(img), jnp.asarray(h), mode=mode, padding_mode=padding))
    assert got.shape == want.shape
    return got, want


def _assert_warp_close(got, want, mode):
    """bilinear: atol 1e-4 on [0, 1) images (the 3x3 inverse is taken in
    another order on each side, so source coordinates differ by a few fp32
    ulps and the blend passes that on times the image's slope); nearest: a
    coordinate within an ulp of a half-integer rounds to the other pixel,
    share of differing values < 1e-3."""
    assert np.isfinite(got).all()
    if mode == "bilinear":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("padding", ["zeros", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("kind", ["multi", "batch"])
def test_warp_image_matches_jax(kind, mode, padding):
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(4, 48, 64, 2)).astype(np.float32)
    h = _homs(4, 4, (48, 64), max_angle=3.0, translation_overflow=0.3)
    got, want = _both(kind, img, h, mode, padding)
    assert got.shape == ((4, 4, 48, 64, 2) if kind == "multi"
                         else (4, 48, 64, 2))
    _assert_warp_close(got, want, mode)
    assert got.std() > 0.05


@pytest.mark.parametrize("mode,padding", [("bilinear", "reflection"),
                                          ("bilinear", "zeros"),
                                          ("nearest", "zeros")])
def test_grid_sample_computes_the_same_function(mode, padding):
    """``F.grid_sample(align_corners=True)`` on the normalised source
    coordinates is the library's form of the three warps homographic
    adaptation makes (its 'reflection' mirrors about the border pixels'
    centres, REFLECT_101; its 'nearest' rounds half to even). The
    normalisation costs a few ulps of the coordinates: bilinear atol 1e-4
    on [0, 1) images, nearest share of differing values < 1e-3."""
    rng = np.random.default_rng(8)
    H, W = 40, 56
    img = T(rng.uniform(size=(4, H, W, 2)).astype(np.float32))
    h = T(_homs(9, 4, (H, W), **HA_SAMPLER))
    want = warp.warp_image_batch(img, h, mode, padding).numpy()
    ys, xs = warp._source_coords(h, H, W)
    grid = torch.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1], -1)
    got = F.grid_sample(img.permute(0, 3, 1, 2), grid.reshape(4, H, W, 2),
                        mode=mode, padding_mode=padding, align_corners=True)
    _assert_warp_close(got.permute(0, 2, 3, 1).numpy(), want, mode)


@pytest.mark.parametrize("kind", ["multi", "batch"])
def test_warp_horizon_crossing_homography_is_finite(kind):
    """The horizon line (denominator 0) crosses the canvas and the principal
    point (0/0) lies on a pixel: coordinates saturate, the output stays
    finite, and away from the horizon it agrees with JAX."""
    rng = np.random.default_rng(7)
    img = rng.uniform(size=(2, 32, 32, 1)).astype(np.float32)
    hinv = np.array([[1.0, 0, 0], [0, 1.0, 0], [0.125, 0, -2.0]], np.float32)
    h = np.stack([np.linalg.inv(hinv), np.linalg.inv(hinv)]).astype(
        np.float32)
    for padding in ("zeros", "reflection"):
        got, want = _both(kind, img, h, "bilinear", padding)
        assert np.isfinite(got).all()
        # columns next to x = 16 have |denominator| <= 0.125: excluded
        far = np.abs(np.arange(32) - 16) > 1
        np.testing.assert_allclose(got[..., far, :], want[..., far, :],
                                   atol=1e-3, rtol=0)


def test_warp_rejects_unknown_modes():
    img, h = torch.zeros(1, 8, 8, 1), torch.eye(3)[None]
    with pytest.raises(ValueError, match="interpolation"):
        warp.warp_image_batch(img, h, mode="cubic")
    with pytest.raises(ValueError, match="padding"):
        warp.warp_image_multi(img, h, padding_mode="border")


# ---- the dispatching entry points, held to JAX's limits for its tiled
# warps against its gather warp -------------------------------------------

def _smooth_image(H, W, B=2):
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = (np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.float32)
    return np.concatenate([img[None, :, :, None]] * B, axis=0)


def _tiled_both(kind, img, h, mode, padding):
    before = warp_projective.warp_projective.launches
    got = getattr(warp_projective, f"warp_{kind}")(
        T(img), T(h), mode, padding).numpy()
    # a CPU tensor runs the plain version, never the kernel
    assert warp_projective.warp_projective.launches == before
    want = np.asarray(getattr(jx_tiled, f"warp_image_{kind}_tiled")(
        jnp.asarray(img), jnp.asarray(h), mode, padding))
    assert got.shape == want.shape
    return got, want


def test_tiled_simple_transforms_match_jax():
    """Axis-aligned maps have no two-pass approximation term on the JAX
    side: 2e-5, JAX's own limit against its gather warp."""
    img = _smooth_image(64, 64, B=1)
    h = np.stack([
        np.eye(3, dtype=np.float32),
        np.array([[1, 0, 3.7], [0, 1, -2.2], [0, 0, 1]], np.float32),
        np.diag([0.9, 0.9, 1.0]).astype(np.float32)])
    got, want = _tiled_both("multi", img, h, "bilinear", "zeros")
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_tiled_near_90_degree_rotation_matches_jax():
    img = _smooth_image(64, 64, B=1)
    th = np.pi / 2 - 0.05
    h = np.array([[[np.cos(th), -np.sin(th), 60],
                   [np.sin(th), np.cos(th), 2], [0, 0, 1]]], np.float32)
    got, want = _tiled_both("multi", img, h, "bilinear", "zeros")
    assert np.abs(got - want).max() < 5e-3


@pytest.mark.parametrize("padding", ["zeros", "reflection"])
@pytest.mark.parametrize("kind", ["multi", "batch"])
def test_tiled_sampled_family_matches_jax(kind, padding):
    """Over the HA sampler at 128^2, inside each homography's valid mask
    (where HA consumes the warp): JAX's two-pass resampler approximates the
    single-pass bilinear warp the port computes; its own limits against its
    gather warp are a masked mean < 2e-3 and a max < 0.2."""
    H = W = 128
    n = 8
    h = _homs(0, n, (H, W), **HA_SAMPLER)
    masks = np.stack([compute_valid_mask((H, W), hm, erosion_radius=3)
                      for hm in h]).astype(np.float32)
    if kind == "multi":
        img = _smooth_image(H, W)
        m = masks[:, None, :, :, None]
    else:
        img = np.concatenate([_smooth_image(H, W, B=1)] * n)
        img = img * np.linspace(0.5, 1.0, n, dtype=np.float32)[:, None, None,
                                                               None]
        m = masks[:, :, :, None]
    got, want = _tiled_both(kind, img, h, "bilinear", padding)
    err = np.abs(got - want) * m
    mean = err.sum() / max(np.broadcast_to(m, err.shape).sum(), 1)
    assert mean < 2e-3, mean
    assert err.max() < 0.2, err.max()


@pytest.mark.parametrize("kind", ["multi", "batch"])
def test_tiled_nearest_mask_matches_jax(kind):
    """Valid-mask (blob) unwarp in nearest mode: boundary rounding differs
    on isolated edge pixels only (JAX's limit: 5e-3 of the pixels)."""
    H = W = 128
    n = 8
    mask = np.zeros((1 if kind == "multi" else n, H, W, 1), np.float32)
    mask[:, 10:110, 15:100] = 1
    h = _homs(1, n, (H, W), **HA_SAMPLER)
    got, want = _tiled_both(kind, mask, h, "nearest", "zeros")
    assert set(np.unique(got)) <= {0.0, 1.0}
    assert (got != want).mean() < 5e-3


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("kind", ["multi", "batch"])
def test_warp_entry_points_take_any_size(kind, mode):
    """No tile: a size that is no multiple of 32 goes the same way as any
    other, and agrees with JAX's gather warp."""
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(3, 40, 56, 1)).astype(np.float32)
    h = _homs(6, 3, (40, 56))
    got = getattr(warp_projective, f"warp_{kind}")(T(img), T(h), mode).numpy()
    want = np.asarray(getattr(jx_warp, f"warp_image_{kind}")(
        jnp.asarray(img), jnp.asarray(h), mode=mode))
    assert got.shape == want.shape
    _assert_warp_close(got, want, mode)


def test_warp_entry_points_check_their_arguments():
    img, h = torch.zeros(2, 48, 64, 1), torch.eye(3)[None]
    with pytest.raises(ValueError, match="2 images for 1"):
        warp_projective.warp_batch(img, h)
    with pytest.raises(ValueError, match=r"\(n, 3, 3\)"):
        warp_projective.warp_multi(img, torch.eye(3))
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        warp_projective.warp_multi(img[0], h)
    with pytest.raises(ValueError, match="interpolation"):
        warp_projective.warp_multi(img, h, mode="cubic")
    assert warp_projective.warp_multi(img, h).shape == (1, 2, 48, 64, 1)


# ---- host homography helpers ---------------------------------------------

@pytest.mark.parametrize("name", sorted(SAMPLERS))
@pytest.mark.parametrize("shape", [(512, 512), (48, 64)])
def test_sample_homography_matches_jax(name, shape):
    """Same seed, same draws in the same order and the same
    cv2.getPerspectiveTransform fit: the same matrix bit for bit."""
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(20):
        want = jx_sample_homography(np.array(shape), rng=r1, **SAMPLERS[name])
        got = sample_homography(np.array(shape), rng=r2, **SAMPLERS[name])
        assert got.dtype == np.float64 and got.shape == (3, 3)
        np.testing.assert_array_equal(got, want)
    # both generators are left in the same state
    assert r1.uniform() == r2.uniform()
