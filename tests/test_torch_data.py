"""Parity of the PyTorch port's device data path (warp, homography helpers,
augmentation, resident batches) with the JAX package's, on the same numpy
homographies and images, on the CPU. The random samplers cannot draw JAX's
bits, so they get property tests instead."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.data.device_augment import _solve_h4 as jx_solve_h4
from xpoint_tpu.data.device_augment import \
    prep_hm_input_device as jx_prep_hm
from xpoint_tpu.data.device_augment import \
    sample_homography_device as jx_sample
from xpoint_tpu.data.device_augment import \
    warp_keypoint_map as jx_warp_kp_map
from xpoint_tpu.data.device_dataset import \
    load_resident_pair_data as jx_load
from xpoint_tpu.data.device_dataset import \
    make_resident_batch_fn as jx_batch_fn
from xpoint_tpu.geometry.homography import \
    compute_valid_mask_device as jx_valid_mask
from xpoint_tpu.geometry.homography import sample_homography
from xpoint_tpu.geometry.homography import warp_points as jx_warp_points
from xpoint_tpu.ops.warp import warp_image_batch as jx_warp_image_batch

from xpoint_tpu_torch.data.device_augment import (_solve_h4,
                                                  make_pair_augment,
                                                  prep_hm_input_device,
                                                  sample_homography_device,
                                                  warp_keypoint_map)
from xpoint_tpu_torch.data.device_dataset import (load_resident_pair_data,
                                                  make_resident_batch_fn)
from xpoint_tpu_torch.geometry.homography import (compute_valid_mask_device,
                                                  warp_points)
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
from xpoint_tpu_torch.ops.warp import warp_image_batch

T = torch.from_numpy
FLAGSHIP_PARAMS = VMAMBA_TRAIN_CFG["dataset"]["augmentation"]["homographic"][
    "params"]


def _homs(seed, n, shape=(48, 64), **kw):
    """Host-sampler (numpy) homographies, fp32."""
    rng = np.random.default_rng(seed)
    return np.stack([sample_homography(shape, rng=rng, **kw)
                     for _ in range(n)]).astype(np.float32)


def test_warp_points_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 64, size=(3, 50, 2)).astype(np.float32)
    h = _homs(1, 3)
    np.testing.assert_allclose(
        warp_points(T(pts), T(h)).numpy(),
        np.asarray(jx_warp_points(jnp.asarray(pts), jnp.asarray(h))),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("erosion,border", [(0, False), (2, False),
                                            (3, True)])
def test_compute_valid_mask_matches_jax(erosion, border):
    h = _homs(2, 4)
    got = compute_valid_mask_device(T(h), (48, 64), erosion, border).numpy()
    want = np.asarray(jx_valid_mask(jnp.asarray(h), (48, 64), erosion,
                                    border))
    assert got.shape == (4, 48, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("padding", ["zeros", "reflection"])
def test_warp_image_batch_matches_jax(padding):
    """The explicit gather against the JAX warp on [0, 1) images, atol
    1e-4: the 3x3 inverse is taken in another order on each side, so the
    fp32 source coordinates (up to ~100 px) differ by a few ulps (2e-5 px
    seen), and the bilinear blend passes that on times the image's slope
    (<= 1 per px here)."""
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(4, 48, 64, 2)).astype(np.float32)
    h = _homs(4, 4, max_angle=3.0, translation_overflow=0.3)
    got = warp_image_batch(T(img), T(h), padding_mode=padding).numpy()
    want = np.asarray(jx_warp_image_batch(jnp.asarray(img), jnp.asarray(h),
                                          mode="bilinear",
                                          padding_mode=padding))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_warp_keypoint_map_matches_jax():
    rng = np.random.default_rng(5)
    B, K = 3, 64
    coords = rng.uniform(0, 48, size=(B, K, 2)).astype(np.float32)
    coords[..., 1] *= 64 / 48
    valid = rng.uniform(size=(B, K)) < 0.8
    h = _homs(6, B)
    got = warp_keypoint_map(T(coords), T(valid), T(h), (48, 64)).numpy()
    want = np.stack([np.asarray(jx_warp_kp_map(
        jnp.asarray(coords[b]), jnp.asarray(valid[b]), jnp.asarray(h[b]),
        (48, 64))) for b in range(B)])
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


def test_prep_hm_input_matches_jax():
    rng = np.random.default_rng(7)
    B, S = 3, 160
    opt = rng.uniform(size=(B, S, S, 1)).astype(np.float32)
    th = rng.uniform(size=(B, S, S, 1)).astype(np.float32)
    h_o = _homs(8, B, (S, S))
    h_t = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    h_t[1] = _homs(9, 1, (S, S))[0]
    tl, patch = (S // 2 - 64, S // 2 - 64), (128, 128)
    hm, four = prep_hm_input_device(T(opt), T(th), T(h_o), T(h_t), tl, patch)
    for b in range(B):
        jhm, jfour = jx_prep_hm(jnp.asarray(opt[b]), jnp.asarray(th[b]),
                                jnp.asarray(h_o[b]), jnp.asarray(h_t[b]),
                                tl, patch)
        np.testing.assert_array_equal(hm[b].numpy(), np.asarray(jhm))
        np.testing.assert_array_equal(four[b].numpy(), np.asarray(jfour))


def test_solve_h4_matches_jax():
    rng = np.random.default_rng(10)
    src = np.tile(np.array([[0, 0], [0, 48], [64, 48], [64, 0]],
                           np.float32), (5, 1, 1))
    dst = (src + rng.uniform(-8, 8, size=src.shape)).astype(np.float32)
    got = _solve_h4(T(src), T(dst)).numpy()
    for b in range(5):
        want = np.asarray(jx_solve_h4(jnp.asarray(src[b]),
                                      jnp.asarray(dst[b])))
        np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-6)
    # and it maps the corners onto their targets
    p = np.concatenate([src, np.ones((5, 4, 1), np.float32)], -1) \
        @ got.transpose(0, 2, 1)
    np.testing.assert_allclose(p[..., :2] / p[..., 2:], dst, atol=1e-3)


def test_sampler_every_transform_off():
    """Nothing random is left: the centred patch square, as in JAX; at
    patch_ratio 1 the identity."""
    off = dict(perspective=False, scaling=False, rotation=False,
               translation=False)
    gen = torch.Generator().manual_seed(0)
    h = sample_homography_device(gen, 3, (64, 96), patch_ratio=0.8, **off)
    want = np.asarray(jx_sample(jax.random.PRNGKey(0), (64, 96),
                                patch_ratio=0.8, **off))
    for b in range(3):
        np.testing.assert_allclose(h[b].numpy(), want, atol=1e-5)
    eye = sample_homography_device(gen, 2, (64, 96), patch_ratio=1.0, **off)
    np.testing.assert_allclose(eye.numpy(), np.tile(np.eye(3), (2, 1, 1)),
                               atol=1e-5)


def _corner_cloud(h, shape):
    Hh, Ww = shape
    c = np.array([[0, 0, 1], [Ww - 1, 0, 1], [Ww - 1, Hh - 1, 1],
                  [0, Hh - 1, 1]], np.float64).T
    p = h.astype(np.float64) @ c
    return p[:, :2] / p[:, 2:3]


def test_sampler_without_artifacts_keeps_corners_inside():
    params = dict(FLAGSHIP_PARAMS, allow_artifacts=False,
                  scaling_amplitude=0.15, perspective_amplitude_x=0.05,
                  perspective_amplitude_y=0.05, patch_ratio=0.7,
                  max_angle=0.8)
    gen = torch.Generator().manual_seed(3)
    h = sample_homography_device(gen, 128, (64, 64), **params).numpy()
    xy = _corner_cloud(h, (64, 64))
    assert np.isfinite(xy).all()
    assert xy.min() >= -1.0 and xy.max() <= 64.0
    # and the draws do vary
    assert xy.std(0).min() > 1.0


def test_sampler_reproducible_and_distributed_like_jax():
    """Same seed, same draws; other seed, other draws; the flagship
    parameters give a warped-corner spread like the JAX sampler's (loose
    statistical bounds over 200 draws)."""
    shape = (64, 64)
    a = sample_homography_device(torch.Generator().manual_seed(1), 200,
                                 shape, **FLAGSHIP_PARAMS).numpy()
    b = sample_homography_device(torch.Generator().manual_seed(1), 200,
                                 shape, **FLAGSHIP_PARAMS).numpy()
    c = sample_homography_device(torch.Generator().manual_seed(2), 200,
                                 shape, **FLAGSHIP_PARAMS).numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    keys = jax.random.split(jax.random.PRNGKey(42), 200)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda k: jx_sample(k, shape, **FLAGSHIP_PARAMS)))(keys))
    mine, theirs = _corner_cloud(a, shape), _corner_cloud(ref, shape)
    assert np.all(np.abs(np.linalg.det(a)) > 1e-6)
    np.testing.assert_allclose(mine.mean(0), theirs.mean(0), atol=8.0)
    np.testing.assert_allclose(mine.std(0), theirs.std(0), rtol=0.35,
                               atol=4.0)


def test_pair_augment_semantics():
    """One side warped per sample by the homography it reports, the other
    the identity with an all-ones mask; the warped side's image, mask and
    keypoint map equal the port's own functions on that homography."""
    B, S = 6, 64
    rng = np.random.default_rng(12)
    img = rng.uniform(size=(B, S, S, 1)).astype(np.float32)
    coords = rng.uniform(0, S, size=(B, 20, 2)).astype(np.float32)
    valid = np.ones((B, 20), bool)
    side = lambda: {'image': T(img), 'keypoint_coords': T(coords),  # noqa
                    'keypoint_valid': T(valid)}
    aug = make_pair_augment((S, S), FLAGSHIP_PARAMS, hm_input=True)
    out = aug(torch.Generator().manual_seed(0),
              {'optical': side(), 'thermal': side()})
    eye = torch.eye(3)
    warped_o = ~torch.all((out['optical']['homography'] - eye).abs() < 1e-6,
                          dim=(1, 2))
    warped_t = ~torch.all((out['thermal']['homography'] - eye).abs() < 1e-6,
                          dim=(1, 2))
    assert torch.equal(warped_o, ~warped_t)
    assert 0 < int(warped_o.sum()) < B        # the coin flip varies
    for name in ('optical', 'thermal'):
        o = out[name]
        h = o['homography']
        assert torch.equal(o['image'], warp_image_batch(
            T(img), h, padding_mode="reflection"))
        assert torch.equal(o['keypoints'], warp_keypoint_map(
            T(coords), T(valid), h, (S, S)))
        mask = compute_valid_mask_device(h, (S, S))
        warped = warped_o if name == 'optical' else warped_t
        for b in range(B):
            want = mask[b] if warped[b] else torch.ones(S, S)
            assert torch.equal(o['valid_mask'][b], want)
    assert out['hm_input'].shape == (B, S, S, 2)
    assert out['hfour_points'].shape == (B, 4, 2)


class _Pairs:
    """A small in-memory dataset with the ImagePairDataset loading pair."""

    def __init__(self, n, size, k):
        rng = np.random.default_rng(13)
        self.imgs = rng.uniform(size=(n, 2, *size)).astype(np.float32)
        self.kps = [rng.uniform(0, min(size), size=(k - i, 2)).astype(
            np.float32) for i in range(n)]

    def __len__(self):
        return len(self.imgs)

    def _load_images(self, i):
        return self.imgs[i, 0], self.imgs[i, 1]

    def _load_keypoints(self, i):
        return self.kps[i]


def test_resident_batch_without_augmentation_matches_jax():
    """Full-size crops and no augmentation leave nothing random: the batch
    equals JAX's (images, keypoint maps, masks, homographies)."""
    ds = _Pairs(5, (64, 96), 30)
    cfg = {'height': 64, 'width': 96, 'random_pairs': False,
           'augmentation': {'photometric': {'enable': False},
                            'homographic': {'enable': False}}}
    data, meta = load_resident_pair_data(ds, device="cpu")
    jdata, jmeta = jx_load(ds)
    assert meta == jmeta
    idx = np.array([3, 0, 4])
    got = make_resident_batch_fn(cfg, meta)(
        torch.Generator().manual_seed(0), {'data': data, 'idx': T(idx)})
    want = jax.jit(jx_batch_fn(cfg, jmeta))(
        jax.random.PRNGKey(0), {'data': jdata, 'idx': jnp.asarray(idx)})
    for side in ('optical', 'thermal'):
        for key in ('image', 'keypoints', 'valid_mask', 'homography',
                    'is_optical'):
            np.testing.assert_array_equal(got[side][key].numpy(),
                                          np.asarray(want[side][key]),
                                          err_msg=f"{side}/{key}")


def test_resident_batch_crops_and_augments():
    """Random crops cut the drawn windows (keypoints shifted with them);
    the flagship augmentation yields the full pair batch with RegNet
    inputs; the same generator seed gives the same batch."""
    ds = _Pairs(4, (80, 72), 25)
    cfg = dict(VMAMBA_TRAIN_CFG['dataset'], height=64, width=64)
    data, meta = load_resident_pair_data(ds, device="cpu")
    fn = make_resident_batch_fn(cfg, meta, hm_input=True)
    payload = {'data': data, 'idx': torch.tensor([1, 2, 3, 0, 1])}
    a = fn(torch.Generator().manual_seed(5), payload)
    b = fn(torch.Generator().manual_seed(5), payload)
    for side in ('optical', 'thermal'):
        assert a[side]['image'].shape == (5, 64, 64, 1)
        assert a[side]['keypoints'].shape == (5, 64, 64)
        assert a[side]['valid_mask'].shape == (5, 64, 64)
        assert torch.equal(a[side]['image'], b[side]['image'])
    assert a['hm_input'].shape == (5, 64, 64, 2)
    assert a['hfour_points'].shape == (5, 4, 2)
    noaug = dict(cfg, augmentation={'photometric': {'enable': False},
                                    'homographic': {'enable': False}})
    c = make_resident_batch_fn(noaug, meta)(torch.Generator().manual_seed(6),
                                            payload)
    opt = c['optical']['image'][..., 0]
    for i, j in enumerate(payload['idx'].tolist()):
        full = data['optical'][j]
        hits = [(r, q) for r in range(80 - 64 + 1) for q in range(72 - 64 + 1)
                if torch.equal(full[r:r + 64, q:q + 64], opt[i])]
        assert len(hits) == 1
        r, q = hits[0]
        kp = ds.kps[j] - np.array([r, q], np.float32)
        ok = (kp[:, 0] >= 0) & (kp[:, 0] < 64) & (kp[:, 1] >= 0) & \
            (kp[:, 1] < 64)
        want = np.zeros((64, 64), np.float32)
        ki = kp[ok].astype(np.int32)
        want[ki[:, 0], ki[:, 1]] = 1.0
        np.testing.assert_array_equal(c['optical']['keypoints'][i].numpy(),
                                      want)


def test_photometric_augmentation_raises():
    cfg = dict(VMAMBA_TRAIN_CFG['dataset'], height=64, width=64)
    cfg['augmentation'] = {'photometric': {'enable': True},
                           'homographic': {'enable': False}}
    with pytest.raises(NotImplementedError, match="use the host data path"):
        make_resident_batch_fn(cfg, {'shape': (64, 64), 'k': 0, 'n': 1})
