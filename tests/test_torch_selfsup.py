"""Parity of the PyTorch port's homographic adaptation and label export with
the JAX package's, on the same numpy images and homographies, on the CPU.

HA's count comes from a nearest-mode unwarp of the eroded valid masks, and
the two packages invert the homographies with different last bits, so a
mask pixel on a blob's edge can flip; a flipped pixel changes that pixel's
count and with it its output. Every comparison of HA outputs is therefore
made where both sides hold the same count, and asserts how few pixels that
leaves out."""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from xpoint_tpu.eval.infer import XPointInference as JxInference
from xpoint_tpu.geometry.homography import \
    compute_valid_mask_device as jx_valid_mask
from xpoint_tpu.ops.detector import prob_from_logits as jx_prob_from_logits
from xpoint_tpu.ops.nms import box_nms as jx_box_nms

from xpoint_tpu_torch.compat.from_flax import load_flax_variables
from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
from xpoint_tpu_torch.eval.infer import XPointInference
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.ops.nms import box_nms
from xpoint_tpu_torch.selfsup.export import (H5Sink, NumpySink,
                                             export_keypoints, make_prob_fn)

from test_torch_models import _jax_tiny_model, tiny_cfg
from torch_env import torch_env  # noqa: F401 (autouse)

# each package re-exports a function of the same name over the module
jx_ha = importlib.import_module("xpoint_tpu.selfsup.homographic_adaptation")
ha = importlib.import_module("xpoint_tpu_torch.selfsup.homographic_adaptation")
T = torch.from_numpy


def test_default_config_is_the_jax_one():
    assert ha.HA_DEFAULT_CONFIG == jx_ha.HA_DEFAULT_CONFIG


@pytest.mark.parametrize("weighted", [True, False])
def test_search_window_matches_jax(weighted):
    rng = np.random.default_rng(0)
    p1 = rng.uniform(size=(2, 20, 24)).astype(np.float32) ** 3
    p2 = rng.uniform(size=(2, 20, 24)).astype(np.float32) ** 3
    p1[0, :8] = 0
    p2[1, :, 10:] = 0
    got = ha.search_window(T(p1), T(p2), 5, weighted)
    want = jx_ha.search_window(jnp.asarray(p1), jnp.asarray(p2), 5, weighted)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("size", [3, 5])
def test_smooth_matches_jax(size):
    p = np.random.default_rng(1).uniform(size=(2, 16, 20)).astype(np.float32)
    np.testing.assert_allclose(ha._smooth(T(p), size).numpy(),
                               np.asarray(jx_ha._smooth(jnp.asarray(p), size)),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["default", "export"])
def test_sample_ha_homographies_matches_jax(name):
    cfg = {"default": dict(ha.HA_DEFAULT_CONFIG, num=6),
           "export": ha.EXPORT_HA_CONFIG}[name]
    got = ha.sample_ha_homographies(cfg, (64, 64), np.random.default_rng(5))
    want, _ = jx_ha.sample_ha_homographies(cfg, (64, 64),
                                           np.random.default_rng(5),
                                           with_masks=False)
    assert got.dtype == np.float32 and got.shape == (cfg["num"] - 1, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-8 * np.abs(want).max())


# ---- make_ha_fn with an analytic detector written twice -------------------

_K = np.random.default_rng(2).normal(size=(2, 3, 3)).astype(np.float32)


def _prob_fn_torch(img, is_optical):
    k = T(_K[0 if is_optical else 1])[None, None]
    z = F.conv2d(img.permute(0, 3, 1, 2), k, padding=1)[:, 0]
    return torch.sigmoid(2.0 * z - 1.0) * 0.3


def _prob_fn_jax(img, is_optical):
    k = jnp.asarray(_K[0 if is_optical else 1])[None, None]
    z = jax.lax.conv_general_dilated(
        img.transpose(0, 3, 1, 2), k, (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[:, 0]
    return jax.nn.sigmoid(2.0 * z - 1.0) * 0.3


def _pair(seed, B, S):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    base = 0.5 + 0.4 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    img_o = np.clip(base[None, :, :, None] + 0.05 * rng.normal(
        size=(B, S, S, 1)), 0, 1).astype(np.float32)
    img_t = np.clip(1.0 - img_o ** 1.5, 0, 1).astype(np.float32)
    return img_o, img_t


def _jax_count(h, shape, cfg):
    """HA's per-pixel count as the JAX package forms it: 1 + the nearest
    unwarps of the eroded valid masks."""
    masks = jx_valid_mask(jnp.asarray(h), shape, cfg["erosion_radius"],
                          cfg["mask_border"])
    c = jx_ha._warp_batch(masks[..., None], jnp.linalg.inv(jnp.asarray(h)),
                          "nearest", "zeros")[..., 0]
    return 1.0 + np.asarray(c).sum(0)


def _run_both(cfg, S, B=2, warp_batch=2, seed=3, prob_fns=None):
    img_o, img_t = _pair(seed, B, S)
    pf_t, pf_j = prob_fns or (_prob_fn_torch, _prob_fn_jax)
    run_t, merged = ha.make_ha_fn(pf_t, cfg, warp_batch)
    run_j, merged_j = jx_ha.make_ha_fn(pf_j, cfg, warp_batch)
    assert merged == merged_j
    hs = ha.sample_ha_homographies(merged, (S, S), np.random.default_rng(4))
    got = run_t(T(img_o), T(img_t), T(hs))
    want = run_j(jnp.asarray(img_o), jnp.asarray(img_t), jnp.asarray(hs))
    count = got.pop("count").numpy()
    assert set(got) == set(want)
    same = count == _jax_count(hs, (S, S), merged)[None]
    keys = [k for k in got if got[k] is not None]
    assert keys == [k for k in want if want[k] is not None]
    assert keys == (["prob_optical", "prob_thermal"]
                    if merged["aggregation"] == "window" else ["prob"])
    pairs = [(got[k].numpy(), np.asarray(want[k])) for k in keys]
    return pairs, same, count, merged


HA_CASES = {
    "prod": dict(aggregation="prod"),
    "sum": dict(aggregation="sum"),
    "window": dict(aggregation="window"),
    "window_unweighted": dict(aggregation="window", weighted_window=False),
    "prod_smooth": dict(aggregation="prod", filter_size=3),
    "sum_smooth": dict(aggregation="sum", filter_size=5),
}


@pytest.mark.parametrize("case", sorted(HA_CASES))
def test_make_ha_fn_matches_jax_exact_gather(case):
    """48^2: JAX takes its exact gather warp, the same function as the
    port's warp. num 6 gives 5 warps,
    not a multiple of warp_batch 2 (one identity / zero-mask pad). atol 1e-4
    (the warps' 1e-4, see test_torch_warp.py) where the counts agree; at
    most 0.5% of the pixels may hold another count."""
    cfg = dict(HA_CASES[case], num=6, erosion_radius=2, min_count=3)
    pairs, same, count, merged = _run_both(cfg, 48)
    assert same.mean() > 0.995, 1 - same.mean()
    assert count.max() <= merged["num"] and count.min() >= 1
    assert (count < merged["min_count"]).any()       # the zeroing is live
    for got, want in pairs:
        assert got.shape == (2, 48, 48) and np.isfinite(got).all()
        assert got.max() > 0
        np.testing.assert_allclose(got[same], want[same], atol=1e-4, rtol=0)
        assert (got[count < merged["min_count"]] == 0).all()


@pytest.mark.parametrize("case", ["prod", "sum", "window"])
def test_make_ha_fn_matches_jax_tiled(case):
    """64^2: JAX takes its tiled warps. Its two-pass
    resampler approximates the single-pass warp the port computes (its own
    limit against its gather warp: masked mean < 2e-3), and its box-kernel
    nearest unwarp moves mask edges (its limit: 5e-3 of the pixels per
    warp), so up to 5% of the pixels may hold another count; where the
    counts agree the mean difference stays < 2e-3."""
    cfg = dict(HA_CASES[case], num=6, erosion_radius=2, min_count=3)
    pairs, same, count, merged = _run_both(cfg, 64)
    assert same.mean() > 0.95, 1 - same.mean()
    for got, want in pairs:
        assert got.shape == (2, 64, 64) and got.max() > 0
        assert np.abs(got - want)[same].mean() < 2e-3


def test_ha_with_num_one_is_the_plain_aggregation():
    img_o, img_t = _pair(5, 1, 48)
    run, _ = ha.make_ha_fn(_prob_fn_torch, dict(num=1, min_count=0))
    out = run(T(img_o), T(img_t), torch.zeros(0, 3, 3))
    want = torch.sqrt(_prob_fn_torch(T(img_o), True)
                      * _prob_fn_torch(T(img_t), False))
    torch.testing.assert_close(out["prob"], want)
    assert float(out["count"].max()) == 1.0


@pytest.mark.parametrize("bad", [dict(num=0), dict(filter_size=4),
                                 dict(aggregation="window", filter_size=3),
                                 dict(aggregation="mean")])
def test_make_ha_fn_rejects_bad_configs(bad):
    with pytest.raises(ValueError):
        ha.make_ha_fn(_prob_fn_torch, bad)


def test_single_spectrum_ha_matches_jax():
    img_o, _ = _pair(6, 2, 48)
    cfg = dict(num=4, erosion_radius=2, min_count=2)
    got = ha.homographic_adaptation(T(img_o), _prob_fn_torch, cfg,
                                    np.random.default_rng(8)).numpy()
    want = np.asarray(jx_ha.homographic_adaptation(
        jnp.asarray(img_o), _prob_fn_jax, cfg, np.random.default_rng(8)))
    assert got.shape == (2, 48, 48)
    # a flipped mask pixel moves its output; allow 0.5% of them
    assert (np.abs(got - want) > 1e-4).mean() < 5e-3


def test_ha_with_the_tiny_model_matches_jax():
    """The tiny VMamba XPoint, carried across by the weight bridge, as the
    detector at 64^2 (JAX on its tiled warps): mean difference < 2e-3
    where the counts agree, on maps whose maximum is above 0.1."""
    jm, v = _jax_tiny_model()
    tm, _ = build_xpoint(tiny_cfg(), device="cpu")
    load_flax_variables(tm, v)

    def pf_j(img, is_optical):
        out = jm.apply(v, img, "optical" if is_optical else "thermal")
        return jx_prob_from_logits(out["logits"], jm.encoder_downsample_ratio)

    cfg = dict(aggregation="prod", num=3, erosion_radius=2, min_count=2)
    pairs, same, _, _ = _run_both(cfg, 64, B=1, warp_batch=2,
                                  prob_fns=(make_prob_fn(tm), pf_j))
    (got, want), = pairs
    assert same.mean() > 0.95
    assert got.max() > 0.1
    assert np.abs(got - want)[same].mean() < 2e-3


# ---- NMS to a heatmap, inference wrapper, export ---------------------------

def _heatmaps(seed, shape):
    p = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    return p ** 6


@pytest.mark.parametrize("top_k", [0, 5, 10 ** 6])
@pytest.mark.parametrize("shape", [(3, 40, 56), (32, 32)])
def test_box_nms_equals_jax(shape, top_k):
    p = _heatmaps(0, shape)
    got = box_nms(T(p), 8, 0.015, keep_top_k=top_k).numpy()
    want = np.asarray(jx_box_nms(jnp.asarray(p), 8, 0.015, keep_top_k=top_k))
    np.testing.assert_array_equal(got, want)
    n = (got > 0).reshape(1 if p.ndim == 2 else p.shape[0], -1).sum(-1)
    assert (n > 0).all() and (top_k == 0 or (n <= top_k).all())


@pytest.mark.parametrize("cfg", [{}, {"nms": 4, "topk": 7},
                                 {"nms": 0, "detection_threshold": 0.3}])
def test_inference_nms_and_keypoints_match_jax(cfg):
    tm, _ = build_xpoint(tiny_cfg(), device="cpu")
    infer, jx_infer = XPointInference(tm, cfg), JxInference(None, None, cfg)
    # every key the port reads holds JAX's default; the port has no CPU NMS
    assert infer.cfg == {k: v for k, v in jx_infer.cfg.items()
                         if k != "cpu_nms"}
    p = _heatmaps(1, (2, 48, 64))
    got, want = infer.nms(p), jx_infer.nms(p)
    np.testing.assert_array_equal(got, want)
    mask = np.zeros((48, 64), np.float32)
    mask[8:40, 8:56] = 1
    for m in (None, mask):
        a = infer.keypoints_from_prob(got[0], m)
        b = jx_infer.keypoints_from_prob(want[0], m)
        np.testing.assert_array_equal(a, b)
        assert a.ndim == 2 and a.shape[1] == 2 and len(a) > 0


def test_inference_forwards():
    tm, _ = build_xpoint(tiny_cfg(), device="cpu")
    infer = XPointInference(tm)
    img_o, img_t = _pair(2, 2, 64)
    prob_o, prob_t, desc_o, desc_t, hm = infer.forward_pair(img_o, img_t)
    assert prob_o.shape == prob_t.shape == (2, 64, 64)
    assert desc_o.shape == desc_t.shape == (2, 8, 8, 32)
    assert hm is not None and np.isfinite(hm).all()
    prob, desc = infer.forward_single(img_o, True)
    np.testing.assert_allclose(prob, prob_o, atol=1e-6)
    np.testing.assert_allclose(desc, desc_o, atol=1e-6)
    sub = XPointInference(tm, {"subpixel": True, "nms": 4})
    p_nms = sub.nms(prob_o)
    kps = sub.keypoints_from_prob(p_nms[0], prob_raw=prob_o[0])
    ints = sub.keypoints_from_prob(p_nms[0])
    assert kps.dtype == np.float32 and kps.shape == ints.shape
    assert len(kps) > 0 and np.abs(kps - ints).max() <= 0.5


EXPORT_CASES = {
    "window": (dict(ha.EXPORT_HA_CONFIG, num=3, min_count=2),
               ["keypoints_optical", "keypoints_thermal"]),
    "prod": (dict(aggregation="prod", num=3, erosion_radius=2),
             ["keypoints"]),
}


@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_export_keypoints_into_the_numpy_sink(case, tmp_path):
    """The export loop against its parts run by hand (same seed, so the same
    homographies), the resume set, the backup and the .npz round trip."""
    ha_cfg, names = EXPORT_CASES[case]
    pred_cfg = {"detection_threshold": 1e-4, "nms": 4}
    tm, _ = build_xpoint(tiny_cfg(), device="cpu", seed=1)
    data = SyntheticPairs(n_pairs=3, size=64, n_kp=1, seed=2)
    path = str(tmp_path / "labels.npz")
    sink = NumpySink(path)
    log = []
    assert export_keypoints(tm, data, sink, ha_cfg, pred_cfg, seed=7,
                            log=log.append) == 3
    assert sink.names() == {data.get_name(i) for i in range(3)}
    assert len(log) == 3 and "synthetic_00002" in log[-1]
    assert (tmp_path / "labels.npz.bak").exists()

    # by hand: one homography stack per sample from the same generator
    infer = XPointInference(tm, pred_cfg)
    run, cfg = ha.make_ha_fn(make_prob_fn(tm), ha_cfg)
    rng = np.random.default_rng(7)
    for i in range(3):
        s = data[i]
        hs = ha.sample_ha_homographies(cfg, (64, 64), rng)
        out = run(T(s["optical"]["image"][None]),
                  T(s["thermal"]["image"][None]), T(hs))
        grp = sink.groups[data.get_name(i)]
        assert sorted(grp) == names
        for name in names:
            prob = out[name.replace("keypoints", "prob")]
            want = infer.keypoints_from_prob(infer.nms(prob)[0])
            np.testing.assert_array_equal(grp[name], want)
            assert grp[name].shape[1] == 2 and len(grp[name]) > 0

    # resume: nothing left to do; a sink that lost one sample redoes it only
    again = NumpySink(path, resume=True)
    assert again.names() == sink.names()
    for n, g in sink.groups.items():
        for k, v in g.items():
            np.testing.assert_array_equal(again.groups[n][k], v)
    assert export_keypoints(tm, data, again, ha_cfg, pred_cfg, seed=7) == 0
    del again.groups[data.get_name(1)]
    assert export_keypoints(tm, data, again, ha_cfg, pred_cfg, seed=7) == 1
    assert again.names() == sink.names()
    assert export_keypoints(tm, data, NumpySink(), ha_cfg, pred_cfg,
                            max_samples=2, batch=2, frequency=0) == 2


def test_export_keypoints_into_the_hdf5_sink(tmp_path):
    """Same groups, dataset names and arrays as the numpy sink, in the
    layout the JAX package's loaders read; resume skips what is there."""
    h5py = pytest.importorskip("h5py")
    ha_cfg, names = EXPORT_CASES["window"]
    pred_cfg = {"detection_threshold": 1e-4, "nms": 4}
    tm, _ = build_xpoint(tiny_cfg(), device="cpu", seed=1)
    data = SyntheticPairs(n_pairs=2, size=64, n_kp=1, seed=2)
    ref = NumpySink()
    export_keypoints(tm, data, ref, ha_cfg, pred_cfg, seed=7)
    path = str(tmp_path / "labels.hdf5")
    sink = H5Sink(path)
    assert export_keypoints(tm, data, sink, ha_cfg, pred_cfg, seed=7,
                            max_samples=1) == 1
    sink.close()
    sink = H5Sink(path, resume=True)
    assert sink.names() == {data.get_name(0)}
    assert export_keypoints(tm, data, sink, ha_cfg, pred_cfg, seed=7) == 1
    sink.close()
    with h5py.File(path, "r") as f:
        assert set(f.keys()) == ref.names()
        g = f[data.get_name(0)]
        assert sorted(g.keys()) == names
        for name in names:
            np.testing.assert_array_equal(
                g[name][...], ref.groups[data.get_name(0)][name])
