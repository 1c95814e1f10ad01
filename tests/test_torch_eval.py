"""The PyTorch port's evaluation path against the JAX package's, on the CPU:
subpixel refinement, keypoint extraction, the matchers through
XPointInference, descriptor sampling, every function of eval/metrics.py,
and the dataset loops (compute_metrics, compute_descriptor_metrics,
compute_repeatability_multispectral, compute_detector_metrics) driven by
both packages' XPointInference on the tiny fp32 model through the weight
bridge. Inputs come from numpy seeds; each tolerance is written where it is
used."""
import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.eval import metrics as jx_metrics
from xpoint_tpu.eval.benchmark import compute_metrics as jx_compute_metrics
from xpoint_tpu.eval.evaluation import (
    compute_descriptor_metrics as jx_descriptor_metrics,
    compute_detector_metrics as jx_detector_metrics,
    compute_repeatability_multispectral as jx_repeatability)
from xpoint_tpu.eval.infer import XPointInference as JxInference
from xpoint_tpu.ops.detector import refine_keypoints_subpixel as jx_refine
from xpoint_tpu.ops.nms import extract_keypoints as jx_extract

from xpoint_tpu_torch.compat.from_flax import load_flax_variables
from xpoint_tpu_torch.eval import metrics
from xpoint_tpu_torch.eval.benchmark import compute_metrics
from xpoint_tpu_torch.eval.evaluation import (
    compute_descriptor_metrics, compute_detector_metrics,
    compute_repeatability_multispectral)
from xpoint_tpu_torch.eval.infer import XPointInference
from xpoint_tpu_torch.geometry import ransac
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.ops.detector import refine_keypoints_subpixel
from xpoint_tpu_torch.ops.nms import extract_keypoints

from test_torch_models import _jax_tiny_model, tiny_cfg

T = torch.from_numpy


@pytest.fixture(scope="module")
def tiny():
    """The tiny fp32 VMamba XPoint in both packages, the same weights."""
    jm, v = _jax_tiny_model()
    tm, _ = build_xpoint(tiny_cfg(), device="cpu")
    load_flax_variables(tm, v)
    return jm, v, tm


def assert_same(got, want, path="result"):
    """Equal structure and values: exact for arrays and numbers."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (float, np.floating))):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def assert_close(got, want, atol, rtol=0.0, path="result"):
    """Equal structure, values within atol + rtol * |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], atol, rtol, f"{path}[{k!r}]")
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_close(a, b, atol, rtol, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), atol=atol,
                                   rtol=rtol, err_msg=path)


# ---- subpixel refinement and keypoint extraction ----

def _refine_case(seed, H=24, W=32):
    rng = np.random.default_rng(seed)
    prob = rng.uniform(size=(H, W)).astype(np.float32) ** 4
    prob[10:14, 10:14] = 0.25                       # flat: no curvature
    border = [[0, 5], [H - 1, 7], [6, 0], [9, W - 1], [0, 0], [H - 1, W - 1]]
    inner = np.stack([rng.integers(1, H - 1, 10), rng.integers(1, W - 1, 10)],
                     -1)
    kps = np.concatenate([border, inner, [[11, 11], [12, 13]],
                          rng.integers(0, 20, (4, 2))]).astype(np.int32)
    valid = np.ones(len(kps), bool)
    valid[-4:] = False                              # padding rows
    return prob, kps, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subpixel_refinement_matches_jax(seed):
    """Refined keypoints within 1e-6 of JAX's, border keypoints on the
    integer grid along their border axis, padding rows passed through."""
    prob, kps, valid = _refine_case(seed)
    want = np.asarray(jx_refine(jnp.asarray(prob), jnp.asarray(kps),
                                jnp.asarray(valid)))
    got = refine_keypoints_subpixel(T(prob), T(kps), T(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:2, 0], kps[:2, 0])     # rows 0, H-1
    np.testing.assert_array_equal(got[2:4, 1], kps[2:4, 1])   # cols 0, W-1
    np.testing.assert_array_equal(got[-4:], kps[-4:])         # padding
    assert (got[6:16] != kps[6:16]).any()                     # refined
    np.testing.assert_array_equal(
        refine_keypoints_subpixel(T(prob), T(kps))[:-4].numpy(), got[:-4])


@pytest.mark.parametrize("k", [1, 7, 40])
def test_extract_keypoints_matches_jax_on_ties(k):
    """Top-k on a heatmap of heavily tied scores: JAX's lower-index-first
    order, exactly."""
    rng = np.random.default_rng(3)
    prob = np.round(rng.uniform(size=(12, 16)) * 4).astype(np.float32) / 4
    prob[prob < 0.5] = 0.0
    want = [np.asarray(a) for a in jx_extract(jnp.asarray(prob), k, 0.0)]
    got = [a.numpy() for a in extract_keypoints(T(prob), k, 0.0)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    batched = extract_keypoints(T(np.stack([prob, prob[::-1].copy()])), k)
    np.testing.assert_array_equal(batched[0][0].numpy(), want[0])


# ---- matchers, descriptor sampling, capacity ----

MATCHING = {
    "bfmatcher": {"method": "bfmatcher",
                  "method_kwargs": {"crossCheck": True}},
    "bfmatcher_no_cross": {"method": "bfmatcher",
                           "method_kwargs": {"crossCheck": False}},
    "bfmatcher_threshold": {"method": "bfmatcher",
                            "method_kwargs": {"threshold": 1.0}},
    "nnmatcher": {"method": "nnmatcher"},
    "nnmatcher_0.9": {"method": "nnmatcher",
                      "method_kwargs": {"threshold": 0.9}},
    "flann": {"method": "flann"},
    "thresholdmatcher": {"method": "thresholdmatcher",
                         "method_kwargs": {"threshold": 1.2}},
    "knn": {"method": "bfmatcher", "knn_matches": True},
}


def _unit(rng, n, d=16):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _descriptor_case(case):
    rng = np.random.default_rng(11)
    if case == "random":
        return _unit(rng, 10), _unit(rng, 12)
    if case == "ties":
        # duplicated targets and queries: NN and second NN tie exactly
        d2 = _unit(rng, 9)
        d2[5] = d2[2]
        d2[7] = d2[4]
        d1 = np.concatenate([d2[[2, 4, 2, 0]], _unit(rng, 4)])
        d1[6] = d1[5]
        return d1, d2
    if case == "one_target":
        return _unit(rng, 5), _unit(rng, 1)
    if case == "one_query":
        return _unit(rng, 1), _unit(rng, 7)
    if case == "empty_target":
        return _unit(rng, 5), np.zeros((0, 16), np.float32)
    return np.zeros((0, 16), np.float32), _unit(rng, 5)


def _assert_same_matches(got, want):
    assert [m[:2] for m in got] == [m[:2] for m in want]
    np.testing.assert_allclose([m[2] for m in got], [m[2] for m in want],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["random", "ties", "one_target",
                                  "one_query", "empty_target", "empty_query"])
@pytest.mark.parametrize("method", sorted(MATCHING))
def test_matchers_match_jax(tiny, method, case):
    """Each configured matcher's (i, j, dist) list, and the cross-checked
    one, equal to JAX's: indices exact, distances within 1e-6."""
    cfg = {"nms": 4, "detection_threshold": 1e-4,
           "matching": MATCHING[method]}
    infer = XPointInference(tiny[2], cfg)
    jx_infer = JxInference(None, None, cfg, max_kp=64)
    d1, d2 = _descriptor_case(case)
    for fn in ("match", "match_crosscheck"):
        got = getattr(infer, fn)(d1, d2)
        want = getattr(jx_infer, fn)(d1, d2)
        _assert_same_matches(got, want)
    if case in ("random", "ties") and method != "thresholdmatcher":
        assert len(want) > 0


def test_knn_one_candidate_passes_the_ratio_test(tiny):
    """With one valid target the second neighbour is at BIG, as the JAX
    package's padding puts it: every query matches it."""
    cfg = {"matching": MATCHING["knn"]}
    d1, d2 = _descriptor_case("one_target")
    got = XPointInference(tiny[2], cfg).match(d1, d2)
    assert [m[:2] for m in got] == [(i, 0) for i in range(5)]


def test_descriptors_at_and_capacity_growth_match_jax(tiny):
    """Descriptors within 1e-6 of JAX's; more keypoints than max_kp grow
    the recorded capacity as JAX's does, each with a warning, and drop
    none."""
    cfg = {"nms": 4, "detection_threshold": 1e-4}
    infer = XPointInference(tiny[2], cfg, max_kp=8)
    jx_infer = JxInference(None, None, cfg, max_kp=8)
    rng = np.random.default_rng(5)
    n = 21
    kps = np.stack([rng.uniform(0, 31, n), rng.uniform(0, 31, n)],
                   1).astype(np.float32)
    desc_map = rng.normal(size=(4, 4, 16)).astype(np.float32)
    with pytest.warns(UserWarning, match="recording capacity 32"):
        got = infer.descriptors_at(kps, desc_map, (32, 32))
    with pytest.warns(UserWarning, match="growing device capacity"):
        want = jx_infer.descriptors_at(kps, desc_map, (32, 32))
    assert got.shape == (n, 16) and infer.max_kp == jx_infer.max_kp == 32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(infer.descriptors_at(kps[:4], desc_map,
                                                    (32, 32)), got[:4],
                               atol=1e-6, rtol=0)
    assert infer.descriptors_at(kps[:0], desc_map, (32, 32)).shape == (0, 16)
    d1, d2 = _unit(rng, 40), _unit(rng, 50)
    infer.max_kp = jx_infer.max_kp = 8
    with pytest.warns(UserWarning, match="recording capacity 64"):
        got = infer.match_crosscheck(d1, d2)
    _assert_same_matches(got, jx_infer.match_crosscheck(d1, d2))


def test_keypoints_from_prob_subpixel_matches_jax(tiny):
    cfg = {"nms": 4, "detection_threshold": 0.3, "subpixel": True}
    infer = XPointInference(tiny[2], cfg)
    jx_infer = JxInference(None, None, cfg)
    prob, _, _ = _refine_case(4)
    mask = np.ones(prob.shape, np.float32)
    mask[:, :3] = 0
    p_nms = infer.nms(prob[None])[0]
    for m in (None, mask):
        got = infer.keypoints_from_prob(p_nms, m, prob_raw=prob)
        want = jx_infer.keypoints_from_prob(p_nms, m, prob_raw=prob)
        assert got.dtype == np.float32 and len(got) > 3
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ints = infer.keypoints_from_prob(p_nms)
    assert ints.dtype.kind == "i"
    np.testing.assert_array_equal(ints, jx_infer.keypoints_from_prob(p_nms))


# ---- metrics.py, function by function ----

def _homography(rng, size=64, amp=4.0):
    src = np.float32([[0, 0], [size, 0], [size, size], [0, size]])
    dst = src + rng.uniform(-amp, amp, (4, 2)).astype(np.float32)
    return cv2.getPerspectiveTransform(src, dst).astype(np.float32)


def _kps(rng, n, size=64):
    return rng.integers(0, size, (n, 2))


def test_pr_and_map_equal_jax():
    rng = np.random.default_rng(0)
    for n_gt in (0, 7, 30):
        tp = rng.uniform(size=25) < 0.4
        got = metrics.pr_from_tp(tp, n_gt)
        want = jx_metrics.pr_from_tp(tp, n_gt)
        assert_same(got, want)
        assert metrics.compute_mAP(*got) == jx_metrics.compute_mAP(*want)


@pytest.mark.parametrize("n_kp", [0, 12])
def test_compute_tp_fp_dist_equals_jax(n_kp):
    rng = np.random.default_rng(1)
    prob = (rng.uniform(size=(32, 40)) ** 8).astype(np.float32)
    kmap = np.zeros((32, 40), bool)
    kmap[tuple(_kps(rng, n_kp, 32).T)] = True
    assert_same(metrics.compute_tp_fp_dist(prob, kmap),
                jx_metrics.compute_tp_fp_dist(prob, kmap))


@pytest.mark.parametrize("sizes", [(30, 25), (0, 10), (10, 0), (0, 0)])
def test_repeatability_sample_equals_jax(sizes):
    rng = np.random.default_rng(2)
    kp_o, kp_t = _kps(rng, sizes[0]), _kps(rng, sizes[1])
    H_o, H_t = _homography(rng), _homography(rng)
    for th in (1, 3):
        assert metrics.repeatability_sample(
            kp_o, kp_t, H_o, H_t, (64, 64), th) == \
            jx_metrics.repeatability_sample(kp_o, kp_t, H_o, H_t, (64, 64),
                                            th)


def _correspondences(rng, n_in=60, n_out=30):
    H = np.array([[1.05, 0.03, 8.0], [-0.02, 0.97, -5.0],
                  [2e-5, -3e-5, 1.0]])
    p1 = rng.uniform(20, 480, (n_in + n_out, 2))
    p = np.c_[p1, np.ones(len(p1))] @ H.T
    p2 = p[:, :2] / p[:, 2:]
    p2[:n_in] += rng.normal(0, 0.5, (n_in, 2))
    p2[n_in:] = rng.uniform(0, 500, (n_out, 2))
    return p1.astype(np.float32), p2.astype(np.float32), H


def test_magsac_and_corner_error_equal_jax():
    """cv2's USAC_MAGSAC called by both packages in one process: the same
    H and mask bit for bit; fewer than 4 points give (None, None); the
    corner error (with the reference's (H, H) corner) and its 999."""
    rng = np.random.default_rng(3)
    p1, p2, H_true = _correspondences(rng)
    for th in (2, 3):
        got = metrics.estimate_homography(p1, p2, th)
        want = jx_metrics.estimate_homography(p1, p2, th)
        assert_same(got, want)
        for shape in ((480, 640), (512, 512)):
            assert metrics.homography_corner_error(got[0], H_true, shape) \
                == jx_metrics.homography_corner_error(want[0], H_true, shape)
    assert metrics.estimate_homography(p1[:3], p2[:3]) == (None, None)
    assert metrics.homography_corner_error(None, H_true, (64, 64)) == 999.0
    with pytest.raises(ValueError, match="h_estimator"):
        metrics.estimate_homography(p1, p2, method="on-device")


def _sample_inputs(seed, n_o=40, n_t=35):
    rng = np.random.default_rng(seed)
    kp_o, kp_t = _kps(rng, n_o), _kps(rng, n_t)
    kp_t[:20] = kp_o[:20]
    d_o, d_t = _unit(rng, n_o), _unit(rng, n_t)
    d_t[:20] = d_o[:20] + 0.05 * _unit(rng, 20)
    mo = [(i, int(rng.integers(n_t)) if i >= 20 else i,
           float(rng.uniform(0, 1.5))) for i in range(n_o)]
    mt = [(t, q, d) for q, t, d in mo]
    return kp_o, d_o, kp_t, d_t, mo, mt


@pytest.mark.parametrize("h_estimator", ["magsac", "device"])
def test_descriptor_metrics_equal_jax(h_estimator, monkeypatch):
    """descriptor_metrics_sample and aggregate_descriptor_metrics equal to
    JAX's bit for bit (with 'device', both estimators draw JAX's noise of
    key 0 and pts_dist agrees within 1e-3 px)."""
    monkeypatch.setattr(ransac, "gumbel_noise", _jax_gumbel)
    got, want = [], []
    for seed in range(3):
        kp_o, d_o, kp_t, d_t, mo, mt = _sample_inputs(seed)
        H_o = np.eye(3, dtype=np.float32)
        H_t = np.eye(3, dtype=np.float32) if seed == 0 else \
            _homography(np.random.default_rng(seed + 10))
        args = (kp_o, d_o, kp_t, d_t, H_o, H_t, (64, 64), 3, mo, mt,
                mo[:30] if seed else None, 3, h_estimator)
        got.append(metrics.descriptor_metrics_sample(*args, device="cpu"))
        want.append(jx_metrics.descriptor_metrics_sample(*args))
    if h_estimator == "device":
        for g, w in zip(got, want):
            assert abs(g.pop("pts_dist") - w.pop("pts_dist")) < 1e-3
            assert_close(g.pop("H_est"), w.pop("H_est"), 1e-3, 1e-3)
        assert_same(got, want)
        return
    assert_same(got, want)
    for th in (1, 3):
        assert_same(metrics.aggregate_descriptor_metrics(got, th),
                    jx_metrics.aggregate_descriptor_metrics(want, th))
    assert_same(metrics.aggregate_descriptor_metrics([]),
                jx_metrics.aggregate_descriptor_metrics([]))


# ---- the dataset loops on the tiny model ----

def _jax_gumbel(shape, generator, device):
    """The noise JAX's estimate_homography_device draws (key 0), in place
    of the port's generator."""
    return torch.from_numpy(np.asarray(jax.random.gumbel(
        jax.random.PRNGKey(0), shape))).to(device)


def _pair_batches(n_batches=2, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        img = rng.uniform(size=(B, S, S, 1)).astype(np.float32)
        H_t = np.stack([_homography(rng, S) for _ in range(B)])
        warped = np.stack([cv2.warpPerspective(img[b, :, :, 0], H_t[b],
                                               (S, S))[..., None]
                           for b in range(B)])
        mask_t = np.stack([cv2.warpPerspective(np.ones((S, S), np.float32),
                                               H_t[b], (S, S)) > 0.5
                           for b in range(B)])
        batches.append({
            "optical": {"image": img, "valid_mask": np.ones((B, S, S), bool),
                        "homography": np.tile(np.eye(3, dtype=np.float32),
                                              (B, 1, 1))},
            "thermal": {"image": warped, "valid_mask": mask_t,
                        "homography": H_t}})
    return batches


def _single_batches(S=64):
    rng = np.random.default_rng(9)
    kmap = np.zeros((2, S, S), np.float32)
    for b in range(2):
        kmap[b][tuple(_kps(rng, 15, S).T)] = 1
    return [{"image": rng.uniform(size=(2, S, S, 1)).astype(np.float32),
             "is_optical": np.array([[True], [False]]),
             "valid_mask": np.ones((2, S, S), np.float32),
             "keypoints": kmap}]


PRED = {"nms": 4, "detection_threshold": 0.015, "topk": 0,
        "reprojection_threshold": 3,
        "matching": {"method": "bfmatcher",
                     "method_kwargs": {"crossCheck": True}}}


def _run_loops(infer, jx, pred):
    """The four dataset loops of one package on the same batches."""
    mod = {False: (compute_metrics, compute_descriptor_metrics,
                   compute_repeatability_multispectral,
                   compute_detector_metrics),
           True: (jx_compute_metrics, jx_descriptor_metrics,
                  jx_repeatability, jx_detector_metrics)}[jx]
    config = {"prediction": pred}
    pairs = _pair_batches()
    return {
        "compute_metrics": mod[0](infer, pairs, config,
                                  threshold_ransac=(2, 3), verbose=False),
        "descriptor": mod[1](infer, pairs, pred),
        "repeatability": mod[2](infer, pairs, config),
        "detector": mod[3](infer, _single_batches(), pred),
    }


@pytest.mark.parametrize("variant", ["magsac", "device", "subpixel"])
def test_dataset_loops_fed_jax_forward_equal_jax(tiny, variant,
                                                 monkeypatch):
    """Both packages' loops fed JAX's forward arrays: keypoints, matches and
    every metric equal (1e-6 plus 1e-5 of the value: a match distance is
    sqrt(2 - 2 dot), which turns the few fp32 ulps by which the two
    libraries' dot products differ into ~5e-6 of the distance; the device
    estimator's corner errors, fitted with the same noise, within 1e-2
    px: its SVDs round differently in the two libraries)."""
    jm, v, tm = tiny
    pred = dict(PRED)
    if variant == "device":
        pred["h_estimator"] = "device"
        monkeypatch.setattr(ransac, "gumbel_noise", _jax_gumbel)
    if variant == "subpixel":
        pred["subpixel"] = True
    jx_infer = JxInference(jm, v, pred)
    infer = XPointInference(tm, pred)
    infer.forward_pair = jx_infer.forward_pair
    infer.forward_single = jx_infer.forward_single
    got, want = _run_loops(infer, False, pred), _run_loops(jx_infer, True,
                                                           pred)
    assert sum(want["compute_metrics"]["n_kp_optical"]) > 20
    assert want["descriptor"]["nn_map"] > 0
    for key in ("descriptor", "compute_metrics"):
        if variant == "device":
            atol = 1e-2
            d = want[key]["pts_dist"] if key == "descriptor" else 0
            assert np.all(np.asarray(d) < 999)
        else:
            atol = 1e-6
        assert_close(got[key], want[key], atol, 1e-5, key)
    assert_close(got["repeatability"], want["repeatability"], 1e-6)
    assert_close(got["detector"], want["detector"], 1e-6)
    assert_same(got["compute_metrics"]["n_kp_optical"],
                want["compute_metrics"]["n_kp_optical"])


def test_dataset_loops_own_forward_close_to_jax(tiny):
    """Each package's own forward: the same keypoint counts, and every
    metric within 1e-4 (the heatmaps and descriptors agree within 1e-5)."""
    jm, v, tm = tiny
    got = _run_loops(XPointInference(tm, PRED), False, PRED)
    want = _run_loops(JxInference(jm, v, PRED), True, PRED)
    for key in ("n_kp_optical", "n_kp_thermal"):
        assert_same(got["compute_metrics"][key],
                    want["compute_metrics"][key])
    for key in got:
        assert_close(got[key], want[key], 1e-4, path=key)
