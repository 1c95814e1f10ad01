"""The PyTorch port's on-device homography estimation against the JAX
package's, on the CPU: the DLT (and the minimal-fit behaviour it shares
with JAX), the hypotheses, RANSAC handed the same Gumbel noise,
estimate_homography_device's padding and iteration cap, and the pair
pipeline with the estimator.

JAX draws its noise inside ransac_homography from a key; the port takes the
(n_iters, N) array. The tests draw jax.random.gumbel(key, (n_iters, N))
themselves and hand the same numbers to both."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.eval.pipeline import make_pair_pipeline as jx_pipeline
from xpoint_tpu.geometry import ransac as jx_ransac
from xpoint_tpu.models import build_xpoint as jx_build_xpoint

from xpoint_tpu_torch.compat.from_flax import load_flax_variables
from xpoint_tpu_torch.eval import make_pair_pipeline, pipeline
from xpoint_tpu_torch.geometry import ransac
from xpoint_tpu_torch.models import build_xpoint

T = torch.from_numpy
H_TRUE = np.array([[1.05, 0.03, 8.0], [-0.02, 0.97, -5.0],
                   [2e-5, -3e-5, 1.0]])


def correspondences(seed, n_in=80, n_out=40, noise=0.3, H=H_TRUE):
    rng = np.random.default_rng(seed)
    pts1 = rng.uniform(20, 480, (n_in + n_out, 2))
    p = np.c_[pts1, np.ones(len(pts1))] @ H.T
    pts2 = p[:, :2] / p[:, 2:]
    pts2[:n_in] += rng.normal(0, noise, (n_in, 2))
    pts2[n_in:] = rng.uniform(0, 500, (n_out, 2))
    return pts1.astype(np.float32), pts2.astype(np.float32)


def corner_error(H_a, H_b, size=512):
    pts = np.array([[0, 0, 1], [size, 0, 1], [0, size, 1], [size, size, 1]],
                   float)
    a = pts @ np.asarray(H_a, float).T
    b = pts @ np.asarray(H_b, float).T
    return np.linalg.norm(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:],
                          axis=1).max()


def padded(pts1, pts2, N, quality=None):
    p1 = np.zeros((N, 2), np.float32)
    p2 = np.zeros((N, 2), np.float32)
    m = np.zeros(N, bool)
    n = len(pts1)
    p1[:n], p2[:n], m[:n] = pts1, pts2, True
    q = None
    if quality is not None:
        q = np.full(N, np.inf, np.float32)
        q[:n] = quality
    return p1, p2, m, q


def _normed(H):
    H = np.asarray(H, np.float64)
    return H / H[..., 2:, 2:]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [5, 16, 100])
def test_dlt_matches_jax(n, weighted):
    """Fits on 5 or more Hartley-normalised correspondences (how the
    refinement calls it) within 1e-4 of JAX's after normalising by H[2, 2],
    and right on exact points."""
    pts1, pts2 = correspondences(n, n_in=n, n_out=0, noise=0.0)
    T1, p1n = ransac._normalization(T(pts1), torch.ones(n, dtype=bool))
    T2, p2n = ransac._normalization(T(pts2), torch.ones(n, dtype=bool))
    w = np.random.default_rng(n).uniform(0.2, 1.0, n).astype(np.float32) \
        if weighted else None
    got = ransac.fit_homography_dlt(p1n, p2n,
                                    None if w is None else T(w)).numpy()
    want = np.asarray(jx_ransac.fit_homography_dlt(
        jnp.asarray(p1n.numpy()), jnp.asarray(p2n.numpy()),
        None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(_normed(got), _normed(want), atol=1e-4)
    H = ransac._inv_similarity(T2).numpy() @ got @ T1.numpy()
    assert corner_error(_normed(H), H_TRUE) < 0.05
    jT, _ = jx_ransac._normalization(jnp.asarray(pts1), jnp.ones(n, bool))
    np.testing.assert_allclose(T1.numpy(), np.asarray(jT), rtol=1e-6)
    np.testing.assert_allclose(ransac._inv_similarity(T1).numpy(),
                               np.linalg.inv(np.asarray(jT)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_minimal_fit_takes_the_smallest_nonzero_singular_vector(seed):
    """The pinned behaviour of the JAX package, copied: a 4-point fit takes
    the last row of the reduced SVD of its 8 x 9 system, the singular vector
    of the smallest nonzero singular value and not the null vector, so on 4
    exact correspondences it is far from the true H. Both packages give
    that vector (within 10% after normalising by H[2, 2]: it is
    ill-conditioned in fp32 on pixel coordinates)."""
    H = np.array([[1.1, .05, 10], [.02, .95, -5], [1e-4, 2e-4, 1]])
    pts1, pts2 = correspondences(seed, n_in=4, n_out=0, noise=0.0, H=H)
    got = _normed(ransac.fit_homography_dlt(T(pts1), T(pts2)).numpy())
    want = _normed(jx_ransac.fit_homography_dlt(jnp.asarray(pts1),
                                                jnp.asarray(pts2)))
    np.testing.assert_allclose(got, want, rtol=0.1, atol=1e-3)
    assert corner_error(got, H) > 10 and corner_error(want, H) > 10
    # the null vector (full SVD, in float64) is the true H
    x1, y1 = pts1.astype(np.float64).T
    x2, y2 = pts2.astype(np.float64).T
    z, o = np.zeros(4), np.ones(4)
    M = np.concatenate([np.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1,
                                  -x2], -1),
                        np.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1,
                                  -y2], -1)])
    null = np.linalg.svd(M)[2][-1].reshape(3, 3)
    assert corner_error(_normed(null), H) < 1e-3


def _jax_hypotheses(p1, p2, m, g, threshold, q):
    """JAX's minimal-sample stage, step by step as ransac_homography runs
    it (ransac.py:84-129)."""
    N = p1.shape[0]
    n_iters = g.shape[0]
    g = jnp.asarray(g) + jnp.where(jnp.asarray(m), 0.0, -jnp.inf)[None]
    if q is not None:
        order = jnp.argsort(jnp.where(jnp.asarray(m), jnp.asarray(q),
                                      jnp.inf))
        rank = jnp.argsort(order)
        jfrac = jnp.arange(n_iters, dtype=jnp.float32) / max(n_iters - 1, 1)
        n_j = 8.0 * (N / 8.0) ** jfrac
        g = g + jnp.where(rank[None, :] < n_j[:, None], 0.0, -jnp.inf)
    _, sel = jax.lax.top_k(g, 4)
    P1, P2 = jnp.asarray(p1), jnp.asarray(p2)
    Hs = jax.vmap(lambda i: jx_ransac.fit_homography_dlt(P1[i], P2[i]))(sel)
    errs = jax.vmap(lambda H: jx_ransac._reproj_error(H, P1, P2))(Hs)

    def ts(th):
        return jnp.where(jnp.asarray(m)[None] & (errs < th),
                         1.0 - (errs / th) ** 2, 0.0).sum(-1)
    scores = (ts(threshold) + 0.5 * ts(2 * threshold)
              + 0.25 * ts(4 * threshold) + 0.125 * ts(8 * threshold))
    return np.asarray(sel), np.asarray(Hs), np.asarray(scores)


@pytest.mark.parametrize("prosac", [False, True])
def test_hypotheses_match_jax(prosac):
    """The same 4-point samples exactly (stable ranks, lower index first
    on ties) and the same best hypothesis. The fits themselves are the
    ill-conditioned minimal fits above, so they agree only statistically:
    H (normalised by H[2, 2]) within 1e-3 of its largest entry for half
    the hypotheses and 2e-2 for nine in ten, scores within 1e-2 for half
    and 0.1 for nine in ten."""
    pts1, pts2 = correspondences(3, n_in=50, n_out=50)
    quality = np.random.default_rng(3).uniform(0, 1, 100).astype(np.float32)
    p1, p2, m, q = padded(pts1, pts2, 128, quality if prosac else None)
    g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (256, 128)))
    sel, Hs, scores = ransac.hypotheses(
        T(p1)[None], T(p2)[None], T(m)[None], T(g)[None], 3.0,
        None if q is None else T(q)[None])
    want_sel, want_Hs, want_scores = _jax_hypotheses(p1, p2, m, g, 3.0, q)
    np.testing.assert_array_equal(sel[0].numpy(), want_sel)
    assert (want_sel < 100).all()
    a, b = _normed(Hs[0].numpy()), _normed(want_Hs)
    rel = np.abs(a - b).max((1, 2)) / np.abs(b).max((1, 2))
    assert np.percentile(rel, 50) < 1e-3 and np.percentile(rel, 90) < 2e-2
    ds = np.abs(scores[0].numpy() - want_scores)
    assert np.percentile(ds, 50) < 1e-2 and np.percentile(ds, 90) < 0.1
    assert int(scores[0].argmax()) == int(want_scores.argmax())


def _run_both(pts1, pts2, N, n_iters, seed, quality=None, refine=True,
              threshold=3.0):
    p1, p2, m, q = padded(pts1, pts2, N, quality)
    key = jax.random.PRNGKey(seed)
    g = np.asarray(jax.random.gumbel(key, (n_iters, N)))
    want = jax.device_get(jx_ransac.ransac_homography(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m), key,
        threshold=threshold, n_iters=n_iters, refine=refine,
        quality=None if q is None else jnp.asarray(q)))
    got = ransac.ransac_homography(T(p1), T(p2), T(m), T(g),
                                   threshold=threshold, refine=refine,
                                   quality=None if q is None else T(q))
    return {k: v.numpy() for k, v in got.items()}, want, (p1, p2, m, g, q)


@pytest.mark.parametrize("case", ["uniform", "prosac", "no_refine",
                                  "low_inlier_prosac"])
def test_ransac_homography_matches_jax(case):
    """Handed JAX's noise: H within 0.01 px at the 512^2 corners (1 px
    without refinement, which returns the best minimal fit as it is), the
    score within 1e-3 of it, the inlier masks equal wherever a match's
    error is more than 1e-3 px from the threshold, and both near the true
    H."""
    quality = None
    n_in, n_out = 80, 40
    if case == "low_inlier_prosac":
        n_in, n_out = 12, 150
    pts1, pts2 = correspondences(7, n_in, n_out)
    if case in ("prosac", "low_inlier_prosac"):
        rng = np.random.default_rng(8)
        quality = np.r_[rng.uniform(0.1, 0.4, n_in),
                        rng.uniform(0.3, 1.5, n_out)].astype(np.float32)
    got, want, (p1, p2, m, _, _) = _run_both(
        pts1, pts2, 256, 256, 5, quality, refine=case != "no_refine")
    assert corner_error(got["H"], want["H"]) < (
        0.01 if case != "no_refine" else 1.0)
    assert abs(float(got["score"]) - float(want["score"])) < 1e-3 * max(
        1.0, float(want["score"]))
    err = np.asarray(jx_ransac._reproj_error(jnp.asarray(want["H"]),
                                             jnp.asarray(p1),
                                             jnp.asarray(p2)))
    away = m & (np.abs(err - 3.0) > 1e-3)
    np.testing.assert_array_equal(got["inliers"][away], want["inliers"][away])
    assert abs(int(got["n_inliers"]) - int(want["n_inliers"])) <= int(
        (m & ~away).sum())
    limit = 3.0 if case != "no_refine" else 40.0
    assert corner_error(got["H"], H_TRUE) < limit
    assert got["H"][2, 2] == 1.0


def test_ransac_batch_equals_single_samples():
    """A batch of samples gives each sample's single result bit for bit."""
    outs, args = [], []
    for seed in (1, 2):
        pts1, pts2 = correspondences(seed, 40, 20)
        p1, p2, m, _ = padded(pts1, pts2, 64)
        g = np.random.default_rng(seed).gumbel(size=(64, 64)).astype(
            np.float32)
        args.append((p1, p2, m, g))
        outs.append(ransac.ransac_homography(*map(T, (p1, p2, m, g))))
    batch = ransac.ransac_homography(
        *(T(np.stack([a[i] for a in args])) for i in range(4)))
    for b, single in enumerate(outs):
        for k, v in single.items():
            assert torch.equal(batch[k][b], v), k


def _jax_noise_recorder(shapes):
    def noise(shape, generator, device):
        shapes.append(tuple(shape))
        return torch.from_numpy(np.asarray(jax.random.gumbel(
            jax.random.PRNGKey(0), shape))).to(device)
    return noise


@pytest.mark.parametrize("n, max_points, cap", [(20, 8192, 32),
                                                (120, 8192, 128),
                                                (48, 32, 32)])
def test_estimate_homography_device_matches_jax(n, max_points, cap,
                                                monkeypatch):
    """The power-of-two padding (at least 16, at most max_points; rows past
    it come back as outliers), the mask of length N, float64 H, and the
    result of JAX's estimator on the same noise (key 0): H within 0.01 px,
    inlier masks equal away from the threshold."""
    shapes = []
    monkeypatch.setattr(ransac, "gumbel_noise", _jax_noise_recorder(shapes))
    pts1, pts2 = correspondences(n, n_in=n * 3 // 4, n_out=n - n * 3 // 4)
    q = np.random.default_rng(n).uniform(0, 1, n).astype(np.float32)
    for quality in (None, q):
        got = ransac.estimate_homography_device(
            pts1, pts2, 3.0, n_iters=256, max_points=max_points,
            quality=quality, device="cpu")
        want = jx_ransac.estimate_homography_device(
            pts1, pts2, 3.0, n_iters=256, max_points=max_points,
            quality=quality)
        assert shapes[-1] == (256, cap)
        assert got[0].dtype == np.float64 and got[0].shape == (3, 3)
        assert got[1].shape == want[1].shape == (n, 1)
        assert got[1].dtype == np.uint8
        assert corner_error(got[0], want[0]) < 0.01
        err = np.linalg.norm(
            (np.c_[pts1, np.ones(n)] @ want[0].T)[:, :2]
            / (np.c_[pts1, np.ones(n)] @ want[0].T)[:, 2:] - pts2, axis=1)
        away = np.abs(err - 3.0) > 1e-3
        np.testing.assert_array_equal(got[1][away], want[1][away])
        assert int(got[1][cap:].sum()) == 0


def test_estimate_homography_device_iteration_cap_and_none(monkeypatch):
    """n_iters is capped to max(1024, 2^24 // cap) as in JAX (which shapes
    the hypotheses), and fewer than 4 points, unequal lengths or fewer than
    4 inliers give (None, None)."""
    shapes = []
    monkeypatch.setattr(ransac, "gumbel_noise", _jax_noise_recorder(shapes))
    calls = []

    def fake_ransac(p1, p2, mask, g, threshold, quality):
        calls.append(int(mask.sum()))
        N = p1.shape[0]
        return {"H": torch.eye(3), "inliers": mask,
                "score": torch.zeros(()),
                "n_inliers": torch.tensor(min(3, N) if N < 64 else 10)}
    monkeypatch.setattr(ransac, "ransac_homography", fake_ransac)
    for n, cap in ((3000, 4096), (9000, 8192), (700, 1024)):
        p = np.zeros((n, 2), np.float32)
        ransac.estimate_homography_device(p, p, device="cpu")
        assert shapes[-1] == (min(8192, max(1024, (1 << 24) // cap)), cap)
    assert shapes[-3:] == [(4096, 4096), (2048, 8192), (8192, 1024)]
    assert calls[-2:] == [8192, 700]
    p = np.zeros((30, 2), np.float32)
    assert ransac.estimate_homography_device(p, p, device="cpu") == \
        (None, None)                                # 3 inliers
    assert ransac.estimate_homography_device(p[:3], p[:3], device="cpu") \
        == (None, None)
    assert ransac.estimate_homography_device(p, p[:20], device="cpu") == \
        (None, None)


def _cnn_cfg():
    return {'multispectral': False, 'takes_pair': True, 'channel_version': 2,
            'descriptor_size': 32,
            'homography_regression_head': {'check': False}}


def test_pipeline_with_ransac_matches_jax(monkeypatch):
    """The pipeline with estimate_homography on the identity pair, as the
    JAX package's test: H_est near the identity with more than 10 inliers;
    handed JAX's per-sample noise (one key a sample, split from key 1), the
    same H_est within 0.01 px and the same inlier counts within the few
    matches near the threshold."""
    jm, _ = jx_build_xpoint(_cnn_cfg())
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
    img[1] = img[1, ::-1]
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(img[:1]),
                method=jm.init_all)
    kw = dict(k=256, nms_size=4, detection_threshold=1e-4,
              estimate_homography=True, ransac_iters=64)
    key = jax.random.PRNGKey(1)
    want = jax.device_get(jx_pipeline(jm, (64, 64), **kw)(
        v, jnp.asarray(img), jnp.asarray(img), key))
    keys = jax.random.split(key, 2)

    def noise(shape, generator, device):
        assert tuple(shape) == (2, 64, 256)
        return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
            k, shape[1:])) for k in keys]))
    monkeypatch.setattr(pipeline, "gumbel_noise", noise)
    tm, _ = build_xpoint(_cnn_cfg(), device="cpu")
    load_flax_variables(tm, v)
    got = make_pair_pipeline(tm, (64, 64), **kw)(T(img), T(img))
    assert set(got) == set(want)
    for b in range(2):
        H = got["H_est"][b].numpy()
        assert np.abs(H - np.eye(3)).max() < 0.3, H
        assert int(got["ransac_n_inliers"][b]) > 10
        assert corner_error(H, want["H_est"][b], 64) < 0.01
        np.testing.assert_array_equal(got["matched"][b].numpy(),
                                      want["matched"][b])
        assert abs(int(got["ransac_n_inliers"][b])
                   - int(want["ransac_n_inliers"][b])) <= 2
    assert got["H_est"].dtype == torch.float32
    assert got["ransac_inliers"].shape == (2, 256)


def test_pipeline_ransac_noise_from_the_generator():
    """Without a generator the noise comes from one seeded 0 on the device:
    two calls agree; another generator may draw other hypotheses."""
    tm, _ = build_xpoint(_cnn_cfg(), device="cpu", seed=1)
    img = T(np.random.default_rng(2).uniform(
        size=(1, 64, 64, 1)).astype(np.float32))
    run = make_pair_pipeline(tm, (64, 64), k=128, nms_size=4,
                             detection_threshold=1e-4,
                             estimate_homography=True, ransac_iters=32)
    a, b = run(img, img), run(img, img)
    c = run(img, img, torch.Generator().manual_seed(0))
    for k in ("H_est", "ransac_inliers", "ransac_score"):
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
    assert "H_est" not in make_pair_pipeline(tm, (64, 64), k=128,
                                             nms_size=4)(img, img)
