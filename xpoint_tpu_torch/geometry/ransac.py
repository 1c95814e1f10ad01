"""Homography estimation on the device: batched DLT + RANSAC with
MAGSAC-style truncated scoring (port of ``xpoint_tpu/geometry/ransac.py``).

Every hypothesis is fitted in one batched SVD (4-point DLT systems) and
scored against every match in one product; the top hypotheses are refined
by annealed reweighted refits. Functions take (N, 2) points or a batch of
them, (B, N, 2).

What must equal the JAX package, and how:

  * The noise. JAX draws Gumbel noise inside ``ransac_homography`` from a
    ``jax.random`` key; here the caller passes the (n_iters, N) array (one
    a sample), and :func:`gumbel_noise` draws it from a ``torch.Generator``.
    Handed the same array, both packages fit the same hypotheses.
  * Orders. The PROSAC ranks use stable argsorts (``jnp.argsort`` is
    stable), and every top-k is a stable descending sort: on ties (many
    hypotheses score exactly 0) the lower index comes first, as with
    ``jax.lax.top_k``.
  * The minimal fits. ``fit_homography_dlt`` takes the last row of the
    reduced SVD's V^T. For a 4-point fit the 8 x 9 system then yields the
    singular vector of the smallest *nonzero* singular value, not the null
    vector. The JAX package does the same; it is its behaviour, copied and
    pinned by a test, not fixed here.
  * No host read inside the fit: the similarity transforms of the Hartley
    normalisation are inverted in closed form. On a CUDA tensor
    ``torch.linalg.svd`` itself still waits for the device (it checks the
    solver's convergence flags on the host; it has no ``_ex`` form).
"""
import math

import numpy as np
import torch


def gumbel_noise(shape, generator, device):
    """Standard Gumbel noise of ``shape`` (fp32) from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _normalization(pts, mask):
    """Hartley normalisation of (..., N, 2) xy points over ``mask``: a
    similarity T (..., 3, 3) to centroid 0 and mean distance sqrt(2), and
    the normalised points."""
    w = mask.float()
    n = w.sum(-1).clamp_min(1.0)
    mean = (pts * w[..., None]).sum(-2) / n[..., None]
    centred = pts - mean[..., None, :]
    d = torch.sqrt((centred ** 2).sum(-1)) * w
    scale = math.sqrt(2.0) / (d.sum(-1) / n).clamp_min(1e-8)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([one, zero, -mean[..., 0], zero, one, -mean[..., 1],
                     zero, zero, 1.0 / scale], -1).reshape(
        *scale.shape, 3, 3) * scale[..., None, None]
    return T, centred * scale[..., None, None]


def _inv_similarity(T):
    """Inverse of [[s, 0, a], [0, s, b], [0, 0, c]] in closed form."""
    s, a, b, c = T[..., 0, 0], T[..., 0, 2], T[..., 1, 2], T[..., 2, 2]
    zero = torch.zeros_like(s)
    return torch.stack([1.0 / s, zero, -a / (s * c), zero, 1.0 / s,
                        -b / (s * c), zero, zero, 1.0 / c], -1).reshape(
        *s.shape, 3, 3)


def fit_homography_dlt(pts1, pts2, weights=None):
    """Weighted DLT from (..., N, 2) xy correspondences: (..., 3, 3) H with
    H [x1, y1, 1]^T ~ [x2, y2, 1]^T, the last row of the reduced SVD's V^T
    (see the module docstring for N = 4). Degenerate sets give an H that
    scores no inlier downstream."""
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    r2 = torch.stack([z, z, z, x1, y1, o, -y2 * x1, -y2 * y1, -y2], -1)
    A = torch.cat([r1, r2], -2)
    if weights is not None:
        A = A * torch.cat([weights, weights], -1)[..., None]
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return vt[..., -1, :].reshape(*vt.shape[:-2], 3, 3)


def _reproj_error(H, pts1, pts2):
    """Forward transfer error |H p1 - p2| (cv2's), (..., N)."""
    p = torch.cat([pts1, torch.ones_like(pts1[..., :1])], -1) \
        @ H.transpose(-1, -2)
    den = p[..., 2:]
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    return torch.sqrt(((p[..., :2] / den - pts2) ** 2).sum(-1))


def _trunc_score(e, valid, th):
    return torch.where(valid & (e < th), 1.0 - (e / th) ** 2,
                       torch.zeros_like(e)).sum(-1)


def _marg_score(e, valid, th):
    """The truncated-quadratic score marginalised over thresholds th, 2th,
    4th and 8th with weights 1, 1/2, 1/4 and 1/8."""
    return (_trunc_score(e, valid, th) + 0.5 * _trunc_score(e, valid, 2.0 * th)
            + 0.25 * _trunc_score(e, valid, 4.0 * th)
            + 0.125 * _trunc_score(e, valid, 8.0 * th))


def _top(values, k):
    """Indices of the k largest along the last dim, lower index first on
    ties (``jax.lax.top_k``'s order)."""
    return torch.sort(values, dim=-1, descending=True, stable=True)[1][..., :k]


def _take(x, idx):
    """x (B, N, ...) gathered at idx (B, ...) along N."""
    b = torch.arange(x.shape[0], device=x.device).reshape(
        -1, *([1] * (idx.dim() - 1)))
    return x[b, idx]


def hypotheses(pts1, pts2, mask, gumbel, threshold, quality=None):
    """The minimal-sample stage, batched (B, N, 2) / (B, n_iters, N):
    the 4 sample indices of every hypothesis (B, n_iters, 4), its DLT fit
    (B, n_iters, 3, 3) and its marginalised score (B, n_iters)."""
    N = pts1.shape[-2]
    n_iters = gumbel.shape[-2]
    inf = torch.full((), float("inf"), device=pts1.device)
    zero = torch.zeros((), device=pts1.device)
    g = gumbel + torch.where(mask, zero, -inf)[:, None, :]
    if quality is not None:
        # PROSAC: hypothesis j samples among the n_j best-ranked matches,
        # n_j growing geometrically from 8 to N over the hypotheses
        order = torch.argsort(torch.where(mask, quality, inf), dim=-1,
                              stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        jfrac = torch.arange(n_iters, dtype=torch.float32,
                             device=pts1.device) / max(n_iters - 1, 1)
        n_j = 8.0 * torch.pow(N / 8.0, jfrac)
        g = g + torch.where(rank[:, None, :] < n_j[:, None], zero, -inf)
    sel = _top(g, 4)
    Hs = fit_homography_dlt(_take(pts1, sel), _take(pts2, sel))
    errs = _reproj_error(Hs, pts1[:, None], pts2[:, None])
    return sel, Hs, _marg_score(errs, mask[:, None], threshold)


def ransac_homography(pts1, pts2, mask, gumbel, threshold=3.0, refine=True,
                      quality=None, n_refine=16):
    """RANSAC homography (``xpoint_tpu/geometry/ransac.py::
    ransac_homography``), one sample or a batch.

    pts1/pts2: (N, 2) or (B, N, 2) xy matched points; mask: (N,) / (B, N)
    validity; gumbel: (n_iters, N) / (B, n_iters, N) Gumbel noise that
    draws the 4-point samples (:func:`gumbel_noise`); threshold: inlier
    reprojection threshold (px); quality: optional per-match quality, lower
    is better (descriptor distance), for PROSAC-style progressive sampling;
    refine: anneal-refine the ``n_refine`` best hypotheses.

    Returns dict(H (3, 3), inliers (N,) bool, score (), n_inliers ()),
    each with the batch dimension when the input has one.
    """
    single = pts1.dim() == 2
    if single:
        pts1, pts2, mask, gumbel = (t[None] for t in (pts1, pts2, mask,
                                                      gumbel))
        quality = None if quality is None else quality[None]
    pts1, pts2 = pts1.float(), pts2.float()
    n_iters = gumbel.shape[-2]
    _, Hs, scores = hypotheses(pts1, pts2, mask, gumbel, threshold, quality)
    P1, P2 = pts1[:, None], pts2[:, None]
    valid = mask[:, None]

    def refine_once(H_cur, th):
        err = _reproj_error(H_cur, P1, P2)
        w = torch.where(valid & (err < th), 1.0 - (err / th) ** 2,
                        torch.zeros_like(err))
        T1, p1n = _normalization(P1, w > 0)
        T2, p2n = _normalization(P2, w > 0)
        return _inv_similarity(T2) @ fit_homography_dlt(p1n, p2n, w) @ T1

    def strict_score(H):
        return _trunc_score(_reproj_error(H, P1, P2), valid, threshold)

    if refine:
        # LO-RANSAC on the best n_refine hypotheses: refits down a shrinking
        # threshold ladder, each judged by the score that ranked them
        top_idx = _top(scores, min(n_refine, n_iters))
        H_cur = H_best = _take(Hs, top_idx)
        s_best = _take(scores, top_idx)
        for th in (8.0 * threshold, 4.0 * threshold, 2.0 * threshold,
                   threshold, threshold):
            H_cur = refine_once(H_cur, th)
            s_cur = _marg_score(_reproj_error(H_cur, P1, P2), valid,
                                threshold)
            better = s_cur >= s_best
            H_best = torch.where(better[..., None, None], H_cur, H_best)
            s_best = torch.maximum(s_cur, s_best)
        H_best = _take(H_best, torch.argmax(s_best, dim=-1, keepdim=True))
        # two strict-threshold polish rounds, kept where the strict score
        # improves
        for _ in range(2):
            H_pol = refine_once(H_best, threshold)
            use = strict_score(H_pol) > strict_score(H_best)
            H_best = torch.where(use[..., None, None], H_pol, H_best)
    else:
        H_best = _take(Hs, torch.argmax(scores, dim=-1, keepdim=True))

    err = _reproj_error(H_best, P1, P2)[:, 0]
    H_best = H_best[:, 0]
    inliers = mask & (err < threshold)
    h22 = H_best[:, 2:, 2:]
    H_best = H_best / torch.where(h22.abs() < 1e-12,
                                  torch.full_like(h22, 1e-12), h22)
    out = {"H": H_best, "inliers": inliers,
           "score": torch.where(inliers, 1.0 - (err / threshold) ** 2,
                                torch.zeros_like(err)).sum(-1),
           "n_inliers": inliers.sum(-1)}
    return {k: v[0] for k, v in out.items()} if single else out


def estimate_homography_device(pts1, pts2, reprojection_threshold=3.0,
                               n_iters=8192, seed=0, max_points=8192,
                               quality=None, device="cuda"):
    """Host-facing estimator (``xpoint_tpu/geometry/ransac.py::
    estimate_homography_device``): (N, 2) float (x, y) matched points ->
    (H (3, 3) float64 numpy, inlier mask (N, 1) uint8) as
    ``cv2.findHomography`` returns them, or (None, None) below 4 points or
    4 inliers.

    The points are padded to the JAX package's power-of-two bucket ``cap``
    (at least 16, at most ``max_points``; rows past it are not fitted and
    come back as outliers), and ``n_iters`` is capped to
    ``max(1024, 2**24 // cap)``: both set which hypotheses are drawn (the
    PROSAC schedule depends on N), so they are kept although torch needs no
    static shape. The noise comes from a generator on ``device`` seeded
    with ``seed``.
    """
    pts1 = np.asarray(pts1, np.float32).reshape(-1, 2)
    pts2 = np.asarray(pts2, np.float32).reshape(-1, 2)
    n_in = n = pts1.shape[0]
    if n < 4 or pts2.shape[0] != n:
        return None, None
    cap = min(max(16, 1 << (n - 1).bit_length()), max_points)
    if n > cap:
        pts1, pts2, n = pts1[:cap], pts2[:cap], cap
    pad = cap - n
    p1 = np.pad(pts1, ((0, pad), (0, 0)))
    p2 = np.pad(pts2, ((0, pad), (0, 0)))
    q = None
    if quality is not None:
        q = np.full((cap,), np.inf, np.float32)
        q[:n] = np.asarray(quality, np.float32).reshape(-1)[:n]
        q = torch.from_numpy(q).to(device)
    n_iters = min(n_iters, max(1024, (1 << 24) // cap))
    generator = torch.Generator(device=device).manual_seed(seed)
    out = ransac_homography(
        torch.from_numpy(p1).to(device), torch.from_numpy(p2).to(device),
        torch.arange(cap, device=device) < n,
        gumbel_noise((n_iters, cap), generator, device),
        threshold=reprojection_threshold, quality=q)
    # one device-to-host read of what is returned: H's 9 entries, the
    # inlier count and the mask, each exact in float32
    flat = torch.cat([out["H"].reshape(9), out["n_inliers"].reshape(1),
                      out["inliers"]]).float().cpu().numpy()
    if int(flat[9]) < 4:
        return None, None
    H = flat[:9].reshape(3, 3).astype(np.float64)
    if not np.all(np.isfinite(H)):
        return None, None
    inl = np.zeros((n_in, 1), np.uint8)
    inl[:n, 0] = flat[10:10 + n] > 0
    return H, inl
