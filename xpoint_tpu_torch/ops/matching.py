"""Descriptor distances and matching (port of
``xpoint_tpu/ops/matching.py``), batched: every matcher takes (B, N, D)
descriptors and optional (B, N) validity masks.

The JAX code asks for ``precision="high"``; here the product runs in full
fp32 (callers keep TF32 off). Ties go to the lower index, as in the JAX
package: ``torch.argmin`` returns the first minimum.
"""
import numpy as np
import torch

BIG = 1e9


def descriptor_distance_matrix(desc1, desc2):
    """(B, N1, D), (B, N2, D) unit descriptors -> (B, N1, N2) L2 distances."""
    dots = torch.matmul(desc1.float(), desc2.float().transpose(-1, -2))
    return torch.sqrt((2.0 - 2.0 * dots.clamp(-1.0, 1.0)).clamp_min(0.0))


def _masked_distances(desc1, desc2, mask1, mask2):
    dmat = descriptor_distance_matrix(desc1, desc2)
    big = torch.full((), BIG, dtype=dmat.dtype, device=dmat.device)
    if mask1 is not None:
        dmat = torch.where(mask1[:, :, None], dmat, big)
    if mask2 is not None:
        dmat = torch.where(mask2[:, None, :], dmat, big)
    return dmat


def mnn_match(desc1, desc2, mask1=None, mask2=None, threshold=None,
              cross_check=True):
    """Mutual-NN matching with padding masks.

    Returns idx2 (B, N1) int32 index of each query's NN in desc2,
    dist (B, N1) fp32 NN distance, matched (B, N1) bool.
    """
    dmat = _masked_distances(desc1, desc2, mask1, mask2)
    idx2 = torch.argmin(dmat, dim=2)
    dist = torch.gather(dmat, 2, idx2[..., None])[..., 0]
    matched = dist < BIG
    if cross_check:
        idx1 = torch.argmin(dmat, dim=1)               # best row per column
        rows = torch.arange(desc1.shape[1], device=dmat.device)
        matched = matched & (torch.gather(idx1, 1, idx2) == rows)
    if threshold is not None:
        matched = matched & (dist < threshold)
    return idx2.int(), dist, matched


def knn2_match(desc1, desc2, mask1=None, mask2=None, ratio=0.9):
    """2-NN matching with Lowe's ratio test (first < ratio * second).

    The two neighbours are two argmins, the second with the first masked
    to BIG, so that ties order as ``jax.lax.top_k``'s (lower index first).
    A side of one candidate has its second neighbour at BIG, as the JAX
    package's padding gives it. Returns (idx2, dist, matched) like
    :func:`mnn_match`.
    """
    dmat = _masked_distances(desc1, desc2, mask1, mask2)
    idx2 = torch.argmin(dmat, dim=2, keepdim=True)
    d1 = torch.gather(dmat, 2, idx2)[..., 0]
    d2 = dmat.scatter(2, idx2, BIG).amin(dim=2)
    matched = (d1 < BIG) & (d1 < ratio * d2)
    return idx2[..., 0].int(), d1, matched


def threshold_match(desc1, desc2, mask1=None, mask2=None, threshold=0.4):
    """Every pair closer than ``threshold``: (B, N1, N2) bool match matrix
    and the distance matrix; the host enumerates the pairs."""
    dmat = _masked_distances(desc1, desc2, mask1, mask2)
    return dmat < threshold, dmat


def matches_to_list(idx2, dist, matched):
    """One pair's match tensors -> host list of (i1, i2, distance) tuples
    in ascending query order (cv2's)."""
    idx2, dist, matched = (t.cpu().numpy() for t in (idx2, dist, matched))
    return [(int(i), int(idx2[i]), float(dist[i]))
            for i in np.nonzero(matched)[0]]
