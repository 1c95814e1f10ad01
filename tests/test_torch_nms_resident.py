"""The card kernel's resident decomposition of K2 (``csrc/nms_sweep.cu``:
one thread-block cluster a plane, each block a run of rows with its halo
rows' keep read from the sweep before, tiles computed only where a pixel
within the strip set's reach changed in the sweep before, each plane
stopping at its own fixed point, the count the largest of a plane's),
mirrored on the CPU by ``grid_nms_keep_cluster_mirror``, against the JAX
package's grid NMS (``xpoint_tpu.ops.nms._grid_nms_keep``, its XLA path on
the CPU) and its Pallas kernel in interpret mode, and against the port's
plain version. Masks and sweep counts must be equal exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from xpoint_tpu.ops.nms import _grid_nms_keep, _grid_nms_keep_pallas

from xpoint_tpu_torch.ops.nms import (grid_nms_keep_cluster_mirror,
                                      grid_nms_keep_plain)
from torch_env import torch_env  # noqa: F401 (autouse)


def _planes(seed, n, H, W):
    """(n, H, W) heatmaps: random planes with a ramp along the rows of the
    first one's left half (a suppression chain) and the last one's lower
    half zero."""
    rng = np.random.default_rng(seed)
    prob = rng.uniform(size=(n, H, W)).astype(np.float32) ** 4
    prob[0, :, : W // 2] = np.linspace(1.0, 0.6, W // 2)[None, :]
    prob[-1, H // 2:] = 0.0
    return prob


def _check(prob, valid, size, iou, blocks, seg=None, chunk=128):
    """The mirror's mask and count equal JAX's mask and the plain
    version's mask and count; returns the count."""
    want = np.asarray(_grid_nms_keep(jnp.asarray(prob), jnp.asarray(valid),
                                     size, iou))
    p, v = torch.from_numpy(prob), torch.from_numpy(valid)
    ref, ref_sweeps = grid_nms_keep_plain(p, v, size, iou)
    keep, sweeps = grid_nms_keep_cluster_mirror(p, v, size, iou, blocks,
                                                seg, chunk)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert torch.equal(keep, ref) and sweeps == ref_sweeps
    return sweeps


@pytest.mark.parametrize("size,iou,shape,blocks,seg,chunk", [
    # rows a block (3) fewer than the halo (6 at size 8)
    (8, 0.1, (2, 40, 72), 16, None, 32),
    # H not divisible by the block count: 50 rows, 8 blocks of 7 (the last
    # of one row), tiles of 3 rows
    (4, 0.1, (2, 50, 70), 8, 3, 32),
    # one block, one tile of all its rows
    (8, 0.1, (2, 64, 96), 1, None, 128),
    # 16 blocks, a box of 16 (halo 13 rows, wider than a tile of 32
    # columns)
    (16, 0.1, (1, 96, 80), 16, 2, 32),
    (16, 0.2, (2, 33, 65), 5, 4, 32),
    (3, 0.5, (3, 33, 65), 8, None, 32),
    (8, 1.0, (1, 32, 32), 8, None, 32),
])
def test_mirror_matches_jax(size, iou, shape, blocks, seg, chunk):
    prob = _planes(size + shape[1], *shape)
    valid = prob > 0.015
    _check(prob, valid, size, iou, blocks, seg, chunk)


def test_planes_converge_at_their_own_sweep_counts():
    """One call holding a long chain (a ramp along every row, 40+ sweeps),
    a random plane (about ten sweeps) and an all-invalid one (one sweep):
    each plane stops at its own fixed point, the count is the ramp's."""
    H, W = 48, 160
    prob = _planes(3, 3, H, W)
    prob[0] = np.linspace(1.0, 0.5, W, dtype=np.float32)[None, :]
    valid = prob > 0.015
    valid[2] = False
    counts = [grid_nms_keep_plain(torch.from_numpy(prob[i:i + 1]),
                                  torch.from_numpy(valid[i:i + 1]), 8,
                                  0.1)[1] for i in range(3)]
    assert counts[0] >= 40 and counts[1] <= 12 and counts[2] == 1
    assert _check(prob, valid, 8, 0.1, 6, 4, 32) == max(counts)


@pytest.mark.parametrize("W", [64, 65])
def test_mirror_at_the_sweep_cap(W):
    """A 1 x W ramp at size 2 still changes at the H * W cap: the mirror
    stops there, with the last sweep's mask, on one and on two blocks."""
    prob = np.linspace(1.0, 0.5, W, dtype=np.float32)[None, None, :].copy()
    for blocks in (1, 2):
        assert _check(prob, prob > 0, 2, 0.1, blocks, 1, 32) == W


def test_valid_pixel_scored_minus_inf():
    """A valid pixel whose score is -inf is kept unless a kept neighbour
    scores above it, and suppresses nothing (the XLA form and the plain
    version; JAX's Pallas kernel folds valid into the score as -inf and
    cannot keep it, so the card keeps valid apart from p)."""
    prob = _planes(11, 2, 40, 56)
    valid = prob > 0.015
    prob[0, 5, 5] = prob[0, 30, 40] = prob[1, 20, 28] = -np.inf
    valid[0, 5, 5] = valid[0, 30, 40] = valid[1, 20, 28] = True
    valid[0, :12, :12] = False            # (5, 5) alone: kept
    valid[0, 5, 5] = True
    keep, _ = grid_nms_keep_cluster_mirror(
        torch.from_numpy(prob), torch.from_numpy(valid), 8, 0.1, 8, 2, 32)
    assert bool(keep[0, 5, 5])
    _check(prob, valid, 8, 0.1, 8, 2, 32)


def test_mirror_matches_pallas_kernel():
    """Against the JAX package's own kernel in interpret mode on a 128 x
    128 plane (a ramp along the rows of its left half, 8 blocks of 16
    rows)."""
    prob = _planes(5, 1, 128, 128)
    valid = prob > 0.015
    want = np.asarray(_grid_nms_keep_pallas(jnp.asarray(prob),
                                            jnp.asarray(valid), 8, 0.1))
    keep, sweeps = grid_nms_keep_cluster_mirror(
        torch.from_numpy(prob), torch.from_numpy(valid), 8, 0.1, 8)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert sweeps >= 20
