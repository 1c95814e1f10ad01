"""K2's plain version, the card kernel's oracle, against the JAX package's
grid NMS (``xpoint_tpu.ops.nms._grid_nms_keep``, its XLA path on the CPU) on
the inputs the device loop of ``csrc/nms_sweep.cu`` must get right: long
suppression chains that need many sweeps, the sweep cap, an all-invalid
plane and a plane of one 32 x 32 tile, at box sizes up to 32 (above 16
the kernel takes its direct instance). Masks must be equal exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from xpoint_tpu.ops.nms import _grid_nms_keep

from xpoint_tpu_torch.ops.nms import grid_nms_keep, grid_nms_keep_plain
from torch_env import torch_env  # noqa: F401 (autouse)


def _ramp(H, W, axis):
    """(1, H, W) strictly decreasing along each row (axis -1) or column
    (axis -2): every box suppresses the next, about two sweeps a box."""
    r = np.linspace(1.0, 0.5, W if axis == -1 else H, dtype=np.float32)
    r = r[None, None, :] if axis == -1 else r[None, :, None]
    return np.broadcast_to(r, (1, H, W)).copy()


def _both(prob, valid, size, iou=0.1):
    """(plain keep, plain sweeps) after checking the mask against JAX's and
    the public wrapper's on the CPU."""
    ref = np.asarray(_grid_nms_keep(jnp.asarray(prob), jnp.asarray(valid),
                                    size, iou))
    keep, sweeps = grid_nms_keep_plain(torch.from_numpy(prob),
                                       torch.from_numpy(valid), size, iou)
    np.testing.assert_array_equal(keep.numpy(), ref)
    before = grid_nms_keep.launches
    keep_w, sweeps_w = grid_nms_keep(torch.from_numpy(prob),
                                     torch.from_numpy(valid), size, iou)
    assert grid_nms_keep.launches == before
    assert sweeps_w == sweeps and torch.equal(keep_w, keep)
    return keep, sweeps


@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("shape,axis", [((64, 512), -1), ((512, 64), -2)])
def test_ramp_chains_match_jax(shape, axis, size):
    prob = _ramp(*shape, axis)
    keep, sweeps = _both(prob, prob > 0, size)
    assert sweeps >= 60
    # one survivor every box's reach along the ramp, the top of it kept
    line = keep[0, 0] if axis == -1 else keep[0, :, 0]
    assert bool(line[0]) and 1 < int(line.sum()) < line.numel() // 2


@pytest.mark.parametrize("W", [64, 65])
def test_sweep_cap_matches_jax(W):
    """A 1 x W row ramp at size 2 is still changing at the H * W cap, where
    both stop (the kernel's card test takes the same plane)."""
    prob = _ramp(1, W, -1)
    _, sweeps = _both(prob, prob > 0, 2)
    assert sweeps == W


@pytest.mark.parametrize("size", [1, 8, 16, 24, 32])
def test_all_invalid_plane(size):
    prob = np.random.default_rng(size).uniform(size=(2, 40, 72)).astype(
        np.float32)
    keep, sweeps = _both(prob, np.zeros(prob.shape, bool), size)
    assert sweeps in (0, 1) and not bool(keep.any())


@pytest.mark.parametrize("size,iou", [(8, 0.1), (4, 0.3), (16, 0.2),
                                      (24, 0.1), (32, 0.3)])
def test_one_tile_plane(size, iou):
    rng = np.random.default_rng(size)
    prob = (rng.uniform(size=(1, 32, 32)) ** 4).astype(np.float32)
    keep, sweeps = _both(prob, prob > 0.015, size, iou)
    assert sweeps >= 2 and 0 < int(keep.sum()) < int((prob > 0.015).sum())


@pytest.mark.parametrize("size,iou,shape", [(40, 0.3, (1, 64, 20)),
                                            (64, 0.1, (2, 60, 33))])
def test_box_wider_than_the_plane(size, iou, shape):
    """Strips wider than the plane (|dx| up to 21 and 52 on planes 20 and
    33 wide): every window then holds the whole row, as JAX's
    reduce_window gives it; the kernel clamps its halo to the plane."""
    prob = (np.random.default_rng(size).uniform(size=shape) ** 4).astype(
        np.float32)
    keep, sweeps = _both(prob, prob > 0.015, size, iou)
    assert sweeps >= 2 and 0 < int(keep.sum()) < int((prob > 0.015).sum())
