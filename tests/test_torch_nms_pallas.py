"""K2's plain version, the oracle of the card kernel's banded instance
(boxes above 16), against the JAX package's own kernel,
``xpoint_tpu.ops.nms._grid_nms_keep_pallas``, run in interpret mode on the
CPU as the JAX package's tests run it. Small planes (1, 64, 128), boxes of
24 and 40 at IoU 0.1 and 0.3, on a ramp along each row (a suppression chain)
and on a random plane; keep masks must be equal exactly.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from xpoint_tpu.ops.nms import _grid_nms_keep_pallas

from xpoint_tpu_torch.ops.nms import grid_nms_keep_plain
from torch_env import torch_env  # noqa: F401 (autouse)


def _plane(kind, seed):
    """(prob, valid) of shape (1, 64, 128)."""
    if kind == "ramp":
        r = np.linspace(1.0, 0.5, 128, dtype=np.float32)
        prob = np.broadcast_to(r[None, None, :], (1, 64, 128)).copy()
        return prob, prob > 0
    rng = np.random.default_rng(seed)
    prob = (rng.uniform(size=(1, 64, 128)) ** 4).astype(np.float32)
    return prob, prob > 0.015


@pytest.mark.parametrize("kind", ["ramp", "random"])
@pytest.mark.parametrize("iou", [0.1, 0.3])
@pytest.mark.parametrize("size", [24, 40])
def test_plain_matches_pallas_kernel_above_16(size, iou, kind):
    prob, valid = _plane(kind, size)
    want = np.asarray(_grid_nms_keep_pallas(jnp.asarray(prob),
                                            jnp.asarray(valid), size, iou))
    keep, sweeps = grid_nms_keep_plain(torch.from_numpy(prob),
                                       torch.from_numpy(valid), size, iou)
    np.testing.assert_array_equal(keep.numpy(), want)
    # the boxes suppress: fewer survivors than candidates, but some
    assert sweeps >= 2 and 0 < int(keep.sum()) < int(valid.sum())
