"""The weights made from the seed: the same seed gives the same state, and
no leaf is a constant, so that no bias, norm affine, BatchNorm statistic or
scan parameter is an identity in the comparison."""
import json
import os

import pytest
import torch

from xpbench import reference, weights
from tiny import ROOT


def _shapes(config):
    with open(os.path.join(ROOT, "xpbench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    model, _ = reference.build(cfg["model"], cfg["precision"], None, "meta")
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


@pytest.mark.parametrize("config", ["xpoint-vmamba", "xpoint-swinv2"])
def test_no_leaf_is_constant(config):
    state = weights.make_state(_shapes(config), 2 ** 31 + 5, "cpu")
    flat = [n for n, t in state.items() if t.numel() > 1
            and float(t.float().std()) == 0.0]
    assert not flat, flat
    for n, t in state.items():
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "running_var":
            assert 0.5 <= float(t.min()) and float(t.max()) <= 1.5, n
        if leaf in ("bias", "q_bias", "v_bias", "running_mean"):
            assert float(t.abs().max()) > 0.0, n


@pytest.mark.parametrize("config", ["xpoint-vmamba", "xpoint-swinv2"])
def test_same_seed_same_state(config):
    shapes = _shapes(config)
    a = weights.make_state(shapes, 123456789012, "cpu")
    b = weights.make_state(dict(reversed(list(shapes.items()))),
                           123456789012, "cpu")
    c = weights.make_state(shapes, 123456789013, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in shapes)
    assert not all(torch.equal(a[n], c[n]) for n in shapes)
