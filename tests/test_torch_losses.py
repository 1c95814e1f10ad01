"""Parity of the PyTorch port's training losses with the JAX package's
(``xpoint_tpu/losses/xpoint_loss.py``): the same numpy inputs through both,
values and gradients, fp32 on the CPU."""
import copy
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.losses.xpoint_loss import DEFAULT_CONFIG as JX_DEFAULT
from xpoint_tpu.losses.xpoint_loss import XPointLoss as JxXPointLoss
from xpoint_tpu.losses.xpoint_loss import descriptor_loss as jx_descriptor_loss
from xpoint_tpu.losses.xpoint_loss import detector_loss as jx_detector_loss

from xpoint_tpu_torch.losses.xpoint_loss import (DEFAULT_CONFIG, XPointLoss,
                                                 descriptor_loss,
                                                 detector_loss)
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG
from xpoint_tpu_torch.utils import dict_update

T = torch.from_numpy
# fp32 sums in another order on each side: 1e-5 relative
RTOL, ATOL = 1e-5, 1e-6


def _cfg(**kw):
    return dict_update(copy.deepcopy(DEFAULT_CONFIG), kw)


def _keypoint_map(rng, B, H, W, per_cell_max1=True):
    """Random keypoints; with per_cell_max1 at most one per 8x8 cell, so
    that the hard assignment's random tiebreak never decides anything."""
    kp = np.zeros((B, H, W), np.float32)
    for b in range(B):
        for i in range(0, H, 8):
            for j in range(0, W, 8):
                if rng.uniform() < 0.4:
                    n = 1 if per_cell_max1 else rng.integers(1, 4)
                    for _ in range(n):
                        kp[b, i + rng.integers(8), j + rng.integers(8)] = 1.0
    return kp


def _homographies(rng, B, scale=0.05):
    h = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    h[:, :2, :2] += scale * rng.normal(size=(B, 2, 2))
    h[:, :2, 2] += 4 * scale * 20 * rng.normal(size=(B, 2))
    h[:, 2, :2] += 1e-4 * rng.normal(size=(B, 2))
    return h.astype(np.float32)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def test_default_config_is_the_jax_one():
    assert DEFAULT_CONFIG == JX_DEFAULT


@pytest.mark.parametrize("fn", ["cross_entropy", "focal_loss",
                                "cross_entropy_focal_blended"])
@pytest.mark.parametrize("assign", ["hard_assignment", "soft_assignment"])
@pytest.mark.parametrize("masked", [False, True])
def test_detector_loss_matches_jax(fn, assign, masked):
    """Loss, every diagnostic and the logits gradient within rtol 1e-5
    (keypoints at most one per cell: the tiebreak noise decides nothing)."""
    rng = np.random.default_rng(
        zlib.crc32(f"{fn}-{assign}-{masked}".encode()))
    B, H, W = 2, 32, 40
    logits = rng.normal(size=(B, H // 8, W // 8, 65)).astype(np.float32) * 2
    kp = _keypoint_map(rng, B, H, W)
    vm = None
    if masked:
        vm = np.ones((B, H, W), np.float32)
        vm[0, :5] = 0.0
        vm[1, :, -9:] = 0.0
    cfg = _cfg(detector_loss_function=fn,
               detector_handle_multiple_keypoints=assign,
               detector_dustbin_loss_weight=0.025)

    def jf(lg):
        return jx_detector_loss(lg, jnp.asarray(kp),
                                None if vm is None else jnp.asarray(vm), cfg)
    (jl, jc), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(logits))
    lg = T(logits).requires_grad_()
    tl, tc = detector_loss(lg, T(kp), None if vm is None else T(vm), cfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    assert set(tc) == set(jc)
    for k in tc:
        np.testing.assert_allclose(float(tc[k].detach()), float(jc[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL * np.abs(np.asarray(jg)).max())


def test_detector_soft_assignment_several_keypoints_per_cell():
    """Soft targets spread over several keypoints of a cell: the loss does
    not depend on the tiebreak (only the diagnostics do)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 4, 4, 65)).astype(np.float32)
    kp = _keypoint_map(rng, 2, 32, 32, per_cell_max1=False)
    cfg = _cfg()
    jl, _ = jx_detector_loss(jnp.asarray(logits), jnp.asarray(kp), None, cfg)
    tl, _ = detector_loss(T(logits), T(kp), None, cfg,
                          torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)


def _desc_inputs(seed, B=2, Hc=8, Wc=8, D=16):
    rng = np.random.default_rng(seed)
    d1 = _unit(rng.normal(size=(B, Hc, Wc, D)))
    # descriptor 2 near descriptor 1: positives near 1, some hard negatives
    d2 = _unit(d1 + 0.6 * rng.normal(size=d1.shape))
    h1 = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    h2 = _homographies(rng, B)
    H, W = Hc * 8, Wc * 8
    vm1 = np.ones((B, H, W), np.float32)
    vm2 = np.ones((B, H, W), np.float32)
    vm2[:, :, : W // 4] = 0.0
    vm2[1, -12:] = 0.0
    return d1, d2, h1, h2, vm1, vm2


@pytest.mark.parametrize("hn", [False, True])
@pytest.mark.parametrize("mask", ["masks", "no_masks", "mask_off"])
@pytest.mark.parametrize("cells", [(8, 8), (24, 24)])
def test_descriptor_loss_matches_jax(hn, mask, cells):
    """Dense descriptor loss (total, positive, negative) and its gradient
    w.r.t. both descriptor maps within rtol 1e-5; 24x24 cells (N = 576)
    streams two chunks of 288. Threshold 4 (the flagship's) and 8."""
    d1, d2, h1, h2, vm1, vm2 = _desc_inputs(len(mask) + hn, *(2, *cells))
    if mask == "no_masks":
        vm1 = vm2 = None
    for thr in (4.0, 8.0):
        cfg = _cfg(descriptor_loss_threshold=thr,
                   descriptor_loss_use_mask=mask != "mask_off",
                   hard_negative_weighting={'check': hn, 'temperature': 0.1,
                                            'weight': 0.2,
                                            'keep_uniform': True})
        opt = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731

        def jf(a, b):
            tot, pos, neg = jx_descriptor_loss(
                a, b, jnp.asarray(h1), jnp.asarray(h2), opt(vm1), opt(vm2),
                cfg)
            return tot, (pos, neg)
        (jt, (jp, jn)), (ga, gb) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jnp.asarray(d1), jnp.asarray(d2))
        a, b = T(d1).requires_grad_(), T(d2).requires_grad_()
        tt, tp, tn = descriptor_loss(
            a, b, T(h1), T(h2), None if vm1 is None else T(vm1),
            None if vm2 is None else T(vm2), cfg)
        tt.backward()
        for mine, theirs in ((tt, jt), (tp, jp), (tn, jn)):
            np.testing.assert_allclose(float(mine.detach()), float(theirs),
                                       rtol=RTOL, atol=ATOL)
        for mine, theirs in ((a.grad, ga), (b.grad, gb)):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(mine.numpy(), theirs, rtol=RTOL,
                                       atol=ATOL * np.abs(theirs).max())


def test_hard_negative_replace_uniform():
    d1, d2, h1, h2, vm1, vm2 = _desc_inputs(9)
    cfg = _cfg(hard_negative_weighting={'check': True, 'temperature': 0.1,
                                        'weight': 0.2, 'keep_uniform': False})
    ref = jx_descriptor_loss(*map(jnp.asarray, (d1, d2, h1, h2, vm1, vm2)),
                             cfg)
    out = descriptor_loss(*map(T, (d1, d2, h1, h2, vm1, vm2)), cfg)
    for mine, theirs in zip(out, ref):
        np.testing.assert_allclose(float(mine), float(theirs), rtol=RTOL)


def _jax_sparse_cells(key, Hc, Wc, divisor):
    """The cells JAX's sparse descriptor loss draws from ``key``."""
    n = (Hc * Wc) // divisor
    r1, r2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.randint(r1, (n,), 0, Hc)),
                     np.asarray(jax.random.randint(r2, (n,), 0, Wc))], -1)


@pytest.mark.parametrize("hn", ["off", "uniform", "replace"])
@pytest.mark.parametrize("warped", [True, False])
def test_sparse_descriptor_loss_matches_jax(hn, warped):
    """The sparse descriptor loss on JAX's own cell draws (64 of 16 x 16
    cells, divisor 4), warped by mild homographies or not at all, hard
    negatives off, beside the uniform term, or replacing it: total,
    positive and negative, and the gradients w.r.t. both descriptor maps,
    within rtol 1e-5."""
    d1, d2, _, _, _, _ = _desc_inputs(20 + len(hn), 2, 16, 16, 32)
    rng = np.random.default_rng(21)
    h1, h2 = (_homographies(rng, 2, scale=0.02) if warped else None
              for _ in range(2))
    cfg = _cfg(sparse_descriptor_loss=True,
               sparse_descriptor_loss_num_cell_divisor=4,
               hard_negative_weighting={'check': hn != "off",
                                        'temperature': 0.1, 'weight': 0.2,
                                        'keep_uniform': hn != "replace"})
    key = jax.random.PRNGKey(len(hn))
    opt = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731

    def jf(a, b):
        tot, pos, neg = jx_descriptor_loss(a, b, opt(h1), opt(h2), None,
                                           None, cfg, key)
        return tot, (pos, neg)
    (jt, (jp, jn)), (ga, gb) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(d1), jnp.asarray(d2))
    a, b = T(d1).requires_grad_(), T(d2).requires_grad_()
    opt_t = lambda v: None if v is None else T(v)  # noqa: E731
    tt, tp, tn = descriptor_loss(a, b, opt_t(h1), opt_t(h2), None, None, cfg,
                                 cells=T(_jax_sparse_cells(key, 16, 16, 4)))
    tt.backward()
    for mine, theirs in ((tt, jt), (tp, jp), (tn, jn)):
        np.testing.assert_allclose(float(mine.detach()), float(theirs),
                                   rtol=RTOL, atol=ATOL)
    for mine, theirs in ((a.grad, ga), (b.grad, gb)):
        theirs = np.asarray(theirs)
        assert np.abs(theirs).max() > 0
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=RTOL,
                                   atol=ATOL * np.abs(theirs).max())


def test_sparse_descriptor_loss_raises(monkeypatch):
    """(The sparse loss raised here before it was ported.) XPointLoss with
    ``sparse_descriptor_loss`` on a pair batch, the flagship loss config
    otherwise, against JAX's with the cells JAX draws from the descriptor
    key of its rng split handed to the port: every component and the
    gradients w.r.t. both predictions within rtol 1e-5; without cells the
    port draws its own from the generator, the same ones for the same
    seed."""
    from xpoint_tpu_torch.losses import xpoint_loss
    rng = np.random.default_rng(23)
    B, H, W = 2, 64, 64
    cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8,
               sparse_descriptor_loss=True,
               sparse_descriptor_loss_num_cell_divisor=2)
    d1, d2, _, _, vm1, vm2 = _desc_inputs(24, B, H // 8, W // 8, 32)
    h1, h2 = (_homographies(rng, B, scale=0.01) for _ in range(2))
    data = {
        'optical': {'keypoints': _keypoint_map(rng, B, H, W),
                    'valid_mask': vm1, 'homography': h1},
        'thermal': {'keypoints': _keypoint_map(rng, B, H, W),
                    'valid_mask': vm2, 'homography': h2}}
    preds = [{'logits': rng.normal(size=(B, 8, 8, 65)).astype(np.float32),
              'desc': d} for d in (d1, d2)]
    key = jax.random.PRNGKey(3)
    jloss = JxXPointLoss(cfg)
    jdata = jax.tree.map(jnp.asarray, data)
    (jl, jc), jg = jax.value_and_grad(
        lambda p1, p2: jloss(jdata, p1, p2, None, key), argnums=(0, 1),
        has_aux=True)(*jax.tree.map(jnp.asarray, (preds[0], preds[1])))

    cells = T(_jax_sparse_cells(jax.random.split(key, 3)[2], 8, 8, 2))
    inner = xpoint_loss.sparse_descriptor_loss
    monkeypatch.setattr(
        xpoint_loss, "sparse_descriptor_loss",
        lambda *a, **kw: inner(*a[:5], cells=cells))
    tdata = {k: {kk: T(vv) for kk, vv in v.items()} for k, v in data.items()}
    tp = [{k: T(v).requires_grad_() for k, v in p.items()} for p in preds]
    tl, tc = XPointLoss(cfg)(tdata, tp[0], tp[1])
    tl.backward()
    assert set(tc) == set(jc)
    for k in tc:
        np.testing.assert_allclose(float(tc[k].detach()), float(jc[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for mine, theirs in ((tp[0], jg[0]), (tp[1], jg[1])):
        for k in ('logits', 'desc'):
            ref = np.asarray(theirs[k])
            np.testing.assert_allclose(mine[k].grad.numpy(), ref, rtol=RTOL,
                                       atol=ATOL * max(np.abs(ref).max(), 1),
                                       err_msg=k)
    monkeypatch.setattr(xpoint_loss, "sparse_descriptor_loss", inner)
    drawn = [XPointLoss(cfg)(tdata, tp[0], tp[1],
                             gen=torch.Generator().manual_seed(5))[1]
             for _ in range(2)]
    assert float(drawn[0]['descriptor_loss'].detach()) == \
        float(drawn[1]['descriptor_loss'].detach())


@pytest.mark.parametrize("similarity", [False, True])
def test_xpoint_loss_matches_jax(similarity):
    """The flagship loss config (CE soft assignment, dustbin 0.025,
    threshold 4, hard negatives, HM loss) on a pair batch, every component
    and the gradients w.r.t. both predictions within rtol 1e-5."""
    rng = np.random.default_rng(11)
    B, H, W = 2, 64, 64
    cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8,
               use_encoder_similarity=similarity)
    d1, d2, h1, h2, vm1, vm2 = _desc_inputs(12, B, H // 8, W // 8, 32)
    data = {
        'optical': {'keypoints': _keypoint_map(rng, B, H, W),
                    'valid_mask': vm1, 'homography': h1},
        'thermal': {'keypoints': _keypoint_map(rng, B, H, W),
                    'valid_mask': vm2, 'homography': h2},
        'hfour_points': rng.normal(size=(B, 4, 2)).astype(np.float32) * 9}
    preds = [{'logits': rng.normal(size=(B, 8, 8, 65)).astype(np.float32),
              'desc': d, 'encoder_output': rng.normal(
                  size=(B, 8, 8, 12)).astype(np.float32)} for d in (d1, d2)]
    hm = rng.normal(size=(B, 8)).astype(np.float32) * 0.3

    jloss = JxXPointLoss(cfg)
    jdata = jax.tree.map(jnp.asarray, data)

    def jf(p1, p2, h):
        return jloss(jdata, p1, p2, h)
    (jl, jc), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *jax.tree.map(jnp.asarray, (preds[0], preds[1], hm)))

    tdata = {k: ({kk: T(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else T(v)) for k, v in data.items()}
    tp = [{k: T(v).requires_grad_() for k, v in p.items()} for p in preds]
    th = T(hm).requires_grad_()
    tl, tc = XPointLoss(cfg)(tdata, tp[0], tp[1], th)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    assert set(tc) == set(jc)
    for k in tc:
        np.testing.assert_allclose(float(tc[k].detach()), float(jc[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for mine, theirs in ((tp[0], jg[0]), (tp[1], jg[1])):
        for k in ('logits', 'desc', 'encoder_output'):
            ref = np.asarray(theirs[k])
            got = mine[k].grad
            got = np.zeros_like(ref) if got is None else got.numpy()
            np.testing.assert_allclose(got, ref, rtol=RTOL,
                                       atol=ATOL * max(np.abs(ref).max(), 1),
                                       err_msg=k)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg[2]), rtol=RTOL,
                               atol=ATOL)
