"""Parity of the PyTorch port's ops (plain versions, CPU) with the JAX
package on the same numpy inputs.

The JAX side runs as the JAX package's own tests run it on the CPU: Pallas
kernels in interpret mode. The CUDA kernels themselves are held against
these plain versions in tests/test_torch_kernels.py (card only).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.ops.descriptor import interpolate_descriptors as jx_interp
from xpoint_tpu.ops.detector import prob_from_logits as jx_prob
from xpoint_tpu.ops.gridops import depth_to_space as jx_d2s
from xpoint_tpu.ops.gridops import space_to_depth as jx_s2d
from xpoint_tpu.ops.matching import mnn_match as jx_mnn
from xpoint_tpu.ops.nms import (_grid_nms_keep, _grid_nms_keep_pallas,
                                _nms_block_edge, _overlap_widths,
                                box_nms_extract as jx_box_nms_extract)
from xpoint_tpu.ops.selective_scan_pallas import (
    _fused_bidir_tok_impl, selective_scan_fused_bidir_tok)

from xpoint_tpu_torch.ops.descriptor import interpolate_descriptors
from xpoint_tpu_torch.ops.detector import prob_from_logits
from xpoint_tpu_torch.ops.gridops import depth_to_space, space_to_depth
from xpoint_tpu_torch.ops.matching import mnn_match
from xpoint_tpu_torch.ops.nms import (box_nms_extract, grid_nms_keep,
                                      grid_nms_keep_plain, nms_block_edge,
                                      overlap_widths)
from xpoint_tpu_torch.ops.selective_scan_cuda import (
    SelectiveScanBidir, scan_bidir, selective_scan_bidir,
    selective_scan_bidir_bwd, selective_scan_bidir_bwd_plain,
    selective_scan_bidir_plain)

T = torch.from_numpy


def _scan_operands(seed, L, B, Dim):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(L, B, 2, Dim), f(2, L, B, 2, Dim) * 0.5, f(2, L, B, 2),
            f(2, L, B, 2), -np.exp(f(4 * Dim) * 0.3), f(4 * Dim),
            f(4 * Dim) * 0.2)


def test_scan_plain_matches_pallas_bidir_tok():
    """K1's plain version against the Pallas kernel (interpret mode), fp32,
    L=300 crossing the 256-token chunk, Dim=24."""
    args = _scan_operands(3, L=300, B=2, Dim=24)
    y_f, y_r = jax.jit(selective_scan_fused_bidir_tok)(
        *map(jnp.asarray, args))
    t_f, t_r = selective_scan_bidir_plain(*map(T, args))
    np.testing.assert_allclose(t_f.numpy(), np.asarray(y_f),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_r.numpy(), np.asarray(y_r),
                               rtol=1e-4, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors, never the kernel
    before = selective_scan_bidir.launches
    w_f, w_r = selective_scan_bidir(*map(T, args))
    assert selective_scan_bidir.launches == before
    assert torch.equal(w_f, t_f) and torch.equal(w_r, t_r)


def test_scan_checkpoints_and_bwd_plain_match_pallas():
    """K1's checkpoints and K3's plain version against the Pallas kernels
    (interpret mode): _fused_bidir_tok_impl(emit_ckpt=True) and jax.vjp of
    selective_scan_fused_bidir_tok (which runs _fused_bidir_bwd_kernel).
    fp32, L=300 crossing the 256-token chunk, Dim=24, B=2: rtol 1e-4,
    atol 1e-5 for the checkpoints and all seven cotangents."""
    L, B, Dim = 300, 2, 24
    args = _scan_operands(5, L=L, B=B, Dim=Dim)
    rng = np.random.default_rng(6)
    g_f, g_r = (rng.normal(size=(L, B, 2, Dim)).astype(np.float32)
                for _ in range(2))
    jargs = tuple(map(jnp.asarray, args))
    (_, _), (jh_f, jh_r) = jax.jit(
        lambda *a: _fused_bidir_tok_impl(*a, emit_ckpt=True))(*jargs)
    _, vjp = jax.vjp(selective_scan_fused_bidir_tok, *jargs)
    ref = vjp((jnp.asarray(g_f), jnp.asarray(g_r)))

    M = B * 2 * Dim
    y_f, y_r, h_f, h_r = selective_scan_bidir_plain(*map(T, args),
                                                    emit_ckpt=True)
    assert h_f.shape == (2, M) and h_f.dtype == torch.float32
    # JAX blocks (nl, 8, Mp): row 0 holds the state, the rest is padding
    for mine, theirs in ((h_f, jh_f), (h_r, jh_r)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs)[:, 0, :M],
                                   rtol=1e-4, atol=1e-5)
    out = selective_scan_bidir_bwd_plain(*map(T, args), h_f, h_r, T(g_f),
                                         T(g_r))
    names = ("du_t", "ddt_t", "dbc_t", "dcc_t", "dA", "dD", "ddelta_bias")
    for name, mine, theirs in zip(names, out, ref):
        assert mine.shape == theirs.shape, name
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # on CPU tensors the wrappers take the plain versions, never a kernel
    before = (selective_scan_bidir.launches, selective_scan_bidir_bwd.launches)
    w = selective_scan_bidir_bwd(*map(T, args), h_f, h_r, T(g_f), T(g_r))
    assert all(torch.equal(a, b) for a, b in zip(w, out))
    xs = [T(a).requires_grad_() for a in args]
    yf, yr = scan_bidir(*xs)
    torch.autograd.backward((yf, yr), (T(g_f), T(g_r)))
    for name, x, mine in zip(names, xs, out):
        assert torch.equal(x.grad, mine), name
    assert (selective_scan_bidir.launches,
            selective_scan_bidir_bwd.launches) == before


def test_scan_autograd_gradcheck():
    """SelectiveScanBidir (plain forward with checkpoints, plain backward)
    under torch.autograd.gradcheck in float64, L=7, Dim=2."""
    rng = np.random.default_rng(7)
    f = lambda *s: torch.from_numpy(rng.normal(size=s))  # noqa: E731
    L, B, Dim = 7, 2, 2
    xs = [f(L, B, 2, Dim), f(2, L, B, 2, Dim) * 0.5, f(2, L, B, 2),
          f(2, L, B, 2), -torch.exp(f(4 * Dim) * 0.3), f(4 * Dim),
          f(4 * Dim) * 0.2]
    assert torch.autograd.gradcheck(
        SelectiveScanBidir.apply, [x.requires_grad_() for x in xs])


def test_scan_no_checkpoints_without_grad():
    """Serving (no gradient wanted) keeps the forward without checkpoints."""
    args = list(map(T, _scan_operands(0, L=9, B=1, Dim=4)))
    assert len(scan_bidir(*args)) == 2
    with torch.no_grad():
        assert len(scan_bidir(*[a.requires_grad_() for a in args])) == 2


def test_scan_bwd_wrapper_rejects_bad_operands():
    args = list(map(T, _scan_operands(0, L=8, B=1, Dim=4)))
    _, _, h_f, h_r = selective_scan_bidir(*args, emit_ckpt=True)
    g = torch.zeros(8, 1, 2, 4)
    with pytest.raises(TypeError):                      # bf16 cotangent
        selective_scan_bidir_bwd(*args, h_f, h_r, g.bfloat16(), g)
    with pytest.raises(ValueError):                     # checkpoint shape
        selective_scan_bidir_bwd(*args, h_f[:, :4], h_r, g, g)
    with pytest.raises(TypeError):                      # fp64 checkpoints
        selective_scan_bidir_bwd(*args, h_f.double(), h_r, g, g)


def test_scan_wrapper_rejects_bad_operands():
    args = list(map(T, _scan_operands(0, L=8, B=1, Dim=4)))
    with pytest.raises(TypeError):
        selective_scan_bidir(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError):
        selective_scan_bidir(args[0], args[1][:, :4], *args[2:])
    with pytest.raises(ValueError):
        wide = torch.cat([args[0], args[0]], dim=-1)
        selective_scan_bidir(wide[..., :4], *args[1:])     # non-contiguous


def _nms_fixture():
    """tests/test_ops_core.py::test_grid_nms_pallas_matches_xla_path."""
    rng = np.random.default_rng(11)
    prob = rng.uniform(size=(2, 64, 128)).astype(np.float32)
    prob[prob < 0.7] = 0.0
    prob[1, :, :64] = np.linspace(1.0, 0.6, 64)[None, :]   # ramp chains
    prob[0, 40:] = 0.0                                      # sparse region
    return prob


@pytest.mark.parametrize("size,thr", [(8, 0.015), (4, 0.5), (8, None)])
def test_grid_nms_plain_equals_jax(size, thr):
    """K2's plain keep mask equals both JAX paths exactly; thr None is the
    negative-min_prob case (every pixel valid, scores <= 0 eligible)."""
    prob = _nms_fixture()
    if thr is None:
        prob = prob - 0.5
        valid = np.ones(prob.shape, bool)
    else:
        valid = prob > thr
    ref = np.asarray(_grid_nms_keep(jnp.asarray(prob), jnp.asarray(valid),
                                    size, 0.1))
    pal = np.asarray(_grid_nms_keep_pallas(jnp.asarray(prob),
                                           jnp.asarray(valid), size, 0.1))
    keep, sweeps = grid_nms_keep_plain(T(prob), T(valid), size, 0.1)
    np.testing.assert_array_equal(keep.numpy(), ref)
    np.testing.assert_array_equal(keep.numpy(), pal)
    assert sweeps >= 2
    before = grid_nms_keep.launches
    keep_w, sweeps_w = grid_nms_keep(T(prob), T(valid), size, 0.1)
    assert grid_nms_keep.launches == before and sweeps_w == sweeps
    assert torch.equal(keep_w, keep)


_TABLE_CASES = [(8, 0.1), (4, 0.1), (3, 0.5), (8, 1.0)]


@pytest.mark.parametrize("size,iou", _TABLE_CASES + [
    (s, iou) for iou in (0.1, 0.3, 0.7) for s in range(1, 33)
    if (s, iou) not in _TABLE_CASES])
def test_nms_tables_match_jax(size, iou):
    assert overlap_widths(size, iou) == _overlap_widths(size, iou)
    for H, W in [(512, 512), (64, 96), (30, 30)]:
        assert nms_block_edge(size, iou, H, W) == _nms_block_edge(size, iou,
                                                                  H, W)


def _kp_set(kps, mask):
    return {tuple(p) for p, m in zip(np.asarray(kps), np.asarray(mask)) if m}


@pytest.mark.parametrize("k", [16, 200, 5000])
def test_box_nms_extract_keypoint_sets(k):
    """Masked keypoint sets and their scores equal the JAX extraction: the
    block-max top-k (k small), the full top-k (k large) and padding
    (k > H*W)."""
    rng = np.random.default_rng(5)
    prob = rng.uniform(size=(3, 64, 64)).astype(np.float32) ** 4
    min_prob = 0.015
    kps, sc, m = box_nms_extract(T(prob), 8, min_prob, 0.1, k)
    assert kps.shape == (3, k, 2) and sc.shape == (3, k) and m.shape == (3, k)
    for b in range(3):
        jk, js, jm = jx_box_nms_extract(jnp.asarray(prob[b]), 8, min_prob,
                                        0.1, k)
        assert _kp_set(kps[b].numpy(), m[b].numpy()) == _kp_set(jk, jm)
        np.testing.assert_array_equal(np.sort(sc[b].numpy()),
                                      np.sort(np.asarray(js)))
        assert int(m[b].sum()) == int(np.asarray(jm).sum())


def test_prob_from_logits_and_depth_to_space():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 6, 65)).astype(np.float32) * 3
    np.testing.assert_allclose(prob_from_logits(T(logits), 8).numpy(),
                               np.asarray(jx_prob(jnp.asarray(logits), 8)),
                               atol=1e-7, rtol=1e-6)
    # several output channels: (i, j, c) order with c minor
    x = rng.normal(size=(2, 3, 5, 4 * 4 * 3)).astype(np.float32)
    np.testing.assert_array_equal(depth_to_space(T(x), 4).numpy(),
                                  np.asarray(jx_d2s(jnp.asarray(x), 4)))


@pytest.mark.parametrize("shape", [(2, 16, 24), (2, 16, 8, 3)])
def test_space_to_depth(shape):
    """(i, j, c) channel order with c minor, single- and multi-channel, and
    the inverse of depth_to_space."""
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    out = space_to_depth(T(x), 8)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jx_s2d(jnp.asarray(x), 8)))
    back = depth_to_space(out, 8)
    assert torch.equal(back.reshape(x.shape), T(x))


def test_interpolate_descriptors():
    rng = np.random.default_rng(2)
    desc = rng.normal(size=(2, 8, 12, 16)).astype(np.float32)
    kps = np.stack([rng.integers(0, 64, size=(2, 40)),
                    rng.integers(0, 96, size=(2, 40))], -1).astype(np.float32)
    kps[:, :3] = [[0, 0], [63, 95], [7.5, 12.25]]
    out = interpolate_descriptors(T(kps), T(desc), (64, 96)).numpy()
    for b in range(2):
        ref = np.asarray(jx_interp(jnp.asarray(kps[b]), jnp.asarray(desc[b]),
                                   (64, 96)))
        # fp32: XLA fuses the bilinear blend with another rounding order
        np.testing.assert_allclose(out[b], ref, atol=1e-5)


def test_mnn_match():
    rng = np.random.default_rng(4)
    d1 = rng.normal(size=(2, 50, 32)).astype(np.float32)
    d2 = np.concatenate([d1[:, :30] + 0.1 * rng.normal(size=(2, 30, 32)),
                         rng.normal(size=(2, 30, 32))], 1).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    m1 = rng.uniform(size=(2, 50)) > 0.2
    m2 = rng.uniform(size=(2, 60)) > 0.2
    for thr in (None, 0.5):
        idx, dist, matched = mnn_match(T(d1), T(d2), T(m1), T(m2), thr)
        for b in range(2):
            ji, jd, jm = jx_mnn(jnp.asarray(d1[b]), jnp.asarray(d2[b]),
                                jnp.asarray(m1[b]), jnp.asarray(m2[b]), thr)
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(matched[b].numpy(), np.asarray(jm))
            np.testing.assert_allclose(dist[b].numpy(), np.asarray(jd),
                                       atol=1e-5)
