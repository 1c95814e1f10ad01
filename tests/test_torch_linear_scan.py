"""The linear recurrence h_t = a_t h_{t-1} + b_t of the PyTorch port and the
general selective scan built on it, against the JAX package: the plain
version against the Pallas kernel in interpret mode (forward and the
reversed, shifted form of its VJP), the autograd Function against jax.grad,
and ``selective_scan`` for N = 1 and N > 1 against the ``'pallas'`` and
``'ref'`` backends. fp32 on the CPU, inputs from numpy seeds."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.ops.selective_scan import \
    flops_selective_scan as jx_flops_selective_scan
from xpoint_tpu.ops.selective_scan import selective_scan as jx_selective_scan
from xpoint_tpu.ops.selective_scan_pallas import _scan_lm
from xpoint_tpu.ops.selective_scan_pallas import linear_scan as jx_linear_scan

from xpoint_tpu_torch.ops.linear_scan import (linear_scan,
                                              linear_scan_launch,
                                              linear_scan_plain)
from xpoint_tpu_torch.ops.selective_scan import (_selective_scan_unfused,
                                                 flops_selective_scan,
                                                 selective_scan,
                                                 selective_scan_fused,
                                                 selective_scan_ref)

T = torch.from_numpy


def _planes(seed, L, M):
    """a in (0, 1] as exp(delta A) gives, b of either sign."""
    rng = np.random.default_rng(seed)
    a = np.exp(-rng.uniform(0.0, 1.5, size=(L, M))).astype(np.float32)
    a[0, 0] = 1.0
    return a, rng.normal(size=(L, M)).astype(np.float32)


@pytest.mark.parametrize("L", [1, 7, 256, 300])
def test_linear_scan_plain_matches_pallas_interpret(L):
    """Forward, at L below, at and off the Pallas chunk (256), M = 37 off
    its lane block: the sequential fp32 recurrence against the in-chunk
    Hillis-Steele scan, rtol 1e-5 (atol 1e-6 where h passes near 0)."""
    a, b = _planes(L, L, 37)
    before = linear_scan.launches
    got = linear_scan_launch(T(a), T(b))
    assert linear_scan.launches == before      # a CPU tensor never launches
    assert got.dtype == torch.float32 and got.shape == (L, 37)
    assert torch.equal(got, linear_scan_plain(T(a), T(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(_scan_lm(
        jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("L", [1, 7, 256, 300])
def test_linear_scan_reversed_shifted_matches_jax_vjp_form(L):
    """reverse=True, shift=1 equals what _linear_scan_bwd composes from
    flips and a shifted copy: dh_t = g_t + a_{t+1} dh_{t+1}, a_L := 1.
    rtol 1e-5 / atol 1e-6."""
    a, g = _planes(L + 1, L, 37)
    ja, jg = jnp.asarray(a), jnp.asarray(g)
    a_next = jnp.concatenate([ja[1:], jnp.ones_like(ja[:1])], axis=0)
    want = jnp.flip(_scan_lm(jnp.flip(a_next, 0), jnp.flip(jg, 0)), 0)
    got = linear_scan_plain(T(a), T(g), reverse=True, shift=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("L", [1, 7, 300])
def test_linear_scan_reverse_is_the_flipped_scan(L):
    """reverse=True alone is the forward scan of the flipped planes,
    flipped back: bit for bit, the same operations in the same order."""
    a, b = _planes(L + 2, L, 11)
    got = linear_scan_plain(T(a), T(b), reverse=True)
    want = linear_scan_plain(T(a).flip(0), T(b).flip(0)).flip(0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dim", [1, 2, -1])
def test_linear_scan_along_an_inner_dim(dim):
    """``dim`` scans (B, K, L, Dim)-like planes where they lie: equal to
    moving the axis to the front, scanning and moving it back."""
    rng = np.random.default_rng(3)
    a = np.exp(-rng.uniform(0, 1, size=(3, 9, 5))).astype(np.float32)
    b = rng.normal(size=(3, 9, 5)).astype(np.float32)
    got = linear_scan(T(a), T(b), dim=dim)
    front = lambda x: T(x).movedim(dim, 0).contiguous()  # noqa: E731
    want = linear_scan_plain(front(a), front(b)).movedim(0, dim)
    assert torch.equal(got, want)


@pytest.mark.parametrize("L", [1, 7, 300])
def test_linear_scan_gradients_match_jax(L):
    """LinearScan's backward (the reversed, shifted scan and dh * h_prev)
    against jax.grad of linear_scan through its custom VJP, rtol 1e-5 of
    each gradient's max."""
    a, b = _planes(L + 5, L, 19)
    w = np.random.default_rng(L).normal(size=(L, 19)).astype(np.float32)
    ja, jb = jax.grad(lambda a_, b_: (jx_linear_scan(a_, b_) * w).sum(),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    (linear_scan(ta, tb) * T(w)).sum().backward()
    for mine, theirs in ((ta.grad, ja), (tb.grad, jb)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max() + 1e-7)
    assert float(ta.grad[0].abs().max()) == 0.0        # h_{-1} = 0


@pytest.mark.parametrize("shape,dim", [((6, 4), 0), ((1, 3), 0),
                                       ((2, 5, 3), 1)])
def test_linear_scan_gradcheck_fp64(shape, dim):
    g = torch.Generator().manual_seed(0)
    a = torch.rand(shape, generator=g, dtype=torch.float64).requires_grad_()
    b = torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a_, b_: linear_scan(a_, b_, dim=dim), (a, b))


def test_linear_scan_bf16_operands_are_read_as_fp32():
    """bf16 planes: the result is the fp32 scan of the rounded operands,
    and the gradients come back in bf16."""
    a, b = _planes(9, 40, 8)
    ta, tb = T(a).bfloat16(), T(b).bfloat16()
    got = linear_scan_launch(ta, tb)
    assert got.dtype == torch.float32
    assert torch.equal(got, linear_scan_plain(ta.float(), tb.float()))
    ta.requires_grad_(), tb.requires_grad_()
    linear_scan(ta, tb).sum().backward()
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16


def test_linear_scan_long_decay():
    """A long sequence with strong decay (the products of a underflow to 0
    in fp32): finite, and equal to JAX's kernel at the rows where its chunk
    carry enters, rtol 1e-5 / atol 1e-5 as the JAX ring-scan test has it."""
    rng = np.random.default_rng(2)
    L, M = 2048, 4
    a = rng.uniform(0.0, 0.2, size=(L, M)).astype(np.float32)
    a[:, 0] = 0.0
    b = rng.normal(size=(L, M)).astype(np.float32)
    ta, tb = T(a).requires_grad_(), T(b).requires_grad_()
    h = linear_scan(ta, tb)
    h.sum().backward()
    assert bool(torch.isfinite(h).all())
    assert bool(torch.isfinite(ta.grad).all() and torch.isfinite(tb.grad).all())
    ref = np.asarray(jx_linear_scan(jnp.asarray(a), jnp.asarray(b)))
    for i in range(0, L, 256):
        np.testing.assert_allclose(h.detach().numpy()[i], ref[i], rtol=1e-5,
                                   atol=1e-5)


def test_linear_scan_checks_its_operands():
    a, b = (T(x) for x in _planes(0, 4, 6))
    with pytest.raises(ValueError, match="share"):
        linear_scan_launch(a, b[:, :3])
    with pytest.raises(ValueError, match="share"):
        linear_scan_launch(a, b.bfloat16())
    with pytest.raises(TypeError):
        linear_scan_launch(a.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        linear_scan_launch(a.t(), b.t())
    with pytest.raises(ValueError, match="dim"):
        linear_scan_launch(a, b, dim=2)
    # the differentiable entry makes its operands contiguous itself
    assert torch.equal(linear_scan(a.t(), b.t()),
                       linear_scan_plain(a.t().contiguous(),
                                         b.t().contiguous()))


def _scan_args(seed, N, with_D, with_bias, B=2, K=4, C=6, L=40):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    KC = K * C
    return dict(u=f(B, KC, L) * 0.5, delta=f(B, KC, L) * 0.5,
                A=-np.exp(f(KC, N) * 0.3), Bmat=f(B, K, N, L) * 0.5,
                Cmat=f(B, K, N, L) * 0.5, D=f(KC) if with_D else None,
                delta_bias=f(KC) * 0.2 if with_bias else None)


_ORDER = ("u", "delta", "A", "Bmat", "Cmat", "D", "delta_bias")


def _jax_scan(o, softplus, backend):
    return jx_selective_scan(*(None if o[k] is None else jnp.asarray(o[k])
                               for k in _ORDER), softplus, backend=backend)


@pytest.mark.parametrize("backend", ["pallas", "ref"])
@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("with_D,with_bias", [(True, True), (False, False)])
@pytest.mark.parametrize("N", [1, 4])
def test_selective_scan_matches_jax(N, with_D, with_bias, softplus, backend):
    """The dispatching entry against JAX's: N = 1 with softplus takes the
    fused single-direction scan, everything else the composition around
    linear_scan. fp32 (B, K*C, L) output, rtol 1e-4 / atol 1e-5."""
    o = _scan_args(N, N, with_D, with_bias)
    got = selective_scan(*(None if o[k] is None else T(o[k])
                           for k in _ORDER), softplus)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 40)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_jax_scan(o, softplus, backend)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("N", [1, 4])
def test_selective_scan_ref_matches_jax_ref(N, softplus):
    """The step-by-step oracle against JAX's lax.scan oracle, and the
    composition around linear_scan against both. rtol 1e-4 / atol 1e-5."""
    o = _scan_args(10 + N, N, True, True)
    args = [T(o[k]) for k in _ORDER]
    want = np.asarray(_jax_scan(o, softplus, "ref"))
    for fn in (selective_scan_ref, _selective_scan_unfused):
        np.testing.assert_allclose(fn(*args, softplus).numpy(), want,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("with_D,with_bias", [(True, True), (False, False)])
@pytest.mark.parametrize("N", [1, 4])
def test_selective_scan_gradients_match_jax(N, with_D, with_bias, softplus):
    """Every operand's gradient of a weighted sum against jax.grad through
    the 'pallas' backend (its custom VJPs run the Pallas recurrence
    reversed), 1e-4 of each gradient's max."""
    o = _scan_args(20 + N, N, with_D, with_bias)
    keys = [k for k in _ORDER if o[k] is not None]
    w = np.random.default_rng(5).normal(size=(2, 24, 40)).astype(np.float32)

    def jf(*xs):
        full = dict(zip(keys, xs))
        return (jx_selective_scan(*(full.get(k) for k in _ORDER), softplus,
                                  backend="pallas") * w).sum()
    want = jax.grad(jf, argnums=tuple(range(len(keys))))(
        *(jnp.asarray(o[k]) for k in keys))
    ts = {k: T(o[k]).requires_grad_() for k in keys}
    (selective_scan(*(ts.get(k) for k in _ORDER), softplus)
     * T(w)).sum().backward()
    for k, theirs in zip(keys, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ts[k].grad.numpy(), theirs, rtol=0,
                                   atol=1e-4 * np.abs(theirs).max(),
                                   err_msg=k)


def test_selective_scan_fused_takes_mixed_and_bf16_operands():
    """bf16 u / delta / B / C: the fused route's bf16 output, returned as
    fp32, within one bf16 ulp of the fp32 oracle on the rounded operands
    (2^-7 relative, 1e-2 absolute); N > 1 is refused by the fused entry."""
    o = _scan_args(30, 1, True, True)
    args = [T(o[k]) for k in _ORDER]
    low = [x.bfloat16() if i in (0, 1, 3, 4) else x
           for i, x in enumerate(args)]
    got = selective_scan(*low)
    want = selective_scan_ref(*(x.float() for x in low))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-2)
    mixed = selective_scan(args[0], low[1], *args[2:])
    torch.testing.assert_close(mixed, selective_scan_ref(
        args[0], low[1].float(), *args[2:]), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="N = 1"):
        selective_scan_fused(*(T(v) for v in list(_scan_args(
            31, 2, True, True).values())))


def test_flops_selective_scan_is_the_jax_count():
    for kw in ({}, {"B": 2, "L": 64, "D": 96, "N": 4, "with_D": False}):
        assert flops_selective_scan(**kw) == jx_flops_selective_scan(**kw)
