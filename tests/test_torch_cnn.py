"""Parity of the port's CNN XPoint models (the full cycle's: the CNN
encoder, two spectrum encoders, per-spectrum BatchNorm) with the flax
ones, the bridge and the initialiser. fp32 on the CPU, TF32
off; the same flax weights go through the bridge into both sides, and the
inputs are made from a seed with numpy."""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models.heads import SpectralBatchNorm as JxSpectralBN

from xpoint_tpu_torch.compat.from_flax import (_flatten, load_flax_variables,
                                               to_flax)
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.models.heads import SpectralBatchNorm

from test_torch_models import _perturb
from torch_env import torch_env  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T = torch.from_numpy

def cnn_cfg(**kw):
    """A narrow CNN model (channel version 2: 8-16-32-64, descriptor 16)
    with two encoders and per-spectrum statistics unless ``kw`` says
    otherwise."""
    cfg = {"multispectral": True, "spectral_norm_stats": True,
           "channel_version": 2, "descriptor_size": 16,
           "homography_regression_head": {"check": False}}
    cfg.update(kw)
    return cfg


def jax_cnn(cfg, seed=0, hw=(32, 32)):
    """The flax model and its variables: params perturbed, every running
    statistic moved off its 0 / 1 start (per slot, so the two spectra's
    differ). Cached: callers do not modify them."""
    key = (json.dumps(cfg, sort_keys=True), seed, hw)
    if key not in _JAX_MODELS:
        _JAX_MODELS[key] = _jax_cnn(cfg, seed, hw)
    return _JAX_MODELS[key]


_JAX_MODELS = {}


def _jax_cnn(cfg, seed, hw):
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, *hw, 1), jnp.float32),
                                  method=jm.init_all))(
                                      jax.random.PRNGKey(seed))
    v = _perturb(v, seed + 10, scale=0.05)
    rng = np.random.default_rng(seed + 20)
    v["batch_stats"] = jax.tree.map(
        lambda s: (np.asarray(s) * rng.uniform(0.5, 1.5, s.shape)
                   + 0.1 * rng.normal(size=s.shape)).astype(np.float32),
        v["batch_stats"])
    return jm, v


def port_cnn(cfg, v):
    tm, _ = build_xpoint(cfg, device="cpu")
    return load_flax_variables(tm, v)


def _leaves(tree):
    return {"/".join(p): np.asarray(x) for p, x in _flatten(tree)}


def _assert_trees_close(mine, theirs, rel, what, floor=0.0):
    """Leaf by leaf: |mine - theirs| <= rel * max|theirs leaf| + floor *
    max|theirs| over all leaves (+ 1e-12)."""
    a, b = _leaves(mine), _leaves(theirs)
    assert set(a) == set(b), (what, set(a) ^ set(b))
    top = max(float(np.abs(x).max()) for x in b.values())
    for k in b:
        tol = rel * float(np.abs(b[k]).max()) + floor * top + 1e-12
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol,
                                   err_msg=f"{what}: {k}")


def _rel_tol(train):
    """Forward tolerance relative to max |ref| (see
    test_cnn_forward_matches_flax)."""
    return 5e-4 if train else 1e-5


def _images(seed, B=3, hw=(32, 40)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, *hw, 1)).astype(np.float32),
            np.arange(B) % 2 == 0)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("spectrum", ["optical", "thermal", "mixed"])
def test_spectral_batchnorm_matches_flax(spectrum, train):
    """SpectralBatchNorm alone: output and input gradient (rtol 1e-5), and
    in train mode the updated slots (the spectrum's own, both for 'mixed';
    variance mean((x - mean)^2)); in eval mode 'mixed' normalises with the
    mixture statistics 0.5 (v_o + v_t) + 0.25 (m_o - m_t)^2."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 5, 4, 6)) * 2 + 3).astype(np.float32)
    jm = JxSpectralBN()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": rng.normal(size=6).astype(np.float32),
                    "bias": rng.normal(size=6).astype(np.float32)},
         "batch_stats": {k: (rng.normal(size=6) if k.startswith("mean")
                             else rng.uniform(0.5, 2, 6)).astype(np.float32)
                         for k in v["batch_stats"]}}
    w = rng.normal(size=x.shape).astype(np.float32)

    def jf(xx):
        y, mut = jm.apply(v, xx, spectrum, train, mutable=["batch_stats"])
        return (y * w).sum(), (y, mut)
    (_, (jy, jmut)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    tm = load_flax_variables(SpectralBatchNorm(6), v).train(train)
    tx = T(x).requires_grad_()
    ty = tm(tx, spectrum)
    (ty * T(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    stats = to_flax(tm)["batch_stats"]
    for k, want in jmut["batch_stats"].items():
        np.testing.assert_allclose(stats[k], np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    moved = {k for k in stats if not np.array_equal(stats[k],
                                                    v["batch_stats"][k])}
    slots = ({"optical", "thermal"} if spectrum == "mixed" else {spectrum})
    assert moved == ({f"{m}_{s}" for m in ("mean", "var") for s in slots}
                     if train else set())


@pytest.mark.parametrize("spectrum", ["optical", "thermal", "mixed"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("spectral", [True, False],
                         ids=["spectral_stats", "plain_bn"])
@pytest.mark.parametrize("multispectral", [True, False],
                         ids=["two_encoders", "shared"])
def test_cnn_forward_matches_flax(multispectral, spectral, train, spectrum):
    """The CNN XPointNet (channel version 2, descriptor 16) through the
    bridge on a 32 x 40 batch of three (is_optical alternating for
    'mixed'): logits, descriptors and encoder output within 1e-5 of their
    max |ref| in eval mode and 5e-4 in train mode (ten train-mode
    BatchNorms in a row, each dividing by a deviation of this small batch
    summed in another order; measured worst 1.8e-4), and in train mode
    every running statistic after the one forward within 1e-5 of its
    leaf's max + 1e-6.""" 
    cfg = cnn_cfg(multispectral=multispectral, spectral_norm_stats=spectral)
    jm, v = jax_cnn(cfg, seed=1)
    img, is_optical = _images(2)
    args = (jnp.asarray(img), spectrum, jnp.asarray(is_optical), train)
    if train:
        ref, mut = jm.apply(v, *args, mutable=["batch_stats"])
    else:
        ref, mut = jm.apply(v, *args), v
    tm = port_cnn(cfg, v).train(train)
    with torch.no_grad():
        out = tm(T(img), spectrum, T(is_optical))
    assert set(out) == set(ref)
    for k in out:
        r = np.asarray(ref[k])
        assert out[k].dtype == torch.float32 and out[k].shape == r.shape
        np.testing.assert_allclose(out[k].numpy(), r, rtol=0,
                                   atol=_rel_tol(train) * np.abs(r).max(),
                                   err_msg=k)
    _assert_trees_close(to_flax(tm)["batch_stats"], mut["batch_stats"],
                        1e-5, "batch_stats", floor=1e-6)


@pytest.mark.parametrize("case", [
    {"channel_version": 0}, {"channel_version": 1},
    {"bn_first": True}, {"reflection_pad": False},
    {"final_batchnorm": False}, {"double_convolution": False},
    {"descriptor_head": False},
    {"normalize_descriptors": False, "multispectral": False}],
    ids=["channels_v0", "channels_v1", "bn_first", "zero_pad",
         "no_final_bn", "single_conv", "no_descriptor_head",
         "unnormalized_shared"])
def test_cnn_options_match_flax(case):
    """Each option of the CNN model against flax, eval and train mode,
    'mixed' routing, tolerances as test_cnn_forward_matches_flax; channel
    versions 0 (64-64-128-128, head 256) and 1 (32-64-96-128, head =
    descriptor size) at their full widths."""
    cfg = cnn_cfg(**case)
    jm, v = jax_cnn(cfg, seed=3)
    img, is_optical = _images(4)
    tm = port_cnn(cfg, v)
    assert ("desc" in tm(T(img))) == cfg.get("descriptor_head", True)
    for train in (False, True):
        ref = jm.apply(v, jnp.asarray(img), "mixed", jnp.asarray(is_optical),
                       train, mutable=["batch_stats"] if train else False)
        ref = ref[0] if train else ref
        tm.train(train)
        with torch.no_grad():
            out = tm(T(img), "mixed", T(is_optical))
        load_flax_variables(tm, v)          # undo the train-mode update
        assert set(out) == set(ref)
        for k in out:
            r = np.asarray(ref[k])
            np.testing.assert_allclose(out[k].numpy(), r, rtol=0,
                                       atol=_rel_tol(train) * np.abs(r).max(),
                                       err_msg=f"train={train} {k}")


def test_bridge_carries_two_encoders_and_spectral_stats():
    """flax -> torch -> flax is the identity on the two-encoder model with
    per-spectrum statistics: every leaf, both encoder subtrees and the four
    statistics of each SpectralBatchNorm."""
    cfg = cnn_cfg()
    _, v = jax_cnn(cfg, seed=13)
    back = to_flax(port_cnn(cfg, v))
    a, b = _leaves(back), _leaves(v)
    assert set(a) == set(b)
    assert any(k.startswith("params/encoder_thermal/") for k in a)
    assert any(k.endswith("SpectralBatchNorm_0/var_thermal") for k in a)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_init_matches_flax_defaults():
    """The seeded initialiser gives the flax defaults' constants: every
    bias 0, every BatchNorm scale 1, all four statistics of each
    SpectralBatchNorm 0 / 1; conv kernels lecun_normal (std sqrt(1 /
    fan_in) within 10%)."""
    tm, _ = build_xpoint(cnn_cfg(channel_version=0), device="cpu", seed=0)
    jm, _ = jx_build_xpoint(cnn_cfg(channel_version=0), dtype=jnp.float32)
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
                 method=jm.init_all)
    mine = to_flax(tm)
    a, b = _leaves(mine), _leaves(jv)
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape, k
        if k.endswith(("bias", "mean_optical", "mean_thermal", "scale",
                       "var_optical", "var_thermal")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif k.endswith("kernel"):
            fan_in = np.prod(b[k].shape[:-1])
            assert abs(a[k].std() * np.sqrt(fan_in) - 1) < 0.1, k
