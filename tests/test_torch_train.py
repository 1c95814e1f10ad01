"""Parity of the PyTorch port's training path with the JAX package's:
train-mode BatchNorm, RegNet, the stochastic layers, Adam, and one whole
train step of the tiny model through both ``make_train_step``s. fp32 on the
CPU; the same flax weights go through the bridge into both sides."""
import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
import torch

from xpoint_tpu.config import load_yaml
from xpoint_tpu.losses.xpoint_loss import XPointLoss as JxXPointLoss
from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.models.regnet import RegNet as JxRegNet
from xpoint_tpu.parallel.train_step import TrainState as JxTrainState
from xpoint_tpu.parallel.train_step import \
    make_eval_step as jx_make_eval_step
from xpoint_tpu.parallel.train_step import \
    make_train_step as jx_make_train_step
from xpoint_tpu.trainer import make_optimizer as jx_make_optimizer

from xpoint_tpu_torch.compat.from_flax import (_flatten, load_flax_variables,
                                               state_dict_to_flax, to_flax)
from xpoint_tpu_torch.losses import XPointLoss
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG, build_xpoint
from xpoint_tpu_torch.models.heads import BatchNorm
from xpoint_tpu_torch.models.regnet import RegNet
from xpoint_tpu_torch.models.vssm import VSSM, DropPath, dropout
from xpoint_tpu_torch.train import (TrainState, make_eval_step,
                                    make_optimizer, make_train_step)

from test_torch_models import _perturb, tiny_cfg
from torch_env import torch_env  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree):
    return {"/".join(p): np.asarray(v) for p, v in _flatten(tree)}


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


def test_flagship_train_config_is_the_yaml():
    """VMAMBA_TRAIN_CFG is configs/xpoint_vmamba.yaml with the pretrained
    encoder block off (its weights are not in the repository)."""
    ref = load_yaml(os.path.join(ROOT, "configs", "xpoint_vmamba.yaml"))
    ref["model"]["use_attention"]["pretrained"] = {"check": False}
    # YAML 1.1 reads "1e-4" as a string; the JAX trainer float()s it
    ref["training"]["learningrate"] = float(ref["training"]["learningrate"])
    assert VMAMBA_TRAIN_CFG == ref


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(train):
    """Normalised output, its input gradient and (train) the updated
    running statistics: biased variance for both, running <- 0.9 running +
    0.1 batch. rtol 1e-5."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 4, 6)) * 2 + 1).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": rng.normal(size=6).astype(np.float32),
                    "bias": rng.normal(size=6).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=6).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 6).astype(np.float32)}}
    w = rng.normal(size=x.shape).astype(np.float32)

    def jf(xx):
        y, mut = jm.apply(v, xx, mutable=["batch_stats"])
        return (y * w).sum(), (y, mut)
    (_, (jy, jmut)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    tm = load_flax_variables(BatchNorm(6), v).train(train)
    tx = T(x).requires_grad_()
    ty = tm(tx)
    (ty * T(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    stats = to_flax(tm)["batch_stats"]
    want = jmut["batch_stats"] if train else v["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("hw", [32, 64, 16, 48])
def test_regnet_matches_flax(hw):
    """RegNet in eval mode on (N, hw, hw, 12) encoder outputs: 32^2 -> 16^2
    after the pool (to_16's identity), 64^2 (block mean), 16^2 and 48^2
    (the antialiased linear resize, up and down). Output within 1e-5 and
    the parameter and input gradients of a scalar within 1e-4 of each
    leaf's max."""
    rng = np.random.default_rng(hw)
    x1, x2 = (rng.normal(size=(2, hw, hw, 12)).astype(np.float32)
              for _ in range(2))
    jm = JxRegNet()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2))
    v = _perturb(v, hw, scale=0.05)
    v["batch_stats"] = jax.tree.map(
        lambda s: np.asarray(s) + rng.uniform(0.1, 0.5, s.shape).astype(
            np.float32), v["batch_stats"])
    w = rng.normal(size=(2, 8)).astype(np.float32)

    def jf(params, a, b):
        return (jm.apply({**v, "params": params}, a, b) * w).sum()
    jy = jm.apply(v, jnp.asarray(x1), jnp.asarray(x2))
    jgp, jg1, jg2 = jax.grad(jf, argnums=(0, 1, 2))(
        v["params"], jnp.asarray(x1), jnp.asarray(x2))
    tm = load_flax_variables(RegNet(12), v).eval()
    a, b = T(x1).requires_grad_(), T(x2).requires_grad_()
    ty = tm(a, b)
    (ty * T(w)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    grads = state_dict_to_flax({n: p.grad for n, p in
                                tm.named_parameters()})["params"]
    _assert_trees_close(grads, jgp, 1e-4, "param grads")
    for mine, theirs in ((a.grad, jg1), (b.grad, jg2)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=0,
                                   atol=1e-4 * np.abs(theirs).max())


def test_droppath_and_dropout_statistics():
    """Per-sample masks (DropPath) and per-element masks (Dropout), kept
    with probability 1 - rate (within 4 sigma) and scaled by 1 / keep;
    identity in eval mode; a train-mode draw needs a generator; the same
    seed gives the same mask."""
    x = torch.ones(4000, 3, 2, 5)
    dp = DropPath(0.2).train()
    y = dp(x, torch.Generator().manual_seed(0))
    per_sample = y.reshape(4000, -1)
    assert torch.all(per_sample == per_sample[:, :1])          # one mask
    kept = (per_sample[:, 0] > 0).float()
    assert set(per_sample[:, 0].unique().tolist()) <= {0.0, 1 / 0.8}
    sigma = (0.8 * 0.2 / 4000) ** 0.5
    assert abs(float(kept.mean()) - 0.8) < 4 * sigma
    assert torch.equal(dp(x, torch.Generator().manual_seed(0)), y)
    with pytest.raises(ValueError, match="Generator"):
        dp(x)
    assert dp.eval()(x) is x
    z = dropout(torch.ones(200, 100), 0.5, True,
                torch.Generator().manual_seed(1))
    assert set(z.unique().tolist()) <= {0.0, 2.0}
    assert abs(float((z > 0).float().mean()) - 0.5) < 4 * (0.25 / 2e4) ** .5
    assert (z.reshape(200, 100) > 0).float().mean(1).std() > 0   # per elem
    assert dropout(x, 0.5, False, None) is x


def test_droppath_schedule_is_linear():
    """Block b of n gets rate b * DROP_PATH_RATE / (n - 1), as
    np.linspace in the JAX VSSM."""
    m = VSSM(depths=(2, 2, 2, 2), embed_dim=8, drop_path_rate=0.2)
    rates = [m.get_submodule(f"layers_{i}_blocks_{d}").drop_path.rate
             for i in range(4) for d in range(2)]
    np.testing.assert_allclose(rates, np.linspace(0, 0.2, 8))


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_optax(wd):
    """Three Adam steps on toy tensors: the port's update and moments
    against make_optimizer's optax chain (rtol 1e-6), and the per-epoch
    schedules."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10 ** i
              for k, v in p0.items()} for i in range(-2, 1)]
    cfg = {"learningrate": 3e-3, "weight_decay": wd}
    jtx, _ = jx_make_optimizer(cfg)
    jp, js = p0, jtx.init(p0)
    for g in grads:
        u, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, u)
    tx, lr_at_epoch = make_optimizer(cfg)
    assert lr_at_epoch is None
    params = [T(p0[k].copy()) for k in ("a", "b")]
    opt = tx(params)
    for g in grads:
        for p, k in zip(params, ("a", "b")):
            p.grad = T(g[k])
        opt.step()
    for i, k in enumerate(("a", "b")):
        st = opt.state[params[i]]
        np.testing.assert_allclose(params[i].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(js[-2].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(js[-2].nu[k]), rtol=1e-6)
        assert int(st["step"]) == 3
    for stype in ("StepLR", "ExponentialLR"):
        sc = {"learningrate": 1e-3, "scheduler": {
            "use_scheduler": True, "type": stype, "gamma": 0.5,
            "step_size": 2}}
        mine, theirs = make_optimizer(sc)[1], jx_make_optimizer(sc)[1]
        assert [mine(e) for e in range(5)] == [theirs(e) for e in range(5)]


def _tiny_train_cfg():
    cfg = copy.deepcopy(tiny_cfg())
    cfg["homography_regression_head"] = {"check": False}
    cfg["use_attention"]["model_parameters"]["MODEL"]["DROP_PATH_RATE"] = 0.0
    return cfg


def _pair_batch(seed, B=2, S=64):
    """A pair batch as the JAX step takes it (numpy): keypoints at most one
    per 8x8 cell (the hard tiebreak then decides no diagnostic), the
    thermal side warped by a mild homography with its valid mask."""
    from xpoint_tpu.geometry.homography import (compute_valid_mask,
                                                sample_homography)
    rng = np.random.default_rng(seed)

    def kps():
        kp = np.zeros((B, S, S), np.float32)
        cells = rng.uniform(size=(B, S // 8, S // 8)) < 0.4
        for b, i, j in zip(*np.nonzero(cells)):
            kp[b, 8 * i + rng.integers(8), 8 * j + rng.integers(8)] = 1.0
        return kp
    h = np.stack([sample_homography((S, S), rng=rng, max_angle=0.3,
                                    patch_ratio=0.9)
                  for _ in range(B)]).astype(np.float32)
    vm = np.stack([compute_valid_mask((S, S), hb) for hb in h]).astype(
        np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    img = rng.uniform(size=(B, S, S, 1)).astype(np.float32)
    return {"optical": {"image": img, "keypoints": kps(),
                        "valid_mask": np.ones((B, S, S), np.float32),
                        "homography": eye},
            "thermal": {"image": np.clip(
                img + 0.1 * rng.normal(size=img.shape), 0, 1).astype(
                    np.float32),
                        "keypoints": kps(), "valid_mask": vm,
                        "homography": h}}


def _torch_batch(batch):
    return {k: {kk: T(vv.copy()) for kk, vv in v.items()}
            for k, v in batch.items()}


def _port_state_tree(state):
    """The port's params, BN stats, Adam moments as flax trees."""
    mu = dict(zip(state.names, state.opt_state["mu"]))
    nu = dict(zip(state.names, state.opt_state["nu"]))
    return (to_flax(state.module), state_dict_to_flax(mu)["params"],
            state_dict_to_flax(nu)["params"])


def test_train_step_matches_jax():
    """The tiny model (depths [1,1,1,1], embed 24, descriptor 32, fp32,
    64^2, DropPath 0, no HM head) through JAX's make_train_step (optax Adam
    1e-4, associative scan) and the port's, from the same weights and
    batches, with the flagship loss config.

    After step 1: every loss component within 1e-5 relative (ratios within
    one cell's share of 1/128: a near-tied logit argmax may fall the other
    way), and every gradient leaf by leaf (recovered from Adam's first
    moment, mu = 0.1 g, on both sides) within 1e-4 of the leaf's max |g|
    plus a noise floor of 1e-7 of the largest gradient: fp32 sums in
    another order. The floor covers the leaves whose gradient is zero in
    exact arithmetic (the biases right before a train-mode BatchNorm),
    where both sides hold roundoff of ~5e-10.
    After 3 steps: Adam moments within 1e-3 of each leaf's max (+ the
    floor); BatchNorm statistics within 1e-3 of each leaf's max + 1e-4;
    params within 2e-4 absolute: Adam's first steps divide each gradient
    element by its own magnitude, so an element whose gradient lies within
    roundoff of zero moves by up to lr = 1e-4 a step, with either sign, on
    either side (the update arithmetic itself is held to 1e-6 by
    test_adam_matches_optax). A NaN batch leaves the whole state unchanged
    on both sides."""
    cfg = _tiny_train_cfg()
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(0))
    v = _perturb(v, 21, scale=0.05)
    loss_cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)

    jtx, _ = jx_make_optimizer({"learningrate": 1e-4})
    jstate = JxTrainState.create(v["params"], v["batch_stats"], jtx)
    jstep = jx_make_train_step(jm, JxXPointLoss(loss_cfg), donate=False)

    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, v)
    tstate = TrainState(tm, make_optimizer({"learningrate": 1e-4})[0])
    tstep = make_train_step(tm, XPointLoss(loss_cfg))
    gen = torch.Generator().manual_seed(0)

    batches = [_pair_batch(s) for s in (1, 2, 3)]
    for i, batch in enumerate(batches):
        jstate, jc = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jax.random.PRNGKey(i))
        tc = tstep(tstate, _torch_batch(batch), gen)
        assert float(tc["skipped_nonfinite"]) == 0.0
        if i == 0:
            assert set(tc) == set(jc)
            for k in tc:
                tol = (1.5 / 128 if "ratio" in k
                       else 1e-5 * abs(float(jc[k])) + 1e-6)
                assert abs(float(tc[k]) - float(jc[k])) <= tol, k
            _, mu, _ = _port_state_tree(tstate)
            _assert_trees_close(mu, jstate.opt_state[0].mu, 1e-4,
                                "gradients (mu / 0.1)", floor=1e-7)
    assert tstate.step == int(jstate.step) == 3
    variables, mu, nu = _port_state_tree(tstate)
    a = _leaves(variables["params"])
    b = _leaves(jstate.params)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-4, err_msg=k)
    _assert_trees_close(mu, jstate.opt_state[0].mu, 1e-3, "mu", floor=1e-7)
    _assert_trees_close(nu, jstate.opt_state[0].nu, 1e-3, "nu", floor=1e-7)
    _assert_trees_close(variables["batch_stats"], jstate.batch_stats, 1e-3,
                        "batch_stats", floor=1e-4 / max(
                            float(np.abs(x).max()) for x in
                            _leaves(jstate.batch_stats).values()))

    # a NaN batch: skipped, nothing changes, on both sides
    bad = copy.deepcopy(batches[0])
    bad["optical"]["image"][0, 3, 5, 0] = np.nan
    j_before = jax.tree.map(np.asarray, jstate)
    jstate2, jc = jstep(jstate, jax.tree.map(jnp.asarray, bad),
                        jax.random.PRNGKey(9))
    assert float(jc["skipped_nonfinite"]) == 1.0
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(
        np.asarray, jstate2), j_before)
    t_before = [t.clone() for t in (*tm.state_dict().values(),
                                    *tstate.opt_state["mu"],
                                    *tstate.opt_state["nu"])]
    tc = tstep(tstate, _torch_batch(bad), gen)
    assert float(tc["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(tc["loss"]))
    t_after = [*tm.state_dict().values(), *tstate.opt_state["mu"],
               *tstate.opt_state["nu"]]
    assert all(torch.equal(x, y) for x, y in zip(t_before, t_after))
    assert tstate.step == 3 and tstate.opt_state["count"] == 3


@pytest.mark.parametrize("ftype,d_state", [("v052d_noz", 1), ("v051d", 2)])
def test_train_step_forward_types_match_jax(ftype, d_state):
    """One train step of the tiny model in the bidi forward type (the fused
    single-direction scan, its gradient through the linear recurrence) and
    in the gated unidi type with d_state 2 (the general scan), JAX on the
    Pallas backend with its custom VJPs: loss components within 1e-5
    relative and every gradient leaf (Adam's first moment, mu = 0.1 g)
    within 1e-4 of the leaf's max + 1e-7 of the largest, as
    test_train_step_matches_jax holds the flagship type."""
    cfg = _tiny_train_cfg()
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        SSM_FORWARDTYPE=ftype, SSM_D_STATE=d_state)
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="pallas")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(0))
    v = _perturb(v, 22, scale=0.05)
    loss_cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)
    jtx, _ = jx_make_optimizer({"learningrate": 1e-4})
    jstate = JxTrainState.create(v["params"], v["batch_stats"], jtx)
    jstep = jx_make_train_step(jm, JxXPointLoss(loss_cfg), donate=False)
    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, v)
    tstate = TrainState(tm, make_optimizer({"learningrate": 1e-4})[0])
    tstep = make_train_step(tm, XPointLoss(loss_cfg))
    batch = _pair_batch(4)
    jstate, jc = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                       jax.random.PRNGKey(0))
    tc = tstep(tstate, _torch_batch(batch), torch.Generator().manual_seed(0))
    assert float(tc["skipped_nonfinite"]) == 0.0 and set(tc) == set(jc)
    for k in tc:
        tol = 1.5 / 128 if "ratio" in k else 1e-5 * abs(float(jc[k])) + 1e-6
        assert abs(float(tc[k]) - float(jc[k])) <= tol, k
    _, mu, _ = _port_state_tree(tstate)
    _assert_trees_close(mu, jstate.opt_state[0].mu, 1e-4,
                        "gradients (mu / 0.1)", floor=1e-7)


def test_flagship_model_trains_a_step_on_cpu():
    """The flagship structure (RegNet, HM loss, DropPath, bf16) at a tiny
    width: a device-batch step runs, RegNet and every encoder block get a
    finite gradient, and encoder_output is detached."""
    cfg = copy.deepcopy(VMAMBA_TRAIN_CFG)
    cfg["model"]["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24)
    cfg["model"]["descriptor_size"] = 32
    tm, _ = build_xpoint(cfg["model"], device="cpu")
    assert tm.encoder.dtype == torch.bfloat16
    assert tm.encoder.layers_3_blocks_0.drop_path.rate == pytest.approx(0.2)
    tm.train()
    batch = _torch_batch(_pair_batch(5))
    batch["hfour_points"] = torch.randn(2, 4, 2) * 8
    gen = torch.Generator().manual_seed(0)
    pred_o, pred_t, pred_hm = tm.forward_pair(batch["optical"]["image"],
                                              batch["thermal"]["image"], gen)
    assert not pred_o["encoder_output"].requires_grad
    loss, comps = XPointLoss(dict(cfg["loss"], space_to_depth_ratio=8))(
        batch, pred_o, pred_t, pred_hm, gen)
    assert "homography_regression_loss" in comps
    loss.backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.startswith(("hm_regressor.conv", "hm_regressor.fc")):
            assert p.grad.abs().max() > 0, name


def test_eval_step_matches_jax():
    """make_eval_step: eval-mode forward pair (running BatchNorm statistics,
    perturbed away from 0/1) and the loss, against JAX's, rtol 1e-5; the
    RegNet head (with its Dropout off in eval) included."""
    cfg = copy.deepcopy(tiny_cfg())
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(1))
    v = _perturb(v, 31, scale=0.05)
    rng = np.random.default_rng(32)
    v["batch_stats"] = jax.tree.map(
        lambda s: np.asarray(s) + rng.uniform(0.05, 0.2, s.shape).astype(
            np.float32), v["batch_stats"])
    loss_cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)
    batch = _pair_batch(7)
    batch["hfour_points"] = rng.normal(size=(2, 4, 2)).astype(np.float32) * 8
    jstate = JxTrainState.create(v["params"], v["batch_stats"],
                                 jx_make_optimizer({})[0])
    jl, jc = jax.jit(jx_make_eval_step(jm, JxXPointLoss(loss_cfg)))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tm, _ = build_xpoint(cfg, device="cpu")
    load_flax_variables(tm, v)
    tstate = TrainState(tm, make_optimizer({})[0])
    tb = _torch_batch({k: v for k, v in batch.items() if k != "hfour_points"})
    tb["hfour_points"] = T(batch["hfour_points"])
    tl, tc = make_eval_step(tm, XPointLoss(loss_cfg))(tstate, tb)
    assert not tm.training
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert "homography_regression_loss" in tc and set(tc) == set(jc)
    for k in tc:
        tol = 1.5 / 128 if "ratio" in k else 1e-5 * abs(float(jc[k])) + 1e-6
        assert abs(float(tc[k]) - float(jc[k])) <= tol, k


def _no_dropout(monkeypatch):
    """Dropout as the identity on both sides: its masks come from random
    streams that cannot match (test_droppath_and_dropout_statistics holds
    the port's to flax's statistics)."""
    from xpoint_tpu_torch.models import homographynet, regnet
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    for mod in (homographynet, regnet):
        monkeypatch.setattr(mod, "dropout", lambda x, *args: x)


def _cnn_homographynet_cfg():
    return {"multispectral": False, "descriptor_size": 32,
            "channel_version": 2, "takes_pair": True,
            "homography_regression_head": {"check": True,
                                           "type": "HomographyNet"}}


def _hm_batch(seed, S=64):
    """A pair batch with the hm target, optical_not_warped true for the
    first sample and false for the second: its optical homography is not
    the identity either, so HomographyNet takes its thermal map first."""
    batch = _pair_batch(seed, S=S)
    batch["optical"]["homography"][1] = batch["thermal"]["homography"][1]
    batch["hfour_points"] = np.random.default_rng(seed).normal(
        size=(2, 4, 2)).astype(np.float32) * 8
    return batch


@pytest.mark.parametrize("model", ["swin_regnet", "vmamba_homographynet"])
def test_train_step_hm_heads_match_jax(model, monkeypatch):
    """One train step of the tiny Swin XPoint with RegNet (configs/cmt.yaml
    at depths [2, 2], embed 24, window 4; DropPath 0; 32^2, 16 x 16 cells)
    and of the tiny VMamba XPoint with HomographyNet (64^2), the flagship
    loss with the HM loss, Dropout the identity on both sides,
    optical_not_warped true and false in one batch: loss components within 1e-5
    relative and every gradient leaf (Adam's first moment, mu = 0.1 g)
    within 1e-4 of the leaf's max + 1e-7 of the largest, as
    test_train_step_matches_jax; the BatchNorm statistics the step updates
    within 1e-5 of each leaf's max.

    The encoders here are smooth (GELU, SiLU): in a ReLU network a
    pre-activation within fp32 roundoff of zero takes the other side of
    the ReLU in the other framework and moves whole gradient leaves (the
    CNN encoder of test_unported_heads_raise: 17% of a leaf's max from a
    7e-5 difference in one layer's input), and the more cells a head
    sees, the likelier such a pre-activation is; the CNN with
    HomographyNet is held by that eval-step test."""
    from test_torch_swinv2 import swin_cfg
    _no_dropout(monkeypatch)
    S = 64
    if model == "swin_regnet":
        cfg = swin_cfg()
        cfg["use_attention"]["model_parameters"]["MODEL"][
            "DROP_PATH_RATE"] = 0.0
        S = 32
    else:
        cfg = _tiny_train_cfg()
        cfg["homography_regression_head"] = {"check": True,
                                             "type": "HomographyNet"}
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(0))
    v = _perturb(v, 23, scale=0.05)
    ratio = jm.encoder_downsample_ratio
    loss_cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=ratio)
    jtx, _ = jx_make_optimizer({"learningrate": 1e-4})
    jstate = JxTrainState.create(v["params"], v["batch_stats"], jtx)
    jstep = jx_make_train_step(jm, JxXPointLoss(loss_cfg), donate=False)
    tm, _ = build_xpoint(cfg, device="cpu")
    assert tm.encoder_downsample_ratio == ratio
    load_flax_variables(tm, v)
    tstate = TrainState(tm, make_optimizer({"learningrate": 1e-4})[0])
    tstep = make_train_step(tm, XPointLoss(loss_cfg))
    batch = _hm_batch(6, S)
    jstate, jc = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                       jax.random.PRNGKey(0))
    tb = _torch_batch({k: v for k, v in batch.items() if k != "hfour_points"})
    tb["hfour_points"] = T(batch["hfour_points"])
    tc = tstep(tstate, tb, torch.Generator().manual_seed(0))
    assert float(tc["skipped_nonfinite"]) == 0.0 and set(tc) == set(jc)
    assert "homography_regression_loss" in tc
    for k in tc:
        tol = 1.5 / 128 if "ratio" in k else 1e-5 * abs(float(jc[k])) + 1e-6
        assert abs(float(tc[k]) - float(jc[k])) <= tol, k
    variables, mu, _ = _port_state_tree(tstate)
    _assert_trees_close(mu, jstate.opt_state[0].mu, 1e-4,
                        "gradients (mu / 0.1)", floor=1e-7)
    _assert_trees_close(variables["batch_stats"], jstate.batch_stats, 1e-5,
                        "batch_stats")


def test_unported_heads_raise(monkeypatch):
    """The HomographyNet head raised NotImplementedError until it was
    ported; the CNN XPoint with it now builds it and its eval step (running
    BatchNorm statistics perturbed away from 0 / 1, no Dropout) matches
    JAX's, rtol 1e-5, with optical_not_warped true and false in one batch
    (the first sample's optical homography the identity, the second's
    not)."""
    from xpoint_tpu_torch.models.homographynet import HomographyNet
    cfg = _cnn_homographynet_cfg()
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32)
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 64, 64, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(2))
    v = _perturb(v, 33, scale=0.05)
    rng = np.random.default_rng(34)
    v["batch_stats"] = jax.tree.map(
        lambda s: np.asarray(s) + rng.uniform(0.05, 0.2, s.shape).astype(
            np.float32), v["batch_stats"])
    loss_cfg = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)
    batch = _hm_batch(8)
    jstate = JxTrainState.create(v["params"], v["batch_stats"],
                                 jx_make_optimizer({})[0])
    jl, jc = jax.jit(jx_make_eval_step(jm, JxXPointLoss(loss_cfg)))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tm, _ = build_xpoint(cfg, device="cpu")
    assert isinstance(tm.hm_regressor, HomographyNet)
    load_flax_variables(tm, v)
    tb = _torch_batch({k: v for k, v in batch.items() if k != "hfour_points"})
    tb["hfour_points"] = T(batch["hfour_points"])
    tl, tc = make_eval_step(tm, XPointLoss(loss_cfg))(
        TrainState(tm, make_optimizer({})[0]), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert "homography_regression_loss" in tc and set(tc) == set(jc)
    for k in tc:
        tol = 1.5 / 128 if "ratio" in k else 1e-5 * abs(float(jc[k])) + 1e-6
        assert abs(float(tc[k]) - float(jc[k])) <= tol, k
