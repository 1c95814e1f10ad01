"""Data-parallel training of the port on 2 CPU ranks (gloo, through
``parallel.launch``) against the JAX package's 2-device programs on
``make_mesh(2)`` and against the port on one device: ``make_train_step``
with a mesh (global BatchNorm statistics of both kinds, the blended loss's
keypoint ratio, the summed diagnostic ratios, the joint non-finite skip,
the global batch's DropPath and Dropout masks), the resident ``batch_fn``,
the host loader's rank slices, the ``Trainer`` with its bit-equal resume,
and the train entry point on 2 ranks.

The ranks run tests/torch_parallel_ranks.py (no JAX); one launch runs every
2-rank case. fp32 on the CPU; inputs made from seeds with numpy."""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xpoint_tpu_torch.compat.from_flax import (load_flax_variables,
                                               state_dict_to_flax, to_flax)
from xpoint_tpu_torch.data import DataLoader
from xpoint_tpu_torch.data.device_dataset import (load_resident_pair_data,
                                                  make_resident_batch_fn)
from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
from xpoint_tpu_torch.losses import XPointLoss
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG, build_xpoint
from xpoint_tpu_torch.parallel import launch
from xpoint_tpu_torch.parallel.mesh import Mesh
from xpoint_tpu_torch.train import TrainState, make_optimizer, make_train_step

import torch_parallel_ranks as ranks
from test_torch_cnn import _assert_trees_close, cnn_cfg, jax_cnn
from test_torch_cnn_steps import SYNTH_LOSS, _pair_batch, _single_batch
from test_torch_models import _perturb, tiny_cfg
from torch_env import torch_env  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
T = torch.from_numpy
CPU2 = ["cpu", "cpu"]
# a launch's deadline (``ranked`` takes ~30 s alone, several times that
# beside the rest of the suite); a hung collective raises after the
# launcher's own 60 s a collective
LAUNCH_S = 400
FLAGSHIP_LOSS = dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)
BLENDED_LOSS = dict(FLAGSHIP_LOSS,
                    detector_loss_function="cross_entropy_focal_blended",
                    detector_handle_multiple_keypoints="hard_assignment")
RESIDENT_CFG = {"type": "ImagePairDataset", "height": 32, "width": 32,
                "random_pairs": True,
                "augmentation": {"photometric": {"enable": False},
                                 "homographic": {"enable": True, "params": {
                                     "rotation": True, "max_angle": 0.3,
                                     "patch_ratio": 0.9},
                                     "border_reflect": True}}}


def _vmamba_cfg(drop_path=0.0, hm_head=False):
    cfg = copy.deepcopy(tiny_cfg())
    cfg["homography_regression_head"] = {"check": hm_head}
    cfg["use_attention"]["model_parameters"]["MODEL"]["DROP_PATH_RATE"] = \
        drop_path
    return cfg


def _jax_vmamba(cfg, S=32):
    from xpoint_tpu.models import build_xpoint as jx_build_xpoint
    jm, _ = jx_build_xpoint(cfg, dtype=jnp.float32, scan_backend="assoc")
    v = jax.jit(lambda r: jm.init(r, jnp.zeros((1, S, S, 1), jnp.float32),
                                  method=jm.init_all))(jax.random.PRNGKey(0))
    return jm, _perturb(v, 21, scale=0.05)


def _vmamba_batch(seed, B=2, S=32):
    """A pair batch (numpy): keypoints at most one per cell, the thermal
    side shifted by a translation with its valid mask."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(B, S, S, 1)).astype(np.float32)

    def kps():
        kp = np.zeros((B, S, S), np.float32)
        cells = rng.uniform(size=(B, S // 8, S // 8)) < 0.4
        for b, i, j in zip(*np.nonzero(cells)):
            kp[b, 8 * i + rng.integers(8), 8 * j + rng.integers(8)] = 1.0
        return kp
    h = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    h[:, 1, 2] = 2.0
    vm = np.ones((B, S, S), np.float32)
    vm[:, :2] = 0.0
    eye = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    return {"optical": {"image": img, "keypoints": kps(),
                        "valid_mask": np.ones((B, S, S), np.float32),
                        "homography": eye},
            "thermal": {"image": np.clip(img + 0.1 * rng.normal(
                size=img.shape), 0, 1).astype(np.float32),
                "keypoints": kps(), "valid_mask": vm, "homography": h}}


def _nan_on_rank_1(batch, pair):
    """The batch with one NaN pixel in its last sample (rank 1's rows)."""
    bad = copy.deepcopy(batch)
    (bad["optical"] if pair else bad)["image"][-1, 3, 5, 0] = np.nan
    return bad


def _dp_cases():
    """name -> (case for the ranks, JAX model and variables or None)."""
    cases = {}
    for name, cfg, pair, loss, batches in (
            ("cnn_pair", cnn_cfg(descriptor_head=True), True, FLAGSHIP_LOSS,
             [_pair_batch(s) for s in (6, 7)]),
            ("cnn_single_plain_bn", cnn_cfg(spectral_norm_stats=False),
             False, SYNTH_LOSS, [_single_batch(s) for s in (6, 7)]),
            ("cnn_blended", cnn_cfg(descriptor_head=True), True,
             BLENDED_LOSS, [_pair_batch(s) for s in (8, 9)])):
        jm, v = jax_cnn(cfg, seed=5)
        sd = load_flax_variables(build_xpoint(cfg, device="cpu")[0],
                                 v).state_dict()
        batches = batches + [_nan_on_rank_1(batches[0], pair)]
        cases[name] = ({"cfg": cfg, "sd": sd, "pair": pair, "loss": loss,
                        "lr": 1e-3, "batches": batches, "gen_seed": 0},
                       (jm, v))
    cfg = _vmamba_cfg()
    jm, v = _jax_vmamba(cfg)
    sd = load_flax_variables(build_xpoint(cfg, device="cpu")[0],
                             v).state_dict()
    cases["vmamba"] = ({"cfg": cfg, "sd": sd, "pair": True,
                        "loss": FLAGSHIP_LOSS, "lr": 1e-4,
                        "batches": [_vmamba_batch(s) for s in (1, 2)],
                        "gen_seed": 0}, (jm, v))
    # DropPath 0.2 and RegNet's two Dropouts: the masks are the global
    # batch's (held against the port on one device: JAX draws other bits)
    cfg = _vmamba_cfg(drop_path=0.2, hm_head=True)
    tm, _ = build_xpoint(cfg, device="cpu", seed=3)
    batches = [dict(_vmamba_batch(s), hfour_points=np.random.default_rng(
        s).normal(size=(2, 4, 2)).astype(np.float32)) for s in (3, 4)]
    cases["vmamba_droppath_dropout"] = (
        {"cfg": cfg, "sd": tm.state_dict(), "pair": True,
         "loss": dict(FLAGSHIP_LOSS, homography_regression_loss={
             "check": True, "gamma": 1.0}),
         "lr": 1e-4, "batches": batches, "gen_seed": 11}, None)
    return cases


def _trainer_cfg():
    from test_torch_trainer import synth_config
    return synth_config()


@pytest.fixture(scope="module")
def cases():
    return _dp_cases()


@pytest.fixture(scope="module")
def resident_inputs():
    return {"pairs": {"n_pairs": 6, "size": 48, "n_kp": 8, "seed": 3,
                      "config": RESIDENT_CFG},
            "idx": [[0, 3, 5, 1], [2, 4, 1, 0]]}


@pytest.fixture(scope="module")
def trainer_init(tmp_path_factory):
    """The initial weights of the Trainer runs: the JAX Trainer's at seed
    0 (n_devices 2), carried through the bridge."""
    import xpoint_tpu.trainer as jx_trainer
    train_ds = ranks.FrozenSingleImages(8, seed=1)
    val_ds = ranks.FrozenSingleImages(4, seed=2)
    cfg = _trainer_cfg()
    orig = jx_trainer.get_dataset
    jx_trainer.get_dataset = (lambda c: val_ds if c.get("filename") == "val"
                              else train_ds)
    try:
        jt = jx_trainer.Trainer(cfg, str(tmp_path_factory.mktemp("jax")),
                                n_devices=2, seed=0)
    finally:
        jx_trainer.get_dataset = orig
    tm = build_xpoint(cfg["model"], device="cpu")[0]
    load_flax_variables(tm, {"params": jt.state.params,
                             "batch_stats": jt.state.batch_stats})
    return jt, tm.state_dict(), cfg


@pytest.fixture(scope="module")
def ranked(cases, resident_inputs, trainer_init, tmp_path_factory):
    _, sd, cfg = trainer_init
    inp = {"dp": {k: c for k, (c, _) in cases.items()},
           "resident": resident_inputs,
           "trainer": {"cfg": cfg, "sd": sd,
                       "root": str(tmp_path_factory.mktemp("dp_trainer"))}}
    return launch(ranks.train_cases, 2, args=(inp,), devices=CPU2,
                  timeout=LAUNCH_S, threads=2)


_ONE_DEVICE = {}


def _one_device(case):
    """The same steps through make_train_step without a mesh (cached by
    the case's identity: a case is built once per module)."""
    if id(case) not in _ONE_DEVICE:
        _ONE_DEVICE[id(case)] = _one_device_run(case)
    return _ONE_DEVICE[id(case)]


def _one_device_run(case):
    tm, _ = build_xpoint(case["cfg"], device="cpu")
    tm.load_state_dict(case["sd"])
    state = TrainState(tm, make_optimizer({"learningrate": case["lr"]})[0])
    step = make_train_step(tm, XPointLoss(case["loss"]),
                           takes_pair=case["pair"])
    gen = torch.Generator().manual_seed(case["gen_seed"])
    comps, mus, buffers = [], [], None
    for b in case["batches"]:
        comps.append({k: float(v) for k, v in step(
            state, ranks._torch_tree(b), gen).items()})
        mus.append(state.optimizer.mu.clone())
        if buffers is None:
            buffers = {k: v.clone() for k, v in tm.named_buffers()}
    return comps, ranks._state(state), mus, buffers


def _trees(case, state):
    """A rank's state as flax trees: variables, and Adam's mu (0.1 g after
    the first step) by parameter."""
    tm, _ = build_xpoint(case["cfg"], device="cpu")
    tm.load_state_dict(state["module"])
    names = [n for n, _ in tm.named_parameters()]
    sizes = [p.numel() for _, p in tm.named_parameters()]
    mu = {n: t.view_as(p) for n, t, (_, p) in zip(
        names, state["mu"].split(sizes), tm.named_parameters())}
    return to_flax(tm), state_dict_to_flax(mu)["params"]


def _grads(case, state, mus):
    """Each step's gradient as a flax tree, from Adam's mu after it
    (mu_t = 0.9 mu_(t-1) + 0.1 g_t)."""
    out, prev = [], torch.zeros_like(mus[0])
    for mu in mus:
        out.append(_trees(case, dict(state, mu=(mu - 0.9 * prev) / 0.1))[1])
        prev = mu
    return out


def _norm_ratio(a, b, c=None):
    """|a - b| / |b - c| over all leaves of the flat dicts (c: zero)."""
    num = sum(float(np.sum((np.asarray(a[k]) - np.asarray(b[k])) ** 2))
              for k in b)
    den = sum(float(np.sum((np.asarray(b[k]) - (0 if c is None
                                                 else np.asarray(c[k])))
                           ** 2)) for k in b)
    return (num / den) ** 0.5


def _ratio_tol(batch, pair):
    """One cell's share of a ratio (a near-tied argmax may fall either
    way): 1.5 / (B Hc Wc)."""
    img = (batch["optical"] if pair else batch)["image"]
    return 1.5 / (img.shape[0] * (img.shape[1] // 8) * (img.shape[2] // 8))


@pytest.mark.parametrize("name", ["cnn_pair", "cnn_single_plain_bn",
                                  "cnn_blended", "vmamba"])
def test_dp_step_matches_jax_two_devices(name, cases, ranked):
    """Two data-parallel steps on 2 ranks against JAX's make_train_step on
    2 devices (state replicated, batches sharded), from the same weights:
    after step 1 every component within 1e-5 relative, the TP/FP/FN/TN
    and correct ratios within one cell's share, every gradient (Adam's mu
    / 0.1) within 3e-4 of its leaf's max + 5e-7 of the largest (the
    global batch's sums formed per rank, then across the ranks, in
    another order than XLA's; the floor holds the leaves whose gradient is
    zero in exact arithmetic, the biases before a train-mode BatchNorm),
    and the
    BatchNorm statistics (both kinds: the E[x^2] - E[x]^2 and the
    two-pass form, over the global batch) within 1e-5 of their leaf's max
    + 1e-6; step 2's gradient (from mu: mu_2 - 0.9 mu_1 = 0.1 g_2) within
    1e-2 of its leaf's max + 5e-7 of the largest (the parameters it is
    taken at differ by up to 2 lr on the elements whose step-1 gradient
    was roundoff, which Adam moves by lr either way); the update of the
    2 steps within 0.1 of its norm (|dtheta_port - dtheta_jax| /
    |dtheta_jax|, the same elements), and the statistics within 1e-3 of
    their leaf's max + 4 lr. The state is equal on both ranks."""
    from xpoint_tpu.losses.xpoint_loss import XPointLoss as JxXPointLoss
    from xpoint_tpu.parallel import make_mesh, replicate, shard_batch
    from xpoint_tpu.parallel.train_step import TrainState as JxTrainState
    from xpoint_tpu.parallel.train_step import \
        make_train_step as jx_make_train_step
    from xpoint_tpu.trainer import make_optimizer as jx_make_optimizer
    case, (jm, v) = cases[name]
    mesh = make_mesh(2)
    jtx, _ = jx_make_optimizer({"learningrate": case["lr"]})
    jstate = replicate(JxTrainState.create(v["params"], v["batch_stats"],
                                           jtx), mesh)
    jstep = jx_make_train_step(jm, JxXPointLoss(case["loss"]),
                               takes_pair=case["pair"], donate=False)
    got = ranked["dp"][name]
    assert got["same_on_every_rank"]
    lr = case["lr"]
    grads = _grads(case, got["state"], got["mus"])
    jmu = []
    for i, batch in enumerate(case["batches"][:2]):
        with mesh:
            jstate, jc = jstep(jstate, shard_batch(
                jax.tree.map(jnp.asarray, batch), mesh),
                jax.random.PRNGKey(i))
        jmu.append(jax.device_get(jstate.opt_state[0].mu))
        tc = got["comps"][i]
        assert tc["skipped_nonfinite"] == 0.0
        if i == 0:
            assert set(tc) == set(jc)
            for k in tc:
                tol = (_ratio_tol(batch, case["pair"]) if "ratio" in k
                       else 1e-5 * abs(float(jc[k])) + 1e-6)
                assert abs(tc[k] - float(jc[k])) <= tol, k
            _assert_trees_close(grads[0], jax.tree.map(
                lambda m: m / 0.1, jmu[0]), 3e-4, "step 1's gradient",
                floor=5e-7)
            stats = jax.device_get(jstate.batch_stats)
            if stats:
                tm = build_xpoint(case["cfg"], device="cpu")[0]
                tm.load_state_dict(dict(case["sd"], **got["buffers_first"]))
                top = max(float(np.abs(x).max()) for _, x in _flat(stats))
                _assert_trees_close(to_flax(tm)["batch_stats"], stats, 1e-5,
                                    "batch_stats after step 1",
                                    floor=1e-6 / top)
    _assert_trees_close(grads[1], jax.tree.map(
        lambda m2, m1: (m2 - 0.9 * m1) / 0.1, jmu[1], jmu[0]), 1e-2,
        "step 2's gradient", floor=5e-7)
    variables, _ = _trees(case, got["state"])
    a = {"/".join(k): x for k, x in _flat(variables["params"])}
    b = {"/".join(k): np.asarray(x) for k, x in _flat(jstate.params)}
    b0 = {"/".join(k): np.asarray(x) for k, x in _flat(v["params"])}
    assert set(a) == set(b)
    assert _norm_ratio(a, b, b0) <= 0.1
    stats = jax.device_get(jstate.batch_stats)
    if stats:
        top = max(float(np.abs(x).max()) for _, x in _flat(stats))
        _assert_trees_close(variables["batch_stats"], stats, 1e-3,
                            "batch_stats", floor=4 * lr / top)
    assert got["state"]["step"] == int(jstate.step) == 2


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("name", ["cnn_pair", "cnn_single_plain_bn",
                                  "cnn_blended", "vmamba",
                                  "vmamba_droppath_dropout"])
def test_dp_matches_one_device(name, cases, ranked):
    """The 2-rank steps against the port's own step on one device on the
    global batches, from the same weights and generator. After step 1,
    where both hold the same parameters: every component within 1e-5
    relative (+1e-6; ratios to one cell), every gradient (Adam's mu / 0.1)
    within 3e-5 of its leaf's max + 5e-7 of the largest (sums over the
    batch in another order; the floor holds the leaves that are roundoff
    alone), and every
    BatchNorm running statistic (the global batch's: both kinds) within
    1e-5 of its largest + 1e-7. With DropPath 0.2 and RegNet's two
    Dropout(0.5) this holds only if every rank keeps its rows of the
    global batch's masks. After step 2: the components within 1e-4
    relative; step 2's gradient (from mu) within 0.1 of its norm, as one
    vector (the parameters it is taken at differ by up to 2 lr on the
    elements whose step-1 gradient was roundoff, a bias before a
    train-mode BatchNorm, which Adam moves by lr either way; through a
    ReLU or a near-tied argmax that moves the plain-BN CNN's by 1.8%);
    the update of the 2 steps within 0.1 of its norm (|dtheta_dp -
    dtheta_one| / |dtheta_one|) and the statistics within 1e-4 of their
    largest + 4 lr; the Adam count equal."""
    case, _ = cases[name]
    comps, state, mus, buffers = _one_device(case)
    got = ranked["dp"][name]
    for i, (tc, oc) in enumerate(zip(got["comps"], comps)):
        assert set(tc) == set(oc)
        for k in oc:
            if not np.isfinite(oc[k]):
                assert not np.isfinite(tc[k]), (i, k)
                continue
            tol = (_ratio_tol(case["batches"][i], case["pair"])
                   if "ratio" in k
                   else (1e-5 if i == 0 else 1e-4) * abs(oc[k]) + 1e-6)
            assert abs(tc[k] - oc[k]) <= tol, (i, k)
    g_got = _grads(case, got["state"], got["mus"])
    g_one = _grads(case, state, mus)
    _assert_trees_close(g_got[0], g_one[0], 3e-5, "step 1's gradient",
                        floor=5e-7)
    assert _norm_ratio(dict(_flat(g_got[1])), dict(_flat(g_one[1]))) <= 0.1
    for k, t in buffers.items():
        np.testing.assert_allclose(
            got["buffers_first"][k].numpy(), t.numpy(), rtol=0,
            atol=1e-5 * float(t.abs().max()) + 1e-7, err_msg=k)
    lr = case["lr"]
    params = dict(build_xpoint(case["cfg"], device="cpu")[0]
                  .named_parameters())
    assert _norm_ratio({k: got["state"]["module"][k].numpy() for k in params},
                       {k: state["module"][k].numpy() for k in params},
                       {k: case["sd"][k].numpy() for k in params}) <= 0.1
    for k, t in state["module"].items():
        if k not in params:
            np.testing.assert_allclose(
                got["state"]["module"][k].numpy(), t.numpy(), rtol=0,
                atol=4 * lr + 1e-4 * float(t.abs().max()), err_msg=k)
    assert got["state"]["count"] == state["count"]


@pytest.mark.parametrize("name", ["cnn_pair", "cnn_single_plain_bn",
                                  "cnn_blended"])
def test_dp_non_finite_sample_on_one_rank_skips_both(name, ranked):
    """The third batch holds a NaN pixel in its last sample, which lies on
    rank 1 alone: the global loss is not finite, both ranks skip (the count
    stays at 2) and the state stays equal on both."""
    got = ranked["dp"][name]
    assert got["comps"][2]["skipped_nonfinite"] == 1.0
    assert not np.isfinite(got["comps"][2]["loss"])
    assert got["state"]["count"] == got["state"]["step"] == 2
    assert got["same_on_every_rank"]


def test_dp_blended_ratio_is_global(cases, ranked):
    """cross_entropy_focal_blended blends by the keypoint ratio of the
    global batch: the 2-rank loss equals the one-device loss (1e-5), which
    it would not with each rank's own ratio once the two ranks' ratios
    straddle the threshold; the diagnostic ratios are the global batch's
    (one cell)."""
    case, _ = cases["cnn_blended"]
    comps = _one_device(case)[0]
    got = ranked["dp"]["cnn_blended"]["comps"]
    for i in range(2):
        assert abs(got[i]["loss"] - comps[i]["loss"]) <= \
            1e-5 * abs(comps[i]["loss"]) + 1e-6
        for k in ("TP_ratio1", "FP_ratio1", "FN_ratio1", "TN_ratio1"):
            assert abs(got[i][k] - comps[i][k]) <= \
                _ratio_tol(case["batches"][i], True), (i, k)


def test_resident_batch_fn_slices_equal_the_one_device_batch(
        resident_inputs, ranked):
    """make_resident_batch_fn on 2 ranks (crops, random-pairs flips and the
    homographies drawn for the global batch, each rank warping its own
    rows) gathered over the ranks equals the one-device batch from the same
    generator: images and the RegNet input within 1e-6 (warps of 2 against
    4 samples), everything else exactly."""
    ds = SyntheticPairs(**resident_inputs["pairs"])
    data, meta = load_resident_pair_data(ds, device="cpu")
    fn = make_resident_batch_fn(ds.config, meta, hm_input=True)
    gen = torch.Generator().manual_seed(7)
    for idx, got in zip(resident_inputs["idx"], ranked["resident"]):
        want = fn(gen, {"data": data, "idx": torch.tensor(idx)})
        assert set(got) == set(want)
        for k, w in want.items():
            pairs = (w.items() if isinstance(w, dict) else [(None, w)])
            for kk, ww in pairs:
                g = got[k][kk] if kk else got[k]
                if ww.is_floating_point() and kk in ("image", None):
                    np.testing.assert_allclose(g.numpy(), ww.numpy(),
                                               atol=1e-6, err_msg=(k, kk))
                else:
                    assert torch.equal(g, ww), (k, kk)


class _Rank(Mesh):
    """A mesh as one rank sees it, without a process group: enough for
    the loader's slicing."""

    def __init__(self, rank):
        super().__init__(rank, 2, "cpu")


@pytest.mark.parametrize("workers", [1, 3])
def test_host_loader_rank_slices_equal_the_global_batches(workers):
    """Each rank's DataLoader (same seed, so the same shuffle) yields its
    rows of every global batch; concatenated they are the one-device
    batches bit for bit, whatever the worker count."""
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs as SP
    ds = SP(n_pairs=10, size=32, n_kp=4, seed=1, config=RESIDENT_CFG)
    one = list(DataLoader(ds, 4, shuffle=True, seed=3, workers=workers))
    per_rank = [list(DataLoader(ds, 4, shuffle=True, seed=3,
                                workers=workers, mesh=_Rank(r)))
                for r in (0, 1)]
    assert len(one) == len(per_rank[0]) == len(per_rank[1]) == 2
    for b, r0, r1 in zip(one, *per_rank):
        for side in ("optical", "thermal"):
            for k, v in b[side].items():
                np.testing.assert_array_equal(
                    np.concatenate([r0[side][k], r1[side][k]]), v)


def test_host_loader_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(list(range(8)), 3, mesh=_Rank(0))


def test_trainer_two_ranks_matches_jax_two_devices(trainer_init, ranked,
                                                   tmp_path):
    """The Trainer on 2 ranks against the JAX Trainer with n_devices=2
    (two epochs of 2 steps, batch 4 of 8 samples, a validation pass over
    4): the first step's loss within 1e-5 relative, every later step's
    and each validation loss within 1e-4 relative, Adam's mu after the 4
    steps (every step's gradient, weighed 0.1, 0.09, 0.081, 0.073) within
    1e-3 of its norm as one vector, the update of the 4 steps within 0.1
    of its norm (|dtheta_port - dtheta_jax| / |dtheta_jax|: Adam moves
    the roundoff-sized elements by lr either way) and BatchNorm
    statistics within 1e-4 of their leaf's max + 4 lr
    (test_torch_trainer.py's tolerances); rank 0 alone wrote the files;
    the state is equal on both ranks."""
    import xpoint_tpu.trainer as jx_trainer
    jt, _, cfg = trainer_init
    losses = {"train": [], "val": []}
    inner_t, inner_v = jt.train_step, jt.eval_step

    def rec_t(*a):
        out = inner_t(*a)
        losses["train"].append(float(out[1]["loss"]))
        return out

    def rec_v(*a):
        out = inner_v(*a)
        losses["val"].append(float(out[0]))
        return out
    jt.train_step, jt.eval_step = rec_t, rec_v
    b0 = dict(_flat(jax.device_get(jt.state.params)))
    jstate = jt.train()
    got = ranked["trainer"]
    assert len(got["losses"]["train"]) == len(losses["train"]) == 4
    assert len(got["losses"]["val"]) == len(losses["val"]) == 2
    np.testing.assert_allclose(got["losses"]["train"][0],
                               losses["train"][0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"]["train"], losses["train"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["losses"]["val"], losses["val"],
                               rtol=1e-4)
    LR = cfg["training"]["learningrate"]
    tm = build_xpoint(cfg["model"], device="cpu")[0]
    tm.load_state_dict(got["state"]["module"])
    mine = to_flax(tm)
    a = dict(_flat(mine["params"]))
    b = dict(_flat(jax.device_get(jstate.params)))
    assert set(a) == set(b)
    assert _norm_ratio(a, b, b0) <= 0.1
    _, mu = _trees({"cfg": cfg["model"]}, got["state"])
    assert _norm_ratio(dict(_flat(mu)), dict(_flat(jax.device_get(
        jstate.opt_state[0].mu)))) <= 1e-3
    a = dict(_flat(mine["batch_stats"]))
    b = dict(_flat(jax.device_get(jstate.batch_stats)))
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=1e-4 * np.abs(b[k]).max() + 4 * LR,
                                   err_msg=str(k))
    assert got["state"]["step"] == int(jstate.step) == 4
    assert got["files"] == ["e1.pt", "e2.pt", "latest.pt", "params.yaml"]
    assert got["same_on_every_rank"]


def test_trainer_two_ranks_resume_is_bit_equal(ranked):
    """A second Trainer on both ranks, resumed from the straight run's e1
    in a fresh directory, ends bit for bit where the straight run ended on
    every rank."""
    assert ranked["trainer"]["start"] == 1
    assert ranked["trainer"]["resume_equal"]


def test_train_entry_point_on_two_ranks(tmp_path):
    """cli.train's rank path (``_train``, what ``main`` runs on each of
    several GPUs) launched on 2 CPU ranks (gloo): the full cycle's
    synthetic-pretrain config (two CNN encoders, per-spectrum statistics,
    global batch 4) for two epochs of one step, saving every epoch. Rank 0
    alone wrote the files; latest.pt is epoch 2, step 2. Against one rank
    (``main`` on the CPU), e1.pt's Adam moments, which are the first
    step's gradient (mu = 0.1 g, nu = 0.001 g^2), within 1e-4 of their
    leaf's max + 1e-6 of the largest: a rank that kept its own half-batch
    gradient is off by a large part of the leaf. latest.pt's mu (0.09 g_1
    + 0.1 g_2) within 0.1 of its norm, as one vector: in this config two
    one-rank runs whose sums differ only in order (another thread count)
    drift apart within a few steps, Adam moving each roundoff-sized
    element by lr either way, so step 2 is held loosely; the later steps'
    agreement is the Trainer tests' (per-step losses within 1e-4)."""
    from test_torch_cli import _train_setup
    from xpoint_tpu_torch.cli import train
    from xpoint_tpu_torch.cli._common import rank_count
    cfg = _train_setup(tmp_path)
    with open(cfg) as f:
        body = f.read()
    assert "save_every_n_epoch: 0" in body
    with open(cfg, "w") as f:
        f.write(body.replace("save_every_n_epoch: 0", "save_every_n_epoch: 1"))
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    argv = ["-y", cfg, "--device", "cpu", "--max-steps", "1"]
    assert rank_count(train.parse_args(argv)) == 1
    assert launch(train._train, 2, args=(train.parse_args(argv + ["-o", two]),
                                         False),
                  devices=CPU2, timeout=LAUNCH_S, threads=2) is None
    assert sorted(os.listdir(two)) == ["e1.pt", "e2.pt", "latest.pt",
                                       "params.yaml"]
    train.main(argv + ["-o", one])
    last = torch.load(os.path.join(two, "latest.pt"), weights_only=True)
    last_one = torch.load(os.path.join(one, "latest.pt"), weights_only=True)
    assert last["epoch"] == 2 and int(last["step"]) == 2
    assert _norm_ratio(last["opt_state"]["mu"],
                       last_one["opt_state"]["mu"]) <= 0.1
    a = torch.load(os.path.join(two, "e1.pt"), weights_only=True)
    b = torch.load(os.path.join(one, "e1.pt"), weights_only=True)
    assert a["epoch"] == b["epoch"] == 1 and int(a["step"]) == 1
    assert int(a["opt_state"]["count"]) == int(b["opt_state"]["count"]) == 1
    for moment in ("mu", "nu"):
        _assert_trees_close(
            {k: v.numpy() for k, v in a["opt_state"][moment].items()},
            {k: v.numpy() for k, v in b["opt_state"][moment].items()},
            1e-4, f"Adam's {moment} after step 1", floor=1e-6)
