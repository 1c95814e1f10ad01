"""The port's train steps of the CNN XPoint models against JAX's (the
single-image step of the synthetic pretrain, the pair step with per-sample
spectrum routing), the non-finite skip kept on the device, and the
spectrum routing of the inference call sites. fp32 on the CPU, TF32 off;
the same flax weights go through the bridge into both sides, and the
inputs are made from a seed with numpy."""
import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from xpoint_tpu.eval.infer import XPointInference as JxInference
from xpoint_tpu.eval.pipeline import make_pair_pipeline as jx_pipeline
from xpoint_tpu.losses.xpoint_loss import XPointLoss as JxXPointLoss
from xpoint_tpu.ops.detector import prob_from_logits as jx_prob_from_logits
from xpoint_tpu.parallel.train_step import TrainState as JxTrainState
from xpoint_tpu.parallel.train_step import \
    make_train_step as jx_make_train_step
from xpoint_tpu.trainer import make_optimizer as jx_make_optimizer

from xpoint_tpu_torch.compat.from_flax import state_dict_to_flax, to_flax
from xpoint_tpu_torch.eval import make_pair_pipeline
from xpoint_tpu_torch.eval.infer import XPointInference
from xpoint_tpu_torch.losses import XPointLoss
from xpoint_tpu_torch.models import VMAMBA_TRAIN_CFG, build_xpoint
from xpoint_tpu_torch.selfsup.export import make_prob_fn
from xpoint_tpu_torch.train import (TrainState, make_optimizer,
                                    make_train_step)

from test_torch_cnn import (T, _assert_trees_close, _images, cnn_cfg,
                            jax_cnn, port_cnn)
from torch_env import torch_env  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the full cycle's synthetic-pretrain loss (tools/full_cycle.py SYNTH_CFG)
SYNTH_LOSS = {"detector_loss": True,
              "detector_loss_function": "cross_entropy",
              "detector_handle_multiple_keypoints": "soft_assignment",
              "detector_dustbin_loss_weight": 0.025, "descriptor_loss": False,
              "space_to_depth_ratio": 8}


def _kp_map(rng, B, S):
    """Keypoints at most one per 8x8 cell (the hard tiebreak then decides
    no diagnostic)."""
    kp = np.zeros((B, S, S), np.float32)
    cells = rng.uniform(size=(B, S // 8, S // 8)) < 0.4
    for b, i, j in zip(*np.nonzero(cells)):
        kp[b, 8 * i + rng.integers(8), 8 * j + rng.integers(8)] = 1.0
    return kp


def _single_batch(seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(size=(B, S, S, 1)).astype(np.float32),
            "keypoints": _kp_map(rng, B, S),
            "valid_mask": np.ones((B, S, S), np.float32),
            "is_optical": (np.arange(B) % 2 == 0)[:, None]}


def _pair_batch(seed, B=4, S=32):
    """A pair batch with random_pairs routing: each side's samples hold
    either spectrum (is_optical per sample), and the thermal side is
    shifted by a translation homography."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(B, S, S, 1)).astype(np.float32)
    h = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    h[:, 0, 2] = 3.0
    vm = np.ones((B, S, S), np.float32)
    vm[:, :, :3] = 0.0
    return {"optical": {"image": img, "keypoints": _kp_map(rng, B, S),
                        "valid_mask": np.ones((B, S, S), np.float32),
                        "homography": np.tile(np.eye(3, dtype=np.float32),
                                              (B, 1, 1)),
                        "is_optical": np.array([[1], [0], [1], [1]], bool)},
            "thermal": {"image": np.clip(
                img + 0.1 * rng.normal(size=img.shape), 0, 1).astype(
                    np.float32),
                        "keypoints": _kp_map(rng, B, S), "valid_mask": vm,
                        "homography": h,
                        "is_optical": np.array([[0], [0], [1], [0]], bool)}}


def _torch_batch(batch):
    if "optical" in batch:
        return {k: _torch_batch(v) for k, v in batch.items()}
    return {k: T(np.ascontiguousarray(v)) for k, v in batch.items()}


def _port_state_tree(state):
    mu = dict(zip(state.names, state.opt_state["mu"]))
    return to_flax(state.module), state_dict_to_flax(mu)["params"]


@pytest.mark.parametrize("kind", ["single", "pair"])
def test_train_step_matches_jax(kind):
    """One train step of the two-encoder CNN with per-spectrum statistics
    through JAX's make_train_step and the port's from the same weights and
    batch: the single-image step ('mixed', the synthetic-pretrain loss on
    the flat batch) and the pair step (descriptor head, the flagship loss,
    each side routed per sample by is_optical). Loss components within
    1e-5 relative (ratios within one cell's share), every gradient (Adam's
    first moment, 0.1 g) within 1e-4 of its leaf's max + 1e-7 of the
    largest, and the running statistics after the step within 1e-5 of
    their leaf's max + 1e-6."""
    pair = kind == "pair"
    cfg = cnn_cfg(descriptor_head=pair)
    jm, v = jax_cnn(cfg, seed=5)
    loss_cfg = (dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)
                if pair else SYNTH_LOSS)
    batch = _pair_batch(6) if pair else _single_batch(6)
    jtx, _ = jx_make_optimizer({"learningrate": 1e-3})
    jstate = JxTrainState.create(v["params"], v["batch_stats"], jtx)
    jstep = jx_make_train_step(jm, JxXPointLoss(loss_cfg), takes_pair=pair,
                               donate=False)
    jstate, jc = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                       jax.random.PRNGKey(0))
    tm = port_cnn(cfg, v)
    tstate = TrainState(tm, make_optimizer({"learningrate": 1e-3})[0])
    tc = make_train_step(tm, XPointLoss(loss_cfg), takes_pair=pair)(
        tstate, _torch_batch(batch), torch.Generator().manual_seed(0))
    assert set(tc) == set(jc) and float(tc["skipped_nonfinite"]) == 0.0
    for k in tc:
        tol = 1.5 / 128 if "ratio" in k else 1e-5 * abs(float(jc[k])) + 1e-6
        assert abs(float(tc[k]) - float(jc[k])) <= tol, k
    variables, mu = _port_state_tree(tstate)
    _assert_trees_close(mu, jstate.opt_state[0].mu, 1e-4,
                        "gradients (mu / 0.1)", floor=1e-7)
    _assert_trees_close(variables["batch_stats"], jstate.batch_stats, 1e-5,
                        "batch_stats", floor=1e-6)
    assert int(tstate.step) == int(jstate.step) == 1


def _forbid_host_reads(monkeypatch):
    """Make every way a tensor's value reaches the host raise."""
    def read(*args, **kwargs):
        raise AssertionError("a tensor value was read on the host")
    for name in ("__bool__", "__float__", "__int__", "item", "tolist",
                 "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, read)


@pytest.mark.parametrize("kind", ["single", "pair"])
def test_nonfinite_batch_skipped_on_device(kind, monkeypatch):
    """The non-finite skip is a select on the device: a good step and then
    a batch with a NaN pixel run with every host read of a tensor made to
    raise; after the NaN batch, parameters, both Adam moments, the Adam
    count, the step count and every running statistic are bit for bit as
    before it, skipped_nonfinite is 1, and the counts are device tensors."""
    pair = kind == "pair"
    cfg = cnn_cfg(descriptor_head=pair)
    tm, _ = build_xpoint(cfg, device="cpu", seed=7)
    loss_cfg = (dict(VMAMBA_TRAIN_CFG["loss"], space_to_depth_ratio=8)
                if pair else SYNTH_LOSS)
    state = TrainState(tm, make_optimizer({"learningrate": 1e-3})[0])
    step = make_train_step(tm, XPointLoss(loss_cfg), takes_pair=pair)
    good = _torch_batch(_pair_batch(8) if pair else _single_batch(8))
    bad = copy.deepcopy(good)
    (bad["optical"] if pair else bad)["image"][1, 3, 5, 0] = float("nan")
    gen = torch.Generator().manual_seed(0)

    def snapshot():
        opt = state.opt_state
        return [t.clone() for t in (*tm.state_dict().values(), *opt["mu"],
                                    *opt["nu"], opt["count"], state.step)]
    with monkeypatch.context() as m:
        _forbid_host_reads(m)
        ok = step(state, good, gen)
        before = snapshot()
        skipped = step(state, bad, gen)
        after = snapshot()
    assert torch.is_tensor(state.step) and torch.is_tensor(
        state.opt_state["count"])
    assert float(ok["skipped_nonfinite"]) == 0.0
    assert float(skipped["skipped_nonfinite"]) == 1.0
    assert not np.isfinite(float(skipped["loss"]))
    assert int(state.step) == 1 and int(state.opt_state["count"]) == 1
    assert len(before) == len(after)
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert any(bool((m != 0).any()) for m in state.opt_state["mu"])


def _jax_prob(jm, v, img, spectrum, is_optical=None):
    out = jm.apply(v, jnp.asarray(img), spectrum,
                   None if is_optical is None else jnp.asarray(is_optical))
    return np.asarray(jx_prob_from_logits(out["logits"], 8))


def test_pair_pipeline_routes_spectra_as_jax():
    """make_pair_pipeline on the two-encoder CNN with per-spectrum
    statistics: the optical images through the optical route and the
    thermal ones through the thermal route, as the JAX pipeline: prob maps
    within atol 1e-5 of JAX's, the same masked keypoint sets, and maps
    that differ from the other route's."""
    cfg = cnn_cfg()
    jm, v = jax_cnn(cfg, seed=9, hw=(64, 64))
    rng = np.random.default_rng(10)
    img_o = rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
    img_t = rng.uniform(size=(2, 64, 64, 1)).astype(np.float32)
    kw = dict(k=64, nms_size=4, detection_threshold=0.015)
    ref = jax.device_get(jx_pipeline(jm, (64, 64), **kw)(
        v, jnp.asarray(img_o), jnp.asarray(img_t)))
    tm = port_cnn(cfg, v)
    out = {k: t.numpy() for k, t in make_pair_pipeline(tm, (64, 64), **kw)(
        T(img_o), T(img_t)).items()}
    for s, img, other in (("optical", img_o, "thermal"),
                          ("thermal", img_t, "optical")):
        np.testing.assert_allclose(out[f"prob_{s}"], ref[f"prob_{s}"],
                                   atol=1e-5)
        assert np.abs(out[f"prob_{s}"]
                      - _jax_prob(jm, v, img, other)).max() > 1e-3
        for b in range(2):
            mine = {tuple(p) for p, ok in zip(out[f"keypoints_{s}"][b],
                                              out[f"mask_{s}"][b]) if ok}
            theirs = {tuple(p) for p, ok in zip(ref[f"keypoints_{s}"][b],
                                                ref[f"mask_{s}"][b]) if ok}
            assert mine == theirs and mine, s


def test_prob_fn_and_forward_single_route_spectra_as_jax():
    """The label export's detector (make_prob_fn) runs an optical image
    through the optical route and a thermal one through the thermal route
    (cli/export_keypoints.py:53-56), and XPointInference.forward_single
    runs 'mixed' with is_optical per sample, as JAX's: prob within atol
    1e-5 and descriptors within 1e-5 of JAX's."""
    cfg = cnn_cfg()
    jm, v = jax_cnn(cfg, seed=11)
    img, is_optical = _images(12, B=4, hw=(32, 32))
    tm = port_cnn(cfg, v)
    prob_fn = make_prob_fn(tm)
    with torch.no_grad():
        for flag, spectrum in ((True, "optical"), (False, "thermal")):
            np.testing.assert_allclose(prob_fn(T(img), flag).numpy(),
                                       _jax_prob(jm, v, img, spectrum),
                                       atol=1e-5, err_msg=spectrum)
    prob, desc = XPointInference(tm).forward_single(img, is_optical)
    jprob, jdesc = JxInference(jm, v).forward_single(img, is_optical)
    np.testing.assert_allclose(prob, jprob, atol=1e-5)
    np.testing.assert_allclose(desc, jdesc, atol=1e-5)
    assert np.abs(prob - _jax_prob(jm, v, img, "optical")).max() > 1e-3
