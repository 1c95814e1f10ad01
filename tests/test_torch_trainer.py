"""The port's Trainer against the JAX Trainer (two epochs of a tiny fp32
synthetic-pretrain run on one frozen in-memory dataset), its resume,
``load_weights`` counts, the device-data epochs, and the committed
synthetic-pretrain checkpoint carried through the bridge. fp32 on the
CPU; inputs made from a seed with numpy."""
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import xpoint_tpu.trainer as jx_trainer
from xpoint_tpu import checkpoints as jx_ckpt
from xpoint_tpu.model_io import load_model as jx_load_model
from xpoint_tpu.models import build_xpoint as jx_build_xpoint
from xpoint_tpu.ops.detector import prob_from_logits as jx_prob_from_logits
from xpoint_tpu.parallel.train_step import TrainState as JxTrainState

from xpoint_tpu_torch import checkpoints as ckpt
from xpoint_tpu_torch.compat.from_flax import (_flatten, load_flax_variables,
                                               to_flax)
from xpoint_tpu_torch.config import load_yaml
from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.ops.detector import prob_from_logits
from xpoint_tpu_torch.trainer import Trainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4


class FrozenSingleImages:
    """A single-image dataset in memory, with SyntheticShapes' sample
    layout: image (S, S, 1) fp32, keypoints (S, S) map with at most one
    point an 8x8 cell, valid_mask (S, S) bool, is_optical (1,) bool
    (alternating)."""

    def __init__(self, n, S=32, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.uniform(size=(n, S, S, 1)).astype(np.float32)
        self.kps = np.zeros((n, S, S), np.float32)
        cells = rng.uniform(size=(n, S // 8, S // 8)) < 0.4
        for b, i, j in zip(*np.nonzero(cells)):
            self.kps[b, 8 * i + rng.integers(8),
                     8 * j + rng.integers(8)] = 1.0

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "keypoints": self.kps[i],
                "valid_mask": np.ones(self.kps[i].shape, bool),
                "is_optical": np.array([i % 2 == 0])}

    def returns_pair(self):
        return False


def synth_config(n_epochs=2, **model):
    """The full cycle's synthetic-pretrain config (tools/full_cycle.py
    SYNTH_CFG) at a tiny width: channel version 2, batch 4, lr 1e-4,
    per-spectrum statistics, a validation pass, e{N} every epoch."""
    return {
        "dataset": {"type": "SyntheticShapes", "filename": "train"},
        "model": {"type": "XPoint", "multispectral": True,
                  "descriptor_head": False, "final_batchnorm": True,
                  "reflection_pad": True, "takes_pair": False,
                  "channel_version": 2, "descriptor_size": 16,
                  "spectral_norm_stats": True,
                  "homography_regression_head": {"check": False}, **model},
        "loss": {"type": "XPointLoss", "detector_loss": True,
                 "detector_loss_function": "cross_entropy",
                 "detector_handle_multiple_keypoints": "soft_assignment",
                 "detector_dustbin_loss_weight": 0.025,
                 "descriptor_loss": False},
        "training": {"batchsize": 4, "learningrate": LR,
                     "n_epochs": n_epochs, "save_every_n_epoch": 1,
                     "use_writer": False, "num_worker": 1,
                     "validation": {"compute_validation_loss": True,
                                    "filename": "val"}},
    }


def _record(trainer, attr, losses):
    """Wrap a trainer's train_step or eval_step so that it appends each
    step's loss to ``losses`` (JAX's train step returns (state, comps),
    the port's comps; both eval steps (loss, comps))."""
    inner = getattr(trainer, attr)

    def wrapped(*args):
        out = inner(*args)
        if attr == "eval_step":
            loss = out[0]
        else:
            loss = (out[1] if isinstance(out, tuple) else out)["loss"]
        losses.append(float(loss))
        return out
    setattr(trainer, attr, wrapped)


def _leaves(tree):
    return {"/".join(p): np.asarray(x) for p, x in _flatten(tree)}


def _state_tensors(trainer):
    st = trainer.state
    opt = st.opt_state
    return [t.clone() for t in (*trainer.module.state_dict().values(),
                                *opt["mu"], *opt["nu"], opt["count"],
                                st.step)]


@pytest.mark.parametrize("scheduler", [None, "StepLR"])
def test_trainer_matches_jax(scheduler, tmp_path, monkeypatch):
    """Two epochs (2 steps each, batch 4 of 8 samples, then a validation
    pass over 4) of the tiny two-encoder CNN with per-spectrum statistics
    through the JAX Trainer (n_devices=1) and the port's, from the same
    initial weights (JAX's, through the bridge) and the same seeded
    shuffles. The first step's loss within 1e-5 relative; every later
    step's, each epoch's mean and each epoch's validation loss within 1e-4
    relative (the parameters they see agree to steps x lr only, below);
    final parameters within 4 steps x lr = 4e-4 absolute
    (Adam's first steps move an element whose gradient is roundoff-sized
    by up to lr a step, with either sign), BatchNorm statistics within 1e-4
    of their leaf's max + 4e-4 (the statistics follow those parameters: the
    mean after a conv whose bias has a zero gradient in exact arithmetic is
    that bias's roundoff walk). Then a port-alone resume from e1 in a fresh
    directory ends bit for bit where the straight run ended. With a StepLR
    scheduler (gamma 0.5 every epoch) the rate is set once an epoch on
    both sides."""
    train_ds, val_ds = FrozenSingleImages(8, seed=1), FrozenSingleImages(
        4, seed=2)
    cfg = synth_config()
    if scheduler:
        cfg["training"]["scheduler"] = {"use_scheduler": True,
                                        "type": scheduler, "gamma": 0.5,
                                        "step_size": 1}
    monkeypatch.setattr(jx_trainer, "get_dataset",
                        lambda c: val_ds if c.get("filename") == "val"
                        else train_ds)
    jt = jx_trainer.Trainer(cfg, str(tmp_path / "jax"), n_devices=1, seed=0)
    pt = Trainer(cfg, str(tmp_path / "port"), seed=0, device="cpu",
                 dataset=train_ds, val_dataset=val_ds)
    load_flax_variables(pt.module, {"params": jt.state.params,
                                    "batch_stats": jt.state.batch_stats})
    losses = {"jax": [], "port": [], "jax_val": [], "port_val": []}
    for t, side in ((jt, "jax"), (pt, "port")):
        _record(t, "train_step", losses[side])
        _record(t, "eval_step", losses[side + "_val"])
    jstate = jt.train()
    pt.train()
    assert len(losses["port"]) == len(losses["jax"]) == 4
    assert len(losses["port_val"]) == len(losses["jax_val"]) == 2
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0],
                               rtol=1e-5)
    for k in ("port", "port_val"):
        np.testing.assert_allclose(losses[k], losses[k.replace("port", "jax")],
                                   rtol=1e-4, err_msg=k)
    epoch_mean = {k: np.asarray(losses[k]).reshape(2, 2).mean(1)
                  for k in ("port", "jax")}
    np.testing.assert_allclose(epoch_mean["port"], epoch_mean["jax"],
                               rtol=1e-4)
    mine = to_flax(pt.module)
    a, b = _leaves(mine["params"]), _leaves(jax.device_get(jstate.params))
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=4 * LR,
                                   err_msg=k)
    a = _leaves(mine["batch_stats"])
    b = _leaves(jax.device_get(jstate.batch_stats))
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0,
                                   atol=1e-4 * np.abs(b[k]).max() + 4 * LR,
                                   err_msg=k)
    assert int(pt.state.step) == int(jstate.step) == 4
    assert pt.state.lr == (None if scheduler is None else LR * 0.5)
    assert sorted(os.listdir(tmp_path / "port")) == [
        "e1.pt", "e2.pt", "latest.pt", "params.yaml"]

    straight = _state_tensors(pt)
    os.makedirs(tmp_path / "resumed")
    shutil.copy(tmp_path / "port" / "e1.pt", tmp_path / "resumed" / "e1.pt")
    rt = Trainer(cfg, str(tmp_path / "resumed"), seed=0, device="cpu",
                 dataset=train_ds, val_dataset=val_ds)
    assert rt.resume("e1") == 1
    rt.train()
    resumed = _state_tensors(rt)
    assert len(resumed) == len(straight)
    assert all(torch.equal(x, y) for x, y in zip(resumed, straight))


@pytest.mark.parametrize("case", ["no_descriptor_head", "descriptor_size"])
def test_load_weights_counts_match_jax(case, tmp_path):
    """load_weights (strict=False) of a checkpoint with a descriptor head
    (descriptor 16) into a model without one, or with descriptor 32: the
    counts used / missing / unexpected / shape equal the JAX Trainer's for
    the same checkpoint, the used tensors are the checkpoint's, and the
    optimiser state starts fresh."""
    src = synth_config(descriptor_head=True)["model"]
    dst = (synth_config(descriptor_head=False) if case == "no_descriptor_head"
           else synth_config(descriptor_head=True, descriptor_size=32))
    ds = FrozenSingleImages(4)
    # JAX: an orbax checkpoint of the source model, loaded by a Trainer
    jm_src, _ = jx_build_xpoint(src, dtype=jnp.float32)
    v = jm_src.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1)),
                    method=jm_src.init_all)
    tx, _ = jx_trainer.make_optimizer(dst["training"])
    jx_ckpt.save(str(tmp_path), JxTrainState.create(
        v["params"], v["batch_stats"], tx), "src", 1)
    jt = jx_trainer.Trainer.__new__(jx_trainer.Trainer)
    jt.module, jt.model_cfg = jx_build_xpoint(dst["model"], dtype=jnp.float32)
    dv = jt.module.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 1)),
                        method=jt.module.init_all)
    jt.tx, jt.lr_at_epoch = tx, None
    jt.state = JxTrainState.create(dv["params"], dv["batch_stats"], tx)
    want = jt.load_weights(str(tmp_path / "src.ckpt"))
    # the port: the same weights as a Trainer checkpoint
    src_trainer = Trainer(synth_config(descriptor_head=True),
                          str(tmp_path / "port_src"), device="cpu",
                          dataset=ds, val_dataset=ds)
    load_flax_variables(src_trainer.module, v)
    ckpt.save(str(tmp_path / "port_src"), src_trainer.state, "src", 1)
    pt = Trainer(dst, str(tmp_path / "port_dst"), device="cpu", dataset=ds,
                 val_dataset=ds)
    pt.state.optimizer.mu.fill_(1.0)
    got = pt.load_weights(str(tmp_path / "port_src" / "src.pt"))
    assert got == want and got["used"] > 0 and got["unexpected"] + got[
        "shape"] > 0
    src_sd = src_trainer.module.state_dict()
    for k, t in pt.module.state_dict().items():
        if k in src_sd and src_sd[k].shape == t.shape:
            assert torch.equal(t, src_sd[k]), k
    assert not bool(pt.state.optimizer.mu.any())
    assert int(pt.state.step) == 0


def test_device_data_trainer_resumes_exactly(tmp_path):
    """Pair training on the device-resident corpus (the full cycle's
    device_data epochs: the DataLoader's shuffle and drop-last schedule,
    batches assembled and augmented in the step): finite losses, no
    skipped step, and a resume from e1 that ends bit for bit where the
    straight run ended."""
    ds_cfg = {"type": "ImagePairDataset", "height": 32, "width": 32,
              "random_pairs": False,
              "augmentation": {"photometric": {"enable": False},
                               "homographic": {"enable": True, "params": {
                                   "rotation": True, "max_angle": 0.3,
                                   "patch_ratio": 0.9},
                                   "border_reflect": True}}}
    ds = SyntheticPairs(n_pairs=6, size=48, n_kp=8, seed=3, config=ds_cfg)
    cfg = synth_config(descriptor_head=True, takes_pair=True)
    cfg["loss"].update(descriptor_loss=True, descriptor_loss_threshold=4.0,
                       **{"lambda": 1.0})
    cfg["training"].update(device_data=True, validation={}, batchsize=2)
    pt = Trainer(cfg, str(tmp_path / "a"), device="cpu", dataset=ds)
    comps = []
    inner = pt.train_step
    pt.train_step = lambda *a: comps.append(inner(*a)) or comps[-1]
    pt.train()
    assert len(comps) == 6
    assert all(np.isfinite(float(c["loss"])) and
               float(c["skipped_nonfinite"]) == 0.0 for c in comps)
    os.makedirs(tmp_path / "b")
    shutil.copy(tmp_path / "a" / "e1.pt", tmp_path / "b" / "e1.pt")
    rt = Trainer(cfg, str(tmp_path / "b"), device="cpu", dataset=ds)
    rt.resume("e1")
    rt.train()
    assert all(torch.equal(x, y) for x, y in zip(_state_tensors(rt),
                                                 _state_tensors(pt)))


def test_committed_checkpoint_through_the_bridge():
    """artifacts/synth-pretrain (the full cycle's synthetic-pretrain
    detector: two CNN encoders, no descriptor head) restored by the JAX
    model_io (orbax), carried through the bridge into the port's model
    built from the same params.yaml (read by the port's load_yaml): the
    heatmaps of both spectra within atol 1e-5 of JAX's, and the two
    spectra's maps differ (each ran its own encoder)."""
    mdir = os.path.join(ROOT, "artifacts", "synth-pretrain")
    jm, v, _ = jx_load_model(mdir, "latest")
    tm, _ = build_xpoint(load_yaml(os.path.join(mdir, "params.yaml"))
                         ["model"], device="cpu")
    load_flax_variables(tm, jax.device_get(v))
    pairs = SyntheticPairs(n_pairs=2, size=64, n_kp=1, seed=5)
    img = np.stack([pairs.optical[0], pairs.thermal[1]])[..., None]
    probs = {}
    for spectrum in ("optical", "thermal"):
        ref = np.asarray(jx_prob_from_logits(
            jm.apply(v, jnp.asarray(img), spectrum)["logits"], 8))
        with torch.no_grad():
            probs[spectrum] = prob_from_logits(
                tm(torch.from_numpy(img), spectrum)["logits"], 8).numpy()
        np.testing.assert_allclose(probs[spectrum], ref, atol=1e-5,
                                   err_msg=spectrum)
    assert np.abs(probs["optical"] - probs["thermal"]).max() > 1e-3


def test_trainer_builds_host_datasets_and_raises_for_a_pretrained_checkpoint(
        tmp_path, capsys):
    """The datasets the host data path builds are ported: a config alone
    gives the Trainer its SyntheticShapes (train and validation). A
    pretrained block without a checkpoint trains from scratch, as in JAX.
    A pretrained encoder checkpoint (which raised NotImplementedError until
    it was ported): a reference-named VMamba backbone under
    ``{"model": state_dict}`` in ``type_dir`` (the first of the sorted
    checkpoint names) loads through the Trainer's own path, and the
    encoder the Trainer trains from holds exactly the weights JAX's
    convert_pretrained_encoder gives, carried through the bridge; the
    rest of the model keeps the seeded initialisation."""
    from xpoint_tpu.compat.torch_converter import \
        convert_pretrained_encoder as jx_convert_pretrained_encoder
    from xpoint_tpu_torch.compat.from_flax import flax_to_state_dict
    from xpoint_tpu_torch.data import SyntheticShapes
    from test_torch_models import tiny_cfg
    from test_torch_pretrained import reference_checkpoint
    t = Trainer(synth_config(), str(tmp_path / "a"), device="cpu")
    assert isinstance(t.dataset, SyntheticShapes)
    assert isinstance(t.val_loader.dataset, SyntheticShapes)
    cfg = synth_config()
    cfg["model"] = tiny_cfg()
    (tmp_path / "enc").mkdir()
    cfg["model"]["use_attention"]["pretrained"] = {
        "check": True, "type_dir": str(tmp_path / "enc")}
    ds = FrozenSingleImages(4, S=64)
    Trainer(cfg, str(tmp_path / "b"), device="cpu", dataset=ds,
            val_dataset=ds)
    assert "training from scratch" in capsys.readouterr().out

    seeded, _ = build_xpoint(cfg["model"], device="cpu")
    sd = reference_checkpoint(seeded, 7)
    torch.save({"model": sd}, tmp_path / "enc" / "a_vssm_tiny.pth")
    torch.save({"model": {}}, tmp_path / "enc" / "b_other.pth")
    t = Trainer(cfg, str(tmp_path / "c"), device="cpu", dataset=ds,
                val_dataset=ds)
    assert "loaded pretrained encoder weights from" in capsys.readouterr().out
    jm, _ = jx_build_xpoint(cfg["model"], dtype=jnp.float32,
                            scan_backend="assoc")
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)),
                method=jm.init_all)
    want = flax_to_state_dict(jx_convert_pretrained_encoder(
        {k: x.numpy() for k, x in sd.items()}, jm, jax.device_get(v)))
    init = seeded.state_dict()
    for k, x in t.module.state_dict().items():
        ref = want[k] if k.startswith("encoder.") else init[k]
        assert torch.equal(x, ref), k
