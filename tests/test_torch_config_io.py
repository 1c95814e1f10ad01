"""The port's config files, checkpoints, model_io, host DataLoader and
dict helpers against the JAX package's: a port-written params.yaml read
back equal by the JAX load_yaml (also in the JSON form written where PyYAML
is absent), checkpoints and load_model round trips, the same batches from
the DataLoader at the same seed, and the helpers' results."""
import builtins
import inspect
import os
import sys
import types

import numpy as np
import pytest
import torch

import xpoint_tpu.utils.dicttools as jx_dicttools
from xpoint_tpu.config import load_yaml as jx_load_yaml
from xpoint_tpu.data.loader import DataLoader as JxDataLoader

from xpoint_tpu_torch import checkpoints as ckpt
from xpoint_tpu_torch import config as port_config
from xpoint_tpu_torch import utils as port_utils
from xpoint_tpu_torch.data import DataLoader, collate, get_dataset
from xpoint_tpu_torch.model_io import load_model
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.train import TrainState, make_optimizer
from xpoint_tpu_torch.trainer import Trainer
from torch_env import torch_env  # noqa: F401 (autouse)

CONFIG = {
    "dataset": {"type": "ImagePairDataset", "height": 256, "width": 256,
                "augmentation": {"homographic": {"enable": True, "params": {
                    "max_angle": 1.57, "patch_ratio": 0.85,
                    "translation_overflow": 0.05}}}},
    "model": {"type": "XPoint", "multispectral": True,
              "descriptor_head": False, "channel_version": 2,
              "descriptor_size": 16, "spectral_norm_stats": True,
              "homography_regression_head": {"check": False},
              "use_attention": {"check": False, "pretrained": {
                  "check": True, "type_dir": ""}}},
    "loss": {"detector_dustbin_loss_weight": 0.025, "lambda_d": 250,
             "lambda": 1.0, "negative_margin": 0.2, "tiny": 1e-05,
             "huge": 1e+20, "negative": -3.5e-07, "none": None,
             "primitives": ["random_brightness", "motion_blur"],
             "ranges": [[0, 0.06], [-0.5, 0.8]], "text": "1e-3 'quoted'"},
    "training": {"batchsize": 16, "learningrate": "1e-3", "n_epochs": 2,
                 "use_writer": False, "nested": {}, "empty": []},
}


@pytest.fixture
def no_yaml(monkeypatch):
    """Make ``import yaml`` fail, as on a machine without PyYAML."""
    real_import = builtins.__import__

    def fake_import(name, *args, **kwargs):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("no PyYAML")
        return real_import(name, *args, **kwargs)
    monkeypatch.delitem(sys.modules, "yaml", raising=False)
    monkeypatch.setattr(builtins, "__import__", fake_import)


@pytest.mark.parametrize("form", ["yaml", "json"])
def test_params_yaml_read_back_by_jax(form, tmp_path, request):
    """save_yaml writes a config that the JAX load_yaml reads back equal:
    YAML where PyYAML imports, JSON text where it does not (floats with a
    point and a signed exponent, which YAML 1.1 reads as floats); the
    port's load_yaml reads its own file equal in both forms."""
    path = str(tmp_path / "params.yaml")
    if form == "json":
        request.getfixturevalue("no_yaml")
    port_config.save_yaml(CONFIG, path)
    assert port_config.load_yaml(path) == CONFIG
    text = open(path).read()
    assert text.lstrip().startswith("{") == (form == "json")
    if form == "json":
        import json
        assert json.loads(text) == CONFIG
        assert "1.0e-05" in text and "1.0e+20" in text
    assert jx_load_yaml(path) == CONFIG


def test_config_helpers_match_jax(tmp_path):
    """merge_model_params and with_defaults as the JAX package's."""
    from xpoint_tpu import config as jx_config
    mdir = tmp_path / "model"
    port_config.save_yaml({"model": {"type": "XPoint", "x": [1, 2]}},
                          str(mdir / "params.yaml"))
    base = {"model": {"type": "Other"}, "prediction": {"nms": 4}}
    for fn in ("merge_model_params",):
        assert getattr(port_config, fn)(base, str(mdir), "e3") == getattr(
            jx_config, fn)(base, str(mdir), "e3")
    default = {"a": {"b": 1, "c": [1]}, "d": 2}
    user = {"a": {"b": 3}, "e": None}
    assert port_config.with_defaults(default, user) == \
        jx_config.with_defaults(default, user)
    assert default == {"a": {"b": 1, "c": [1]}, "d": 2}


def _state(cfg=None, seed=0):
    module, _ = build_xpoint(cfg or CONFIG["model"], device="cpu", seed=seed)
    return TrainState(module, make_optimizer({"learningrate": 1e-3})[0])


def _fill(state, seed):
    """Give every tensor of a train state a distinct seeded value."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in state.module.state_dict().values():
            t.copy_(torch.rand(t.shape, generator=g))
        for flat in (state.optimizer.mu, state.optimizer.nu):
            flat.copy_(torch.rand(flat.shape, generator=g))
        state.optimizer.count.fill_(7)
        state.step.fill_(11)


def test_checkpoint_round_trip(tmp_path):
    """save then restore into a fresh state gives back module state,
    moments, count and step bit for bit; the epoch comes from the file or,
    where it is 0, from the e{N} name; latest_epoch finds the highest
    e{N}; an absent name gives (None, 0)."""
    a = _state()
    _fill(a, 1)
    ckpt.save(str(tmp_path), a, "e3", 3)
    ckpt.save(str(tmp_path), a, "e12", 0)
    ckpt.save(str(tmp_path), a, "latest", 5)
    for name, epoch in (("e3", 3), ("e12", 12), ("latest", 5)):
        b = _state(seed=9)
        restored, got = ckpt.restore(str(tmp_path), b, name)
        assert restored is b and got == epoch
        for x, y in zip(a.module.state_dict().values(),
                        b.module.state_dict().values()):
            assert torch.equal(x, y)
        for k in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(
                a.opt_state[k], b.opt_state[k]))
        assert int(b.opt_state["count"]) == 7 and int(b.step) == 11
    assert ckpt.latest_epoch(str(tmp_path)) == 12
    assert ckpt.restore(str(tmp_path), _state(), "e99") == (None, 0)


def test_load_model_round_trip(tmp_path):
    """load_model rebuilds the model of params.yaml and loads <version>.pt
    exactly; 'none' gives the seeded initialisation; model_override merges
    over the stored config; a reference .model checkpoint is converted
    as the JAX package converts it; a missing one raises
    FileNotFoundError."""
    ds = _Ones(4)
    t = Trainer({**CONFIG, "training": {"batchsize": 2}}, str(tmp_path),
                device="cpu", dataset=ds)
    _fill(t.state, 2)
    ckpt.save(str(tmp_path), t.state, "latest", 1)
    module, cfg = load_model(str(tmp_path), "latest", device="cpu")
    assert not module.training and cfg["multispectral"]
    for (k, x), y in zip(t.module.state_dict().items(),
                         module.state_dict().values()):
        assert torch.equal(x, y), k
    fresh, _ = load_model(str(tmp_path), "none", device="cpu")
    seeded, _ = build_xpoint(CONFIG["model"], device="cpu", seed=0)
    assert all(torch.equal(x, y) for x, y in zip(
        fresh.state_dict().values(), seeded.state_dict().values()))
    wide, cfg = load_model(str(tmp_path), "none", device="cpu",
                           model_override={"descriptor_head": True})
    assert cfg["descriptor_head"] and hasattr(wide, "descriptor_head")
    # a reference torch checkpoint of the same model loads, equal to the
    # JAX package's conversion of it (its BatchNorm statistics in both
    # spectra's slots of the port's SpectralBatchNorms)
    from test_torch_baselines import jax_conversion, reference_checkpoint
    sd = reference_checkpoint(module, 6)
    torch.save(sd, str(tmp_path / "ref.model"))
    ref, _ = load_model(str(tmp_path), "ref", device="cpu")
    want = jax_conversion(sd, CONFIG["model"], ref)
    for k, t in ref.state_dict().items():
        assert torch.equal(t, want[k]), k
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path), "e7", device="cpu")


class _Ones:
    """A single-image dataset of constant samples (image 32^2)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((32, 32, 1), 0.5, np.float32),
                "keypoints": np.zeros((32, 32), np.float32),
                "valid_mask": np.ones((32, 32), bool),
                "is_optical": np.array([True])}

    def returns_pair(self):
        return False


class _Indexed:
    """Samples that say which index they are, nested like a pair sample;
    raises at ``fail_at``."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"sample {i}")
        return {"optical": {"image": np.full((2, 3), i, np.float32)},
                "idx": np.array([i]), "name": f"s{i}"}


def _epochs(loader, n):
    return [[{"idx": b["idx"].ravel().tolist(), "name": b["name"],
              "image": b["optical"]["image"].copy()} for b in loader]
            for _ in range(n)]


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_dataloader_matches_jax(workers, shuffle, drop_last):
    """The same batches as the JAX DataLoader over three epochs at the same
    seed (shuffle, drop-last, nested collation, lists of names), with 1 and
    3 worker threads; len() as JAX's."""
    ds = _Indexed(11)
    kw = dict(batch_size=3, shuffle=shuffle, seed=5, drop_last=drop_last,
              workers=workers)
    mine, theirs = DataLoader(ds, **kw), JxDataLoader(ds, **kw)
    assert len(mine) == len(theirs) == (3 if drop_last else 4)
    a, b = _epochs(mine, 3), _epochs(theirs, 3)
    assert [[x["idx"] for x in e] for e in a] == \
        [[x["idx"] for x in e] for e in b]
    for ea, eb in zip(a, b):
        for x, y in zip(ea, eb):
            assert x["name"] == y["name"]
            np.testing.assert_array_equal(x["image"], y["image"])
    if shuffle:
        assert a[0] != a[1] or a[1] != a[2]


@pytest.mark.parametrize("workers", [1, 3])
def test_dataloader_worker_failure_matches_jax(workers):
    """A sample that raises reaches the consumer as the same exception at
    the same batch, after the same batches before it."""
    got = {}
    for name, cls in (("port", DataLoader), ("jax", JxDataLoader)):
        seen = []
        with pytest.raises(KeyError, match="sample 7"):
            for b in cls(_Indexed(12, fail_at=7), batch_size=2,
                         shuffle=False, workers=workers):
                seen.append(b["idx"].ravel().tolist())
        got[name] = seen
    assert got["port"] == got["jax"] == [[0, 1], [2, 3], [4, 5]]
    assert collate([{"a": np.zeros(2)}, {"a": np.ones(2)}])["a"].shape == \
        (2, 2)


def test_dicttools_match_jax(tmp_path):
    """dict_update, dict_to_obj, parse_primitives, div0 and
    get_new_filename give the JAX package's results."""
    d = {"a": {"b": 1, "c": {"d": 2}}, "e": [1]}
    u = {"a": {"c": {"d": 3, "f": 4}}, "e": None, "g": {"h": 5}}
    import copy
    assert port_utils.dict_update(copy.deepcopy(d), u) == \
        jx_dicttools.dict_update(copy.deepcopy(d), u)
    obj = port_utils.dict_to_obj({"a": {"b": [1, {"c": 2}]}})
    assert isinstance(obj, types.SimpleNamespace) and obj.a.b[1].c == 2
    assert vars(obj.a.b[1]) == vars(
        jx_dicttools.dict_to_obj({"a": {"b": [1, {"c": 2}]}}).a.b[1])
    prims = ["p", "q", "r"]
    for names in ("all", "q", ["p", "r"]):
        assert port_utils.parse_primitives(names, prims) == \
            jx_dicttools.parse_primitives(names, prims)
    with pytest.raises(AssertionError):
        port_utils.parse_primitives(["x"], prims)
    a = np.array([0.0, 1.0, 0.0, 2.0, -3.0])
    b = np.array([0.0, 0.0, 2.0, 4.0, 0.0])
    np.testing.assert_array_equal(port_utils.div0(a, b),
                                  jx_dicttools.div0(a, b))
    for name in ("x.h5", "x.h5", "y"):
        assert port_utils.get_new_filename(str(tmp_path), name) == \
            jx_dicttools.get_new_filename(str(tmp_path), name)
        (tmp_path / port_utils.get_new_filename(str(tmp_path), name)).touch()


def test_get_dataset_builds_the_host_datasets():
    """The host data path is ported: get_dataset raises where the JAX
    package's raises (a pair dataset without its files, an unknown type)
    and builds SyntheticShapes from its defaults."""
    from xpoint_tpu.data import get_dataset as jx_get_dataset
    for t in ("ImagePairDataset", "SatThermalGeoDataset", "Nope"):
        for fn in (get_dataset, jx_get_dataset):
            with pytest.raises(ValueError):
                fn({"type": t})
    ds = get_dataset({"type": "SyntheticShapes"})
    assert len(ds) == len(jx_get_dataset({"type": "SyntheticShapes"}))


def test_new_entry_points_default_to_cuda():
    assert inspect.signature(Trainer).parameters["device"].default == "cuda"
    assert inspect.signature(load_model).parameters["device"].default == \
        "cuda"
    assert os.path.basename(ckpt._path("d", "e1")) == "e1.pt"
