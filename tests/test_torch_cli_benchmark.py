"""The PyTorch port's benchmark entry point (python -m
xpoint_tpu_torch.cli.benchmark) on the CPU, over a small folder corpus
written by the test: its JSON has the JAX package's keys and nesting, and
its metrics equal the JAX package's compute_metrics on the same batches fed
the same forward arrays."""
import copy
import json
import os

import cv2
import numpy as np
import pytest

import jax
import torch

from xpoint_tpu.eval.benchmark import compute_metrics as jx_compute_metrics
from xpoint_tpu.eval.infer import XPointInference as JxInference

from xpoint_tpu_torch.cli import benchmark as cli
from xpoint_tpu_torch.config import load_yaml, save_yaml
from xpoint_tpu_torch.data import DataLoader, get_dataset
from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
from xpoint_tpu_torch.eval.infer import XPointInference
from xpoint_tpu_torch.geometry import ransac
from xpoint_tpu_torch.model_io import load_model
from xpoint_tpu_torch.models import build_xpoint

from test_torch_models import tiny_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PAIRS = 6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six 96^2 synthetic pairs as PNG files (optical/, thermal/)."""
    root = tmp_path_factory.mktemp("corpus")
    pairs = SyntheticPairs(n_pairs=N_PAIRS, size=96, n_kp=1, seed=4)
    for side, images in (("optical", pairs.optical),
                         ("thermal", pairs.thermal)):
        os.makedirs(root / side)
        for i, img in enumerate(images):
            cv2.imwrite(str(root / side / f"{i:04d}.png"),
                        np.round(img * 255).astype(np.uint8))
    return str(root)


def _config(corpus, tmp_path, **prediction):
    """configs/cipdp.yaml with its dataset pointed at the folder corpus,
    64^2 crops and the tiny model."""
    cfg = load_yaml(os.path.join(ROOT, "configs", "cipdp.yaml"))
    cfg["dataset"].update(foldername=corpus, filename=None, height=64,
                          width=64)
    cfg["prediction"].update(prediction)
    cfg["model"] = tiny_cfg()
    path = str(tmp_path / "eval.yaml")
    save_yaml(cfg, path)
    return path, cfg


def _save_model(model_dir, seed=3):
    """params.yaml and latest.pt of the tiny model with its hm head."""
    module, cfg = build_xpoint(tiny_cfg(), device="cpu", seed=seed)
    assert hasattr(module, "hm_regressor")
    save_yaml({"model": cfg}, os.path.join(model_dir, "params.yaml"))
    torch.save({"module": module.state_dict()},
               os.path.join(model_dir, "latest.pt"))
    return module


def _jax_gumbel(shape, generator, device):
    return torch.from_numpy(np.asarray(jax.random.gumbel(
        jax.random.PRNGKey(0), shape))).to(device)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if isinstance(tree, (list, dict)) else "num"


def _close(got, want, atol, rtol=0.0, path="json"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], atol, rtol, f"{path}[{k!r}]")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), atol=atol,
                                   rtol=rtol, err_msg=path)


@pytest.mark.parametrize("case", ["none", "latest", "device"])
def test_benchmark_cli_matches_jax_compute_metrics(corpus, tmp_path, case,
                                                   monkeypatch):
    """`-m none -v none` (the config's model, seed 0), `-m DIR -v latest`
    with disable_hmhead (the checkpoint loaded without its hm head), and
    `h_estimator: device` (both estimators handed JAX's noise of key 0):
    the JSON's keys are the JAX package's, and every metric equals JAX's
    compute_metrics on the same batches and forward arrays within 1e-6
    (the device estimator's corner errors within 1e-2 px plus 1e-3 of
    their value: its SVDs round differently in the two libraries, and the
    random model's poor fits magnify that)."""
    pred = {"detection_threshold": 0.015, "nms": 4}
    if case == "device":
        pred["h_estimator"] = "device"
        monkeypatch.setattr(ransac, "gumbel_noise", _jax_gumbel)
    yaml_path, cfg = _config(corpus, tmp_path, **pred)
    args = ["-y", yaml_path, "-e", "-o", str(tmp_path / "out"), "--device",
            "cpu", "--max-samples", "4", "-t", "5", "-mask"]
    if case == "latest":
        saved = _save_model(str(tmp_path))
        args += ["-m", str(tmp_path), "-v", "latest"]
    else:
        args += ["-m", "none", "-v", "none"]

    recorded = []
    forward = XPointInference.forward_pair

    def record(self, img_o, img_t):
        out = forward(self, img_o, img_t)
        recorded.append((img_o, img_t, out))
        return out
    monkeypatch.setattr(XPointInference, "forward_pair", record)
    out_path = cli.main(args)
    name = "latest" if case == "latest" else "none"
    assert os.path.basename(out_path) == \
        f"benchmark_{os.path.basename(args[args.index('-m') + 1])}_{name}" \
        "_s0.json"
    with open(out_path) as f:
        got = json.load(f)

    if case == "latest":
        module, _ = load_model(str(tmp_path), "latest", device="cpu",
                               model_override={"homography_regression_head":
                                               {"check": False}})
        assert not hasattr(module, "hm_regressor")
        want_sd = saved.state_dict()
        for k, v in module.state_dict().items():
            assert torch.equal(v, want_sd[k]), k

    # the same batches (samples are seeded by their index), fed to JAX's
    # compute_metrics with the port's forward arrays
    batches = list(DataLoader(cli._Head(get_dataset(cfg["dataset"]), 4),
                              batch_size=1, shuffle=False))
    assert len(recorded) == len(batches) == 4
    for batch, (img_o, img_t, _) in zip(batches, recorded):
        np.testing.assert_array_equal(batch["optical"]["image"], img_o)
        np.testing.assert_array_equal(batch["thermal"]["image"], img_t)
    replay = iter(r[2] for r in recorded)
    jx_infer = JxInference(None, None, cfg["prediction"])
    jx_infer.forward_pair = lambda a, b: next(replay)
    want = jx_compute_metrics(
        jx_infer, batches, cfg, threshold_repeatability=list(range(1, 11)),
        threshold_keypoints=list(range(1, 11)),
        threshold_warp=list(range(1, 11)), threshold_ransac=[2],
        verbose=False)
    want = json.loads(json.dumps(want, default=float))
    timing = got.pop("timing_seconds")
    assert set(timing) == {"two_forward", "nms", "interpolate"}
    assert all(len(v) == 5 for v in timing.values())   # 5 of 6 samples
    assert _keys(got) == _keys(want)
    assert sum(got["n_kp_optical"]) > 20
    assert got["n_kp_optical"] == want["n_kp_optical"]
    assert got["n_kp_thermal"] == want["n_kp_thermal"]
    if case == "device":
        h_got, h_want = got.pop("homography"), want.pop("homography")
        _close(h_got, h_want, 1e-2, 1e-3)
        assert h_want["2"]["average_h_error"] < 999
    _close(got, want, 1e-6)


def test_benchmark_cli_without_evaluation(corpus, tmp_path, capsys):
    """Without -e only the timing harness runs (the given indices) and no
    JSON is written; the entry point runs on the card unless asked."""
    yaml_path, _ = _config(corpus, tmp_path)
    assert cli.main(["-y", yaml_path, "-m", "none", "-v", "none", "-i", "1",
                     "3", "--device", "cpu", "-o",
                     str(tmp_path / "out")]) is None
    printed = capsys.readouterr().out
    for stage in ("two_forward", "nms", "interpolate", "total"):
        assert f"{stage}: " in printed and " Hz" in printed
    assert not os.path.exists(tmp_path / "out")
    assert cli.parse_args([]).device == "cuda"


def test_load_eval_setup_disable_hmhead_and_dataset(corpus, tmp_path):
    """load_eval_setup merges the variable YAML, drops the hm head when the
    prediction section asks, and builds the folder dataset in pair mode."""
    from xpoint_tpu_torch.cli._common import load_eval_setup
    yaml_path, _ = _config(corpus, tmp_path)
    variable = str(tmp_path / "variable.yaml")
    save_yaml({"prediction": {"nms": 2, "detection_threshold": 0.02}},
              variable)
    args = cli.parse_args(["-y", yaml_path, "-yv", variable, "-m", "none",
                           "-v", "none", "--device", "cpu"])
    config, module, infer, dataset = load_eval_setup(
        args, single_image_override=False)
    assert not hasattr(module, "hm_regressor")
    assert config["model"]["homography_regression_head"]["check"] is False
    assert infer.cfg["nms"] == 2 and infer.cfg["detection_threshold"] == 0.02
    assert len(dataset) == N_PAIRS and dataset.returns_pair()
    s = dataset[0]
    assert s["optical"]["image"].shape == (64, 64, 1)
    assert s["thermal"]["homography"].shape == (3, 3)
    ref = copy.deepcopy(config)
    ref["prediction"]["disable_hmhead"] = False
    ref["model"] = tiny_cfg()
    save_yaml(ref, str(tmp_path / "keep.yaml"))
    args.yaml_config, args.yaml_variable = str(tmp_path / "keep.yaml"), None
    _, module, _, _ = load_eval_setup(args)
    assert hasattr(module, "hm_regressor")
