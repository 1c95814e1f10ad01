"""The port's entry points (python -m xpoint_tpu_torch.cli.<name>) on the
CPU, on the tiny fp32 VMamba XPoint bridged from flax and saved as a model
directory, over a small .npz mini corpus: each one's output against the
JAX function it calls, fed the same batches, with the tolerances
test_torch_eval.py holds for the same functions (each package's own
forward: the same keypoints and every metric within 1e-4); cli.train's checkpoints and bit-equal resume;
cli.export_keypoints' resume (-skip) and backups."""
import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

from xpoint_tpu.eval.evaluation import (
    compute_descriptor_metrics as jx_descriptor_metrics,
    compute_repeatability_multispectral as jx_repeatability)
from xpoint_tpu.eval.infer import XPointInference as JxInference
from xpoint_tpu.eval.metrics import estimate_homography as jx_estimate

from xpoint_tpu_torch.cli import (demo, export_keypoints, predict_keypoints,
                                  predict_align_image_pair, train)
from xpoint_tpu_torch.cli._common import load_eval_setup
from xpoint_tpu_torch.compat.from_flax import load_flax_variables
from xpoint_tpu_torch.config import save_yaml
from xpoint_tpu_torch.data import DataLoader, get_dataset
from xpoint_tpu_torch.data.group_file import open_group_file
from xpoint_tpu_torch.data.group_file import write_npz_groups
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.selfsup.export import NumpySink
from xpoint_tpu_torch.selfsup.export import export_keypoints as export_lib
from xpoint_tpu_torch.tools import full_cycle
from xpoint_tpu_torch.tools import make_mini_corpus as corpus

from test_torch_models import _jax_tiny_model, tiny_cfg
from torch_env import torch_env  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRED = {"nms": 4, "detection_threshold": 0.015, "topk": 0,
        "disable_hmhead": True, "reprojection_threshold": 3,
        "matching": {"method": "bfmatcher",
                     "method_kwargs": {"crossCheck": True}}}
HOMOGRAPHIC = {"enable": True, "valid_border_margin": 4, "params": {
    "translation": True, "rotation": True, "scaling": True,
    "perspective": True, "scaling_amplitude": 0.1,
    "perspective_amplitude_x": 0.05, "perspective_amplitude_y": 0.05,
    "patch_ratio": 0.9, "max_angle": 1.57, "allow_artifacts": True}}
N_PAIRS = 4
METRIC_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tiny model in both packages (the same weights), its model
    directory, and a 4-pair 64^2 mini corpus with its eval config."""
    root = tmp_path_factory.mktemp("cli")
    jm, v = _jax_tiny_model()
    tm, cfg = build_xpoint(tiny_cfg(), device="cpu")
    load_flax_variables(tm, v)
    model_dir = str(root / "model")
    os.makedirs(model_dir)
    save_yaml({"model": cfg}, os.path.join(model_dir, "params.yaml"))
    torch.save({"module": tm.state_dict()},
               os.path.join(model_dir, "latest.pt"))
    corpus.main(["--out", str(root / "corpus"), "--n-test", str(N_PAIRS),
                 "--size", "64", "--splits", "test"])
    config = {"dataset": {"type": "ImagePairDataset",
                          "filename": str(root / "corpus" / "test.npz"),
                          "single_image": False,
                          "augmentation": {"homographic": HOMOGRAPHIC}},
              "prediction": PRED}
    yaml_path = str(root / "eval.yaml")
    save_yaml(config, yaml_path)
    return {"root": root, "jm": jm, "v": v, "model_dir": model_dir,
            "yaml": yaml_path, "config": config}


def _batches(config):
    """The batches the port's loops see: samples seeded by their index."""
    return list(DataLoader(get_dataset(config["dataset"]), batch_size=1,
                           shuffle=False))


def assert_close(got, want, atol, path="result"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], atol, f"{path}[{k!r}]")
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), atol=atol,
                                   rtol=0, err_msg=path)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jx_cli_{name}", os.path.join(ROOT, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cli", [train, export_keypoints, predict_keypoints,
                                 predict_align_image_pair])
def test_entry_points_default_to_the_card(cli):
    required = {train: ["-y", "c.yaml"],
                export_keypoints: ["-o", "l.npz"]}.get(cli, [])
    assert cli.parse_args(required).device == "cuda"


def test_demo_defaults_to_the_card():
    assert demo.parse_args(["--visible", "a", "--other", "b"]).device \
        == "cuda"


def test_seed_flag_reaches_the_evaluation_draws(setup):
    """-s seeds the dataset's draws (the evaluation warps), as set_seeds
    seeds the global streams the JAX datasets draw from: the same seed
    gives the same samples, another seed other warps; the default is the
    dataset's own seed 0."""
    from xpoint_tpu_torch.cli import benchmark

    def homographies(seed):
        args = benchmark.parse_args(["-y", setup["yaml"], "-m",
                                     setup["model_dir"], "-s", str(seed),
                                     "--device", "cpu"])
        _, _, _, ds = load_eval_setup(args, single_image_override=False)
        return [np.concatenate([ds[i]["optical"]["homography"],
                                ds[i]["thermal"]["homography"]])
                for i in range(N_PAIRS)]
    plain = get_dataset(setup["config"]["dataset"])
    s0, s1 = homographies(0), homographies(1)
    for i in range(N_PAIRS):
        np.testing.assert_array_equal(s0[i], np.concatenate([
            plain[i]["optical"]["homography"],
            plain[i]["thermal"]["homography"]]))
        np.testing.assert_array_equal(homographies(1)[i], s1[i])
    assert all(not np.array_equal(a, b) for a, b in zip(s0, s1))


def test_predict_keypoints_evaluation_matches_jax(setup, tmp_path):
    """-e: repeatability.json against JAX's
    compute_repeatability_multispectral on the same batches."""
    out = predict_keypoints.main([
        "-y", setup["yaml"], "-m", setup["model_dir"], "-e", "-t", "3",
        "-o", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "repeatability.json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(out))
    jx = JxInference(setup["jm"], setup["v"], PRED)
    mean_rep, reps, n_o, n_t = jx_repeatability(
        jx, _batches(setup["config"]), setup["config"], distance_thresh=3)
    assert got["n_kp_optical"] == n_o and got["n_kp_thermal"] == n_t
    assert sum(n_o) > 20
    assert_close(got["repeatability"], mean_rep, METRIC_ATOL)
    assert_close(got["per_sample"], list(map(float, reps)), METRIC_ATOL)


@pytest.mark.parametrize("mask", [False, True])
def test_predict_keypoints_sample_matches_jax(setup, tmp_path, mask):
    """One sample: the keypoints of both spectra equal JAX's forward ->
    nms -> keypoints_from_prob on the same images; -p draws them."""
    argv = ["-y", setup["yaml"], "-m", setup["model_dir"], "-i", "2", "-p",
            "-o", str(tmp_path), "--device", "cpu"] + (["-mask"] if mask
                                                       else [])
    kp_o, kp_t = predict_keypoints.main(argv)
    sample = get_dataset(setup["config"]["dataset"])[2]
    jx = JxInference(setup["jm"], setup["v"], PRED)
    prob_o, prob_t, _, _, _ = jx.forward_pair(
        sample["optical"]["image"][None], sample["thermal"]["image"][None])
    for got, prob, side in ((kp_o, prob_o, "optical"),
                            (kp_t, prob_t, "thermal")):
        m = (np.asarray(sample[side]["valid_mask"], np.float32) if mask
             else None)
        want = jx.keypoints_from_prob(jx.nms(prob)[0], m)
        np.testing.assert_array_equal(got, want)
        assert len(got) > 0
        assert cv2.imread(str(tmp_path / f"keypoints_{side}_i2.png")) \
            .shape == (64, 64, 3)


@pytest.mark.parametrize("estimator", ["magsac", "device"])
def test_predict_align_evaluation_matches_jax(setup, tmp_path, estimator,
                                              monkeypatch):
    """-e: <model>_<version>_results.json against JAX's
    compute_descriptor_metrics on the same batches (the device estimator
    handed JAX's noise, its corner errors within 1e-2 px as
    test_torch_eval.py holds them)."""
    config = json.loads(json.dumps(setup["config"]))
    if estimator == "device":
        from xpoint_tpu_torch.geometry import ransac
        import jax
        config["prediction"]["h_estimator"] = "device"
        monkeypatch.setattr(ransac, "gumbel_noise", lambda shape, g, d: (
            torch.from_numpy(np.array(jax.random.gumbel(
                jax.random.PRNGKey(0), shape))).to(d)))
    yaml_path = str(tmp_path / "eval.yaml")
    save_yaml(config, yaml_path)
    got = predict_align_image_pair.main([
        "-y", yaml_path, "-m", setup["model_dir"], "-e", "-tk", "3",
        "-th", "3", "-o", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "model_latest_results.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    jx = JxInference(setup["jm"], setup["v"], config["prediction"])
    want = jx_descriptor_metrics(jx, _batches(config), config["prediction"],
                                 threshold_keypoints=3, threshold_warp=3)
    want = json.loads(json.dumps(
        {k: (v.tolist() if isinstance(v, np.ndarray) else v)
         for k, v in want.items() if k != "H_est"}, default=float))
    assert set(got) == set(want)
    assert want["nn_map"] > 0
    h_keys = {"h_correctness", "average_h_error", "pts_dist"}
    for k in set(want) - h_keys:
        assert_close(got[k], want[k], METRIC_ATOL, k)
    assert_close({k: got[k] for k in h_keys}, {k: want[k] for k in h_keys},
                 METRIC_ATOL if estimator == "magsac" else 1e-2)


def test_predict_align_sample_matches_jax(setup, tmp_path):
    """One sample: keypoints, matches and MAGSAC's homography against
    JAX's chain on the same images; -p draws the matches."""
    kp_o, kp_t, matches, H = predict_align_image_pair.main([
        "-y", setup["yaml"], "-m", setup["model_dir"], "-i", "1", "-p",
        "-o", str(tmp_path), "--device", "cpu"])
    sample = get_dataset(setup["config"]["dataset"])[1]
    jx = JxInference(setup["jm"], setup["v"], PRED)
    prob_o, prob_t, desc_o, desc_t, _ = jx.forward_pair(
        sample["optical"]["image"][None], sample["thermal"]["image"][None])
    want_o = jx.keypoints_from_prob(jx.nms(prob_o)[0])
    want_t = jx.keypoints_from_prob(jx.nms(prob_t)[0])
    np.testing.assert_array_equal(kp_o, want_o)
    np.testing.assert_array_equal(kp_t, want_t)
    d_o = jx.descriptors_at(want_o, desc_o[0], (64, 64))
    d_t = jx.descriptors_at(want_t, desc_t[0], (64, 64))
    want_m = jx.match(d_o, d_t)
    assert [m[:2] for m in matches] == [m[:2] for m in want_m]
    assert len(matches) >= 4
    np.testing.assert_allclose([m[2] for m in matches],
                               [m[2] for m in want_m], atol=METRIC_ATOL)
    want_H, _ = jx_estimate(
        np.float32([want_o[q][::-1] for q, t, d in want_m]),
        np.float32([want_t[t][::-1] for q, t, d in want_m]), 3,
        match_distances=[d for q, t, d in want_m])
    assert (H is None) == (want_H is None)
    if H is not None:
        np.testing.assert_allclose(H, want_H, atol=1e-6)
    assert os.path.exists(tmp_path / "matches_i1.png")


@pytest.mark.parametrize("plot", [False, True])
def test_demo_matches_jax(setup, tmp_path, plot):
    """The demo on two PNGs of a corpus pair: its metrics (all but the
    runtimes) against the JAX demo's compute_metrics over JAX's chain on
    the same images; the images it writes, and with --plot the alignment
    figure and metrics.json."""
    sample = get_dataset(dict(setup["config"]["dataset"],
                              augmentation={}))[0]
    paths = []
    for side in ("optical", "thermal"):
        paths.append(str(tmp_path / f"{side}.png"))
        cv2.imwrite(paths[-1], np.round(
            sample[side]["image"][..., 0] * 255).astype(np.uint8))
    out = str(tmp_path / "demo")
    argv = ["--visible", paths[0], "--other", paths[1], "--config",
            setup["yaml"], "--model-dir", setup["model_dir"], "--output",
            out, "--device", "cpu"] + (["--plot"] if plot else [])
    metrics, H = demo.main(argv)

    jd = _jax_cli("demo")
    jx = JxInference(setup["jm"], setup["v"], PRED)
    visible = jd.load_gray(paths[0])
    other = jd.load_gray(paths[1], size=visible.shape[:2])
    prob_o, prob_t, desc_o, desc_t, _ = jx.forward_pair(
        visible[None, ..., None], other[None, ..., None])
    kp_o = jx.keypoints_from_prob(jx.nms(prob_o)[0])
    kp_t = jx.keypoints_from_prob(jx.nms(prob_t)[0])
    matches = jx.match(jx.descriptors_at(kp_o, desc_o[0], (64, 64)),
                       jx.descriptors_at(kp_t, desc_t[0], (64, 64)))
    H_want, inliers = None, None
    if len(matches) >= 4:
        H_want, inliers = jx_estimate(
            np.float32([kp_o[q][::-1] for q, t, d in matches]),
            np.float32([kp_t[t][::-1] for q, t, d in matches]), 3,
            match_distances=[d for q, t, d in matches])
    want = jd.compute_metrics(matches, kp_o, kp_t, H_want, inliers, {},
                              visible.shape[:2])
    assert metrics["keypoints"] == want["keypoints"]
    assert metrics["keypoints"]["n_matches"] >= 4
    assert metrics["homography"] == want["homography"]
    for k in ("matching_score", "repeatability", "match_statistics"):
        assert_close(metrics[k], want[k], METRIC_ATOL, k)
    assert set(metrics["runtime"]) == set(want["runtime"])
    assert (H is None) == (H_want is None)
    written = set(os.listdir(out))
    assert {"matches.png"} <= written
    assert ("registered_checkerboard.png" in written) == (H is not None)
    if plot:
        assert {"alignment.png", "metrics.json"} <= written
        with open(os.path.join(out, "metrics.json")) as f:
            saved = json.load(f)
        assert saved["keypoints"] == want["keypoints"]
    else:
        assert "metrics.json" not in written


def _train_setup(root):
    """A cached synthetic set of 8 small samples and the cycle's pretrain
    config (two CNN encoders) at batch 4 on it."""
    rng = np.random.default_rng(0)
    write_npz_groups(str(root / "synthetic.npz"), {
        f"s{i:05d}": {"image": rng.integers(0, 256, (64, 80), np.uint8),
                      "points": rng.uniform(0, 60, (10, 2)).astype(
                          np.float32)} for i in range(8)})
    body = full_cycle.SYNTH_CFG.replace("{work}", str(root)).replace(
        "{synth_epochs}", "2").replace("batchsize: 16", "batchsize: 4")
    body = body.replace("    on-the-fly: false\n",
                        "    on-the-fly: false\n    image_size: [64, 80]\n")
    path = str(root / "synth.yaml")
    with open(path, "w") as f:
        f.write(body)
    return path


def test_train_writes_latest_and_resumes_bit_equal(tmp_path, capsys):
    """Two epochs straight against one epoch, then --resume for the second
    in another directory: the same latest.pt bit for bit; -w takes a .pt
    (every tensor) and a reference checkpoint (converted), and refuses an
    orbax checkpoint."""
    cfg = _train_setup(tmp_path)
    straight = str(tmp_path / "straight")
    train.main(["-y", cfg, "-o", straight, "--device", "cpu"])
    assert sorted(os.listdir(straight)) == ["latest.pt", "params.yaml"]
    split = str(tmp_path / "split")
    train.main(["-y", cfg, "-o", split, "-e", "1", "--device", "cpu"])
    trainer = train.main(["-y", cfg, "-o", split, "-e", "2", "--resume",
                          "--device", "cpu"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert trainer.start_epoch == 1
    a = torch.load(os.path.join(straight, "latest.pt"), weights_only=True)
    b = torch.load(os.path.join(split, "latest.pt"), weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    for k, v in a["module"].items():
        assert torch.equal(v, b["module"][k]), k

    tuned = train.main(["-y", cfg, "-o", str(tmp_path / "tuned"), "-e", "1",
                        "--max-steps", "1", "-w",
                        os.path.join(straight, "latest.pt"),
                        "--device", "cpu"])
    assert "0 missing" in capsys.readouterr().out
    assert tuned.state is not None
    with pytest.raises(NotImplementedError):
        train.main(["-y", cfg, "-o", str(tmp_path / "bad"), "-w",
                    "weights.ckpt", "--device", "cpu"])
    # a reference checkpoint of the same model (per-spectrum statistics
    # filled from its one set): every tensor converted and taken
    from test_torch_baselines import reference_checkpoint
    ref_path = str(tmp_path / "weights.model")
    torch.save(reference_checkpoint(tuned.module, 2), ref_path)
    train.main(["-y", cfg, "-o", str(tmp_path / "ref"), "-e", "1",
                "--max-steps", "1", "-w", ref_path, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "0 missing" in printed and "0 unexpected" in printed


def test_export_keypoints_resumes_without_exporting_twice(setup, tmp_path,
                                                          capsys):
    """The export entry point equals the library loop on the same seed;
    -skip exports only what the file lacks (no sample twice), -f 1 keeps a
    backup, and the .npz labels are what the port's dataset reads."""
    cfg = dict(setup["config"], homographic_adaptation={
        "num": 3, "aggregation": "window", "min_count": 1,
        "erosion_radius": 2})
    cfg["dataset"] = dict(cfg["dataset"], augmentation={})
    yaml_path = str(tmp_path / "export.yaml")
    save_yaml(cfg, yaml_path)
    out = str(tmp_path / "labels.npz")
    argv = ["-y", yaml_path, "-o", out, "-m", setup["model_dir"],
            "--device", "cpu", "-s", "3"]
    assert export_keypoints.main(argv + ["--max-samples", "2"]) == 2
    with open_group_file(out) as f:
        first = {n: f[n]["keypoints_optical"] for n in f.keys()}
    assert len(first) == 2 and os.path.exists(out + ".bak")

    written = []
    write = NumpySink.write

    def count(self, name, arrays):
        written.append(name)
        return write(self, name, arrays)
    NumpySink.write = count
    try:
        assert export_keypoints.main(argv + ["-skip"]) == N_PAIRS - 2
        assert "skipping 2 already-processed samples" in \
            capsys.readouterr().out
        assert export_keypoints.main(argv + ["-skip"]) == 0
    finally:
        NumpySink.write = write
    assert sorted(written) == [f"sample_{i:04d}" for i in range(2, N_PAIRS)]

    # the whole export at once from the library, same seed and batches:
    # one homography stack a batch, so the resumed run's later samples
    # were drawn from a fresh generator; compare the first two
    config, module, _, dataset = load_eval_setup(
        export_keypoints.parse_args(argv), single_image_override=False)
    ref = NumpySink()
    export_lib(module, dataset, ref, cfg["homographic_adaptation"],
               config["prediction"], seed=3)
    with open_group_file(out) as f:
        assert f.keys() == [f"sample_{i:04d}" for i in range(N_PAIRS)]
        for name in first:
            for side in ("optical", "thermal"):
                np.testing.assert_array_equal(
                    f[name][f"keypoints_{side}"],
                    ref.groups[name][f"keypoints_{side}"])
    labelled = get_dataset(dict(cfg["dataset"], keypoints_filename=out))
    assert labelled[0]["optical"]["keypoints"].shape == (64, 64)
