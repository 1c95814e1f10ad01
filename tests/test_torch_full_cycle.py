"""The port's full-cycle tools against the JAX package's, on the CPU: the
mini corpus (gaps v1 and v2) and the cached synthetic set bit for bit, the
cycle's five config templates and its flags, the holdout sweep's summary,
and the cycle itself end to end on ``--device cpu`` through its stage
processes, writing a metrics JSON with the JAX file's keys and importing
no h5py in any stage."""
import argparse
import glob
import importlib.util
import json
import os
import random
import shutil
import sys

import cv2
import h5py
import numpy as np
import pytest
import yaml

from xpoint_tpu.data.synthetic_shapes import SyntheticShapes as JxShapes

from xpoint_tpu_torch.cli._common import RUN_REPORT_ENV
from xpoint_tpu_torch.data.group_file import open_group_file
from xpoint_tpu_torch.tools import full_cycle, holdout_sweep
from xpoint_tpu_torch.tools import make_mini_corpus as corpus
from xpoint_tpu_torch.tools.cycle_report import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A module of the JAX package's ``tools/`` (scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jx_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gap", ["v1", "v2"])
def test_mini_corpus_equals_jax_bit_for_bit(gap, tmp_path):
    """Three 128^2 pairs a split through the port's entry point against the
    JAX tool's write_split (its HDF5) from the same split seeds."""
    jx = _jax_tool("make_mini_corpus")
    corpus.main(["--out", str(tmp_path / "port"), "--n-train", "3",
                 "--n-test", "3", "--size", "128", "--gap", gap])
    for split, seed in (("training", 0), ("test", 1)):
        want = str(tmp_path / f"{split}.hdf5")
        jx.write_split(want, 3, np.random.default_rng(seed), (128, 128), gap)
        with h5py.File(want, "r") as a, \
                open_group_file(str(tmp_path / "port" / f"{split}.npz")) as b:
            assert b.keys() == list(a.keys()) == [
                f"sample_{i:04d}" for i in range(3)]
            for name in a.keys():
                assert b[name].keys() == ["optical", "thermal"]
                for side in ("optical", "thermal"):
                    x, y = a[name][side][...], b[name][side]
                    assert y.dtype == x.dtype == np.float32
                    np.testing.assert_array_equal(y, x, err_msg=name)
                assert b[name]["optical"].std() > 0.05


def test_mini_corpus_splits_are_written_alone(tmp_path):
    out = str(tmp_path / "c")
    corpus.main(["--out", out, "--n-test", "2", "--size", "64", "--splits",
                 "test"])
    assert os.listdir(out) == ["test.npz"]
    corpus.main(["--out", out, "--n-train", "1", "--size", "64",
                 "--splits", "train"])
    assert sorted(os.listdir(out)) == ["test.npz", "training.npz"]
    assert corpus.parse_args([]).out == "data/mini_corpus"


def test_synthetic_set_equals_jax_pregeneration(tmp_path):
    """The first 8 cached samples equal the JAX tool's inline
    pre-generation (random.seed(0); np.random.seed(0); one
    SyntheticShapes drawn in sequence), bit for bit."""
    path = str(tmp_path / "synthetic.npz")
    full_cycle.write_synthetic_set(path, 8)
    random.seed(0)
    np.random.seed(0)
    ds = JxShapes({"primitives": "all"})
    with open_group_file(path) as f:
        assert f.keys() == [f"s{i:05d}" for i in range(8)]
        for i in range(8):
            img, kp, _ = ds.generate_synthetic_image(i)
            image, points = f[f"s{i:05d}"]["image"], f[f"s{i:05d}"]["points"]
            assert image.dtype == np.uint8 and image.shape == (240, 320)
            np.testing.assert_array_equal(image,
                                          (img * 255).astype("uint8"))
            assert points.dtype == np.float32
            np.testing.assert_array_equal(points, np.asarray(kp, "float32"))


TEMPLATES = ["SYNTH_CFG", "EXPORT_CFG", "PAIR_CFG", "EVAL_CFG",
             "CLASSICAL_MODEL_CFG"]


@pytest.mark.parametrize("name", TEMPLATES)
def test_cycle_templates_parse_to_the_jax_ones(name):
    """Key for key the JAX tool's configs, each file .npz where JAX's is
    .hdf5."""
    jx = _jax_tool("full_cycle")
    fill = {"work": "/w", "synth_epochs": 3, "ha_num": 7, "export_det": 0.01,
            "pair_epochs": 9, "pair_lr": "3e-4", "use_sched": "true",
            "sched_gamma": 0.5, "sched_step": 300, "device_data": "true",
            "multispectral": "false", "hard_neg_check": "true",
            "hard_neg_tau": 0.1, "hard_neg_weight": 0.2,
            "hard_neg_keep_uniform": "true", "save_every": 0}

    def parse(tpl):
        for k, v in fill.items():
            tpl = tpl.replace("{%s}" % k, str(v))
        return yaml.safe_load(tpl)
    mine, theirs = getattr(full_cycle, name), getattr(jx, name)
    assert ".hdf5" not in mine
    assert mine.count(".npz") == theirs.count(".hdf5")
    assert parse(mine.replace(".npz", ".hdf5")) == parse(theirs)


def _jax_parser(tool, monkeypatch):
    """The argparse parser the JAX tool's main() builds."""
    class Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        raise Caught(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught) as exc:
        _jax_tool(tool).main()
    monkeypatch.undo()
    return exc.value.args[0]


@pytest.mark.parametrize("tool", ["full_cycle", "holdout_sweep",
                                  "make_mini_corpus"])
def test_tools_take_every_jax_flag(tool, monkeypatch):
    """The same flags with the same defaults; the port adds --device
    (cuda) to the tools that run a model, and keeps its outputs in the
    work directory (not the JAX side's committed metrics/)."""
    theirs = _jax_parser(tool, monkeypatch)
    mine = {"full_cycle": full_cycle, "holdout_sweep": holdout_sweep,
            "make_mini_corpus": corpus}[tool]
    parsed = mine.parse_args([])
    want = {a.dest: a.default for a in theirs._actions
            if a.dest != "help"}
    got = vars(parsed)
    moved = {"out", "work"} if tool != "make_mini_corpus" else set()
    assert set(got) - set(want) == ({"device"} if moved else set())
    assert set(want) <= set(got)
    for k in set(want) - moved:
        assert got[k] == want[k], k
    if moved:
        assert parsed.device == "cuda" and got["out"] is None
        assert os.path.basename(got["work"]) == "cycle"


def test_classical_baseline_is_not_ported(tmp_path, monkeypatch):
    """The classical stage (5a) alone, as ``--classical`` runs it, on a PNG
    folder corpus the test writes: ``cli.benchmark -m none -v none -e`` in
    a process of its own with the cycle's evaluation config and its SIFT
    model section; ``<out>_classical.json`` holds the JAX keys and nesting
    with finite values, and the process did not import h5py. (The name is
    kept from when ``--classical`` raised NotImplementedError.)"""
    from test_torch_cli_benchmark import _keys
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    root = tmp_path / "corpus"
    pairs = SyntheticPairs(n_pairs=3, size=96, n_kp=1, seed=4)
    for side, images in (("optical", pairs.optical),
                         ("thermal", pairs.thermal)):
        os.makedirs(root / side)
        for i, img in enumerate(images):
            cv2.imwrite(str(root / side / f"{i:04d}.png"),
                        np.round(img * 255).astype(np.uint8))
    body = (full_cycle.EVAL_CFG + full_cycle.CLASSICAL_MODEL_CFG).replace(
        "{work}", str(tmp_path))
    cfg = yaml.safe_load(body)
    cfg["dataset"].update(foldername=str(root), filename=None, height=96,
                          width=96)
    eval_yaml = str(tmp_path / "eval_classical.yaml")
    with open(eval_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    reports = tmp_path / "reports"
    monkeypatch.setenv("XPOINT_TORCH_RUN_REPORT", str(reports))
    out = full_cycle.classical_stage(
        [sys.executable, "-m", "xpoint_tpu_torch.cli.benchmark"], eval_yaml,
        str(tmp_path / "outputs_classical"),
        str(tmp_path / "m" / "metrics.json"), ["--device", "cpu"])
    assert out == str(tmp_path / "m" / "metrics_classical.json")
    with open(out) as f:
        res = json.load(f)
    assert set(res) >= {"repeatability", "descriptor", "homography",
                        "n_kp_optical", "n_kp_thermal", "timing_seconds"}
    assert _keys(res["descriptor"]["3"]) == {
        k: "num" for k in res["descriptor"]["3"]}
    assert res["homography"]["2"]["h_correctness"]["epsilon_warp_th3"] \
        is not None
    assert all(np.isfinite(v) for v in res["repeatability"].values())
    assert sum(res["n_kp_optical"]) > 0
    (report,) = [json.load(open(reports / n)) for n in os.listdir(reports)]
    assert report["stage"] == "benchmark" and not report["h5py_imported"]


def test_holdout_summary_equals_jax(tmp_path, monkeypatch):
    """Both tools over the same ten seed outputs (the JAX side's committed
    per-seed files, reused as done seeds): the same summary, equal to the
    committed summary.json."""
    work = tmp_path / "work"
    for seed in range(10):
        os.makedirs(work / f"holdout_s{seed}")
        shutil.copy(os.path.join(ROOT, "metrics", "holdout",
                                 f"mini_corpus_metrics_s{seed}.json"),
                    work / f"holdout_s{seed}" / "benchmark.json")
    got = holdout_sweep.main(["--work", str(work), "--device", "cpu"])
    with open(work / "holdout" / "summary.json") as f:
        got_file = json.load(f)
    monkeypatch.setattr(sys, "argv", [
        "holdout_sweep.py", "--work", str(work), "--out",
        str(tmp_path / "jx")])
    _jax_tool("holdout_sweep").main()
    with open(tmp_path / "jx" / "summary.json") as f:
        want = json.load(f)
    with open(os.path.join(ROOT, "metrics", "holdout", "summary.json")) as f:
        committed = json.load(f)
    assert got_file == want
    assert json.loads(json.dumps(got)) == want
    for key in holdout_sweep.SUMMARY_KEYS:
        np.testing.assert_allclose(want[key]["mean"],
                                   committed[key]["mean"], rtol=1e-12)
    for xs in ([0.5], [0.1, 0.3], list(np.linspace(0, 1, 12))):
        assert holdout_sweep.mean_ci(xs) == \
            _jax_tool("holdout_sweep").mean_ci(xs)


def _key_tree(tree):
    if isinstance(tree, dict):
        return {k: _key_tree(v) for k, v in tree.items()}
    return "list" if isinstance(tree, list) else "num"


def test_cycle_runs_end_to_end_on_cpu(tmp_path, monkeypatch):
    """Corpus -> synthetic set -> pretrain -> HA export -> pair training
    -> both sweeps, each stage a process of its own on the CPU at a tiny
    size: the metrics JSON has the JAX file's keys and nesting with finite
    values, the labels are .npz, no stage imported h5py; the holdout sweep
    over its model in one process and in processes of its own; and a
    rerun with --reuse-model --reuse-labels and a reused pretrain trains
    nothing."""
    work, reports = tmp_path / "w", tmp_path / "reports"
    monkeypatch.setenv(RUN_REPORT_ENV, str(reports))
    # two compute threads in each stage process: the suite runs beside
    # other test workers, and a stage that spins a thread per core beside
    # them took 680 s against 481 s with two
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    args = ["--work", str(work), "--n-train", "8", "--n-test", "2",
            "--size", "256", "--synth-epochs", "1", "--synth-samples", "16",
            "--pair-epochs", "1", "--ha-num", "3", "--device", "cpu"]
    res = full_cycle.main(args)
    with open(os.path.join(ROOT, "metrics", "mini_corpus_metrics.json")) as f:
        want = json.load(f)
    with open(work / "mini_corpus_metrics.json") as f:
        got = json.load(f)
    assert got == json.loads(json.dumps(res))
    assert _key_tree(got) == _key_tree(want)
    assert len(got["n_kp_optical"]) == 2
    for t in range(1, 11):
        assert 0.0 <= got["repeatability"][str(t)] <= 1.0
        for v in got["descriptor"][str(t)].values():
            assert np.isfinite(v) and 0.0 <= v <= 1.0
    for h in (got["homography"]["2"], got["homography_device"]["2"]):
        assert 0.0 <= h["average_h_error"] <= 999.0
    assert sorted(os.listdir(work / "corpus")) == ["test.npz", "training.npz"]
    assert os.path.exists(work / "pair-train" / "latest.pt")
    assert not glob.glob(str(work / "**" / "*.hdf5"), recursive=True)

    rep = report(str(work), str(reports))
    stages = [s["stage"] for s in rep["stages"]]
    assert stages == ["make_mini_corpus", "synthetic_set", "train",
                      "export_keypoints", "train", "benchmark", "benchmark"]
    assert not any(s["h5py_imported"] for s in rep["stages"])
    assert rep["labels"]["pairs"] == 8
    assert set(rep["labels"]) == {"pairs", "keypoints_optical",
                                  "keypoints_thermal"}

    # the holdout sweep on the cycle's model: in one process, seed 0 is
    # the cycle's own sweep (timings aside); a seed run as a process of
    # its own gives what the in-process run gave
    summary = holdout_sweep.main(["--work", str(work), "--seeds", "2",
                                  "--one-process", "--device", "cpu"])
    assert summary["n_seeds"] == 2
    # each seed draws its own evaluation warps
    assert summary["per_seed"][0] != summary["per_seed"][1]
    with open(glob.glob(str(work / "holdout_s0" / "*.json"))[0]) as f:
        s0 = json.load(f)
    for key in ("repeatability", "descriptor", "homography", "n_kp_optical",
                "n_kp_thermal"):
        assert s0[key] == got[key], key
    in_process = summary["per_seed"][1]
    shutil.rmtree(work / "holdout_s1")
    again = holdout_sweep.main(["--work", str(work), "--seeds", "2",
                                "--device", "cpu"])
    assert again["per_seed"][1] == in_process
    assert again["per_seed"][0] == summary["per_seed"][0]

    shutil.rmtree(reports)
    full_cycle.main(args + ["--reuse-model", "--reuse-labels",
                            "--reuse-synth", str(work / "synthetic-pretrain")])
    assert [s["stage"] for s in report(str(work), str(reports))["stages"]] \
        == ["make_mini_corpus", "benchmark", "benchmark"]
