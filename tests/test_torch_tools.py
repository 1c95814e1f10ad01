"""The port's measuring tools and small CLIs against the JAX package's files
of the same name, on the CPU: ``tools.op_sweep`` (its rewrite and grid),
``tools.make_multipoint_fixture`` (the committed HDF5 fixture, array for
array), the three ``show_*`` CLIs (the PNGs the JAX CLIs write, run here in
this process on the same input), ``cli.download_multipoint_data`` (no
network: existing files are kept and nothing is fetched),
``tools.parse_trace`` on a CPU ``torch.profiler`` trace, and
``tools.roofline`` / ``tools.stage_table`` at tiny sizes. Also the
committed pretrain (``xpoint_tpu_torch/pretrained/synth-pretrain``): the
parameters of the JAX package's orbax checkpoint
``artifacts/synth-pretrain`` carried through the bridge, bit for bit.

Exactness: the PNGs, arrays and rewritten files are compared for equality.
"""
import gzip
import os
import random
import runpy
import shutil
import sys
import types

import cv2
import h5py
import numpy as np
import pytest
import torch

from xpoint_tpu_torch.cli import (download_multipoint_data,
                                  show_image_pair_sample, show_keypoints,
                                  show_synthetic_images)
from xpoint_tpu_torch.data import SyntheticShapes
from xpoint_tpu_torch.data.group_file import open_group_file, write_groups
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.tools import (make_multipoint_fixture, op_sweep,
                                    parse_trace, roofline, stage_table)

from test_torch_models import tiny_cfg
from torch_env import torch_env  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(path):
    """A module of the JAX package's ``tools/`` or ``cli/`` by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jx_" + os.path.basename(path)[:-3], os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_cli(path, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [path] + argv)
    runpy.run_path(os.path.join(ROOT, path), run_name="__main__")


def _pngs(d):
    return {f: cv2.imread(os.path.join(d, f), cv2.IMREAD_UNCHANGED)
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def _assert_same_pngs(got_dir, want_dir, n):
    got, want = _pngs(got_dir), _pngs(want_dir)
    assert sorted(got) == sorted(want) and len(got) == n
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


# ---- op_sweep ----------------------------------------------------------

@pytest.mark.parametrize("point", [(0.005, 8, 512), (0.001, 4, 0)])
def test_op_sweep_rewrite_matches_jax(tmp_path, point):
    jx = _jax_tool("tools/op_sweep.py")
    src = os.path.join(ROOT, "configs", "cipdp.yaml")
    jx.rewrite(src, str(tmp_path / "jax.yaml"), *point)
    op_sweep.rewrite(src, str(tmp_path / "port.yaml"), *point)
    got = (tmp_path / "port.yaml").read_text()
    assert got == (tmp_path / "jax.yaml").read_text()
    assert f"detection_threshold: {point[0]}" in got
    assert op_sweep.DEFAULT_GRID == jx.DEFAULT_GRID
    assert op_sweep.parse_grid("0.01,8,0;0.001,4,512") == [
        (0.01, 8, 0), (0.001, 4, 512)]


# ---- the MULTIPOINT fixture ---------------------------------------------

@pytest.mark.parametrize("suffix", [".hdf5", ".npz"])
def test_multipoint_fixture_equals_the_jax_tools_file(tmp_path, suffix):
    """The committed tests/data/multipoint_micro.hdf5 is the JAX tool's
    output; the port's tool writes the same groups, arrays and dtypes."""
    out = str(tmp_path / f"fixture{suffix}")
    make_multipoint_fixture.main(["--out", out])
    with h5py.File(os.path.join(ROOT, "tests", "data",
                                "multipoint_micro.hdf5"), "r") as want, \
            open_group_file(out) as got:
        assert sorted(got.keys()) == sorted(want.keys())
        for name in want.keys():
            assert sorted(got[name].keys()) == sorted(want[name].keys())
            for ds in want[name].keys():
                w = np.asarray(want[name][ds])
                g = np.asarray(got[name][ds])
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


# ---- the show_* CLIs -----------------------------------------------------

@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """A 3-pair HDF5 dataset (one pair without a thermal image), a
    keypoint file with per-side sets and one with one set, and .npz copies
    of all three."""
    d = tmp_path_factory.mktemp("show")
    rng = np.random.default_rng(4)
    data, kps, kps_one = {}, {}, {}
    for i in range(3):
        g = data[f"sample_{i:04d}"] = {
            "optical": rng.uniform(size=(48, 64)).astype(np.float32)}
        if i != 1:
            g["thermal"] = rng.uniform(size=(48, 64)).astype(np.float32)
        kps[f"sample_{i:04d}"] = {
            "keypoints_optical": rng.uniform(0, 48, size=(7, 2)),
            "keypoints_thermal": rng.uniform(0, 48, size=(5, 2))}
        kps_one[f"sample_{i:04d}"] = {
            "keypoints": rng.integers(0, 48, size=(6, 2))}
    files = {}
    for tag, groups in (("data", data), ("kps", kps), ("kps_one", kps_one)):
        for suffix in (".hdf5", ".npz"):
            files[tag + suffix] = str(d / f"{tag}{suffix}")
            write_groups(files[tag + suffix], groups)
    return files


@pytest.mark.parametrize("n,kp_file", [(0, "kps"), (1, "kps_one"),
                                       (2, "kps")])
def test_show_keypoints_matches_jax(pair_files, tmp_path, monkeypatch, n,
                                    kp_file):
    want = tmp_path / "jax"
    _run_jax_cli("cli/show_keypoints.py", [
        "-d", pair_files["data.hdf5"], "-k", pair_files[kp_file + ".hdf5"],
        "-n", str(n), "-r", "3", "-o", str(want)], monkeypatch)
    for suffix in (".hdf5", ".npz"):
        got = tmp_path / f"port{suffix}"
        show_keypoints.main(["-d", pair_files["data" + suffix], "-k",
                             pair_files[kp_file + suffix], "-n", str(n),
                             "-r", "3", "-o", str(got)])
        _assert_same_pngs(got, want, 2)


@pytest.mark.parametrize("with_kps", [False, True])
def test_show_image_pair_sample_matches_jax(pair_files, tmp_path,
                                            monkeypatch, with_kps):
    kp = ["-k", pair_files["kps.hdf5"]] if with_kps else []
    want = tmp_path / "jax"
    _run_jax_cli("cli/show_image_pair_sample.py", [
        "-i", pair_files["data.hdf5"], *kp, "-n", "1", "-o", str(want)],
        monkeypatch)
    for suffix in (".hdf5", ".npz"):
        got = tmp_path / f"port{suffix}"
        kp = ["-k", pair_files["kps" + suffix]] if with_kps else []
        show_image_pair_sample.main(["-i", pair_files["data" + suffix], *kp,
                                     "-n", "1", "-o", str(got)])
        _assert_same_pngs(got, want, 1)


def test_show_synthetic_images_matches_jax(tmp_path, monkeypatch):
    """The JAX CLI draws its samples one after another from the global
    streams; here they are seeded, and the port's dataset is handed the
    same two streams for every sample (in place of its per-sample
    generators): the same images and keypoints, drawn."""
    want = tmp_path / "jax"
    np.random.seed(11)
    random.seed(11)
    _run_jax_cli("cli/show_synthetic_images.py",
                 ["-n", "2", "-o", str(want)], monkeypatch)
    streams = (np.random.RandomState(11), random.Random(11))
    monkeypatch.setattr(SyntheticShapes, "generators",
                        lambda self, index: streams)
    got = tmp_path / "port"
    show_synthetic_images.main(["-n", "2", "-o", str(got)])
    _assert_same_pngs(got, want, 2)


def test_show_synthetic_images_mask_flag_fails_as_in_jax(tmp_path,
                                                          monkeypatch):
    """``-m`` tints with ``(0, 0, 150) * 0.6``, a tuple times a float: the
    JAX CLI raises TypeError there, and the port keeps the defect."""
    with pytest.raises(TypeError):
        _run_jax_cli("cli/show_synthetic_images.py",
                     ["-n", "1", "-m", "-o", str(tmp_path / "jax")],
                     monkeypatch)
    with pytest.raises(TypeError):
        show_synthetic_images.main(["-n", "1", "-m", "-o",
                                    str(tmp_path / "port")])


def test_label_counts_read_hdf5_and_npz(pair_files):
    """tools.cycle_report.label_counts on the same keypoint groups in both
    files: the counts of each side's keypoints a pair."""
    from xpoint_tpu_torch.tools.cycle_report import label_counts
    want = {"pairs": 3,
            "keypoints_optical": {"mean": 7.0, "min": 7, "max": 7,
                                  "total": 21},
            "keypoints_thermal": {"mean": 5.0, "min": 5, "max": 5,
                                  "total": 15}}
    for suffix in (".hdf5", ".npz"):
        assert label_counts(pair_files["kps" + suffix]) == want


# ---- download -------------------------------------------------------------

def test_download_keeps_existing_files_without_the_network(tmp_path,
                                                           monkeypatch):
    """Every target exists: each is kept as it is, and requests is never
    used (a module standing in for it raises if it is)."""
    refuse = types.ModuleType("requests")

    def __getattr__(attr):
        raise AssertionError(f"requests.{attr} used: a download started")
    refuse.__getattr__ = __getattr__
    monkeypatch.setitem(sys.modules, "requests", refuse)
    names = ["test.hdf5", "training.hdf5", "labels_training.hdf5"]
    for n in names:
        (tmp_path / n).write_bytes(n.encode())
    out = download_multipoint_data.main(["-d", str(tmp_path)])
    assert out == [str(tmp_path / n) for n in names]
    for n in names:
        assert (tmp_path / n).read_bytes() == n.encode()
    jx = _jax_tool("cli/download_multipoint_data.py")
    assert download_multipoint_data.BASE_URL == jx.BASE_URL


# ---- parse_trace ----------------------------------------------------------

def test_parse_trace_of_a_cpu_profile(tmp_path, capsys):
    model, _ = build_xpoint(tiny_cfg(), device="cpu")
    x = torch.rand(1, 32, 32, 1)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            model(x, "optical")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    total, by_cat, by_name, counts = parse_trace.report(path, 2,
                                                        ("cpu_op",))
    assert total > 0 and set(by_cat) == {"cpu_op"}
    assert abs(sum(by_cat.values()) - total) < 1e-6
    assert parse_trace.launches(counts, "aten::conv2d") % 2 == 0
    assert parse_trace.launches(counts, "aten::conv2d") > 0
    out = capsys.readouterr().out
    assert "total device op time" in out and "top 25 ops:" in out
    # the device's categories: none in a CPU trace
    assert parse_trace.summarize(parse_trace.load_events(path))[0] == 0.0
    # a gzipped trace in a directory, found and read alike
    with open(path, "rb") as f, gzip.open(tmp_path / "d.json.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(path)
    found = parse_trace.find_trace(str(tmp_path))
    assert found.endswith("d.json.gz")
    assert parse_trace.main([str(tmp_path), "--categories", "cpu_op"])[0] \
        == pytest.approx(total)


# ---- roofline and stage_table at tiny sizes ----------------------------

@pytest.fixture(scope="module")
def tiny_model():
    model, _ = build_xpoint(tiny_cfg(), device="cpu")
    return model.eval()


def test_roofline_probe(tiny_model):
    rows = []
    enc = tiny_model.encoder
    blk = enc.layers_0_blocks_0
    ms = roofline.probe("stage0_blocks(1)", blk,
                        lambda: torch.rand(2, 16, 16, 24), rows, 1e9, n=2)
    (row,) = rows
    assert row["ms"] == ms > 0 and row["kernel_launches"] == 1
    assert row["bound"] in ("tensor", "fp32", "hbm", "sfu")
    assert row["bound_ms"] == max(row[f"t_{k}_ms"]
                                  for k in ("tensor", "fp32", "hbm", "sfu"))
    assert row["gflop"] > 0 and row["mb"] > 0 and row["transc_m"] > 0
    assert roofline.calibrate_exp_rate("cpu", n=1 << 12, chain=2) > 0


def test_stage_tables(tiny_model):
    host = stage_table.host_staged_table(tiny_model, 64, 64, n_samples=2)
    assert set(host) == {"two_forward", "nms", "interpolate"}
    assert all(len(v) == 2 and min(v) >= 0 for v in host.values())
    calls = []
    stages, cumulative, call_ms = stage_table.on_device_table(
        tiny_model, 2, 64, 64, k=64, n_iters=2,
        call=lambda a, b: calls.append(a.shape))
    names = ["two_forward", "nms", "interpolate", "match"]
    assert list(stages) == list(cumulative) == names
    assert all(v >= 0 for v in stages.values())
    assert cumulative["match"] > 0
    # the whole-pipeline calls: one warm-up, then CALLS_PER_ROUND after
    # each round of streams, each timed
    n = stage_table.STREAMS * stage_table.CALLS_PER_ROUND
    assert len(calls) == n + 1 and len(call_ms) == n
    assert all(c == (2, 64, 64, 1) for c in calls) and min(call_ms) >= 0


# ---- the committed pretrain -------------------------------------------------

def test_committed_pretrain_is_the_orbax_checkpoint():
    """xpoint_tpu_torch/pretrained/synth-pretrain/latest.pt holds the
    parameters and statistics of artifacts/synth-pretrain's orbax
    checkpoint, restored by the JAX model_io and carried through the bridge
    into the model its params.yaml builds: every tensor bit for bit."""
    import jax
    from xpoint_tpu.model_io import load_model as jx_load_model
    from xpoint_tpu_torch.compat.from_flax import load_flax_variables
    from xpoint_tpu_torch.config import load_yaml
    src = os.path.join(ROOT, "artifacts", "synth-pretrain")
    dst = os.path.join(ROOT, "xpoint_tpu_torch", "pretrained",
                       "synth-pretrain")
    with open(os.path.join(src, "params.yaml")) as a, \
            open(os.path.join(dst, "params.yaml")) as b:
        assert a.read() == b.read()
    _, v, _ = jx_load_model(src, "latest")
    tm, _ = build_xpoint(load_yaml(os.path.join(dst, "params.yaml"))["model"],
                         device="cpu")
    load_flax_variables(tm, jax.device_get(v))
    want = tm.state_dict()
    got = torch.load(os.path.join(dst, "latest.pt"), map_location="cpu",
                     weights_only=True)["module"]
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
