"""The port's spans and counters (``xpoint_tpu_torch.obs``): off by default
and free of the profiler's machinery; under a profiler the pipeline's span
tree on the profiler's own clock; self times, the Chrome export and the
ring of root calls; K2's plane-sweep counter on the plain path and, on the
card, in the resident kernel; the profile tools' busy time.

The card's case skips without one; run it there with

    python -m pytest --noconftest tests/test_torch_obs.py -q
"""
import copy
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xpoint_tpu_torch import obs
from xpoint_tpu_torch.eval import make_pair_pipeline
from xpoint_tpu_torch.eval.profile_pipeline import device_busy_ms
from xpoint_tpu_torch.models import VMAMBA_MODEL_CFG, build_xpoint
from xpoint_tpu_torch.ops.nms import (_grid_nms_keep_async, box_nms_extract,
                                      grid_nms_keep,
                                      grid_nms_keep_cluster_mirror,
                                      grid_nms_keep_plain, last_launch_shape)
from torch_env import torch_env  # noqa: F401 (autouse)

# the profiler's first range of a session carries its one-off entry cost
# (~0.25 ms on an idle CPU), so the clock check warms the session first
CLOCK_NS = 500_000
PIPE_SPANS = ("xp.pipe.forward", "xp.pipe.detect", "xp.pipe.nms",
              "xp.pipe.describe", "xp.pipe.match")


@pytest.fixture(autouse=True)
def fresh_obs():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _pipeline():
    """The tiny fp32 VMamba XPoint's pipeline on two 64 x 64 pairs."""
    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"].update(
        DEPTHS=[1, 1, 1, 1], EMBED_DIM=24)
    cfg["descriptor_size"] = 32
    cfg["mixed_precision"] = False
    module, _ = build_xpoint(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(3)
    imgs = [torch.rand(2, 64, 64, 1, generator=g) for _ in range(2)]
    return make_pair_pipeline(module, (64, 64), k=64), imgs


def _profiled_call(pipe, imgs):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):
            pass
        pipe(*imgs)
    return prof


def test_off_keeps_nothing_and_enters_nothing(monkeypatch):
    pipe, imgs = _pipeline()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert obs.span("xp.pipe.nms") is obs.span("xp.x", a=1) is obs._NOOP
    pipe(*imgs)
    assert obs.spans() == []
    calls = obs.calls()
    assert [c["name"] for c in calls] == ["xp.pipe.call"]
    assert not calls[0]["profiled"]
    assert calls[0]["host_end"] > calls[0]["host_start"]


def test_span_tree_on_the_profilers_clock(tmp_path):
    pipe, imgs = _pipeline()
    pipe(*imgs)
    prof = _profiled_call(pipe, imgs)
    spans = obs.spans()
    by_id = {s["id"]: s for s in spans}
    names = {s["name"] for s in spans}
    roots = [s for s in spans if s["name"] == "xp.pipe.call"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    root = roots[0]
    assert root["profiled"] and root["attrs"] == {"batch": 2}
    assert all(s["call"] == root["id"] for s in spans)
    assert set(PIPE_SPANS) | {"xp.model.encode", "xp.model.heads",
                              "xp.enc.norm", "xp.enc.scan", "xp.enc.mlp",
                              "xp.k.selective_scan_bidir",
                              "xp.k.nms_sweep"} <= names

    def parent(s):
        return by_id[s["parent"]]["name"]

    for s in spans:
        if s["name"] in PIPE_SPANS:
            assert parent(s) == "xp.pipe.call"
        elif s["name"].startswith("xp.model."):
            assert parent(s) == "xp.pipe.forward"
    assert {s["attrs"]["spectrum"] for s in spans
            if s["name"] == "xp.pipe.forward"} == {"optical", "thermal"}
    for name, outer in (("xp.k.selective_scan_bidir", "xp.enc.scan"),
                        ("xp.k.nms_sweep", "xp.pipe.nms")):
        assert {parent(s) for s in spans if s["name"] == name} == {outer}
    nms = next(s for s in spans if s["name"] == "xp.k.nms_sweep")
    assert nms["attrs"] == {"planes": 4, "height": 64, "width": 64,
                            "size": 8, "iou": 0.1}
    # the encoder's spans lie inside xp.model.encode, never in the heads
    for s in spans:
        if s["name"].startswith("xp.enc."):
            up = s
            while not up["name"].startswith("xp.model."):
                up = by_id[up["parent"]]
            assert up["name"] == "xp.model.encode"

    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("xp."):
            start = e["ts"] * 1e3 + base
            ranges.setdefault(e["name"], []).append(
                (start, start + e["dur"] * 1e3))
    assert set(ranges) == names
    for name, found in ranges.items():
        mine = sorted((s["host_start"], s["host_end"]) for s in spans
                      if s["name"] == name)
        assert len(mine) == len(found), name
        for (s0, s1), (t0, t1) in zip(mine, sorted(found)):
            assert abs(s0 - t0) < CLOCK_NS and abs(s1 - t1) < CLOCK_NS, name


def test_self_time_is_the_duration_less_the_children():
    pipe, imgs = _pipeline()
    _profiled_call(pipe, imgs)
    spans = obs.spans()
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    for s in spans:
        inner = sum(k["host_end"] - k["host_start"]
                    for k in kids.get(s["id"], ()))
        assert s["self_ns"] == s["host_end"] - s["host_start"] - inner
        assert s["self_ns"] >= 0 and s["dev_self_ns"] is None
    # overlapping children are counted once
    assert obs._covered(0, 10, [(2, 6), (4, 8), (9, 20)]) == 7


def test_export_chrome_loads_as_json(tmp_path):
    pipe, imgs = _pipeline()
    obs.enable()
    pipe(*imgs)
    spans = obs.spans()
    path = obs.export_chrome(str(tmp_path / "spans.json"))
    out = json.loads(open(path).read())
    xs = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in xs) == sorted(s["name"] for s in spans)
    assert {e["tid"] for e in xs} == {0}         # no CUDA event on the CPU
    first = min(spans, key=lambda s: s["host_start"])
    e = next(e for e in xs if e["args"]["id"] == first["id"])
    assert abs(e["ts"] * 1e3 + out["baseTimeNanoseconds"]
               - first["host_start"]) < 1e3
    assert out["counters"]["nms.planes"] == 4
    assert not any(c["profiled"] for c in obs.calls())


def test_root_ring_is_bounded_and_flags_profiled_calls():
    for _ in range(obs.RING + 10):
        with obs.root("xp.pipe.call"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with obs.root("xp.pipe.call"):
                pass
    calls = obs.calls("xp.pipe.call")
    assert len(calls) == obs.RING
    assert [c["profiled"] for c in calls[-4:]] == [False, True, True, True]
    assert len([s for s in obs.spans() if s["name"] == "xp.pipe.call"]) == 3


def test_plain_k2_counts_sweeps_times_planes():
    rng = np.random.default_rng(5)
    prob = torch.from_numpy(rng.uniform(size=(3, 48, 40)).astype(
        np.float32) ** 4)
    _, sweeps = grid_nms_keep_plain(prob, prob > 0.015, 8, 0.1)
    box_nms_extract(prob, 8, 0.015, 0.1, 32)
    box_nms_extract(prob, 8, 0.015, 0.1, 32)
    counts = obs.counters()
    assert counts["nms.planes"] == 6
    assert counts["nms.plane_sweeps"] == 2 * 3 * sweeps
    assert counts["nms_sweep.launches"] == grid_nms_keep.launches


def test_profile_report_busy_is_the_union():
    """Overlapping device operations count once; ranges and host
    operations not at all."""
    class Prof:
        def export_chrome_trace(self, path):
            events = [{"cat": "kernel", "ts": 0, "dur": 10},
                      {"cat": "kernel", "ts": 5, "dur": 10},
                      {"cat": "gpu_memcpy", "ts": 20, "dur": 2},
                      {"cat": "gpu_memset", "ts": 21, "dur": 4},
                      {"cat": "gpu_user_annotation", "ts": 0, "dur": 100},
                      {"cat": "cpu_op", "ts": 40, "dur": 50}]
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    assert device_busy_ms(Prof()) == pytest.approx(20e-3)


@pytest.mark.cuda
def test_resident_k2_adds_each_planes_sweeps_on_the_card():
    """On a seeded (16, 512, 512) call (the resident instance), the counter
    grows by the sum of the planes' own sweep counts, as the CPU mirror of
    the kernel's decomposition counts them, and the call stays one kernel
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(16)
    prob = rng.uniform(size=(16, 512, 512)).astype(np.float32) ** 4
    prob[0, :, :256] = np.linspace(1.0, 0.6, 256)[None, :]
    p = torch.from_numpy(prob).cuda()
    valid = p > 0.015
    _grid_nms_keep_async(p, valid, 8, 0.1)          # build and warm up
    counter = obs.device_counter("nms.plane_sweeps", p.device)
    before, launches = int(counter.item()), grid_nms_keep.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _grid_nms_keep_async(p, valid, 8, 0.1)
        torch.cuda.synchronize()
    added = int(counter.item()) - before
    shape = last_launch_shape()
    assert shape["cluster"] > 0                      # the resident instance
    want = sum(grid_nms_keep_cluster_mirror(
        p[i:i + 1].cpu(), valid[i:i + 1].cpu(), 8, 0.1, shape["cluster"],
        shape["tile_rows"])[1] for i in range(16))
    assert added == want
    assert grid_nms_keep.launches == launches + 1
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "kernel" in e.name]
    assert len(kernels) == 1, [e.name for e in kernels]
