"""The readers of the program's own records (``records.py`` and the
``layer_metrics`` that use it): nothing to read gives None, a program
without ``obs`` gives None without raising, and synthetic records give
the values their docstrings define."""
import sys

import pytest

import xpoint_tpu_torch
from xpbench import records
from xpbench.harness import metric_reader
from tiny import ROOT

NEW = ("host_ms.serve", "norm_ms.serve", "scan_ms.serve",
       "k2_roofline.serve", "kernel_load_s.serve")
MS = 1_000_000


class Trace:
    def __init__(self, calls, nms_us=0.0):
        self.calls, self.nms_us = calls, nms_us

    def kernel_us(self, pattern):
        return self.nms_us if pattern.search("nms_resident_kernel") else 0.0


class Ctx:
    kind = "serve"

    def __init__(self, trace):
        self.trace = trace


def _span(i, name, call, dev=None, **attrs):
    lo, hi = dev or (None, None)
    return {"name": name, "id": i, "parent": None if i == call else call,
            "call": call, "attrs": attrs, "dev_start": lo, "dev_end": hi}


class FakeObs:
    """Two profiled calls (roots 1 and 2), a span of an earlier call (9)."""

    def spans(self):
        nms = dict(planes=64, height=512, width=512, size=8, iou=0.1)
        return [_span(1, "xp.pipe.call", 1, (0, 80 * MS)),
                _span(3, "xp.enc.norm", 1, (0, 1 * MS)),
                _span(4, "xp.enc.norm", 1, (2 * MS, 5 * MS)),
                _span(5, "xp.enc.scan", 1, (5 * MS, 9 * MS)),
                _span(6, "xp.k.nms_sweep", 1, (70 * MS, 71 * MS), **nms),
                _span(2, "xp.pipe.call", 2, (80 * MS, 160 * MS)),
                _span(7, "xp.enc.norm", 2, (80 * MS, 82 * MS)),
                _span(8, "xp.enc.norm", 2),
                _span(10, "xp.k.nms_sweep", 2, (150 * MS, 151 * MS), **nms),
                _span(9, "xp.enc.norm", 9, (0, 50 * MS))]

    def calls(self, name=None):
        plain = [(0, 1 * MS), (0, 2 * MS), (0, 10 * MS)]
        return ([{"name": "xp.pipe.call", "host_start": a, "host_end": b,
                  "profiled": False} for a, b in plain]
                + [{"name": "xp.pipe.call", "host_start": 0,
                    "host_end": 99 * MS, "profiled": True}] * 2)

    def counters(self):
        return {"nms.planes": 640, "nms.plane_sweeps": 7040,
                "kernels.loaded": 2, "kernels.load_ns": 300 * MS}


def _read(name, ctx):
    return metric_reader(ROOT, name)(ctx)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(name):
    from xpoint_tpu_torch import obs
    obs.reset()
    assert _read(name, Ctx(Trace(4))) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_obs_reads_none(name, monkeypatch):
    monkeypatch.delattr(xpoint_tpu_torch, "obs", raising=False)
    monkeypatch.setitem(sys.modules, "xpoint_tpu_torch.obs", None)
    assert _read(name, Ctx(Trace(2, nms_us=1600.0))) is None


@pytest.mark.parametrize("name,want", [
    ("norm_ms.serve", (1 + 3 + 2) / 2),
    ("scan_ms.serve", 4 / 2),
    ("host_ms.serve", 2.0),
    ("kernel_load_s.serve", 0.3),
    # 25 comparisons a pixel a plane-sweep at size 8, 11 sweeps a plane,
    # against 800 us of K2 a call
    ("k2_roofline.serve", 100 * 2 * 25 * 64 * 512 * 512 * 11 / 67e12
     / 1.6e-3)])
def test_synthetic_records(name, want, monkeypatch):
    monkeypatch.setattr(records, "_obs", FakeObs)
    assert _read(name, Ctx(Trace(2, nms_us=1600.0))) == pytest.approx(want)


@pytest.mark.parametrize("name", ("norm_ms.serve", "k2_roofline.serve",
                                  "host_ms.serve"))
def test_other_call_counts_read_none(name, monkeypatch):
    monkeypatch.setattr(records, "_obs", FakeObs)
    assert _read(name, Ctx(Trace(3, nms_us=1600.0))) is None
