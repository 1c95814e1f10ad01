"""Cells cut to a size that a CPU test run holds: the configurations'
published widths, 128 x 128 images, two pairs a call or step; and the
cells whose files the benchmark keeps although ``BENCHMARK.json`` does not
hold them yet (the training cells, host-paced on today's hosts: PERF.md),
so that their driver, reference and limits stay tested."""
import copy
import json
import os

from xpbench.harness import Cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KEPT = {"vmamba-train-256-b16": {"config": "xpoint-vmamba",
                                 "traffic": "train-256-b16", "chips": 1},
        "swinv2-train-256-b16": {"config": "xpoint-swinv2",
                                 "traffic": "train-256-b16", "chips": 1}}
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    ALL_CELLS = [w["name"] for w in json.load(_f)["workloads"]] + list(KEPT)


def cell(name, root=ROOT):
    entry = KEPT.get(name)
    return Cell(root, name, dict(entry, name=name) if entry else None)


def tiny_cell(name, root=ROOT):
    c = cell(name, root)
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic.update(image=[128, 128], batch=2, pool=3)
    if c.traffic["kind"] == "serve":
        c.traffic.update(k=64, checked=2)
    else:
        c.traffic.update(keypoints=32)
    return c
