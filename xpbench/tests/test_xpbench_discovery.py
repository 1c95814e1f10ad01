"""The harness finds a cell's configuration, traffic mix, traffic driver,
limits and per-layer metric readers by name, and a newly dropped-in set of
files with no other edit."""
import json
import os
import shutil

import pytest

from xpbench.harness import Cell, driver, metric_reader
from tiny import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = Cell(ROOT, name)
    assert cell.config["name"] == cell.entry["config"]
    drv = driver(ROOT, cell.traffic["kind"])
    assert all(callable(getattr(drv, f)) for f in ("setup", "warm_up",
                                                   "window", "check"))
    assert set(cell.limits) and all(isinstance(v, (int, float))
                                    for v in cell.limits.values())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(metric_reader(ROOT, m["name"]))


def test_drop_in_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "xpbench"), tmp_path / "xpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = tmp_path / "xpbench"
    cfg = json.loads((pkg / "configs" / "xpoint-vmamba.json").read_text())
    cfg["name"] = "xpoint-vmamba-new"
    (pkg / "configs" / "xpoint-vmamba-new.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "serve-512-b32.json").read_text())
    traffic["batch"] = 4
    (pkg / "traffic" / "serve-512-b4.json").write_text(json.dumps(traffic))
    (pkg / "traffic" / "echo-mix.json").write_text(json.dumps(
        {"kind": "echo", "rate": 3}))
    (pkg / "drivers" / "echo.py").write_text(
        "class Driver:\n"
        "    def window(self, seconds, trace):\n"
        "        return {'e2e': {'echoes_per_s': 3.0}}\n")
    (pkg / "limits" / "new-cell.json").write_text(json.dumps({"x": 1}))
    (pkg / "layer_metrics" / "new_metric.serve.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0],
                                 name="xpoint-vmamba-new",
                                 file="xpbench/configs/"
                                      "xpoint-vmamba-new.json"))
    bench["workloads"].append({"name": "new-cell",
                               "config": "xpoint-vmamba-new",
                               "traffic": "serve-512-b4", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "new_metric.serve", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "pairs_per_s",
                               "workloads": ["new-cell"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "vmamba-serve-512-b32" in m["workloads"]:
            m["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Cell(str(tmp_path), "new-cell")
    assert cell.config["name"] == "xpoint-vmamba-new"
    assert cell.traffic["batch"] == 4
    assert cell.limits == {"x": 1}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.serve"]
    assert metric_reader(str(tmp_path), "new_metric.serve")(None) == 42.0
    echo = driver(str(tmp_path), json.loads(
        (pkg / "traffic" / "echo-mix.json").read_text())["kind"])
    assert echo().window(1, 0)["e2e"] == {"echoes_per_s": 3.0}
    assert {m["name"] for m in cell.end_to_end} == {
        "pairs_per_s", "call_p95_ms", "setup_s"}
