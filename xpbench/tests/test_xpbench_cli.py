"""The measuring command refuses to run without a card, and prints no
result; its result line carries the keys the contract names."""
import json
import subprocess
import sys
import time

from xpbench.harness import run_cell
from tiny import ROOT, tiny_cell


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "xpbench", "--workload",
                          "vmamba-serve-512-b32", "--seed", "3000000001",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_result_keys():
    for trace in (0, 1):
        res = run_cell(tiny_cell("vmamba-serve-512-b32"), 5, 1.0, trace,
                       "cpu", time.perf_counter())
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        keys += ["breakdown"] if trace else []
        assert list(res) == keys + ["compared"]
        assert res["correct"] is True
        json.dumps(res)
        dev = res["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
        if trace:
            assert {"busy_s", "window_s"} <= set(dev)
        else:
            assert {"pairs_per_s", "call_p95_ms", "setup_s"} == set(
                res["metrics"])
