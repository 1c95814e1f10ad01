"""The benchmark's run: one cell, one seed, one window.

``python -m xpbench --workload <cell> --seed <n> --seconds <s> --trace 0|1``
from the root of a checkout. Everything about a cell is found by name:
its entry in ``BENCHMARK.json``, the configuration file that entry names,
``xpbench/traffic/<traffic>.json``, the driver of the ``kind`` that file
names (``xpbench/drivers/<kind>.py``), ``xpbench/limits/<cell>.json``
(the limit of each number the check compares) and one reader a per-layer
metric, ``xpbench/layer_metrics/<metric>.py``.

The run builds the program's model (``xpoint_tpu_torch``) from the
configuration's ``model`` section, loads weights made on the device from
the seed, makes the traffic's inputs from the seed, warms up the cell's
shapes, measures for ``--seconds`` seconds, reads the peak memory, frees
the program's state and then checks what the window produced against the
plain reference (``check``). The last line of standard output is one JSON
object; the numbers compared, each with its limit, are the last lines of
standard error and the last key of that object.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "xpoint_tpu")


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, root, name, entry=None):
        """``entry``: a ``workloads`` entry that ``BENCHMARK.json`` does
        not hold yet (a cell whose files are kept for a later benchmark;
        the tests run those)."""
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        by_name = {w["name"]: w for w in bench["workloads"]}
        if entry is None and name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entry or by_name[name]
        cfg = next(c for c in bench["configs"]
                   if c["name"] == self.entry["config"])
        with open(os.path.join(root, cfg["file"])) as f:
            self.config = json.load(f)
        self.root = root
        self.traffic = _load_json(root, "traffic", self.entry["traffic"])
        self.limits = _load_json(root, "limits", name)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]
        self.chips = int(self.entry["chips"])


def _load_json(root, folder, name):
    with open(os.path.join(root, "xpbench", folder, f"{name}.json")) as f:
        return json.load(f)


def _load(root, folder, name):
    """The module ``xpbench/<folder>/<name>.py``, loaded from its file."""
    path = os.path.join(root, "xpbench", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"xpbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root, name):
    """The ``read(ctx)`` of ``xpbench/layer_metrics/<name>.py``."""
    return _load(root, "layer_metrics", name).read


def driver(root, kind):
    """The ``Driver`` class of ``xpbench/drivers/<kind>.py``: built with
    (cell, module, seed, device, faults); ``setup()``, ``warm_up()``,
    ``window(seconds, trace)`` (with ``--trace 0`` its ``e2e`` holds every
    end-to-end metric the driver measures, by name) and ``check(state)``."""
    return _load(root, "drivers", kind).Driver


def _fix_caches(root):
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, "build", "xpbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(base, sub)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed, seconds, trace, device, t0, faults=None):
    """Run one cell; returns the result line's object, the numbers compared
    under ``compared``. ``faults`` plants a fault under the timed path (the
    tests' checks that a broken program reads as not correct)."""
    import torch

    from . import check, data, weights, work
    from xpoint_tpu_torch.models.xpoint import build_xpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    module, _ = build_xpoint(cfg["model"], device=device)
    shapes = {n: tuple(t.shape) for n, t in module.state_dict().items()}
    state = weights.make_state(shapes, data.sub_seed(seed, 1), device)
    module.load_state_dict(state, strict=True)
    (faults or {}).get("module", lambda m: None)(module)
    drive = driver(cell.root, traffic["kind"])(cell, module, seed, device,
                                               faults or {})
    del module          # the driver holds the program's state, and frees it
    drive.setup()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    drive.warm_up()
    setup_s = time.perf_counter() - t0
    window = drive.window(seconds, trace)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    readings = drive.check(state)
    correct, table = check.verdict(readings, cell.limits)
    correct = correct and window["failed"] == 0
    metrics = {}
    if not trace:
        values = dict(window["e2e"], setup_s=setup_s)
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in values]
        if missing:
            raise SystemExit(f"xpbench: the {traffic['kind']} driver does "
                             f"not measure {', '.join(missing)}")
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = window["ctx"]
        ctx.work = work.count(cfg, traffic)
        for m in cell.per_layer:
            value = metric_reader(cell.root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if trace:
        tr = window["ctx"].trace
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = window["ctx"].traced_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    if device == "cuda":
        dev["power_limit_w"] = _power_limit()
    result["compared"] = table
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t0=None):
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python -m xpbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = Cell(root, args.workload)
    _fix_caches(root)
    import torch
    if not torch.cuda.is_available():
        print("xpbench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"xpbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"xpbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, row in result["compared"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0

