"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size, several seeds in one process:

``python -m xpbench.calibrate --workload <cell> --seeds 1,2,3
--what program,control[,bf16_work][,half_batch] [--seconds 3]``

``program``: the numbers a sound run of the program gives (a run of the
cell with a window of ``--seconds``). ``control``: the reference put in
the program's place and computed one precision lower than the
configuration states (``reference.ops.Prec``: bfloat16 for float32 work;
for bfloat16 work float8 e4m3 in serving, int8 in training, operands and
gradients), judged by the same comparison. ``bf16_work``: the reference
with its products at the stated precision and its norms, softmax and scan
in bfloat16 (``reference.ops.Prec``), the step a bfloat16 LayerNorm or
scan would take. ``half_batch``
(training): the program's steps on half of each batch, the mean over the
rest. One JSON line a seed and kind; the benchmark's own runs never run
this.
"""
import argparse
import json
import os
import sys
import time

import torch

from . import check, data, reference, weights
from .data import sub_seed
from .harness import Cell, _fix_caches, run_cell


# The rounding below bfloat16 of each kind's control: float8 e4m3 where a
# later change would serve in fp8; int8 in training, where fp8 reads
# within about twice the program on every number compared (PERF.md).
CONTROL = {"serve": "fp8", "train": "int8"}


def half_batch(step, state):
    """A step that sees the first half of each batch only."""
    def half(v):
        if isinstance(v, dict):
            return {k: half(x) for k, x in v.items()}
        return v[:v.shape[0] // 2]
    return lambda st, batch, gen: step(st, half(batch), gen)


def _state(cell, seed, device):
    model, _ = reference.build(cell.config["model"], cell.config["precision"],
                               None, "meta")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    return weights.make_state(shapes, sub_seed(seed, 1), device)


def control_readings(cell, seed, device, control=None):
    """The readings of ``control`` (by default the cell kind's rounding
    below bfloat16, ``CONTROL``) in the program's place."""
    cfg, t = cell.config, cell.traffic
    control = control or CONTROL[t["kind"]]
    state = _state(cell, seed, device)
    H, W = t["image"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    if t["kind"] == "serve":
        img_o, img_t = data.serve_pool(t["pool"], t["batch"], H, W, gen,
                                       device)
        ref, _ = reference.build(cfg["model"], cfg["precision"], state,
                                 device)
        ctl, _ = reference.build(cfg["model"], cfg["precision"], state,
                                 device, control=control)
        total = {}
        for i in data.pick(sub_seed(seed, 3), t["pool"], t["checked"]):
            out = check.reference_outputs(ctl, ctl.ratio, t, img_o[i],
                                          img_t[i])
            r = check.serve_readings(ref, ref.ratio, t, img_o[i], img_t[i],
                                     out)
            for k, v in r.items():
                total[k] = max(total.get(k, v), v)
        return total
    pool = data.train_pool(t["checked_steps"], t["batch"], H, W,
                           t["keypoints"], gen, device)
    seeds = [sub_seed(seed, 10 + s) for s in range(t["checked_steps"])]
    ref = check.reference_steps(cfg, state, pool, seeds, device)
    ctl = check.reference_steps(cfg, state, pool, seeds, device,
                                control=control)
    return check.train_readings(ctl, ref)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m xpbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = Cell(root, args.workload)
    _fix_caches(root)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in args.what.split(","):
            t0 = time.perf_counter()
            if what in ("control", "bf16_work"):
                r = control_readings(cell, seed, device,
                                     None if what == "control" else what)
            else:
                faults = ({"train": half_batch} if what == "half_batch"
                          else {})
                res = run_cell(cell, seed, args.seconds, 0, device, t0,
                               faults)
                r = {k: v["value"] for k, v in res["compared"].items()}
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "what": what, "readings": r,
                              "s": time.perf_counter() - t0}), flush=True)
            if device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
