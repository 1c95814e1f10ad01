"""What a run of the full cycle did, stage by stage, as one JSON object.

    python -m xpoint_tpu_torch.tools.cycle_report --work WORK_DIR \\
        [--reports REPORT_DIR] [--log CYCLE_LOG]

Reads the cycle's work directory: the label counts of ``labels.npz`` per
side (keypoints a pair), and the metrics JSON at seed 0 (repeatability,
NN-mAP, M-score and h-correctness at 3 px, with both estimators). With
``--reports``, the run reports its stages wrote (``tools/full_cycle.py``
run with ``$XPOINT_TORCH_RUN_REPORT`` set, ``cli/_common.report_at_exit``):
each stage's wall seconds, kernel launches, kernel libraries built (nvcc
ran) and whether it imported h5py.
With ``--log``, the cycle's output: the last epoch's loss of each training
stage (the pretrain's is its detector loss: it trains no descriptor).
"""
import argparse
import glob
import json
import os
import re

import numpy as np


def stage_reports(report_dir):
    """The run reports of ``report_dir`` in the order the stages ended
    (the cycle runs them one after another)."""
    reports = []
    for path in glob.glob(os.path.join(report_dir, "*.json")):
        with open(path) as f:
            reports.append(json.load(f))
    reports.sort(key=lambda r: r["end_time"])
    return reports


def label_counts(path):
    """Keypoints a pair in a label file (``.npz`` or HDF5), per side."""
    from ..data.group_file import open_group_file
    counts = {}
    with open_group_file(path) as f:
        names = list(f.keys())
        for name in names:
            grp = f[name]
            for ds in grp.keys():
                counts.setdefault(ds, []).append(len(np.asarray(grp[ds])))
    return {"pairs": len(names), **{
        ds: {"mean": float(np.mean(v)), "min": int(np.min(v)),
             "max": int(np.max(v)), "total": int(np.sum(v))}
        for ds, v in counts.items()}}


def headline(res):
    """The @3 px metrics of one benchmark JSON (with the device
    estimator's h-correctness when the cycle recorded it)."""
    out = {"repeatability@3": res["repeatability"]["3"],
           "nn_map@3": res["descriptor"]["3"]["nn_map"],
           "m_score@3": res["descriptor"]["3"]["m_score"],
           "h_correctness@3": res["homography"]["2"]["h_correctness"][
               "epsilon_warp_th3"],
           "avg_h_error": res["homography"]["2"]["average_h_error"]}
    dev = res.get("homography_device", {}).get("2")
    if dev:
        out["h_correctness@3_device"] = dev["h_correctness"][
            "epsilon_warp_th3"]
        out["avg_h_error_device"] = dev["average_h_error"]
    return out


def training_losses(log_path):
    """[[epoch losses] for each training stage] from the cycle's output:
    a stage starts at its ``+ ... cli.train`` line."""
    stages = []
    with open(log_path) as f:
        for line in f:
            if line.startswith("+ ") and "cli.train" in line:
                stages.append([])
            m = re.match(r"epoch \d+: loss (\S+)", line)
            if m and stages:
                stages[-1].append(float(m.group(1)))
    return stages


def report(work, report_dir=None, log=None):
    """The dict ``main`` prints: labels and seed-0 metrics of the work
    directory, with the stages of ``report_dir`` and the last epoch losses
    of ``log`` when given."""
    out = {"work": work}
    labels = os.path.join(work, "labels.npz")
    if os.path.exists(labels):
        out["labels"] = label_counts(labels)
    metrics = os.path.join(work, "mini_corpus_metrics.json")
    if os.path.exists(metrics):
        with open(metrics) as f:
            out["metrics_seed0"] = headline(json.load(f))
    if report_dir:
        out["stages"] = [
            {"stage": r["stage"], "wall_s": r["wall_s"],
             "launches": {k: v for k, v in r["launches"].items() if v},
             "kernels_built": r["counters"].get("kernels.built", 0),
             "h5py_imported": r["h5py_imported"]}
            for r in stage_reports(report_dir)]
    if log:
        losses = training_losses(log)
        out["last_epoch_loss"] = [s[-1] if s else None for s in losses]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", required=True)
    ap.add_argument("--reports", default=None)
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)
    out = report(os.path.abspath(args.work), args.reports, args.log)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
