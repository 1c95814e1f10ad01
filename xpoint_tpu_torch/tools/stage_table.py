"""Stage timing table of the flagship model (port of
``tools/stage_table.py``): per-stage ms and Hz of two_forward / nms /
interpolate (reference benchmark.py:151-164,
benchmark_evaluation.py:16-134) in two forms:

  host-staged  the reference's decomposition: each stage fenced by
               ``torch.cuda.synchronize()`` at batch size 1, through the
               timing harness of ``eval/benchmark.py``.

  on-device    the serving decomposition: cumulative sub-pipelines of
               ``eval.make_pair_pipeline`` (two_forward -> +nms/top-k ->
               +interpolate -> +match), each timed over streams of fresh
               inputs at the bench batch size with one fence at the end
               of each (the median of three, taken in turns); a stage's
               cost is the difference of consecutive prefixes.

    python -m xpoint_tpu_torch.tools.stage_table [--out
        outputs/stage_table.json] [--device cuda]

The bench batch is ``$XPOINT_BENCH_B`` (default 8), the image 512^2, the
model the flagship (``models.VMAMBA_MODEL_CFG``, seed 0). Writes the JSON
(not the JAX tool's ``metrics/stage_table.json``) and prints both tables in
the reference's "stage: X ms, Y Hz" form.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from ..eval.benchmark import print_timing, timing_harness
from ..eval.infer import XPointInference
from ..ops.descriptor import interpolate_descriptors
from ..ops.detector import prob_from_logits
from ..ops.matching import mnn_match
from ..ops.nms import box_nms_extract


def fence(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fresh_inputs(gen, n, B, H, W, device):
    """n never-repeated image pairs (B, H, W, 1) drawn on the device, all
    made before the timing starts."""
    ins = [(torch.rand(B, H, W, 1, generator=gen, device=device),
            torch.rand(B, H, W, 1, generator=gen, device=device))
           for _ in range(n)]
    fence(device)
    return ins


def host_staged_table(module, H, W, n_samples=5, seed=0):
    """The reference harness on synthetic samples: stage by stage, each
    stage fenced (batch size 1). Returns {stage: [seconds]}."""
    infer = XPointInference(module, {
        "nms": 8, "detection_threshold": 0.015, "topk": 0,
        "matching": {"method": "bfmatcher",
                     "method_kwargs": {"crossCheck": True},
                     "knn_matches": False}})
    rng = np.random.default_rng(seed)

    class _SynthPairs:
        def __getitem__(self, i):
            o = rng.uniform(size=(H, W, 1)).astype(np.float32)
            t = rng.uniform(size=(H, W, 1)).astype(np.float32)
            ones = np.ones((H, W), np.float32)
            return {"optical": {"image": o, "valid_mask": ones},
                    "thermal": {"image": t, "valid_mask": ones}}

        def __len__(self):
            return n_samples

    cfg = {"prediction": {"nms": 8}}
    return timing_harness(infer, _SynthPairs(), list(range(n_samples)), cfg)


def sub_pipelines(module, H, W, k=1024):
    """The cumulative prefixes of the serving pipeline, as
    [(stage, fn(img_o, img_t))]: each runs its stage and every stage
    before it."""
    ratio = module.encoder_downsample_ratio

    def forward(a, b):
        pred_o, pred_t = module(a, "optical"), module(b, "thermal")
        return (pred_o, pred_t, prob_from_logits(pred_o["logits"], ratio),
                prob_from_logits(pred_t["logits"], ratio))

    def nms(a, b):
        pred_o, pred_t, prob_o, prob_t = forward(a, b)
        kps, sc, m = box_nms_extract(torch.cat([prob_o, prob_t]), 8, 0.015,
                                     0.1, k)
        return pred_o, pred_t, kps, m

    def interpolate(a, b):
        pred_o, pred_t, kps, m = nms(a, b)
        B = a.shape[0]
        d_o = interpolate_descriptors(kps[:B].float(), pred_o["desc"],
                                      (H, W))
        d_t = interpolate_descriptors(kps[B:].float(), pred_t["desc"],
                                      (H, W))
        return d_o, d_t, m[:B], m[B:]

    def match(a, b):
        return mnn_match(*interpolate(a, b), None, True)

    return [("two_forward", forward), ("nms", nms),
            ("interpolate", interpolate), ("match", match)]


# streams of fresh inputs timed for each prefix, in turns: a stage is the
# difference of two prefixes' medians, clamped at 0, so a stream that the
# host slows moves the sum of the stages unless the median outvotes it
STREAMS = 7


@torch.no_grad()
def on_device_table(module, B, H, W, k=1024, n_iters=10, seed=1):
    """Stage differences of the cumulative sub-pipelines. A prefix's time
    is the median of STREAMS streams of ``n_iters`` fresh inputs, each
    stream fenced once at its end; the prefixes take their streams in
    turns, so that a drift of the host's speed reaches all of them and one
    slow stream does not move a stage. Returns ({stage: seconds a batch},
    {prefix: seconds a batch})."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    prefixes = sub_pipelines(module, H, W, k)
    for _, fn in prefixes:
        fn(*fresh_inputs(gen, 1, B, H, W, device)[0])     # warm-up
    streams = {name: [] for name, _ in prefixes}
    for _ in range(STREAMS):
        for name, fn in prefixes:
            ins = fresh_inputs(gen, n_iters, B, H, W, device)
            t0 = time.perf_counter()
            for a, b in ins:
                fn(a, b)
            fence(device)
            streams[name].append((time.perf_counter() - t0) / n_iters)
    cumulative = {name: float(np.median(t)) for name, t in streams.items()}
    stages, prev = {}, 0.0
    for name, _ in prefixes:
        stages[name] = max(cumulative[name] - prev, 0.0)
        prev = cumulative[name]
    return stages, cumulative


def main(argv=None):
    from ..models import VMAMBA_MODEL_CFG, build_xpoint
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="outputs/stage_table.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    B = int(os.environ.get("XPOINT_BENCH_B", "8"))
    H = W = 512
    module, _ = build_xpoint(VMAMBA_MODEL_CFG, device=args.device, seed=0)
    module.eval()

    print(f"== host-staged (reference decomposition, B=1, each stage "
          f"fenced) @{H}^2 ==")
    host = host_staged_table(module, H, W)
    print_timing(host)

    print(f"\n== on-device (serving sub-pipelines, differences, B={B}) "
          f"@{H}^2 ==")
    stages, cumulative = on_device_table(module, B, H, W)
    per_pair, total = {}, 0.0
    for name, dt in stages.items():
        per_pair[name] = dt / B
        total += dt / B
        hz = B / dt if dt > 0 else float("inf")
        print(f"{name}: {dt * 1000:.2f} ms/batch "
              f"({dt / B * 1000:.3f} ms/pair), {hz:.2f} Hz")
    print(f"total: {total * B * 1000:.2f} ms/batch, {B / total / B:.2f} Hz "
          f"({1.0 / total:.1f} pairs/s)")

    out = {
        "model": "XPoint VMamba-tiny v05_noz (flagship, seed-0 init)",
        "device": (torch.cuda.get_device_name(args.device)
                   if torch.device(args.device).type == "cuda" else "cpu"),
        "image_size": [H, W],
        "host_staged": {
            "batch_size": 1,
            "caveat": "each stage fenced by torch.cuda.synchronize(): the "
                      "reference benchmark.py:151-164 semantics",
            "stage_seconds": {k: list(map(float, v))
                              for k, v in host.items()},
            "stage_ms_mean": {k: float(np.mean(v)) * 1000
                              for k, v in host.items()},
        },
        "on_device": {
            "batch_size": B,
            "method": "cumulative serving sub-pipelines timed over fresh "
                      "inputs with one fence; stage = difference of "
                      "consecutive prefixes",
            "stage_ms_per_batch": {k: float(v) * 1000
                                   for k, v in stages.items()},
            "stage_ms_per_pair": {k: float(v) * 1000
                                  for k, v in per_pair.items()},
            "cumulative_ms_per_batch": {k: float(v) * 1000
                                        for k, v in cumulative.items()},
            "pairs_per_sec_full_chain": float(B / cumulative["match"]),
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwritten to {args.out}")
    return out


if __name__ == "__main__":
    main()
