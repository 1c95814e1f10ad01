"""Where the time of one pair-pipeline call goes, on the card.

    python -m xpoint_tpu_torch.eval.profile_pipeline [forward_type]
    python -m xpoint_tpu_torch.eval.profile_pipeline --yaml CONFIG.yaml

Builds the flagship VMamba XPoint (bf16, seed 0; ``forward_type``, e.g.
``v052d_noz``, replaces its SSM_FORWARDTYPE v05_noz), or with ``--yaml``
the model of a config file's ``model:`` section (``configs/cmt.yaml``: the
SwinV2 XPoint), seed 0, warms the pipeline up, then profiles one call with
torch.profiler (CPU + CUDA activities) and prints what :func:`report`
prints. Needs a CUDA card.
"""
import copy
import json
import os
import sys
import tempfile
import time

import torch


B, S, TOP = 8, 512, 25
# the device operations of a profiler's trace (Chrome JSON categories)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def pipeline(module):
    """make_pair_pipeline over ``module`` at S x S, k 1024, NMS 8,
    threshold 0.015, the cell size the module's own."""
    from . import make_pair_pipeline
    return make_pair_pipeline(module, (S, S), k=1024, nms_size=8,
                              detection_threshold=0.015,
                              ratio=module.encoder_downsample_ratio)


def flagship_pipeline(dev, forward_type=None):
    """The pipeline over the flagship VMamba XPoint (bf16, seed 0;
    ``forward_type`` in place of its SSM_FORWARDTYPE v05_noz)."""
    from ..models import VMAMBA_MODEL_CFG, build_xpoint

    cfg = copy.deepcopy(VMAMBA_MODEL_CFG)
    if forward_type is not None:
        cfg["use_attention"]["model_parameters"]["MODEL"]["VSSM"][
            "SSM_FORWARDTYPE"] = forward_type
    module, _ = build_xpoint(cfg, device=dev, seed=0)
    return pipeline(module)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profile_pipeline: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    if argv[:1] == ["--yaml"]:
        from ..config import load_yaml
        from ..models import build_xpoint
        model = argv[1]
        module, _ = build_xpoint(load_yaml(model)["model"], device=dev,
                                 seed=0)
        run = pipeline(module)
    else:
        model = argv[0] if argv else "v05_noz"
        run = flagship_pipeline(dev, argv[0] if argv else None)
    g = torch.Generator(device=dev).manual_seed(0)
    imgs = [torch.rand(B, S, S, 1, generator=g, device=dev) for _ in range(4)]
    run(imgs[0], imgs[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(imgs[2], imgs[3])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report(prof, wall_ms, "pipeline call", batch=B, size=S, model=model)
    return 0


def device_busy_ms(prof):
    """Milliseconds of a ``torch.profiler`` run in which some device
    operation ran: the union of the intervals of its kernels, copies and
    sets in the exported trace (overlapping operations counted once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ops = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for s, e in ops:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def report(prof, wall_ms, what, **info):
    """Print the device time by kernel name of a ``torch.profiler`` run,
    the device's busy time against the wall time (:func:`device_busy_ms`:
    the union of kernels, copies and sets) and the kernel launches, then
    the top of the table as one JSON line with ``info``. Returns the busy
    time in ms."""
    rows = []
    for e in prof.key_averages():
        # device-side kernels only: an aten op's own entry, or a range on
        # the device timeline such as torch.optim's "Optimizer.step#..."
        # annotation, would count its kernels a second time
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            rows.append({"name": e.key, "count": e.count,
                         "device_ms": e.self_device_time_total / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = device_busy_ms(prof)
    n_launches = sum(r["count"] for r in rows)
    card = torch.cuda.get_device_name(0)
    print(f"{card}: {what} wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{n_launches} kernel launches")
    for r in rows[:TOP]:
        print(f"{r['device_ms']:10.3f} ms  x{r['count']:<5d} {r['name'][:90]}")
    top = [{**r, "name": r["name"][:100]} for r in rows[:TOP]]
    print(json.dumps({"card": card, **info, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms, "n_launches": n_launches,
                      "n_kernel_names": len(rows), "top": top}))
    return busy_ms


if __name__ == "__main__":
    sys.exit(main())
