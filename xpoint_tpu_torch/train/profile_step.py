"""Where the time of one flagship train step goes, on the card.

    python -m xpoint_tpu_torch.train.profile_step [forward_type]

Builds the flagship train step with :func:`flagship_train` (the one
``chip_smoke.py`` times; ``forward_type``, e.g. ``v052d_noz``, replaces the
config's ``SSM_FORWARDTYPE``), times ``N_TIMED`` unprofiled steps after a
warm-up, then profiles one more with torch.profiler (CPU + CUDA activities)
and prints what ``eval/profile_pipeline.report`` prints. The profiler's CPU
tracing inflates the profiled step's wall time, so the device's idle share
is also given against the median unprofiled step. Needs a CUDA card.
"""
import copy
import sys
import time

import numpy as np
import torch

B, S, N_TIMED = 16, 256, 7


def flagship_train(dev, forward_type=None, d_state=None, mesh=None):
    """The flagship training config (VMAMBA_TRAIN_CFG: 256^2, bf16,
    DropPath 0.2, RegNet + HM loss, hard negatives; with ``forward_type``
    in place of its SSM_FORWARDTYPE v05_noz and ``d_state`` in place of its
    SSM_D_STATE 1) from seed 0, on the
    SyntheticPairs corpus (32 pairs at 320^2, 256 keypoints each, seed 0)
    made resident by load_resident_pair_data and
    batched by make_resident_batch_fn. Returns (state, step, data, meta):
    ``step(state, {"data": data, "idx": idx}, gen)`` runs one train step
    on the samples ``idx``; with ``mesh``, the data-parallel step, each
    rank on its rows of ``idx``."""
    from ..data.device_dataset import (load_resident_pair_data,
                                       make_resident_batch_fn)
    from ..data.synthetic_pairs import SyntheticPairs
    from ..losses import XPointLoss
    from ..models import VMAMBA_TRAIN_CFG, build_xpoint
    from . import TrainState, make_optimizer, make_train_step

    cfg = copy.deepcopy(VMAMBA_TRAIN_CFG)
    vssm = cfg["model"]["use_attention"]["model_parameters"]["MODEL"]["VSSM"]
    if forward_type is not None:
        vssm["SSM_FORWARDTYPE"] = forward_type
    if d_state is not None:
        vssm["SSM_D_STATE"] = d_state
    module, _ = build_xpoint(cfg["model"], device=dev, seed=0)
    state = TrainState(module, make_optimizer(cfg["training"])[0])
    data, meta = load_resident_pair_data(SyntheticPairs(), device=dev)
    step = make_train_step(
        module, XPointLoss(dict(cfg["loss"], space_to_depth_ratio=8)),
        batch_fn=make_resident_batch_fn(cfg["dataset"], meta, hm_input=True,
                                        mesh=mesh), mesh=mesh)
    return state, step, data, meta


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    forward_type = argv[0] if argv else None
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from ..eval.profile_pipeline import report

    dev = torch.device("cuda")
    state, step, data, meta = flagship_train(dev, forward_type)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx_gen = torch.Generator(device=dev).manual_seed(1)

    def run():
        idx = torch.randperm(meta["n"], generator=idx_gen, device=dev)[:B]
        t0 = time.perf_counter()
        step(state, {"data": data, "idx": idx}, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run()                                   # warm-up: kernel builds
    step_ms = float(np.median([run() for _ in range(N_TIMED)]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run()
    busy_ms = report(prof, wall_ms, f"train step {forward_type or 'v05_noz'} "
                     "(profiled, wall inflated by the profiler)", batch=B,
                     size=S,
                     unprofiled_step_ms=step_ms)
    print(f"unprofiled step {step_ms:.3f} ms (median of {N_TIMED}): device "
          f"busy {busy_ms:.3f} ms, idle {100 * (1 - busy_ms / step_ms):.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
