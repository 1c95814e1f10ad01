"""Where the time of one homographic-adaptation sample goes, on the card.

    python -m xpoint_tpu_torch.selfsup.profile_ha

Builds the flagship HA program with :func:`flagship_ha` (the one
``chip_smoke.py`` times: the flagship VMamba XPoint in bf16 from seed 0 as
the detector, HA_DEFAULT_CONFIG with num 100 in prod aggregation, 512^2
synthetic pairs), times ``N_TIMED`` unprofiled samples after a warm-up, then
profiles one more with torch.profiler (CPU + CUDA activities) and prints
what ``eval/profile_pipeline.report`` prints. The profiler's CPU tracing
inflates the profiled sample's wall time, so the device's busy share is
also given against the median unprofiled sample. Needs a CUDA card.
"""
import sys
import time

import numpy as np
import torch

SIZE, N_PAIRS, N_TIMED = 512, 4, 3


def flagship_ha(dev):
    """The flagship detector and HA program on ``dev``. Returns (module,
    sample_fn, cfg, dataset): ``sample_fn(i, rng)`` runs HA on pair ``i`` of
    the seeded synthetic corpus (homographies drawn from ``rng``, images
    moved to the device, no synchronisation) and returns its output."""
    from ..data.synthetic_pairs import SyntheticPairs
    from ..models import VMAMBA_MODEL_CFG, build_xpoint
    from .export import make_prob_fn
    from .homographic_adaptation import make_ha_fn, sample_ha_homographies

    module, _ = build_xpoint(VMAMBA_MODEL_CFG, device=dev, seed=0)
    run, cfg = make_ha_fn(make_prob_fn(module))
    dataset = SyntheticPairs(n_pairs=N_PAIRS, size=SIZE, n_kp=1, seed=0)

    def sample_fn(i, rng):
        s = dataset[i]
        img_o, img_t = (torch.from_numpy(s[side]['image'][None]).to(dev)
                        for side in ('optical', 'thermal'))
        Hs = sample_ha_homographies(cfg, (SIZE, SIZE), rng)
        return run(img_o, img_t, torch.from_numpy(Hs).to(dev))

    return module, sample_fn, cfg, dataset


def main():
    if not torch.cuda.is_available():
        print("profile_ha: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from ..eval.profile_pipeline import report

    dev = torch.device("cuda")
    _, sample_fn, cfg, _ = flagship_ha(dev)
    rng = np.random.default_rng(0)

    def run(i):
        t0 = time.perf_counter()
        sample_fn(i % N_PAIRS, rng)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    run(0)                                  # warm-up: kernel builds
    sample_ms = float(np.median([run(1 + i) for i in range(N_TIMED)]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run(0)
    busy_ms = report(prof, wall_ms, "HA sample (profiled, wall inflated by "
                     "the profiler)", num=cfg['num'], size=SIZE,
                     aggregation=cfg['aggregation'],
                     unprofiled_sample_ms=sample_ms)
    forwards = 2 * cfg['num']
    print(f"unprofiled sample {sample_ms:.3f} ms (median of {N_TIMED}), "
          f"{forwards / sample_ms * 1e3:.1f} forwards/s: device busy "
          f"{busy_ms:.3f} ms, idle {100 * (1 - busy_ms / sample_ms):.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
