"""Full metric sweep + per-stage timing (port of ``cli/benchmark.py``, the
reference benchmark.py).

    python -m xpoint_tpu_torch.cli.benchmark -y configs/cipdp.yaml \\
        -m MODEL_DIR -v latest -e [--max-samples N] [--device cuda]

Times the forward, NMS and descriptor sampling on five samples, and with
``-e`` sweeps repeatability, NN-mAP, M-score and homography correctness
over the dataset, writing them to
``OUTPUT_DIR/benchmark_<model dir>_<version>_s<seed>.json`` with the keys
and nesting of the JAX package's file. ``prediction: h_estimator: device``
in the config estimates the homographies by RANSAC on the device instead of
cv2's MAGSAC. Runs on the card unless ``--device`` says otherwise.
"""
import argparse
import json
import os

import numpy as np

from ._common import load_eval_setup, set_seeds


class _Head:
    """The first n samples of a dataset."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, min(n, len(dataset))

    def __getitem__(self, i):
        return self.dataset[i]

    def __len__(self):
        return self.n

    def returns_pair(self):
        return self.dataset.returns_pair()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Benchmark an XPoint model')
    parser.add_argument('-y', '--yaml-config', default='configs/cipdp.yaml')
    parser.add_argument('-m', '--model-dir', default='model_weights/xpoint')
    parser.add_argument('-v', '--version', default='latest')
    parser.add_argument('-i', '--index', default=None, type=int, nargs='*',
                        help='Sample indices for the timing harness')
    parser.add_argument('-r', '--radius', default=4, type=int)
    parser.add_argument('-p', dest='plot', action='store_true')
    parser.add_argument('-e', dest='evaluation', action='store_true')
    parser.add_argument('-tk', dest='threshold_keypoints', default=4, type=int)
    parser.add_argument('-th', dest='threshold_homography', default=2, type=int)
    parser.add_argument('-s', '--seed', default=0, type=int)
    parser.add_argument('-yv', '--yaml-variable', default=None)
    parser.add_argument('-o', '--output_dir', default='outputs')
    parser.add_argument('--max-samples', default=None, type=int)
    parser.add_argument('--device', default='cuda',
                        help='torch device of the model (default: cuda)')
    # accepted but unused, as in the reference (benchmark.py:40-41: the
    # sweep's grids are fixed, :133-136), so that its scripts still run
    parser.add_argument('-t', dest='threshold', default=3, type=int,
                        help=argparse.SUPPRESS)
    parser.add_argument('-mask', dest='mask', action='store_true',
                        help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the benchmark; returns the path of the JSON written (None
    without ``-e``)."""
    args = parse_args(argv)
    set_seeds(args.seed)

    config, _, infer, dataset = load_eval_setup(
        args, single_image_override=False)

    from ..data import DataLoader
    from ..eval.benchmark import compute_metrics, print_timing, timing_harness

    # the timing harness over 5 random samples (reference benchmark.py:141-164)
    indices = args.index
    if not indices:
        rng = np.random.default_rng(args.seed)
        indices = sorted(rng.choice(len(dataset), size=min(5, len(dataset)),
                                    replace=False).tolist())
    times = timing_harness(infer, dataset, indices, config)
    print_timing(times)
    if not args.evaluation:
        return None

    # threshold grids (reference benchmark.py:133-137)
    threshold_ransac = [args.threshold_homography]
    ds = _Head(dataset, args.max_samples) if args.max_samples else dataset
    results = compute_metrics(
        infer, DataLoader(ds, batch_size=1, shuffle=False), config,
        threshold_repeatability=list(range(1, 11)),
        threshold_keypoints=list(range(1, 11)),
        threshold_warp=list(range(1, 11)),
        threshold_ransac=threshold_ransac)
    results['timing_seconds'] = {k: list(map(float, v))
                                 for k, v in times.items()}

    print(f"repeatability@3px: {results['repeatability'][3]:.4f}")
    d3 = results['descriptor'][3]
    print(f"NN-mAP@3px: {d3['nn_map']:.4f}  M-score@3px: {d3['m_score']:.4f}")
    h = results['homography'][threshold_ransac[0]]
    print(f"h-correctness@3px: {h['h_correctness']['epsilon_warp_th3']:.4f} "
          f"(avg err {h['average_h_error']:.2f})")

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(
        args.output_dir,
        f"benchmark_{os.path.basename(args.model_dir)}_{args.version}"
        f"_s{args.seed}.json")
    with open(out_path, 'w') as f:
        json.dump(results, f, indent=2, default=float)
    print(f"results written to {out_path}")
    return out_path


if __name__ == '__main__':
    main()
