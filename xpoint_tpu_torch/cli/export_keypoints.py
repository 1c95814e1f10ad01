"""Export pseudo-ground-truth keypoints via homographic adaptation (port of
``cli/export_keypoints.py``, the reference export_keypoints.py).

    python -m xpoint_tpu_torch.cli.export_keypoints -y CONFIG.yaml \\
        -o LABELS.npz -m MODEL_DIR [-v latest] [-skip] [-f N] [-s SEED] \\
        [--max-samples N] [--batch N] [--device cuda]

For every pair of the config's dataset: the HA warp -> forward -> unwarp ->
aggregate program, NMS + threshold, and the keypoint coordinates written
under the sample's name (``keypoints``, or ``keypoints_optical`` /
``keypoints_thermal`` in window aggregation). The suffix of ``-o`` picks the
file: ``.hdf5`` / ``.h5`` (needs h5py), else ``.npz``, which the port's
datasets read back as labels (``data/group_file.py``). ``-skip`` resumes:
the samples already in the file are not exported again; ``-f N`` copies the
file to ``<file>.bak`` every N batches. One homography stack is drawn per
batch from ``np.random.default_rng(seed)``. ``--batch`` is the samples of
one HA step on the one card (default 1); the JAX package's sharding over a
mesh is ROADMAP.md Queue 1 item 9. Runs on the card unless ``--device``
says otherwise.
"""
import argparse
import os

from ._common import load_eval_setup, report_at_exit, set_seeds


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Export keypoints via homographic adaptation')
    parser.add_argument('-y', '--yaml-config',
                        default='configs/config_export_keypoints.yaml')
    parser.add_argument('-o', '--output_file', required=True,
                        help='.npz, or .hdf5 / .h5 (needs h5py)')
    parser.add_argument('-m', '--model-dir', default='model_weights/xpoint')
    parser.add_argument('-v', '--version', default='latest')
    parser.add_argument('-snms', '--single-nms', action='store_true',
                        help='Accepted for reference-CLI compatibility; NMS '
                             'always runs per-sample in this implementation')
    parser.add_argument('-skip', dest='skip_processed', action='store_true')
    parser.add_argument('-f', '--frequency', default=1, type=int,
                        help='Backup the output file every f batches')
    parser.add_argument('-s', '--seed', default=0, type=int)
    parser.add_argument('--max-samples', default=None, type=int)
    parser.add_argument('--batch', default=None, type=int,
                        help='Samples per HA step (default 1: one card)')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the model (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the export; returns the number of samples exported."""
    args = parse_args(argv)
    report_at_exit('export_keypoints')
    set_seeds(args.seed)

    config, module, _, dataset = load_eval_setup(
        args, single_image_override=False)

    from ..selfsup.export import export_keypoints, open_sink

    resume = args.skip_processed and os.path.exists(args.output_file)
    sink = open_sink(args.output_file, resume=resume)
    if resume:
        print(f"skipping {len(sink.done)} already-processed samples")
    try:
        n = export_keypoints(
            module, dataset, sink, config.get('homographic_adaptation', {}),
            config['prediction'], seed=args.seed, batch=args.batch or 1,
            max_samples=args.max_samples, frequency=args.frequency,
            log=lambda line: print(line, flush=True))
    finally:
        sink.close()
    print(f"done: keypoints written to {args.output_file}")
    return n


if __name__ == '__main__':
    main()
