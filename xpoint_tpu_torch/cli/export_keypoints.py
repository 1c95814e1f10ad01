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
batch from ``np.random.default_rng(seed)``. Runs on the card unless
``--device`` says otherwise, on every visible GPU, one rank each (as the
JAX CLI shards over every chip): batches of ``--batch`` samples (default
the number of ranks, rounded down to a multiple of it) run sharded over
the ranks, the remainder batch unsharded, and rank 0 alone writes the
file. With one GPU, or on the CPU, it is the one-device export.
"""
import argparse
import os

from ..parallel.launch import launch
from ..parallel.mesh import make_mesh
from ._common import (CLI_COLLECTIVE_TIMEOUT_S, load_eval_setup,
                      rank_count, report_at_exit, set_seeds)


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
                        help='Samples per HA step (default: the number of '
                             'ranks)')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the model (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    """Runs the export; returns the number of samples exported (by rank 0
    where several ranks run)."""
    args = parse_args(argv)
    n = rank_count(args)
    if n > 1:
        return launch(_export, n, args=(args,), timeout=None,
                      collective_timeout=CLI_COLLECTIVE_TIMEOUT_S)
    return _export(args)


def _export(args):
    """The export on this rank (the only one, or one of the launched)."""
    report_at_exit('export_keypoints')
    set_seeds(args.seed)
    mesh = make_mesh(device=args.device)
    if mesh.size > 1:
        args.device = str(mesh.device)
    batch = args.batch or mesh.size
    batch = max(batch // mesh.size, 1) * mesh.size

    config, module, _, dataset = load_eval_setup(
        args, single_image_override=False)

    from ..selfsup.export import export_keypoints, open_sink

    main = mesh.rank == 0
    resume = args.skip_processed and os.path.exists(args.output_file)
    sink = open_sink(args.output_file, resume=resume) if main else None
    if resume and main:
        print(f"skipping {len(sink.done)} already-processed samples")
    try:
        n = export_keypoints(
            module, dataset, sink, config.get('homographic_adaptation', {}),
            config['prediction'], seed=args.seed, batch=batch,
            max_samples=args.max_samples, frequency=args.frequency,
            log=lambda line: print(line, flush=True), mesh=mesh)
    finally:
        if main:
            sink.close()
    if main:
        print(f"done: keypoints written to {args.output_file}")
    return n


if __name__ == '__main__':
    main()
