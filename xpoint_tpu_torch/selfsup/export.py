"""Pseudo-ground-truth keypoint export by homographic adaptation (the loop
of ``cli/export_keypoints.py`` as a library function).

For every dataset pair: run the HA warp -> forward -> unwarp -> aggregate
program, NMS + threshold, and write the keypoint coordinates to a sink keyed
by sample name (``keypoints``, or ``keypoints_optical`` /
``keypoints_thermal`` in window aggregation). Resume skips the names the
sink already holds; a backup is taken every ``frequency`` steps.

    python -m xpoint_tpu_torch.selfsup.export -o labels.npz [--samples 4]

exports labels for the seeded synthetic corpus with a seeded, untrained
flagship model (no checkpoint or dataset is in the repository; the
export CLI that loads them, ``cli/export_keypoints.py``, is ROADMAP.md
Queue 1 item 6).
"""
import argparse
import os
import shutil
import sys

import numpy as np
import torch

from ..eval.infer import XPointInference
from ..ops.detector import prob_from_logits
from .homographic_adaptation import (EXPORT_HA_CONFIG,
                                     EXPORT_PREDICTION_CONFIG, make_ha_fn,
                                     sample_ha_homographies)


class NumpySink:
    """Keypoints in memory as {sample name: {dataset name: array}}, saved as
    one ``.npz`` (entries ``<sample>/<dataset>``) when a path is given.
    Needs nothing but numpy."""

    def __init__(self, path=None, resume=False):
        self.path = path
        self.groups = {}
        if resume and path and os.path.exists(path):
            with np.load(path) as f:
                for key in f.files:
                    name, ds = key.rsplit("/", 1)
                    self.groups.setdefault(name, {})[ds] = f[key]

    def names(self):
        return set(self.groups)

    def write(self, name, arrays):
        self.groups[name] = {k: np.asarray(v) for k, v in arrays.items()}

    def flush(self):
        if self.path:
            np.savez(self.path, **{f"{n}/{k}": v
                                   for n, g in self.groups.items()
                                   for k, v in g.items()})

    def backup(self):
        if self.path and os.path.exists(self.path):
            shutil.copyfile(self.path, self.path + ".bak")

    def close(self):
        self.flush()


class H5Sink:
    """Keypoints in an HDF5 file, one group per sample name holding the
    datasets, the layout ``cli/export_keypoints.py`` writes and the JAX
    package's loaders read. Imports ``h5py`` when constructed."""

    def __init__(self, path, resume=False):
        import h5py
        self.path = path
        exists = os.path.exists(path)
        self._done = set()
        if resume and exists:
            with h5py.File(path, 'r') as f:
                self._done = set(f.keys())
        self.file = h5py.File(path, 'a' if exists else 'w')

    def names(self):
        return self._done | set(self.file.keys())

    def write(self, name, arrays):
        grp = self.file.create_group(name)
        for k, v in arrays.items():
            grp.create_dataset(k, data=v)

    def flush(self):
        self.file.flush()

    def backup(self):
        shutil.copyfile(self.path, self.path + ".bak")

    def close(self):
        self.file.close()


def make_prob_fn(module):
    """The detector as HA takes it: (image (B,H,W,1), is_optical) -> prob
    (B,H,W), the image run through the optical route when ``is_optical``
    and the thermal one otherwise (``cli/export_keypoints.py:53-56``)."""
    def prob_fn(img, is_optical):
        out = module(img, "optical" if is_optical else "thermal")
        return prob_from_logits(out['logits'],
                                module.encoder_downsample_ratio)
    return prob_fn


def export_keypoints(module, dataset, sink, ha_config=None,
                     prediction_config=None, seed=0, batch=1,
                     max_samples=None, frequency=1, log=None):
    """Run the label export over ``dataset`` into ``sink``.

    dataset: ``__len__``, ``__getitem__`` -> {'optical': {'image' (H,W,1)},
    'thermal': {'image'}} and ``get_name``. One homography stack is sampled
    per chunk of ``batch`` samples from ``np.random.default_rng(seed)``.
    Samples whose name the sink already holds are skipped. Returns the
    number of samples exported; the sink is flushed but left open."""
    infer = XPointInference(module, prediction_config)
    run_ha, cfg = make_ha_fn(make_prob_fn(module), ha_config)
    window_mode = cfg['aggregation'] == 'window'
    rng = np.random.default_rng(seed)
    n = len(dataset) if max_samples is None else min(max_samples,
                                                     len(dataset))
    done = sink.names()
    pending = [i for i in range(n) if dataset.get_name(i) not in done]
    n_done = 0
    for step, pos in enumerate(range(0, len(pending), batch), start=1):
        chunk = pending[pos:pos + batch]
        samples = [dataset[i] for i in chunk]
        img_o, img_t = (torch.from_numpy(np.stack(
            [np.asarray(s[side]['image'], np.float32) for s in samples])
        ).to(infer.device) for side in ('optical', 'thermal'))
        Hs = sample_ha_homographies(cfg, img_o.shape[1:3], rng)
        out = run_ha(img_o, img_t, torch.from_numpy(Hs).to(infer.device))

        def extract_all(prob):
            p = infer.nms(prob)
            return [infer.keypoints_from_prob(p[b])
                    for b in range(len(chunk))]

        if window_mode:
            kps = {'keypoints_optical': extract_all(out['prob_optical']),
                   'keypoints_thermal': extract_all(out['prob_thermal'])}
        else:
            kps = {'keypoints': extract_all(out['prob'])}
        for b, i in enumerate(chunk):
            sink.write(dataset.get_name(i), {k: v[b] for k, v in kps.items()})
        sink.flush()
        n_done += len(chunk)
        if frequency and step % max(frequency, 1) == 0:
            if log:
                log(f"[{n_done}/{len(pending)}] exported through "
                    f"{dataset.get_name(chunk[-1])}")
            sink.backup()
    return n_done


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Export keypoints via homographic adaptation')
    parser.add_argument('-o', '--output_file', required=True,
                        help='.npz, or .hdf5 / .h5 (needs h5py)')
    parser.add_argument('-skip', dest='skip_processed', action='store_true')
    parser.add_argument('-f', '--frequency', default=1, type=int)
    parser.add_argument('-s', '--seed', default=0, type=int)
    parser.add_argument('--samples', default=4, type=int)
    parser.add_argument('--size', default=512, type=int)
    parser.add_argument('--batch', default=1, type=int)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    from ..data.synthetic_pairs import SyntheticPairs
    from ..models import VMAMBA_MODEL_CFG, build_xpoint
    module, _ = build_xpoint(VMAMBA_MODEL_CFG, device=args.device,
                             seed=args.seed)
    dataset = SyntheticPairs(n_pairs=args.samples, size=args.size, n_kp=1,
                             seed=args.seed)
    h5 = args.output_file.endswith(('.hdf5', '.h5'))
    sink = (H5Sink if h5 else NumpySink)(args.output_file,
                                         resume=args.skip_processed)
    try:
        n = export_keypoints(module, dataset, sink, EXPORT_HA_CONFIG,
                             EXPORT_PREDICTION_CONFIG, seed=args.seed,
                             batch=args.batch, frequency=args.frequency,
                             log=print)
    finally:
        sink.close()
    print(f"done: keypoints of {n} samples written to {args.output_file}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
