"""Pseudo-ground-truth keypoint export by homographic adaptation (the loop
of ``cli/export_keypoints.py`` as a library function).

For every dataset pair: run the HA warp -> forward -> unwarp -> aggregate
program, NMS + threshold, and write the keypoint coordinates to a sink keyed
by sample name (``keypoints``, or ``keypoints_optical`` /
``keypoints_thermal`` in window aggregation). Resume skips the names the
sink already holds; a backup is taken every ``frequency`` steps. The
entry point over a model directory and a dataset config is
``python -m xpoint_tpu_torch.cli.export_keypoints``.
"""
import os
import shutil

import numpy as np
import torch

from ..data.group_file import NpzGroupFile, is_hdf5, write_npz_groups
from ..eval.infer import XPointInference
from ..ops.detector import prob_from_logits
from .homographic_adaptation import make_ha_fn, sample_ha_homographies


class NumpySink:
    """Keypoints in memory as {sample name: {dataset name: array}}, saved as
    one ``.npz`` (entries ``<sample>/<dataset>``, which
    ``data.group_file`` reads as groups) when a path is given. Needs
    nothing but numpy. As :class:`H5Sink` appends to an existing file, the
    samples of an existing file are kept and skipped; ``resume`` only
    records them as done before the run (``done``)."""

    def __init__(self, path=None, resume=False):
        self.path = path
        self.groups = {}
        if path and os.path.exists(path):
            with NpzGroupFile(path) as f:
                for name in f.keys():
                    self.groups[name] = {ds: f[name][ds]
                                         for ds in f[name].keys()}
        self.done = set(self.groups) if resume else set()

    def names(self):
        return set(self.groups)

    def write(self, name, arrays):
        self.groups[name] = {k: np.asarray(v) for k, v in arrays.items()}

    def flush(self):
        """Rewrite the whole file (fine at the label sets of the cycle:
        128 pairs); it is replaced only when complete."""
        if self.path:
            write_npz_groups(self.path, self.groups)

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
        self.done = set()
        if resume and exists:
            with h5py.File(path, 'r') as f:
                self.done = set(f.keys())
        self.file = h5py.File(path, 'a' if exists else 'w')

    def names(self):
        return self.done | set(self.file.keys())

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


def open_sink(path, resume=False):
    """The sink of ``path`` by its suffix: :class:`H5Sink` for ``.hdf5`` /
    ``.h5``, else :class:`NumpySink`."""
    return (H5Sink if is_hdf5(path) else NumpySink)(path, resume=resume)


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

