"""Per-sample random generators for the host datasets.

The JAX package's host datasets draw from the process-wide ``random`` and
``np.random`` streams, so with several loader threads a sample depends on
which thread drew first. Here every sample draws from its own pair of
generators, derived from (seed, epoch, index): a batch is the same whatever
the number of workers, and a run resumed at an epoch sees the samples a
straight run sees. The pair is a ``np.random.RandomState`` and a
``random.Random``, the generators behind those two global streams, so a
sample drawn with both seeded by s equals the JAX package's sample after
``np.random.seed(s); random.seed(s)``.
"""
import random

import numpy as np


class SeededSamples:
    """Mixin: ``__getitem__(index)`` is ``sample(index, rng, py_rng)`` with
    generators derived from (``seed``, ``epoch``, ``index``); the trainer
    sets both with :meth:`set_epoch` at the start of every epoch."""
    seed = 0
    epoch = 0

    def set_epoch(self, epoch, seed=None):
        self.epoch = int(epoch)
        if seed is not None:
            self.seed = int(seed)

    def generators(self, index):
        np_seed, py_seed = np.random.SeedSequence(
            [self.seed, self.epoch, int(index)]).generate_state(2)
        return np.random.RandomState(np_seed), random.Random(int(py_seed))

    def __getitem__(self, index):
        return self.sample(index, *self.generators(index))
