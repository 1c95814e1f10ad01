"""Minimal data loader (own copy of ``xpoint_tpu/data/loader.py:25-187``):
seeded shuffling, drop-last, numpy batch collation, and a pool of worker
threads so that host-side sample preparation overlaps the card's work.

Threads instead of processes: the per-sample work (numpy, and in the host
data path cv2 warps and h5py reads) releases the GIL, so a thread pool
parallelizes it without pickling batches across a process boundary.
``workers`` takes the ``training: num_worker`` key. Batches are handed out
in a deterministic order whatever the worker count (ordered reassembly);
with ``workers > 1``, datasets that draw from a shared RNG interleave
their draws across threads in no fixed order. Worker failures propagate
to the consumer at the failing batch.
"""
import queue
import threading
import time

import numpy as np


def collate(samples):
    """Stack a list of sample dicts into a batch dict of numpy arrays."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], dict):
            out[key] = collate(vals)
        elif isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals         # e.g. names
    return out


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0,
                 drop_last=True, prefetch=2, workers=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = max(1, int(workers))
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _build(self, batch_idx):
        return collate([self.dataset[int(i)] for i in batch_idx])

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.prefetch <= 0:
            for b in batches:
                yield self._build(b)
            return

        # worker pool with ordered reassembly: up to `ahead` batches in
        # flight, yielded strictly in submission order.
        # Daemon threads on purpose: an abandoned epoch (break, exception,
        # Ctrl-C) must never join a worker that is wedged inside native
        # code (cv2/h5py) — teardown just stops feeding and walks away,
        # matching the old daemon prefetch-thread semantics.
        ahead = max(self.prefetch, self.workers)
        pool = _OrderedPool(self._build, self.workers)
        it = iter(batches)
        seq_submit = seq_yield = 0
        try:
            for _ in range(ahead):
                b = next(it, None)
                if b is None:
                    break
                pool.submit(seq_submit, b)
                seq_submit += 1
            while seq_yield < seq_submit:
                batch = pool.get(seq_yield)
                seq_yield += 1
                b = next(it, None)
                if b is not None:
                    pool.submit(seq_submit, b)
                    seq_submit += 1
                yield batch
        finally:
            pool.close()


class _OrderedPool:
    """Daemon-thread worker pool yielding results by submission sequence
    number. close() drops queued work, then waits a BOUNDED time for
    in-flight __getitem__ calls (so an abandoned epoch's builds cannot
    interleave global-np.random draws or h5py reads with the next epoch's
    pool), and finally walks away — a worker wedged in native code
    (cv2/h5py) can delay teardown by at most the timeout, never hang it."""

    def __init__(self, fn, workers):
        self._fn = fn
        self._workers = workers
        self._tasks = queue.SimpleQueue()
        self._results = {}
        self._cv = threading.Condition()
        self._closed = False
        self._busy = 0
        for i in range(workers):
            threading.Thread(target=self._work, daemon=True,
                             name=f"xpoint-loader-{i}").start()

    def submit(self, seq, arg):
        self._tasks.put((seq, arg))

    def _work(self):
        while True:
            item = self._tasks.get()
            if item is None:
                return
            seq, arg = item
            with self._cv:
                if self._closed:
                    self._busy_done()
                    return
                self._busy += 1
            try:
                res = (True, self._fn(arg))
            except BaseException as e:  # propagate to the consumer
                res = (False, e)
            with self._cv:
                self._busy -= 1
                closed = self._closed
                if not closed:
                    self._results[seq] = res
                self._cv.notify_all()
                if closed:
                    return

    def _busy_done(self):
        # called with cv held when a closed worker drops its task unrun
        self._cv.notify_all()

    def get(self, seq):
        with self._cv:
            while seq not in self._results:
                self._cv.wait()
            ok, val = self._results.pop(seq)
        if not ok:
            raise val
        return val

    def close(self, timeout=5.0):
        with self._cv:
            self._closed = True
        # drop queued-but-unstarted work; wake idle workers so they exit
        while not self._tasks.empty():
            try:
                self._tasks.get_nowait()
            except queue.Empty:
                break
        for _ in range(self._workers):
            self._tasks.put(None)
        # bounded wait for in-flight builds (normal early-exit: at most
        # one batch per worker, typically milliseconds; wedged native
        # code: give up after `timeout` and leave the daemon to it)
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._busy > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
