"""The ``train`` traffic driver: steps back to back through the
program's ``train.make_train_step`` over its ``TrainState``. The traffic
file holds ``image``, ``batch`` (pairs a step), ``keypoints`` (a sample's
labelled points), ``pool`` (distinct batches, cycled), ``checked_steps``
(steps the reference follows) and ``profiled_steps``. The loss is read on
the host once, at the end of the window, which measures
``train_samples_per_s``.
"""
import time

import torch

from xpbench import check, data
from xpbench.loop import Ctx, profile, sync
from xpbench.trace import ModelRanges, Trace


class Driver:
    def __init__(self, cell, module, seed, device, faults):
        self.cell, self.module, self.seed, self.device = (cell, module, seed,
                                                          device)
        self.t = cell.traffic
        self.faults = faults

    def setup(self):
        from xpoint_tpu_torch.losses.xpoint_loss import XPointLoss
        from xpoint_tpu_torch.train.train_step import (TrainState,
                                                       make_optimizer,
                                                       make_train_step)
        cfg, t = self.cell.config, self.t
        tx, _ = make_optimizer(cfg["training"])
        self.state = TrainState(self.module, tx)
        step = make_train_step(self.module, XPointLoss(cfg["loss"]),
                               takes_pair=True)
        self.step = self.faults.get("train", lambda s, st: s)(step,
                                                               self.state)
        H, W = t["image"]
        gen = torch.Generator(device=self.device).manual_seed(
            data.sub_seed(self.seed, 2))
        self.pool = data.train_pool(t["pool"], t["batch"], H, W,
                                    t["keypoints"], gen, self.device)
        self.step_seeds = [data.sub_seed(self.seed, 10 + s)
                           for s in range(t["checked_steps"])]

    def warm_up(self):
        """The first steps, which the reference follows: the state after
        the first and the change over all of them are kept."""
        st = self.state
        names = st.names
        p0 = [p.detach().clone() for p in st.params]
        losses = []
        for s, seed in enumerate(self.step_seeds):
            gen = torch.Generator(device=self.device).manual_seed(seed)
            comps = self.step(st, self.pool[s], gen)
            losses.append(comps["loss"])
            if s == 0:
                mu = st.optimizer.views(st.optimizer.mu)
                grads = {n: m.detach() / (1 - st.optimizer.b1)
                         for n, m in zip(names, mu)}
        self.record = {
            "losses": [v.item() for v in losses], "grads": grads,
            "delta": {n: p.detach() - q for n, p, q in zip(names, st.params,
                                                             p0)}}
        self.gen = torch.Generator(device=self.device).manual_seed(
            data.sub_seed(self.seed, 9))
        self.i = len(self.step_seeds)
        sync(self.device)

    def _steps(self, seconds):
        comps, t_end = [], time.perf_counter() + seconds
        t_a = time.perf_counter()
        while time.perf_counter() < t_end:
            comps.append(self.step(self.state,
                                   self.pool[self.i % len(self.pool)],
                                   self.gen))
            self.i += 1
        last = comps[-1]["loss"].item()
        t_b = time.perf_counter()
        skipped = int(sum(c["skipped_nonfinite"] for c in comps).item())
        return len(comps), t_b - t_a, skipped, last

    def window(self, seconds, trace):
        B = self.t["batch"]
        if not trace:
            n, dt, skipped, _ = self._steps(seconds)
            return {"e2e": {"train_samples_per_s": n * B / dt},
                    "attempted": n, "failed": skipped}
        n, dt, skipped, _ = self._steps(seconds / 2)
        n_prof = self.t["profiled_steps"]
        ranges = ModelRanges(self.module)
        with profile(self.device) as prof:
            t_a = time.perf_counter()
            for _ in range(n_prof):
                self.step(self.state, self.pool[self.i % len(self.pool)],
                          self.gen)
                self.i += 1
            sync(self.device)
            traced_s = time.perf_counter() - t_a
        ranges.remove()
        tr = Trace.from_profiler(prof, n_prof)
        return {"ctx": Ctx(self.cell, tr, traced_s, dt / n),
                "attempted": n + n_prof, "failed": skipped}

    def check(self, state):
        record = self.record
        batches = self.pool[:len(self.step_seeds)]
        del self.module, self.state, self.step
        if self.device == "cuda":
            torch.cuda.empty_cache()
        ref = check.reference_steps(self.cell.config, state, batches,
                                    self.step_seeds, self.device)
        readings, _ = check.train_readings(record, ref)
        return readings
