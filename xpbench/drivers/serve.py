"""The ``serve`` traffic driver: a closed loop of calls of the program's
``eval.make_pair_pipeline``. The traffic file holds ``image`` [H, W],
``batch`` (pairs a call), ``k``, ``nms_size``, ``threshold``, ``iou``,
``in_flight`` (calls dispatched and not yet back), ``pool`` (distinct
batches, cycled), ``checked`` (calls the check compares) and
``profiled_calls`` (calls under the profiler in the traced run). A call is
dispatched as soon as fewer than ``in_flight`` are outstanding; its
results (keypoints, masks, match indices, distances, flags) are copied to
pinned host memory, and it completes when they are there. The window
measures ``pairs_per_s`` and ``call_p95_ms``.
"""
import math
import queue
import sys
import threading
import time

import torch

from xpbench import check, data
from xpbench.loop import Ctx, event, profile, sync
from xpbench.trace import ModelRanges, Trace

HOST_KEYS = ("keypoints_optical", "keypoints_thermal", "mask_optical",
             "mask_thermal", "match_idx", "match_dist", "matched")


class Driver:
    def __init__(self, cell, module, seed, device, faults):
        self.cell, self.module, self.seed, self.device = (cell, module, seed,
                                                          device)
        self.t = cell.traffic
        self.faults = faults

    def setup(self):
        from xpoint_tpu_torch.eval.pipeline import make_pair_pipeline
        t = self.t
        H, W = t["image"]
        pipe = make_pair_pipeline(self.module, (H, W), k=t["k"],
                                  nms_size=t["nms_size"],
                                  detection_threshold=t["threshold"],
                                  iou=t["iou"])
        self.pipe = self.faults.get("serve", lambda p: p)(pipe)
        gen = torch.Generator(device=self.device).manual_seed(
            data.sub_seed(self.seed, 2))
        self.img_o, self.img_t = data.serve_pool(t["pool"], t["batch"], H, W,
                                                 gen, self.device)
        self.checked = data.pick(data.sub_seed(self.seed, 3), t["pool"],
                                 t["checked"])
        self.kept = {}
        pin = self.device == "cuda"
        self.slots = []
        for _ in range(t["in_flight"]):
            out = self.pipe(self.img_o[0], self.img_t[0])
            self.slots.append({k: torch.empty(out[k].shape,
                                              dtype=out[k].dtype,
                                              pin_memory=pin)
                               for k in HOST_KEYS})

    def warm_up(self):
        for i in range(2):
            self.pipe(self.img_o[i], self.img_t[i])
        sync(self.device)

    def _dispatch(self, i):
        idx = i % self.t["pool"]
        out = self.pipe(self.img_o[idx], self.img_t[idx])
        for k, buf in self.slots[i % len(self.slots)].items():
            buf.copy_(out[k], non_blocking=True)
        if idx in self.checked:
            self.kept[idx] = out
        return event(self.device)

    def _loop(self, seconds=None, calls=None, first=0):
        """Calls until ``seconds`` have passed (or ``calls`` were made):
        (dispatch times, completion times) of every call dispatched, all
        waited for."""
        n_slots = len(self.slots)
        free = threading.Semaphore(n_slots)
        pending = queue.Queue()
        done = {}

        def waiter():
            while True:
                item = pending.get()
                if item is None:
                    return
                i, ev = item
                ev.synchronize()
                done[i] = time.perf_counter()
                free.release()

        # the waiter takes the interpreter lock within 0.1 ms of its call's
        # completion, not at the dispatching thread's next 5 ms switch
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        th = threading.Thread(target=waiter, daemon=True)
        th.start()
        starts = []
        t_end = time.perf_counter() + (seconds or 0.0)
        try:
            while (len(starts) < calls if calls is not None
                   else time.perf_counter() < t_end):
                free.acquire()
                i = first + len(starts)
                starts.append(time.perf_counter())
                pending.put((i, self._dispatch(i)))
        finally:
            pending.put(None)
            th.join()
            sys.setswitchinterval(interval)
        return starts, [done[first + i] for i in range(len(starts))]

    def window(self, seconds, trace):
        B = self.t["batch"]
        if not trace:
            starts, ends = self._loop(seconds)
            t_end = starts[0] + seconds
            lat = sorted(e - s for s, e in zip(starts, ends))
            p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
            n_in = sum(1 for e in ends if e <= t_end)
            return {"e2e": {"pairs_per_s": n_in * B / seconds,
                            "call_p95_ms": p95 * 1e3},
                    "attempted": len(starts) * B, "failed": 0}
        starts, ends = self._loop(seconds / 2)
        s_per_call = (ends[-1] - starts[0]) / len(starts)
        n, n_prof = len(starts), self.t["profiled_calls"]
        ranges = ModelRanges(self.module)
        with profile(self.device) as prof:
            t_a = time.perf_counter()
            self._loop(calls=n_prof, first=n)
            sync(self.device)
            traced_s = time.perf_counter() - t_a
        ranges.remove()
        tr = Trace.from_profiler(prof, n_prof)
        return {"ctx": Ctx(self.cell, tr, traced_s, s_per_call),
                "attempted": (n + n_prof) * B, "failed": 0}

    def check(self, state):
        """The readings over the checked calls, the program's state freed
        first."""
        from xpbench import reference
        checked = [i for i in self.checked if i in self.kept]
        kept = {i: self.kept[i] for i in checked}
        imgs = {i: (self.img_o[i].clone(), self.img_t[i].clone())
                for i in checked}
        del self.module, self.pipe, self.img_o, self.img_t, self.kept
        if self.device == "cuda":
            torch.cuda.empty_cache()
        cfg = self.cell.config
        model, _ = reference.build(cfg["model"], cfg["precision"], state,
                                   self.device)
        total = {"prob_gap": float("inf")} if not checked else {}
        for i in checked:
            r = check.serve_readings(model, model.ratio, self.t, *imgs[i],
                                     kept[i])
            for k, v in r.items():
                total[k] = max(total.get(k, v), v) if k.endswith("gap") \
                    else total.get(k, 0) + v
        return total
