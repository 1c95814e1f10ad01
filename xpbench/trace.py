"""What the traced run reads: a ``torch.profiler`` trace of a short
stretch of the window, with the model's forwards marked as ranges by
forward hooks that the benchmark registers (:class:`ModelRanges`).

From the trace: every device operation's interval (kernels, copies,
sets), their union (the busy time), the kernels by name, the device time
of what the model's forwards launched, and the idle gaps between the
operations, each named by the host operation that launched the operation
that ended it.
"""
import bisect
import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MODEL_RANGE = "xpbench.model"


class Trace:
    """The device operations of one profiled stretch of ``calls`` calls."""

    def __init__(self, events, calls):
        self.calls = calls
        self.ops = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                            e.get("cat"), (e.get("args") or {}).get(
                                "correlation"))
                           for e in events if e.get("cat") in DEVICE_CATS),
                          key=lambda o: o[0])
        self.kernels = [o for o in self.ops if o[3] == "kernel"]
        self._host, self._launch = self._host_names(events)
        self.model = sorted((e["ts"], e["ts"] + e.get("dur", 0))
                            for e in events if e.get("name") == MODEL_RANGE
                            and e.get("cat") == "user_annotation")

    @classmethod
    def from_profiler(cls, prof, calls):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events, calls)

    @staticmethod
    def _host_names(events):
        """correlation id -> name of the innermost host operation around
        the runtime call that launched it, and -> that call's time."""
        ops = sorted((e for e in events if e.get("cat") == "cpu_op"),
                     key=lambda e: e["ts"])
        starts = [e["ts"] for e in ops]
        out, when = {}, {}
        for e in events:
            if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
                continue
            when[(e.get("args") or {}).get("correlation")] = e["ts"]
            name = e["name"]
            i = bisect.bisect_right(starts, e["ts"]) - 1
            for j in range(i, max(i - 256, -1), -1):
                o = ops[j]
                if o["tid"] == e["tid"] and o["ts"] + o.get("dur", 0) >= \
                        e["ts"]:
                    name = o["name"]
                    break
            out[(e.get("args") or {}).get("correlation")] = name
        return out, when

    def busy_us(self):
        """Microseconds in which some device operation ran."""
        busy, end = 0.0, float("-inf")
        for s, e, *_ in self.ops:
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy

    def kernel_us(self, pattern):
        """Microseconds of the kernels whose name matches ``pattern``."""
        return sum(e - s for s, e, n, *_ in self.kernels if pattern.search(n))

    def model_split_us(self):
        """(device microseconds of the operations launched inside the
        model's ranges, of the others); None where no range was traced."""
        if not self.model:
            return None
        starts = [r[0] for r in self.model]
        inside = outside = 0.0
        for s, e, _, _, corr in self.ops:
            t = self._launch.get(corr)
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= self.model[i][1]:
                inside += e - s
            else:
                outside += e - s
        return inside, outside

    def top_ops(self, n=10):
        by = {}
        for s, e, name, *_ in self.ops:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in top]

    def idle_gaps(self, n=10):
        """Idle time between device operations, summed by the host
        operation that launched the operation after each gap."""
        by, end = {}, None
        for s, e, _, _, corr in self.ops:
            if end is not None and s > end:
                name = self._host.get(corr, "?")[:120]
                by[name] = by.get(name, 0.0) + (s - end)
            end = e if end is None else max(end, e)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-6] for k, v in top]


class ModelRanges:
    """Forward hooks that mark each forward of the model as a profiler
    range: from the encoder's start to the descriptor head's end, and
    RegNet's forward on its own. (The train step calls ``forward_pair``,
    which passes by the top module's own hooks.)"""

    def __init__(self, module):
        self.open, self.handles = None, []
        self._hook(module.encoder, module.descriptor_head)
        if getattr(module, "hm_regressor", None) is not None:
            self._hook(module.hm_regressor, module.hm_regressor)

    def _hook(self, first, last):
        self.handles.append(first.register_forward_pre_hook(
            lambda m, a: self._enter()))
        self.handles.append(last.register_forward_hook(
            lambda m, a, o: self._exit()))

    def _enter(self):
        self.open = torch.profiler.record_function(MODEL_RANGE)
        self.open.__enter__()

    def _exit(self):
        self.open.__exit__(None, None, None)
        self.open = None

    def remove(self):
        for h in self.handles:
            h.remove()
