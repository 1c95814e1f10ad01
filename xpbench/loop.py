"""What the traffic drivers (``drivers/<kind>.py``) share: completion
events, the device fence, the profiler and the context that the per-layer
metric readers read."""
import torch


class Done:
    """A stand-in for a CUDA event on the CPU, where work is synchronous."""

    def synchronize(self):
        pass


def event(device):
    if device != "cuda":
        return Done()
    ev = torch.cuda.Event(blocking=True)
    ev.record()
    return ev


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


class Ctx:
    """What the per-layer metric readers read (``layer_metrics``)."""

    def __init__(self, cell, trace, traced_s, s_per_call):
        self.kind = cell.traffic["kind"]
        self.config, self.traffic = cell.config, cell.traffic
        self.trace, self.traced_s = trace, traced_s
        self.s_per_call = s_per_call
        self.work = None


def profile(device):
    from torch import profiler
    acts = [profiler.ProfilerActivity.CPU] + (
        [profiler.ProfilerActivity.CUDA] if device == "cuda" else [])
    return profiler.profile(activities=acts)
