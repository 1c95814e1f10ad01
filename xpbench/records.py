"""What the per-layer readers take from the program's own records
(``xpoint_tpu_torch.obs``): the spans of the traced calls, the ring of
root calls and the counters. The program keeps spans while a profiler
records, so in the traced run it keeps exactly those of the profiled
calls. Each function returns None where the program keeps no such records
(a program without ``obs``), or where its root calls on record do not
number the calls the benchmark profiled."""
import statistics

ROOT = {"serve": "xp.pipe.call", "train": "xp.train.step"}


def _obs():
    try:
        from xpoint_tpu_torch import obs
    except ImportError:
        return None
    return obs


def counters():
    """The program's counters, {name: int}, or None."""
    obs = _obs()
    return None if obs is None else obs.counters()


def call_spans(ctx):
    """Every span of the profiled calls (dicts of ``obs.spans()``), or
    None where the program's root spans are not ``ctx.trace.calls``."""
    obs = _obs()
    if obs is None:
        return None
    spans = obs.spans()
    roots = {s["id"] for s in spans if s["name"] == ROOT[ctx.kind]}
    if len(roots) != ctx.trace.calls:
        return None
    return [s for s in spans if s["call"] in roots]


def device_ms(ctx, name):
    """Device ms a call inside the spans ``name`` (their CUDA events), or
    None where none has device events."""
    spans = call_spans(ctx)
    dev = [s for s in spans or () if s["name"] == name
           and s["dev_start"] is not None]
    if not dev:
        return None
    return sum(s["dev_end"] - s["dev_start"] for s in dev) \
        / ctx.trace.calls * 1e-6


def host_ms(ctx):
    """The median host ms of the root calls made with no profiler
    recording (the ring of the last calls), or None where the profiled ones
    on record are not ``ctx.trace.calls``."""
    obs = _obs()
    if obs is None:
        return None
    calls = obs.calls(ROOT[ctx.kind])
    plain = [c["host_end"] - c["host_start"] for c in calls
             if not c["profiled"]]
    if sum(c["profiled"] for c in calls) != ctx.trace.calls or not plain:
        return None
    return statistics.median(plain) * 1e-6
