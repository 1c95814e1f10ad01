"""The device's idle share of a training step: 1 - (the union of the device
operations' intervals in the traced steps) / (the wall time of as many
steps in the untraced rest of the window, where the profiler adds no host
time)."""


def read(ctx):
    busy = ctx.trace.busy_us() * 1e-6 / ctx.trace.calls
    return None if busy <= 0 else 100.0 * (1.0 - busy / ctx.s_per_call)
