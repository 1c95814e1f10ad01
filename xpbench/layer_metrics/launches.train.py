"""Kernel launches a training step, counted in the profiler's trace."""


def read(ctx):
    n = len(ctx.trace.kernels)
    return n / ctx.trace.calls if n else None
