"""Device ms of a training step's forward: the device time of the
operations launched inside the two forwards and RegNet's (marked by the
benchmark's hooks), in the profiler's trace, a step. The backward, the
loss and Adam are the rest."""


def read(ctx):
    split = ctx.trace.model_split_us()
    if split is None or split[0] <= 0:
        return None
    return split[0] / ctx.trace.calls * 1e-3
