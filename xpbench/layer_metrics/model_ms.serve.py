"""Device ms a serving call spends in the model: the device time of the
operations launched inside the two forwards (the benchmark's hooks mark
each from the encoder's start to the descriptor head's end), in the
profiler's trace, a call."""


def read(ctx):
    split = ctx.trace.model_split_us()
    if split is None or split[0] <= 0:
        return None
    return split[0] / ctx.trace.calls * 1e-3
