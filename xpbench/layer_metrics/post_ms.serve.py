"""Device ms a serving call spends outside the model: the device time of
every other operation of the call (detector, box-NMS with top-k,
descriptor sampling, matching, the copies to the host), in the profiler's
trace, a call."""


def read(ctx):
    split = ctx.trace.model_split_us()
    if split is None or split[1] <= 0:
        return None
    return split[1] / ctx.trace.calls * 1e-3
