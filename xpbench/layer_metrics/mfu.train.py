"""The whole training step's share of the card's peaks: the least time the
peaks allow for a step's work (``work.count``: the forward's and the
backward's products at the precision the configuration states, the scan
forward and backward in float32; recomputation not counted) over the
measured wall time a step in the untraced rest of the window."""
from xpbench import work


def read(ctx):
    if not ctx.work:
        return None
    return 100.0 * work.least_seconds(ctx.work) / ctx.s_per_call
