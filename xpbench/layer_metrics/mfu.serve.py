"""The whole call's share of the card's peaks: the least time the peaks
allow for a call's work (``work.count``: the products at the precision the
configuration states, the scan and the matching in float32) over the
measured wall time a call in the untraced rest of the window."""
from xpbench import work


def read(ctx):
    if not ctx.work:
        return None
    return 100.0 * work.least_seconds(ctx.work) / ctx.s_per_call
