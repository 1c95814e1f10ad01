"""K3's share of its roofline in a training step: the least time for the
scan backward's bytes and operations (``work.scan_bidir_bwd`` at each
block's shapes, both sides) over the device time of ``bwd_chain_kernel``,
``bwd_span_kernel`` and ``finish_kernel`` a step."""
import re

from xpbench import work

KERNELS = re.compile(r"\b(bwd_chain|bwd_span|finish)_kernel\b")


def read(ctx):
    us = ctx.trace.kernel_us(KERNELS) / ctx.trace.calls
    if us <= 0:
        return None
    launches = work.scan_launches(ctx.config["model"], ctx.traffic["image"],
                                  ctx.traffic["batch"])
    bound = 2 * sum(work.bound_s(work.scan_bidir_bwd(L, M, G))
                    for L, M, G, _ in launches)
    return 100.0 * bound / (us * 1e-6)
