"""K1's share of its roofline in a serving call: the least time for the
bidirectional scan's bytes and operations (``work.scan_bidir`` at each
block's shapes, both forwards) over the device time of its kernels,
``bidir_chain_kernel`` and ``bidir_span_kernel``, a call."""
import re

from xpbench import work

KERNELS = re.compile(r"\bbidir_(chain|span)_kernel\b")
CKPT = False


def read(ctx):
    us = ctx.trace.kernel_us(KERNELS) / ctx.trace.calls
    if us <= 0:
        return None
    launches = work.scan_launches(ctx.config["model"], ctx.traffic["image"],
                                  ctx.traffic["batch"])
    bound = 2 * sum(work.bound_s(work.scan_bidir(*s, emit_ckpt=CKPT))
                    for s in launches)
    return 100.0 * bound / (us * 1e-6)
