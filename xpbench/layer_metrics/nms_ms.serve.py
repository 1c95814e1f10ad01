"""Device ms a serving call in K2, the box-NMS kernels (``nms_*``). A
time and not a roofline share: K2's work depends on its sweeps, which the
program does not report."""
import re

KERNELS = re.compile(r"\bnms_\w*kernel\b")


def read(ctx):
    us = ctx.trace.kernel_us(KERNELS)
    return us / ctx.trace.calls * 1e-3 if us > 0 else None
