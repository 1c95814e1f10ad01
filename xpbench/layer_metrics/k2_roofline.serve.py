"""K2's share of its roofline in serving: the least time for the box-NMS
calls of the profiled calls (the program's ``xp.k.nms_sweep`` spans give
each call's planes, size and box) at the sweeps the program counted, over
the device time of the ``nms_*kernel`` kernels in the trace.

The bound of a call: p (4 B) and the valid mask (1 B) read and keep (1 B)
written once, 6 B a pixel, at 3.35e12 B/s; and :func:`nms_compares`
float32 comparisons a pixel a plane-sweep at 67e12 a second, the longer of
the two. The plane-sweeps of a call: its planes times the sweeps a plane
the program counted over the process (``nms.plane_sweeps`` over
``nms.planes``). A frozen copy of ``kernels/cost.py::nms``."""
import re

from xpbench import records

KERNELS = re.compile(r"\bnms_\w*kernel\b")
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def overlap_widths(size, iou):
    """Allowed |dx| for each |dy| < size (``ops/nms.py``), -1 where none."""
    s = float(size)
    thr = 2.0 * iou * s * s / (1.0 + iou)
    widths = []
    for dy in range(size):
        w = -1
        for dx in range(size):
            if (s - dy) * (s - dx) > thr:
                w = dx
        widths.append(w)
    return widths


def nms_compares(size, iou):
    """Comparisons a pixel a sweep: the running maxima, the combine over
    the rows with a strip, the test against p."""
    widths = overlap_widths(size, iou)
    return 2 * max(widths) + 2 * sum(w >= 0 for w in widths) - 1


def read(ctx):
    spans = records.call_spans(ctx)
    counts = records.counters()
    us = ctx.trace.kernel_us(KERNELS)
    calls = [s["attrs"] for s in spans or () if s["name"] == "xp.k.nms_sweep"]
    if not calls or not counts or us <= 0:
        return None
    planes = counts.get("nms.planes", 0)
    sweeps = counts.get("nms.plane_sweeps", 0)
    if planes <= 0 or sweeps <= 0:
        return None
    bound = 0.0
    for a in calls:
        px = a["planes"] * a["height"] * a["width"]
        flops = nms_compares(a["size"], a["iou"]) * px * sweeps / planes
        bound += max(6 * px / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
    return 100.0 * bound / (us * 1e-6)
