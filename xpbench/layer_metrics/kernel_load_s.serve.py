"""Seconds this process spent loading the port's kernel libraries (the
program's counter ``kernels.load_ns``: each library's first load, a build
by nvcc included where the checkout had none)."""
from xpbench import records


def read(ctx):
    c = records.counters()
    if not c or not c.get("kernels.loaded"):
        return None
    return c["kernels.load_ns"] * 1e-9
