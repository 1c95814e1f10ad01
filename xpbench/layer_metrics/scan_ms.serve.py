"""Device ms a serving call inside the program's ``xp.enc.scan`` spans:
each SS2D block from the projections into the scan through the merge of
its directions (K1 included), timed by the spans' CUDA events."""
from xpbench import records


def read(ctx):
    return records.device_ms(ctx, "xp.enc.scan")
