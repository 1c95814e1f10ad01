"""Device ms a serving call inside the program's ``xp.enc.norm`` spans:
the encoders' LayerNorm with its casts to float32 and back, timed by the
spans' CUDA events."""
from xpbench import records


def read(ctx):
    return records.device_ms(ctx, "xp.enc.norm")
