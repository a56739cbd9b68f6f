"""Host self time of the optimizer (the program's ``optimizer`` span:
accumulation on every micro-step, clipping and AdamW on each update) over
the profiled stretch's wall, in percent."""

from portbench import spans


def read(ctx):
    return spans.layer_share(ctx, "optimizer")
