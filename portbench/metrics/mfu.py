"""Model FLOPs utilization: the operations the window's inputs need over
valid tokens (``portbench/flops.py``) over the bf16 dense peak times the
unprofiled window's wall time, in percent."""

from portbench import flops


def read(ctx):
    if ctx.window_flops <= 0 or ctx.window_wall_s <= 0:
        return None
    return 100.0 * ctx.window_flops / (flops.PEAK_BF16_FLOPS * ctx.window_wall_s)
