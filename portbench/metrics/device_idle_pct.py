"""The share of the profiled stretch's own wall time in which no kernel ran
on the card (one minus the union of kernel intervals over the wall), in
percent."""


def read(ctx):
    s = ctx.stretch
    if s.window_s <= 0 or s.kernels == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
