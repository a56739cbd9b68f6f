"""Host self time of the hand-written kernels' wrappers (the program's
``launch.*`` spans: checks, aligned copies, the ctypes launch) over the
profiled stretch's wall, in percent."""

from portbench import spans


def read(ctx):
    return spans.layer_share(ctx, "launch")
