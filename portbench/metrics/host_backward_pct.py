"""Host self time of the backward (the program's ``backward`` span: autograd,
with the gradient reduction under a mesh) over the profiled stretch's wall,
in percent."""

from portbench import spans


def read(ctx):
    return spans.layer_share(ctx, "backward")
