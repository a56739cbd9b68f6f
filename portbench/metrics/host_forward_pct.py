"""Host self time of the forward (the program's ``forward`` span, a
training step's model call through its loss, and ``forward.encoder``, the
backbone) over the profiled stretch's wall, in percent; the kernels'
wrappers inside are ``host_kernel_wrapper_pct``'s."""

from portbench import spans


def read(ctx):
    return spans.layer_share(ctx, "forward")
