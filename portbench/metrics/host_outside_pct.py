"""The profiled stretch's wall outside every program span: the caller's
glue, ``topk``, and the wait at the copy to the host or at the stretch's
closing synchronise, in percent."""

from portbench import spans


def read(ctx):
    return spans.outside_share(ctx)
