"""Host self time of scoring against the catalog (the program's ``score``
span) over the profiled stretch's wall, in percent."""

from portbench import spans


def read(ctx):
    return spans.layer_share(ctx, "score")
