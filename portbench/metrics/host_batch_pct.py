"""Host self time of device-side batch assembly (the program's ``batch``
spans: sequence assembly, pair sampling, whole-word MLM) over the profiled
stretch's wall, in percent."""

from portbench import spans


def read(ctx):
    return spans.layer_share(ctx, "batch")
