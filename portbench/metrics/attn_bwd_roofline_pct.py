"""Kernel 2 (``ops/csrc/band_attention_bwd.cu``: its query, key and
reduction passes): the least time of the profiled stretch's launches, from
their valid rows' operations and bytes, over the device time of the
kernels named ``band_bwd_*``, in percent."""

from portbench import flops


def read(ctx):
    seconds = ctx.stretch.seconds_matching(r"band_bwd_")
    least = sum(flops.least_seconds(o, b) for o, b in ctx.kernel_work.get("attn_bwd", []))
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
