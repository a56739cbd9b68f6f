"""Kernel 1 (``ops/csrc/band_attention_fwd.cu``): the least time of the
profiled stretch's launches, from their valid rows' operations and bytes,
over the device time of the kernels named ``band_attention_fwd*``, in
percent."""

from portbench import flops


def read(ctx):
    seconds = ctx.stretch.seconds_matching(r"band_attention_fwd")
    least = sum(flops.least_seconds(o, b) for o, b in ctx.kernel_work.get("attn_fwd", []))
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
