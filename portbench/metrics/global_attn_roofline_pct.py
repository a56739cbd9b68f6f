"""The global layers' attention (``ops/full_attention.py``: PyTorch's fused
scaled-dot-product attention, cuDNN's or the memory-efficient backend):
the least time of the profiled stretch's ``global_attn_fwd`` work, from
its valid rows' operations and bytes, over the device time of the forward
kernels those backends launch, in percent. The kernels are matched by the
names the trace shows: the memory-efficient backend's ``fmha_cutlassF*``,
cuDNN's ``*sdpa*fprop*`` / ``*fprop*sdpa*``, and ``flash_fwd*``."""

from portbench import flops

PATTERN = r"fmha_cutlassF|sdpa.*fprop|fprop.*sdpa|flash_fwd"


def read(ctx):
    seconds = ctx.stretch.seconds_matching(PATTERN)
    least = sum(flops.least_seconds(o, b) for o, b in ctx.kernel_work.get("global_attn_fwd", []))
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
