"""The routed experts' grouped GEMMs (``ops/moe.py``: PyTorch's grouped
GEMM, a CUTLASS kernel over the experts' groups of rows): the least time of
the profiled stretch's ``moe_gemm`` work, from its valid rows' operations
and bytes, over the device time of the grouped-GEMM kernels, in percent.
The kernels are matched by the names the trace shows (CUTLASS's grouped
problem shape, ``GroupProblemShape``, or a name with ``grouped``), which
the dense products' cuBLAS kernels (``nvjet_*``) do not carry."""

from portbench import flops

PATTERN = r"GroupProblemShape|[Gg]rouped"


def read(ctx):
    seconds = ctx.stretch.seconds_matching(PATTERN)
    least = sum(flops.least_seconds(o, b) for o, b in ctx.kernel_work.get("moe_gemm", []))
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least / seconds
