"""The program's spans over the profiled stretch, as shares of its wall.

``recformer_tpu_torch/utils/profiling.py`` records spans only while a
``torch.profiler`` session runs, and in a benchmark run only the profiled
stretch runs one: its span registry holds that stretch alone. A program
without the registry (``self_seconds``) reads as nothing, not as 0."""

from __future__ import annotations


def _registry():
    from recformer_tpu_torch.utils import profiling

    if not hasattr(profiling, "self_seconds") or not profiling.self_seconds():
        return None
    return profiling


def layer_share(ctx, layer: str):
    """The summed self time of the spans named ``layer`` or ``layer.*`` over
    the stretch's own wall, in percent; None without spans."""
    reg = _registry()
    if reg is None or ctx.stretch.window_s <= 0:
        return None
    s = sum(v for k, v in reg.self_seconds().items()
            if k == layer or k.startswith(layer + "."))
    return 100.0 * s / ctx.stretch.window_s


def outside_share(ctx):
    """The stretch's wall outside every span (one minus the spans without a
    parent over the wall), in percent; None without spans."""
    reg = _registry()
    if reg is None or ctx.stretch.window_s <= 0:
        return None
    return 100.0 * (1.0 - reg.root_seconds() / ctx.stretch.window_s)
