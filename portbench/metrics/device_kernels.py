"""Device kernels a unit launches (a micro-step, a request, a chunk), over
the profiled stretch: the host's launch pressure."""


def read(ctx):
    s = ctx.stretch
    if s.units <= 0 or s.kernels == 0:
        return None
    return s.kernels / s.units
