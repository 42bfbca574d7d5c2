"""Device operations (kernels, copies, fills) launched per training step in
the traced window, from the profiler's trace."""


def read(ctx):
    t = ctx["trace"]
    return t["launches"] / t["units"] if t["launches"] else None
