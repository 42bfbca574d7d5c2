"""Device operations (kernels, copies, fills) launched per NSR training step
(the ``nsr.step`` unit) in the traced window, from the profiler's trace:
what a CUDA graph or a fusion of the step moves."""


def read(ctx):
    t = ctx["trace"]
    return t["launches"] / t["units"] if t["launches"] else None
