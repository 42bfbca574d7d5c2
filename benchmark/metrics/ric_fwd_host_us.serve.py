"""The host side of one RIC forward call in serving: the median duration,
in µs, of the ``ric.fwd`` spans (``kernels/ric_conv.py``'s
``RICConvFunction.forward``: checks, plan, allocations and the launch)
of the traced window's frames (the last ``units`` ``serve.frame`` units),
read from the program's span store (``core/profiling.py``'s ``spans()``).
None where the program keeps no such store or span."""
import statistics

SPAN = "ric.fwd"
UNIT = "serve.frame"


def read(ctx):
    from drawingspinup_torch.core import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    records = spans()
    frames = [r.id for r in records if r.name == UNIT and r.unit == r.id]
    window = set(frames[-ctx["trace"]["units"]:])
    durations = [r.end_ns - r.start_ns for r in records
                 if r.name == SPAN and r.unit in window]
    if not durations:
        return None
    return statistics.median(durations) / 1e3
