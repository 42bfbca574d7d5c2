"""The host's time to upload a served frame: ``gan.generate_full_rgba``'s
``serve.upload`` (``from_numpy``, the pageable host-to-card copy and the
feature build).

Read from the program's span store (``core/profiling.py``'s ``spans()``,
which records only while the traced window's profiler does): the median,
over the window's frames (the last ``units`` ``serve.frame`` units), of each
frame's summed ``serve.upload`` spans, in ms. None where the program keeps
no such store or span."""
import statistics

SPAN = "serve.upload"
UNIT = "serve.frame"


def read(ctx):
    from drawingspinup_torch.core import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    records = spans()
    frames = [r.id for r in records if r.name == UNIT and r.unit == r.id]
    per_frame = dict.fromkeys(frames[-ctx["trace"]["units"]:], 0)
    found = False
    for r in records:
        if r.name == SPAN and r.unit in per_frame:
            per_frame[r.unit] += r.end_ns - r.start_ns
            found = True
    if not found:
        return None
    return statistics.median(per_frame.values()) / 1e6
