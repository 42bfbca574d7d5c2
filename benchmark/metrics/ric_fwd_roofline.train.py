"""The RIC conv forward's roofline share in training: the least time of
a step's forward launches (``benchmark/work.py``: bytes at 3.35 TB/s,
products as 3xTF32 at 495 TFLOP/s) over their device time in the traced
window. The forward has no op or range in the trace: its kernels are read
by name (``benchmark/tracing.py``)."""
from benchmark import work


def read(ctx):
    c, t = ctx["config"], ctx["trace"]
    fwd, _ = work.ric_launches(c, c["batch_size"], c["patch_size"], True)
    if not fwd or not t["ric_fwd_s"]:
        return None
    bound_s = work.ric_fwd_bound_ms(fwd) * 1e-3 * t["units"]
    return 100.0 * bound_s / t["ric_fwd_s"]
