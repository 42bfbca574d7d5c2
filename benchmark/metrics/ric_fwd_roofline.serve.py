"""The RIC conv forward's roofline share in serving: the least time of
a 512² frame's forward launches (``benchmark/work.py``) over their device
time in the traced window, read by kernel name as in training."""
from benchmark import work


def read(ctx):
    c, t = ctx["config"], ctx["trace"]
    fwd, _ = work.ric_launches(c, 1, c["frame_size"], False)
    if not fwd or not t["ric_fwd_s"]:
        return None
    bound_s = work.ric_fwd_bound_ms(fwd) * 1e-3 * t["units"]
    return 100.0 * bound_s / t["ric_fwd_s"]
