"""The RIC conv backward's roofline share: the least time of a step's
backward launches (dz, dx where needed, dwk; ``benchmark/work.py``) over
the device time of every operation launched from the autograd node
``RICConvFunctionBackward`` in the traced window (launch correlation,
``benchmark/tracing.py``)."""
from benchmark import work


def read(ctx):
    c, t = ctx["config"], ctx["trace"]
    _, bwd = work.ric_launches(c, c["batch_size"], c["patch_size"], True)
    if not bwd or not t["ric_bwd_s"]:
        return None
    bound_s = work.ric_bwd_bound_ms(bwd) * 1e-3 * t["units"]
    return 100.0 * bound_s / t["ric_bwd_s"]
