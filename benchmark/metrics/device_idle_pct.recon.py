"""The card's idle share of the measured window in the stage-2b cell: 100 −
the device's busy time per step (the union of its operations' intervals in
the traced window, over the steps traced) over the measured window's time
per step. The traced window's own share reads high: the profiler slows the
host's dispatch, not the device's work."""


def read(ctx):
    t, w = ctx["trace"], ctx["window"]
    if not t["busy_s"]:
        return None
    busy = t["busy_s"] / t["units"]
    return 100.0 * (1.0 - busy * w["units"] / w["seconds"])
