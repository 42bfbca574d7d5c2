"""The host's time to enqueue an NSR training step: the median of the last
durations of ``train/nsr.py``'s ``nsr.step`` span (``core/profiling.py``'s
``samples``, a ring of the last 1024, always kept: the measured window's
last steps and the traced ones), in ms: the host's time from the step's
call to its return, its dispatch of the step's launches where the card
keeps up. None where the program keeps no such span."""
import statistics

SPAN = "nsr.step"


def read(ctx):
    from drawingspinup_torch.core import profiling

    samples = getattr(profiling, "samples", None)
    durations = samples(SPAN) if samples is not None else []
    if not durations:
        return None
    return 1e3 * statistics.median(durations)
