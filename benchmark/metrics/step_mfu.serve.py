"""A served frame's model FLOPs (the generator's eval forward;
``benchmark/work.py``) over the measured window's time per frame, as a
share of the card's f32-accurate peak (3xTF32: 495 / 3 TFLOP/s)."""
from benchmark import work


def read(ctx):
    w = ctx["window"]
    rate = work.frame_flops(ctx["config"]) * w["units"] / w["seconds"]
    return 100.0 * rate / work.F32_ACCURATE_FLOPS
