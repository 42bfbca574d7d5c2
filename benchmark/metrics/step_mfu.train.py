"""The training step's model FLOPs (generator, discriminator and VGG,
forward and backward as the step needs them; ``benchmark/work.py``) over
the measured window's time per step, as a share of the card's
f32-accurate peak (3xTF32: 495 / 3 TFLOP/s)."""
from benchmark import work


def read(ctx):
    w = ctx["window"]
    rate = work.train_step_flops(ctx["config"]) * w["units"] / w["seconds"]
    return 100.0 * rate / work.F32_ACCURATE_FLOPS
