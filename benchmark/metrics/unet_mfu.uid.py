"""A uid's UNet model FLOPs (one forward a DDIM step over the batch of 12,
attention at its folded lengths; ``benchmark/mv_work.py``) over the
measured window's time per uid, as a share of the card's dense bf16 peak
(989.4 TFLOP/s)."""
from benchmark import mv_work


def read(ctx):
    w = ctx["window"]
    rate = mv_work.uid_unet_flops(ctx["config"]) * w["units"] / w["seconds"]
    return 100.0 * rate / mv_work.BF16_FLOPS
