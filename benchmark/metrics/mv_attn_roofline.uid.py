"""The MV UNet's attention cores' roofline share: the least time of a uid's
cores (``benchmark/mv_work.py``: each core's 4·B·Sq·Sk·C FLOPs at the bf16
peak or its q, k, v and output in bf16 at 3.35 TB/s, the larger) over the
card's time of the traced uids' ``mv.attn`` spans.

Read from the program's span store (``core/profiling.py``'s ``spans()``,
which records only while the traced window's profiler does) and the
spans' CUDA event pairs (``device_times()``): the ``mv.attn`` records of
the last ``units`` ``mv.uid`` units. None where the program keeps no such
store, span or device time."""
from benchmark import mv_work


def read(ctx):
    from drawingspinup_torch.core import profiling

    spans = getattr(profiling, "spans", None)
    device_times = getattr(profiling, "device_times", None)
    if spans is None or device_times is None:
        return None
    records = spans()
    uids = [r.id for r in records if r.name == "mv.uid" and r.unit == r.id]
    window = set(uids[-ctx["trace"]["units"]:])
    if not window:
        return None
    times = device_times()
    attn = [times[r.id] for r in records
            if r.name == "mv.attn" and r.unit in window and r.id in times]
    if not attn:
        return None
    bound = mv_work.uid_attention_bound_s(ctx["config"]) * len(window)
    return 100.0 * bound / sum(attn)
