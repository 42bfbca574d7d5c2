"""The hash-grid kernels' roofline share in the NSR step: the least time of
the ``hashgrid_fwd`` (the coarse pass's encode and the full evaluation's,
with the jacobian) and ``hashgrid_bwd`` (its scale, scatter and convert
kernels) launches, from their bytes at 3.35 TB/s
(``benchmark/nsr_work.py``), over their device time.

Read from the loop's own profile after the measured window (``window``'s
``hashgrid``: one step of each band phase under ``torch.profiler``, the
kernels' durations in its trace by name, the bytes counted on the points
those steps encode), since the traced window's reduction keeps only its
ten longest operations and the hash-grid kernels are not among them. None
where the loop kept no such profile or found none of the kernels."""
from benchmark import nsr_work


def read(ctx):
    prof = ctx["window"].get("hashgrid")
    if not prof:
        return None
    found = [k for k, s in prof["seconds"].items() if s > 0]
    if not found:
        return None
    bound_s = sum(prof["bytes"][k] for k in found) \
        / nsr_work.HBM_BYTES_PER_S
    return 100.0 * bound_s / sum(prof["seconds"][k] for k in found)
