"""The hash-grid kernels' work in an NSR step, from the grid's levels, the
points and the number of active levels: the bytes each kernel must move at
the least and the operations it does, for their rooflines (the stage-2b
cell's ``hashgrid_roofline.recon`` and ``chip_smoke.py``'s bounds).

Each input byte is counted read once and each output byte written once,
by the kernel that first needs it, whatever the kernels read again: the
encode (``hashgrid_fwd.cu``) reads the points (3 f32) and the table rows
the points' corners touch (counted once a row: what these points need),
and writes the encoding of every level, zeros past the active ones (and,
with the jacobian, its three slopes); the table gradient
(``hashgrid_bwd.cu``) reads the encoding's cotangents in its active
columns (its scale kernel first), the points (its scatter kernel) and
writes the active tables' gradients (its convert kernel). A level is
(resolution, dense); the rows are those of
``benchmark/reference/nsr.py::corners``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.reference import nsr as ref

HBM_BYTES_PER_S = 3.35e12       # one H100 SXM's HBM3, NVIDIA's data sheet
Level = Tuple[int, bool]        # (resolution, stored dense)
# the hash-grid kernels by their names in a trace
KERNELS = {"fwd": re.compile(r"\bhashgrid_fwd_kernel<[^>]*\bfalse>"),
           "fwd_jac": re.compile(r"\bhashgrid_fwd_kernel<[^>]*\btrue>"),
           "bwd_scale": re.compile(r"\bhashgrid_bwd_scale_kernel<"),
           "bwd_scatter": re.compile(r"\bhashgrid_bwd_scatter_kernel<"),
           "bwd_convert": re.compile(r"\bhashgrid_bwd_convert_kernel<")}


def level_rows(levels: Sequence[Level], table_size: int) -> List[int]:
    """Each level's table rows."""
    return [(r + 1) ** 3 if dense else table_size for r, dense in levels]


def touched_rows(x: torch.Tensor, levels: Sequence[Level], n_active: int,
                 cell_rows: bool, table_size: int) -> int:
    """The distinct table rows the points x (P, 3) in [0, 1] touch in the
    first ``n_active`` levels."""
    return sum(int(torch.unique(ref.corners(x, r, dense, cell_rows,
                                            table_size)[0]).numel())
               for r, dense in levels[:n_active])


def encode_work(p: int, rows: int, n_levels: int, nf: int, n_active: int,
                table_bytes: int, compute_bytes: int, with_jac: bool
                ) -> Tuple[int, int]:
    """(bytes, FLOPs) of one encode of p points touching ``rows`` rows:
    per (point, active level, corner) 2 products for the weight and 2·F
    operations for the features, four times with the jacobian."""
    outs = 4 if with_jac else 1
    return (12 * p + rows * nf * table_bytes
            + outs * p * n_levels * nf * compute_bytes,
            outs * p * n_active * 8 * (2 + 2 * nf))


def table_grad_work(p: int, table_rows: int, nf: int, n_active: int,
                    table_bytes: int, compute_bytes: int, with_jac: bool
                    ) -> Dict[str, Tuple[int, int]]:
    """(bytes, FLOPs) of one table gradient at p points by kernel:
    ``scale`` reads the cotangents' active columns, ``scatter`` the
    points and does 8 + 8·F operations a (point, level, corner),
    ``convert`` writes the ``table_rows`` rows of the active tables'
    gradients in the tables' dtype."""
    outs = 4 if with_jac else 1
    return {"scale": (outs * p * n_active * nf * compute_bytes, 0),
            "scatter": (12 * p, p * n_active * 8 * (8 + 8 * nf)),
            "convert": (table_rows * nf * table_bytes, 0)}


def step_kernel_bytes(coarse: torch.Tensor, fine: torch.Tensor,
                      levels: Sequence[Level], nf: int, n_active: int,
                      cell_rows: bool, table_size: int, table_bytes: int,
                      compute_bytes: int) -> Dict[str, int]:
    """The least bytes of each hash-grid kernel of one NSR step, by the
    kernel's name in the trace: the coarse pass's encode (``fwd``) of the
    points ``coarse``, the full evaluation's encode with the jacobian
    (``fwd_jac``) of the points ``fine`` and its table gradient
    (``bwd_scale``, ``bwd_scatter``, ``bwd_convert``)."""
    n_levels = len(levels)
    rows_c = touched_rows(coarse, levels, n_active, cell_rows, table_size)
    rows_f = touched_rows(fine, levels, n_active, cell_rows, table_size)
    grads = table_grad_work(fine.shape[0],
                            sum(level_rows(levels, table_size)[:n_active]),
                            nf, n_active, table_bytes, compute_bytes, True)
    return {"fwd": encode_work(coarse.shape[0], rows_c, n_levels, nf,
                               n_active, table_bytes, compute_bytes,
                               False)[0],
            "fwd_jac": encode_work(fine.shape[0], rows_f, n_levels, nf,
                                   n_active, table_bytes, compute_bytes,
                                   True)[0],
            **{"bwd_" + k: v[0] for k, v in grads.items()}}


def kernel_seconds(events: List[Dict]) -> Dict[str, float]:
    """Each hash-grid kernel's device seconds in a Chrome trace's events
    (``torch.profiler``'s export), summed over its launches."""
    secs = dict.fromkeys(KERNELS, 0.0)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for k, pattern in KERNELS.items():
                if pattern.search(e.get("name", "")):
                    secs[k] += e["dur"] * 1e-6
    return secs
