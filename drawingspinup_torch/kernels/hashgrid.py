"""Multi-resolution hash-grid encoding: the CUDA kernels' wrappers, their
plain PyTorch twins, and the autograd Function that joins them.

Counterpart of ``drawingspinup_tpu/models/hashgrid.py::_level_interp`` (the
XLA-gather encode and its jacobian) and of the two Pallas row gathers of
``scripts/bench_pallas_gather.py`` (``rowdma_kernel``, ``vmemds_kernel``),
whose job on the TPU was this encode's corner fetch:

* ``hashgrid_fwd`` (``csrc/hashgrid_fwd.cu``): one thread per (point,
  level) computes the 8 corner rows (dense cell index, or the spatial hash
  ``x·1 ^ y·2654435761 ^ z·805459861`` & (T−1)), gathers them, and sums
  the trilinear interpolation, and optionally its spatial jacobian, in the
  compute dtype;
* ``hashgrid_bwd`` (``csrc/hashgrid_bwd.cu``): the gradient of the tables,
  the scatter-add of JAX's gather transpose: each f32 term scaled by a
  per-level power of two, rounded to int64 and added with atomics (integer
  sums do not depend on their order, so the bits are the same from run to
  run and under any permutation of the points), then converted once to f32
  or the table dtype; ``hashgrid_bwd_fixed_point`` is that arithmetic in
  plain PyTorch;
* ``row_gather`` (``csrc/row_gather.cu``): ``out[k] = tab[idx[k]]`` for
  fixed-width rows, the Pallas gathers' function bound on its own; the
  encode's corner fetch is the same device function.

Layout is the JAX function's: x (P, 3) f32 in [0, 1], one (T_l, F) table
per level; ``enc`` (P, L·F) and ``denc`` (3, P, L·F) in the compute dtype,
level l in columns l·F … l·F+F−1. Levels ≥ ``n_active`` are zeros and cost
nothing. The trilinear weights are f32; features × weights run in the
compute dtype (f32 or bf16), rounding after every product and sum as the
twins do, so a kernel and its twin agree to the bit.

On a CPU tensor every entry point runs the plain twin (the autograd
Function's table gradient: ``hashgrid_bwd_fixed_point``, the kernel's own
sum); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

PRIMES = (1, 2654435761, 805459861)
MAX_LEVELS = 16

# Launches of each kernel wrapper since the last reset; the smoke run resets
# them to show that the main path went through the kernels.
FWD_LAUNCHES = 0        # hashgrid_fwd without the jacobian
FWD_JAC_LAUNCHES = 0    # hashgrid_fwd with the jacobian
BWD_LAUNCHES = 0        # hashgrid_bwd (its three kernels)
GATHER_LAUNCHES = 0     # row_gather

# float64 is for the twins alone (a reference in the tests); the kernels
# take float32 and bfloat16
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """What the kernels need to know of a grid: per level its resolution and
    whether it is stored dense, the hash table size T, features per level,
    whether dense levels clip the base corner (``dense_cell_rows``), and the
    compute dtype name."""
    res: Tuple[int, ...]
    dense: Tuple[bool, ...]
    table_size: int
    n_features: int
    cell_rows: bool
    compute_dtype: str

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

# the 8 cell corners, x fastest: (dx, dy, dz) of corner c = dx + 2 dy + 4 dz
_OFFSETS = [[c & 1, (c >> 1) & 1, c >> 2] for c in range(8)]


def _corners(x: torch.Tensor, res: int, dense: bool, cell_rows: bool,
             table_size: int):
    """The 8 corners of one level at once: row indices (8, P) int64, the
    per-axis factors (ux, uy, uz), each (8, P) in x's dtype (1 − w or w),
    and the signed scales (sx, sy, sz), each (8, 1). ``_level_interp``'s
    math: weights from the floor (or, on a dense level with cell rows,
    from the base corner clipped to r−1), corners clipped to [0, r]
    otherwise."""
    r = float(res)
    f = x * r
    b0f = torch.floor(f)
    b0 = b0f.to(torch.int64)
    wide = dense and cell_rows
    if wide:
        b0 = b0.clamp(0, res - 1)
        w = f - b0.to(x.dtype)
    else:
        w = f - b0f
    off = torch.tensor(_OFFSETS, dtype=torch.int64, device=x.device)
    c = b0[None] + off[:, None, :]                       # (8, P, 3)
    if not wide:
        c = c.clamp(0, res)
    cx, cy, cz = c.unbind(-1)
    if dense:
        n = res + 1
        idx = cx + n * (cy + n * cz)
    else:
        # uint32 wrap-around is invisible under the & (T-1) mask
        idx = ((cx * PRIMES[0]) ^ (cy * PRIMES[1])
               ^ (cz * PRIMES[2])) & (table_size - 1)
    pick = off.bool()[:, None, :]                        # (8, 1, 3)
    u = torch.where(pick, w[None], 1.0 - w[None])        # (8, P, 3)
    s = torch.where(pick, r, -r).to(x.dtype)             # (8, 1, 3)
    return idx, u.unbind(-1), s.unbind(-1)


def _weights(u, s, cdt, with_jac: bool):
    """The corners' weights (8, P) and, with the jacobian, their three
    slopes, in the order JAX multiplies them (in x's dtype), cast to the
    compute dtype."""
    ux, uy, uz = u
    sx, sy, sz = s
    w = (ux * uy * uz).to(cdt)
    if not with_jac:
        return w, None
    return w, ((sx * uy * uz).to(cdt), (ux * sy * uz).to(cdt),
               (ux * uy * sz).to(cdt))


def _fold(terms: torch.Tensor) -> torch.Tensor:
    """Σ over the corners (axis 0) from zero, in corner order, rounding to
    the terms' dtype after every add as the kernel does."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def hashgrid_fwd_reference(x: torch.Tensor, tables: Sequence[torch.Tensor],
                           spec: GridSpec, n_active: int, with_jac: bool
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch encode of the first ``n_active`` levels: (enc (P, L·F),
    denc (3, P, L·F) or None), zeros past ``n_active``."""
    p, nf, cdt = x.shape[0], spec.n_features, spec.cdt
    lf = len(spec.res) * nf
    enc = torch.zeros((p, lf), dtype=cdt, device=x.device)
    denc = torch.zeros((3, p, lf), dtype=cdt, device=x.device) \
        if with_jac else None
    for lvl in range(n_active):
        cols = slice(lvl * nf, (lvl + 1) * nf)
        idx, u, s = _corners(x, spec.res[lvl], spec.dense[lvl],
                             spec.cell_rows, spec.table_size)
        g = tables[lvl][idx].to(cdt)                     # (8, P, F)
        w, slopes = _weights(u, s, cdt, with_jac)
        enc[:, cols] = _fold(g * w[..., None])
        if with_jac:
            for k, sl in enumerate(slopes):
                denc[k, :, cols] = _fold(g * sl[..., None])
    return enc, denc


def _level_terms(x: torch.Tensor, spec: GridSpec, lvl: int,
                 g_enc: torch.Tensor, g_denc: Optional[torch.Tensor],
                 acc: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level ``lvl``'s scatter: the corner rows (8, P) and per corner the
    term ``ḡ·w + ḡx·gx + ḡy·gy + ḡz·gz`` (8, P, F) in ``acc``, each product
    and sum rounded in that order."""
    nf, cdt = spec.n_features, spec.cdt
    cols = slice(lvl * nf, (lvl + 1) * nf)
    idx, u, s = _corners(x, spec.res[lvl], spec.dense[lvl], spec.cell_rows,
                         spec.table_size)
    w, slopes = _weights(u, s, cdt, g_denc is not None)
    c = g_enc[None, :, cols].to(acc) * w.to(acc)[..., None]
    if g_denc is not None:
        for k, sl in enumerate(slopes):
            gk = g_denc[k, None, :, cols].to(acc)
            c = c + gk * sl.to(acc)[..., None]
    return idx, c


def hashgrid_bwd_reference(x: torch.Tensor, tables: Sequence[torch.Tensor],
                           spec: GridSpec, n_active: int,
                           g_enc: torch.Tensor,
                           g_denc: Optional[torch.Tensor]
                           ) -> List[torch.Tensor]:
    """Plain PyTorch table gradients of the first ``n_active`` levels, f32
    (float64 for float64 compute): per corner ``ḡ·w + ḡx·gx + ḡy·gy +
    ḡz·gz`` scatter-added into the corner's row (``index_add_``, corner
    by corner)."""
    nf = spec.n_features
    acc = torch.float64 if spec.cdt == torch.float64 else torch.float32
    grads = []
    for lvl in range(n_active):
        idx, c = _level_terms(x, spec, lvl, g_enc, g_denc, acc)
        buf = torch.zeros(tables[lvl].shape, dtype=acc, device=x.device)
        buf.index_add_(0, idx.reshape(-1), c.reshape(-1, nf))
        grads.append(buf)
    return grads


def fixed_point_exponent(bound: float, n_points: int) -> int:
    """The table-gradient kernel's scale 2^e of a level whose terms are at
    most ``bound`` in magnitude: e = 62 − ⌈log2(8 P B)⌉ in double
    arithmetic, so that a row's sum of at most 8P rounded terms stays
    inside int64; 0 where the bound is 0."""
    if bound == 0.0:
        return 0
    frac, k = math.frexp(bound * float(8 * n_points))
    return 62 - (k - 1 if frac == 0.5 else k)


def _max_finite_abs(g: torch.Tensor) -> float:
    a = g.float().abs()
    return float(torch.where(torch.isfinite(a), a, 0.0).max()) \
        if a.numel() else 0.0


def level_bound(res: int, m_enc: float, m_x: float = 0.0, m_y: float = 0.0,
                m_z: float = 0.0) -> float:
    """B_l = max|ḡ| + r_l (max|ḡx| + max|ḡy| + max|ḡz|), in the kernel's
    order of double operations: every term of level l is at most B_l (the
    weights are at most 1, the slopes at most r_l, up to their
    roundings)."""
    return m_enc + float(res) * ((m_x + m_y) + m_z)


def fixed_point_sum(idx: torch.Tensor, terms: torch.Tensor, rows: int,
                    e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ of rint(t · 2^e) (half to even) per row of the finite f32
    ``terms`` (K, F) keyed by ``idx`` (K,), as int64 (rows, F), and the
    (rows, F) mask of the entries a non-finite term touched."""
    ok = torch.isfinite(terms)
    q = torch.round(torch.where(ok, terms, 0.0).double() * 2.0 ** e)
    nf = terms.shape[1]
    acc = torch.zeros((rows, nf), dtype=torch.int64, device=terms.device)
    acc.index_add_(0, idx, q.to(torch.int64))
    bad = torch.zeros((rows, nf), dtype=torch.int32, device=terms.device)
    bad.index_add_(0, idx, (~ok).to(torch.int32))
    return acc, bad > 0


def hashgrid_bwd_fixed_point(x: torch.Tensor, tables: Sequence[torch.Tensor],
                             spec: GridSpec, n_active: int,
                             g_enc: torch.Tensor,
                             g_denc: Optional[torch.Tensor],
                             out_dtype: torch.dtype = torch.float32
                             ) -> List[torch.Tensor]:
    """The table-gradient kernel's arithmetic in plain PyTorch, bit for bit
    (f32 and bf16 compute): per level the bound B_l of its terms from the
    largest finite cotangents, e_l from ``fixed_point_exponent``, the f32
    terms summed as int64 multiples of 2^-e_l, then acc · 2^-e_l in double
    rounded once to f32 and from there to ``out_dtype``; NaN where a
    non-finite term landed."""
    p, nf = x.shape[0], spec.n_features
    grads = []
    for lvl in range(n_active):
        cols = slice(lvl * nf, (lvl + 1) * nf)
        m = [_max_finite_abs(g_enc[:, cols])]
        if g_denc is not None:
            m += [_max_finite_abs(g_denc[k, :, cols]) for k in range(3)]
        e = fixed_point_exponent(level_bound(spec.res[lvl], *m), p)
        idx, c = _level_terms(x, spec, lvl, g_enc, g_denc, torch.float32)
        acc, bad = fixed_point_sum(idx.reshape(-1), c.reshape(-1, nf),
                                   tables[lvl].shape[0], e)
        out = (acc.double() * 2.0 ** -e).float().masked_fill(bad, math.nan)
        grads.append(out.to(out_dtype))
    return grads


def row_gather_reference(tab: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """``tab[idx]``."""
    return tab[idx.long()]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _raise_on(ext, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {ext.error_string(err)}")


def _check_points(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 \
            or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float32 (P, 3), got "
                         f"{x.dtype} {tuple(x.shape)}")


def _level_args(name: str, x: torch.Tensor, tables: Sequence[torch.Tensor],
                spec: GridSpec, n_active: int):
    """Validated (table pointers, resolutions, dense flags) of the active
    levels, and the table dtype."""
    nf = spec.n_features
    if not 0 < n_active <= len(spec.res) or len(spec.res) > MAX_LEVELS:
        raise ValueError(f"{name}: n_active {n_active} out of range for "
                         f"{len(spec.res)} levels (at most {MAX_LEVELS})")
    tdt = tables[0].dtype
    if tdt not in (torch.float32, torch.bfloat16) \
            or spec.cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: tables and compute must be float32 or "
                        f"bfloat16, got {tdt} / {spec.cdt}")
    if nf not in (2, 4, 8):
        raise ValueError(f"{name}: the kernels take 2, 4 or 8 features per "
                         f"level, got {nf}")
    ptrs, res, dense = [], [], []
    for lvl in range(n_active):
        t = tables[lvl]
        r = spec.res[lvl]
        rows = (r + 1) ** 3 if spec.dense[lvl] else spec.table_size
        if t.dtype != tdt or t.device != x.device or not t.is_contiguous() \
                or tuple(t.shape) != (rows, nf):
            raise ValueError(f"{name}: level {lvl} table must be contiguous "
                             f"{tdt} ({rows}, {nf}) on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
        res.append(r)
        dense.append(int(spec.dense[lvl]))
    if spec.table_size & (spec.table_size - 1):
        raise ValueError(f"{name}: table size {spec.table_size} is not a "
                         f"power of two")
    return ptrs, res, dense, tdt


def hashgrid_fwd(x: torch.Tensor, tables: Sequence[torch.Tensor],
                 spec: GridSpec, n_active: int, with_jac: bool
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the encode kernel on the current stream for the first
    ``n_active`` levels: (enc (P, L·F), denc (3, P, L·F) or None) in the
    compute dtype, zeros past ``n_active`` (written by the kernel)."""
    global FWD_LAUNCHES, FWD_JAC_LAUNCHES
    _check_points("hashgrid_fwd", x)
    ptrs, res, dense, tdt = _level_args("hashgrid_fwd", x, tables, spec,
                                        n_active)
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    p, nf = x.shape[0], spec.n_features
    lf = len(spec.res) * nf
    enc = torch.empty((p, lf), dtype=spec.cdt, device=x.device)
    denc = torch.empty((3, p, lf), dtype=spec.cdt, device=x.device) \
        if with_jac else None
    if p == 0:
        return enc, denc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = ext.hashgrid_fwd(
            x.data_ptr(), p, ptrs, res, dense, spec.table_size, nf,
            int(spec.cell_rows), int(tdt == torch.bfloat16),
            int(spec.cdt == torch.bfloat16), lf, enc.data_ptr(),
            denc.data_ptr() if with_jac else 0, stream)
    _raise_on(ext, "hashgrid_fwd", err)
    if with_jac:
        FWD_JAC_LAUNCHES += 1
    else:
        FWD_LAUNCHES += 1
    return enc, denc


def hashgrid_bwd(x: torch.Tensor, tables: Sequence[torch.Tensor],
                 spec: GridSpec, n_active: int, g_enc: torch.Tensor,
                 g_denc: Optional[torch.Tensor],
                 out_dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Launch the table-gradient kernels on the current stream: the
    gradients of the first ``n_active`` tables in ``out_dtype`` (f32, or
    bf16 rounded from the f32 values as ``.to()`` rounds), views of one
    flat buffer. Scale, scatter and convert kernels: the sums are int64
    fixed point, the same bits from run to run and under any permutation of
    the points (``hashgrid_bwd_fixed_point`` is the same arithmetic in
    plain PyTorch); NaN where a non-finite term landed."""
    global BWD_LAUNCHES
    _check_points("hashgrid_bwd", x)
    _, res, dense, _ = _level_args("hashgrid_bwd", x, tables, spec, n_active)
    p, nf = x.shape[0], spec.n_features
    lf = len(spec.res) * nf
    for name, g, shape in (("g_enc", g_enc, (p, lf)),
                           ("g_denc", g_denc, (3, p, lf))):
        if g is not None and (g.dtype != spec.cdt or tuple(g.shape) != shape
                              or g.device != x.device):
            raise ValueError(f"hashgrid_bwd: {name} must be {spec.cdt} "
                             f"{shape} on {x.device}, got {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hashgrid_bwd: out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")
    rows = [tables[lvl].shape[0] for lvl in range(n_active)]
    total = sum(rows)
    if p * n_active >= 2 ** 31 or total >= 2 ** 31:
        raise ValueError(f"hashgrid_bwd: {p} points x {n_active} levels or "
                         f"{total} rows do not fit the kernels' 32-bit "
                         f"items and row keys")
    if p == 0:
        return list(torch.split(torch.zeros((total, nf), dtype=out_dtype,
                                            device=x.device), rows))
    out = torch.empty((total, nf), dtype=out_dtype, device=x.device)
    g_enc = g_enc.contiguous()
    g_denc = g_denc.contiguous() if g_denc is not None else None
    base = [sum(rows[:lvl]) for lvl in range(n_active)]
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    scratch = torch.zeros((ext.hashgrid_bwd_scratch_words(n_active,
                                                          total * nf),),
                          dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = ext.hashgrid_bwd(
            x.data_ptr(), p, res, dense, base, total, spec.table_size, nf,
            int(spec.cell_rows), int(spec.cdt == torch.bfloat16),
            int(out_dtype == torch.bfloat16), lf, g_enc.data_ptr(),
            g_denc.data_ptr() if g_denc is not None else 0,
            scratch.data_ptr(), out.data_ptr(), stream)
    _raise_on(ext, "hashgrid_bwd", err)
    BWD_LAUNCHES += 1
    return list(torch.split(out, rows))


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the row-gather kernel on the current stream: ``tab[idx]`` for
    a contiguous (T, C) table whose rows are 4, 8, 16, 32, 48 or 64 bytes
    and int32 indices in [0, T)."""
    global GATHER_LAUNCHES
    if tab.device.type != "cuda" or idx.device != tab.device:
        raise ValueError(f"row_gather: tab and idx must be on one CUDA "
                         f"device, got {tab.device} / {idx.device}")
    row_bytes = tab.shape[1] * tab.element_size() if tab.dim() == 2 else 0
    if row_bytes not in (4, 8, 16, 32, 48, 64) or not tab.is_contiguous():
        raise ValueError(f"row_gather: tab must be a contiguous (T, C) table "
                         f"of 4-64 byte rows, got {tab.dtype} "
                         f"{tuple(tab.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"row_gather: idx must be contiguous int32 (K,), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    out = torch.empty((idx.shape[0], tab.shape[1]), dtype=tab.dtype,
                      device=tab.device)
    if idx.shape[0] == 0 or tab.shape[0] == 0:
        return out
    from drawingspinup_torch.kernels._build import extension

    ext = extension()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = ext.row_gather(tab.data_ptr(), tab.shape[0], row_bytes,
                             idx.data_ptr(), idx.shape[0], out.data_ptr(),
                             stream)
    _raise_on(ext, "row_gather", err)
    GATHER_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------

class HashGridFunction(torch.autograd.Function):
    """The encode, differentiable in the tables only: positions carry no
    gradient in NSR (samples come from rays and stop-gradient'd t), so the
    backward returns None for x, and x must not require grad."""

    @staticmethod
    def forward(ctx, x, spec, n_active, with_jac, *tables):
        if x.requires_grad:
            raise ValueError("hashgrid: positions must not require grad")
        ctx.spec, ctx.n_active = spec, n_active
        ctx.save_for_backward(x, *tables)
        if x.device.type == "cpu":
            enc, denc = hashgrid_fwd_reference(x, tables, spec, n_active,
                                               with_jac)
        else:
            enc, denc = hashgrid_fwd(x, tables, spec, n_active, with_jac)
        return (enc, denc) if with_jac else enc

    @staticmethod
    def backward(ctx, g_enc, g_denc=None):
        x, *tables = ctx.saved_tensors
        spec, n_active = ctx.spec, ctx.n_active
        if x.device.type == "cpu" and spec.cdt == torch.float64:
            # a float64 reference run: the twin sums in float64
            out = hashgrid_bwd_reference(x, tables, spec, n_active, g_enc,
                                         g_denc)
        elif x.device.type == "cpu":
            # the kernel's arithmetic, so both devices share its semantics
            out = hashgrid_bwd_fixed_point(x, tables, spec, n_active, g_enc,
                                           g_denc, out_dtype=tables[0].dtype)
        else:
            out = hashgrid_bwd(x, tables, spec, n_active, g_enc, g_denc,
                               out_dtype=tables[0].dtype)
        out += [None] * (len(tables) - n_active)
        return (None, None, None, None, *out)
