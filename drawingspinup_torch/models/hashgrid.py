"""Multi-resolution hash-grid encoding, tcnn-compatible (counterpart of
``drawingspinup_tpu/models/hashgrid.py``).

Per level l: resolution N_l = floor(base · scale^l); dense indexing when the
grid fits the table (or ``dense_max_rows``), else the spatial hash
(x·1 ^ y·2654435761 ^ z·805459861) mod T; trilinear interpolation of the 8
corner features; levels ≥ the progressive band's current level are zeroed.
One (T_l, F) table per level, in the table dtype.

The per-level work runs in ``kernels/hashgrid.py`` (CUDA kernels, or their
plain twins on the CPU); the level mask and the xyz prefix stay here in
PyTorch. ``n_active`` is a plain int: levels ≥ it emit zeros and cost
nothing, with nothing to recompile.

JAX's ``_widen_dense`` cell rows are dropped, their semantics kept: on a
dense level with ``dense_cell_rows`` the base corner is clipped to r−1 and
the weights recomputed from it, so the spatial slope at px == 1 is
one-sided, not 0 (JAX ``hashgrid.py:52-57``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from drawingspinup_torch.kernels import hashgrid as hk


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 10
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 32
    per_level_scale: float = 1.3195079107728942
    include_xyz: bool = True
    start_level: int = 4
    start_step: int = 0
    update_steps: int = 1000
    dense_cell_rows: bool = True
    dense_max_rows: int = 0
    compute_dtype: str = "float32"
    table_dtype: str = "float32"

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    def is_dense(self, r: int) -> bool:
        return (int(r) + 1) ** 3 <= max(self.table_size, self.dense_max_rows)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level \
            + (3 if self.include_xyz else 0)

    def level_resolutions(self) -> np.ndarray:
        ls = np.arange(self.n_levels)
        return np.floor(self.base_resolution * self.per_level_scale ** ls
                        ).astype(np.int32)

    def current_level(self, step: int) -> int:
        return min(self.start_level + max(step - self.start_step, 0)
                   // self.update_steps, self.n_levels)

    def spec(self) -> hk.GridSpec:
        res = tuple(int(r) for r in self.level_resolutions())
        return hk.GridSpec(res=res, dense=tuple(self.is_dense(r) for r in res),
                           table_size=self.table_size,
                           n_features=self.n_features_per_level,
                           cell_rows=self.dense_cell_rows,
                           compute_dtype=self.compute_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def tdt(self) -> torch.dtype:
        return getattr(torch, self.table_dtype)


def init_table(cfg: HashGridConfig, generator: torch.Generator,
               device="cpu") -> list:
    """tcnn init: U(-1e-4, 1e-4), one (T_l, F) table per level, drawn in f32
    and cast to the table dtype."""
    tables = []
    for r in cfg.level_resolutions():
        rows = int(r + 1) ** 3 if cfg.is_dense(r) else cfg.table_size
        t = torch.rand((rows, cfg.n_features_per_level), generator=generator,
                       device=device) * 2e-4 - 1e-4
        tables.append(t.to(cfg.tdt))
    return tables


def _finish(cfg: HashGridConfig, raw: torch.Tensor,
            level_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if level_mask is None:
        return raw
    m = level_mask.repeat_interleave(cfg.n_features_per_level).to(raw.dtype)
    return raw * m


def _active(cfg: HashGridConfig, n_active: Optional[int]) -> int:
    return cfg.n_levels if n_active is None else min(int(n_active),
                                                     cfg.n_levels)


def encode(tables: Sequence[torch.Tensor], x: torch.Tensor,
           cfg: HashGridConfig, level_mask: Optional[torch.Tensor] = None,
           n_active: Optional[int] = None) -> torch.Tensor:
    """x: (P, 3) in [0, 1] → features (P, n_output_dims) in the compute
    dtype; include_xyz prepends x·2−1."""
    na = _active(cfg, n_active)
    p = x.shape[0]
    if na > 0:
        raw = hk.HashGridFunction.apply(x, cfg.spec(), na, False, *tables)
    else:
        raw = torch.zeros((p, cfg.n_levels * cfg.n_features_per_level),
                          dtype=cfg.cdt, device=x.device)
    out = _finish(cfg, raw, level_mask)
    if cfg.include_xyz:
        out = torch.cat([(x * 2.0 - 1.0).to(cfg.cdt), out], dim=-1)
    return out


def encode_with_spatial_grad(tables: Sequence[torch.Tensor], x: torch.Tensor,
                             cfg: HashGridConfig,
                             level_mask: Optional[torch.Tensor] = None,
                             n_active: Optional[int] = None):
    """The encoding and its exact spatial jacobian from one set of gathers:
    (enc (P, D), denc (3, P, D)), D = n_output_dims."""
    na = _active(cfg, n_active)
    p = x.shape[0]
    lf = cfg.n_levels * cfg.n_features_per_level
    if na > 0:
        raw, draw = hk.HashGridFunction.apply(x, cfg.spec(), na, True,
                                              *tables)
    else:
        raw = torch.zeros((p, lf), dtype=cfg.cdt, device=x.device)
        draw = torch.zeros((3, p, lf), dtype=cfg.cdt, device=x.device)
    enc = _finish(cfg, raw, level_mask)
    denc = _finish(cfg, draw, level_mask)
    if cfg.include_xyz:
        enc = torch.cat([(x * 2.0 - 1.0).to(cfg.cdt), enc], dim=-1)
        eye = 2.0 * torch.eye(3, dtype=cfg.cdt, device=x.device)
        denc = torch.cat([eye[:, None, :].expand(3, p, 3), denc], dim=-1)
    return enc, denc


def progressive_mask(cfg: HashGridConfig, step: int,
                     device="cpu") -> torch.Tensor:
    """(L,) f32 mask of the levels active at ``step``."""
    cur = cfg.current_level(int(step))
    return (torch.arange(cfg.n_levels, device=device) < cur).to(torch.float32)


def finite_difference_eps(cfg: HashGridConfig, step: int,
                          radius: float = 1.0) -> float:
    """One cell of the current finest active level (reference
    VolumeSDF.update_step), in f32 as JAX computes it."""
    cur = np.float32(cfg.current_level(int(step)))
    grid_res = np.float32(cfg.base_resolution) * np.float32(
        cfg.per_level_scale) ** (cur - np.float32(1.0))
    return float(np.float32(2.0 * radius) / grid_res)
