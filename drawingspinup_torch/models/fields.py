"""Neural fields for NSR reconstruction: SDF geometry, radiance, variance
(counterpart of ``drawingspinup_tpu/models/fields.py``).

Parameters are plain dicts of tensors with the JAX pytree's layout
(``{"table": [per-level tables], "mlp": {"layers": [{"w", "b", "g"}]}}``),
so ``utils/jax_params.py`` converts a JAX state leaf by leaf and the tests
compare like with like.

``apply_mlp`` runs in the input dtype: operands cast to it, products summed
in f32 and cast back (JAX's ``preferred_element_type=f32``), bias added in
the input dtype. ``sdf_with_grad_analytic`` writes JAX's three MLP
``jax.jvp``s as explicit tangent propagation in the same dtypes, so the
training graph stays first-order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from drawingspinup_torch.models.hashgrid import (
    HashGridConfig, encode, encode_with_spatial_grad, init_table,
)


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    n_neurons: int = 64
    n_hidden_layers: int = 1
    sphere_init: bool = False
    sphere_init_radius: float = 0.5
    weight_norm: bool = False
    output_activation: Optional[str] = None   # None | sigmoid


def init_mlp(cfg: MLPConfig, dim_in: int, dim_out: int,
             generator: torch.Generator, device="cpu") -> Dict[str, Any]:
    """Weights as V (dim_in, dim_out), and the per-column gain g when
    weight-normed; JAX's init distributions, drawn from ``generator``."""
    dims = [dim_in] + [cfg.n_neurons] * cfg.n_hidden_layers + [dim_out]
    layers = []

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)

    for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
        is_first, is_last = i == 0, i == len(dims) - 2
        if cfg.sphere_init:
            if is_last:
                w = (normal((di, do)) * 1e-4
                     + math.sqrt(math.pi) / math.sqrt(di))
                b = torch.full((do,), -cfg.sphere_init_radius, device=device)
            elif is_first:
                w = torch.zeros((di, do), device=device)
                w[:3] = normal((3, do)) * math.sqrt(2) / math.sqrt(do)
                b = torch.zeros((do,), device=device)
            else:
                w = normal((di, do)) * math.sqrt(2) / math.sqrt(do)
                b = torch.zeros((do,), device=device)
        else:
            bound = math.sqrt(6.0 / di)
            w = (torch.rand((di, do), generator=generator, device=device)
                 * 2 - 1) * bound
            b = torch.zeros((do,), device=device)
        layer = {"w": w.float(), "b": b.float()}
        if cfg.weight_norm:
            layer["g"] = torch.linalg.norm(w, dim=0)
        layers.append(layer)
    return {"layers": layers}


def _weight(cfg: MLPConfig, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    w = layer["w"]
    if cfg.weight_norm:
        # weight-norm math in f32 on the f32 params, cast once by the caller
        w = w * (layer["g"] / (torch.linalg.norm(w, dim=0) + 1e-12))
    return w


def _dot(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w.astype(h.dtype), products summed in f32, cast back to h's dtype
    (a bf16 × bf16 product is exact in f32)."""
    cdt = h.dtype
    if cdt in (torch.float32, torch.float64):
        return h @ w.to(cdt)
    return (h.float() @ w.to(cdt).float()).to(cdt)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """f32 for a bf16 or f32 tensor; a float64 one (the plain path's
    reference) stays float64."""
    return t if t.dtype == torch.float64 else t.float()


def apply_mlp(cfg: MLPConfig, params: Dict[str, Any],
              x: torch.Tensor) -> torch.Tensor:
    """Runs in the input dtype (JAX ``apply_mlp``)."""
    h = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        h = _dot(h, _weight(cfg, layer)) + layer["b"].to(h.dtype)
        if i < n - 1:
            if cfg.sphere_init:
                # softplus β=100
                h = F.softplus(100.0 * h) / 100.0
            else:
                h = F.relu(h)
    if cfg.output_activation == "sigmoid":
        h = torch.sigmoid(h)
    return h


def _mlp_with_tangents(cfg: MLPConfig, params: Dict[str, Any],
                       x: torch.Tensor, t: torch.Tensor):
    """``apply_mlp`` and its forward derivative along the tangents t
    (K, P, D) at once, in JAX's jvp dtypes: t ← (t·W in f32) cast to the
    input dtype; through softplus(100h)/100, t ← t·sigmoid(100h); through
    relu, t ← t·[h > 0]."""
    h = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        w = _weight(cfg, layer)
        h = _dot(h, w) + layer["b"].to(h.dtype)
        t = _dot(t, w)
        if i < n - 1:
            if cfg.sphere_init:
                z = 100.0 * h
                t = t * torch.sigmoid(z)
                h = F.softplus(z) / 100.0
            else:
                t = t * (h > 0).to(t.dtype)
                h = F.relu(h)
    if cfg.output_activation == "sigmoid":
        s = torch.sigmoid(h)
        t = t * (s * (1 - s))
        h = s
    return h, t


# ---------------------------------------------------------------------------
# SDF geometry field
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SDFFieldConfig:
    radius: float = 1.0
    feature_dim: int = 13
    grid: HashGridConfig = HashGridConfig()
    mlp: MLPConfig = MLPConfig(n_neurons=64, n_hidden_layers=1,
                               sphere_init=True, weight_norm=True)


def init_sdf_field(cfg: SDFFieldConfig, generator: torch.Generator,
                   device="cpu") -> Dict[str, Any]:
    return {"table": init_table(cfg.grid, generator, device),
            "mlp": init_mlp(cfg.mlp, cfg.grid.n_output_dims, cfg.feature_dim,
                            generator, device)}


def contract(x: torch.Tensor, radius: float, kind: str = "aabb"
             ) -> torch.Tensor:
    """[-r, r] → [0, 1], clipped (JAX ``contract``); 'sphere' squashes the
    outside of the unit ball into the [0.25, 0.75] band's rim."""
    u = (x + radius) / (2 * radius)
    if kind == "sphere":
        y = u * 2 - 1
        mag = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True) + 1e-24)
        y = torch.where(mag > 1, (2 - 1 / mag) * (y / mag), y)
        return y / 4 + 0.5
    return u.clamp(0.0, 1.0)


def sdf_forward(cfg: SDFFieldConfig, params, x: torch.Tensor,
                level_mask: Optional[torch.Tensor] = None,
                n_active: Optional[int] = None):
    """x: (P, 3) world coords → (sdf (P,) f32, feature (P, D) f32; float64
    for float64 compute); the feature includes the sdf as channel 0."""
    u = contract(x, cfg.radius)
    enc = encode(params["table"], u, cfg.grid, level_mask, n_active)
    out = _wide(apply_mlp(cfg.mlp, params["mlp"], enc))
    return out[..., 0], out


def sdf_with_grad_analytic(cfg: SDFFieldConfig, params, x: torch.Tensor,
                           level_mask: Optional[torch.Tensor] = None,
                           n_active: Optional[int] = None):
    """Analytic position gradients: the encode's closed-form spatial
    jacobian pushed through the MLP as three tangents. Returns (sdf (P,),
    grad (P, 3), feature (P, D)), all f32."""
    u = contract(x, cfg.radius)
    enc, denc = encode_with_spatial_grad(params["table"], u, cfg.grid,
                                         level_mask, n_active)
    feat, tang = _mlp_with_tangents(cfg.mlp, params["mlp"], enc, denc)
    scale = 1.0 / (2.0 * cfg.radius)
    grad = (_wide(tang[..., 0]) * scale).T
    return _wide(feat[..., 0]), grad, _wide(feat)


def sdf_with_grad(cfg: SDFFieldConfig, params, x: torch.Tensor, eps,
                  level_mask: Optional[torch.Tensor] = None,
                  with_laplace: bool = False,
                  n_active: Optional[int] = None):
    """Finite-difference gradients: the 6 offset probes and the center as
    one batched field evaluation."""
    p = x.shape[0]
    offsets = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                            [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                           device=x.device)
    probes = (x[:, None, :] + eps * offsets[None]).clamp(-cfg.radius,
                                                         cfg.radius)
    all_pts = torch.cat([x, probes.reshape(-1, 3)], dim=0)
    sdf_all, feat_all = sdf_forward(cfg, params, all_pts, level_mask,
                                    n_active)
    sdf = sdf_all[:p]
    feature = feat_all[:p]
    d = sdf_all[p:].reshape(p, 6)
    grad = 0.5 * (d[:, 0::2] - d[:, 1::2]) / eps
    if with_laplace:
        laplace = (d[:, 0::2] + d[:, 1::2] - 2.0 * sdf[:, None]).sum(-1) \
            / (eps ** 2)
        return sdf, grad, feature, laplace
    return sdf, grad, feature


# ---------------------------------------------------------------------------
# radiance field and variance
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RadianceConfig:
    input_feature_dim: int = 16
    mlp: MLPConfig = MLPConfig(n_neurons=64, n_hidden_layers=2,
                               output_activation="sigmoid")


def init_radiance(cfg: RadianceConfig, generator: torch.Generator,
                  device="cpu") -> Dict[str, Any]:
    return {"mlp": init_mlp(cfg.mlp, cfg.input_feature_dim, 3, generator,
                            device)}


def radiance_forward(cfg: RadianceConfig, params, feature: torch.Tensor,
                     dirs: torch.Tensor, normal: torch.Tensor
                     ) -> torch.Tensor:
    """MLP(feature ⊕ normal) → rgb; view dirs are not fed (as the
    reference fork)."""
    del dirs
    return apply_mlp(cfg.mlp, params["mlp"],
                     torch.cat([feature, normal], dim=-1))


def init_variance(init_val: float = 0.3, device="cpu"
                  ) -> Dict[str, torch.Tensor]:
    return {"variance": torch.tensor(init_val, dtype=torch.float32,
                                     device=device)}


def inv_s(params) -> torch.Tensor:
    return torch.exp(params["variance"] * 10.0).clamp(1e-6, 1e6)
