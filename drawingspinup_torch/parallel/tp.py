"""Tensor parallelism over the ``tp`` axis of a ``(dp, tp)`` mesh (the
counterpart of ``drawingspinup_tpu/parallel/mesh.py::shard_params_tp``).

JAX shards every parameter's trailing (output-feature) axis over ``tp``
when it divides evenly and is at least ``2·tp`` long, replicates the rest,
and lets GSPMD place the collectives. The port writes the same column
partition out (Megatron's): each tp rank holds the contiguous slice of a
sharded parameter at its tp index (and the Adam moments of that slice),
and a sharded layer computes only that slice of its output channels. The
FFC modules (``models/ffc.py``) call this module's collectives where a
tensor changes layout:

  * ``copy``: identity forward, all-reduce SUM over ``tp`` backward: the
    input of a sharded layer, whose input gradient is a partial sum over
    its output channels;
  * ``gather``: all-gather along channels forward, this rank's slice
    backward: a sharded activation where the next operation needs every
    channel;
  * ``scatter``: this rank's slice forward, all-gather backward: a
    replicated tensor meeting a sharded one in an add;
  * ``dp_sum``: all-reduce SUM over ``dp`` forward and backward: the batch
    norms' sums over the global batch.

A layout is read from a tensor's channel count: a module knows the full
width of what it takes, and a slice has ``width / tp`` channels.
``TRAFFIC`` counts each rank's collectives and their bytes (a gather: the
bytes of the gathered tensor; an all-reduce: the bytes of the tensor).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from drawingspinup_torch.parallel.mesh import Mesh

TRAFFIC: Dict[str, int] = {}


def reset_traffic() -> None:
    TRAFFIC.clear()
    TRAFFIC.update({"gathers": 0, "gather_bytes": 0, "all_reduces": 0,
                    "all_reduce_bytes": 0})


reset_traffic()


def _count(kind: str, t: torch.Tensor) -> None:
    TRAFFIC[kind + "s"] += 1
    TRAFFIC[kind + "_bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    _count("all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.tp)]
    dist.all_gather(parts, t, group=mesh.tp_group)
    out = torch.cat(parts, dim=1)
    _count("gather", out)
    return out


def _own(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = t.shape[1] // mesh.tp
    return t.narrow(1, mesh.tp_index * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh.tp_group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.mesh), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _own(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh), None


class _DPSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh.dp_group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh.dp_group), None


def _out_axis(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """The output-feature axis of a parameter in torch's layout: dim 0 of a
    conv weight and of a 1-D parameter, dim 1 of a transposed conv's
    (in, out, kh, kw) weight."""
    if p.ndim == 1:
        return 0
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return 1
    if name == "weight" and isinstance(module, nn.Conv2d):
        return 0
    raise ValueError(f"no output-feature axis known for "
                     f"{type(module).__name__}.{name} {tuple(p.shape)}")


def shards(size: int, tp: int) -> bool:
    """JAX's rule for an output-feature axis of ``size``."""
    return size % tp == 0 and size >= 2 * tp


def tp_axes(module: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """Per ``state_dict`` name of the full ``module``: the axis sharded over
    ``tp`` by JAX's rule, or None (replicated). A module's 1-D buffers (a
    batch norm's running statistics) follow its 1-D parameters."""
    axes: Dict[str, Optional[int]] = {}
    for prefix, m in module.named_modules():
        pre = prefix + "." if prefix else ""
        vec = None
        for name, p in m.named_parameters(recurse=False):
            axis = _out_axis(m, name, p)
            axes[pre + name] = axis if shards(p.shape[axis], tp) else None
            if p.ndim == 1:
                vec = axes[pre + name]
        for name, b in m.named_buffers(recurse=False):
            axes[pre + name] = vec if b.ndim == 1 else None
    return axes


def _narrow(t: torch.Tensor, axis: Optional[int], mesh: Mesh
            ) -> torch.Tensor:
    if axis is None:
        return t
    n = t.shape[axis] // mesh.tp
    return t.narrow(axis, mesh.tp_index * n, n)


def shard_params_tp(module: nn.Module, mesh: Mesh
                    ) -> Dict[str, Optional[int]]:
    """Replace each parameter and buffer of ``module`` that JAX's rule
    shards by its slice at this rank's tp index, hand every submodule the
    mesh's collectives (``TensorParallel``), and return ``tp_axes``. Only
    modules that run the column-parallel path (``tp_ready``) are taken. At
    world size 1 the module is left as it is."""
    if not getattr(module, "tp_ready", False):
        raise NotImplementedError(
            f"{type(module).__name__} has no tensor-parallel path")
    axes = tp_axes(module, mesh.tp)
    if mesh.dp * mesh.tp == 1:
        return axes
    par = TensorParallel(mesh)
    for prefix, m in module.named_modules():
        pre = prefix + "." if prefix else ""
        for name, p in list(m.named_parameters(recurse=False)):
            if axes[pre + name] is not None:
                setattr(m, name, nn.Parameter(
                    _narrow(p.detach(), axes[pre + name], mesh).clone(),
                    requires_grad=p.requires_grad))
        for name, b in list(m.named_buffers(recurse=False)):
            if axes[pre + name] is not None:
                setattr(m, name,
                        _narrow(b, axes[pre + name], mesh).clone())
        m.tp = par
    return axes


def load_full(module: nn.Module, state: Mapping[str, torch.Tensor],
              axes: Mapping[str, Optional[int]], mesh: Mesh) -> None:
    """Load a full ``state_dict`` into a sharded ``module``: each sharded
    entry's slice at this rank's tp index (strict: the same names)."""
    module.load_state_dict({k: _narrow(v, axes[k], mesh)
                            for k, v in state.items()}, strict=True)


@torch.no_grad()
def gather_named(tensors: Mapping[str, torch.Tensor],
                 axes: Mapping[str, Optional[int]], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """Shards → full tensors on every rank (all-gathers over ``tp`` along
    each name's axis), replicated ones copied. Every rank passes the same
    names in the same order."""
    out = {}
    for k, t in tensors.items():
        axis = axes[k]
        if axis is None or mesh.tp == 1:
            out[k] = t.detach().clone()
            continue
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.tp)]
        dist.all_gather(parts, t, group=mesh.tp_group)
        out[k] = torch.cat(parts, dim=axis)
    return out


def gather_full(module: nn.Module, axes: Mapping[str, Optional[int]],
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` of a sharded ``module``, on every rank."""
    return gather_named(module.state_dict(), axes, mesh)


class TensorParallel:
    """The collectives of one mesh, as the FFC modules call them; each is
    the identity where its axis has one rank."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def sharded(self, layer: nn.Module) -> bool:
        """Whether ``layer`` (a conv or transposed conv, or a module whose
        output is its ``conv2``'s) computes a slice."""
        layer = getattr(layer, "conv2", layer)
        own = layer.weight.shape[
            1 if isinstance(layer, nn.ConvTranspose2d) else 0]
        return own != layer.out_channels

    def full(self, x: Optional[torch.Tensor], width: int
             ) -> Optional[torch.Tensor]:
        """``x`` with all ``width`` channels: gathered if it is a slice."""
        if x is None or x.shape[1] == width:
            return x
        return _Gather.apply(x, self.mesh)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.mesh) if self.mesh.tp > 1 else x

    def col(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """The input of ``layer``: every channel, and its gradient summed
        over ``tp`` when the layer computes a slice."""
        x = self.full(x, layer.in_channels)
        return self.copy(x) if self.sharded(layer) else x

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a + b``; a replicated term meeting a slice gives its own
        matching slice."""
        if a.shape[1] > b.shape[1]:
            a = _Scatter.apply(a, self.mesh)
        elif b.shape[1] > a.shape[1]:
            b = _Scatter.apply(b, self.mesh)
        return a + b

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return _DPSum.apply(x, self.mesh) if self.mesh.dp > 1 else x
