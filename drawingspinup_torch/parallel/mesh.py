"""Process groups for the data-parallel trainings (counterpart of
``drawingspinup_tpu/parallel/mesh.py``).

JAX runs one SPMD process over a ``(dp, tp)`` device mesh: ``shard_map``
hands each device its shard and ``lax.pmean`` averages over ``dp``. The
port runs one process a GPU, as torchrun starts them: each rank samples and
renders its own shard, ``all_mean_`` averages what JAX ``pmean``s, and
every rank applies the same update, so all ranks hold the same bits. With
one rank (no process group) every entry point takes its plain path.

The tensor-parallel axis: ``make_mesh(dp, tp)`` lays the ranks out as
JAX's ``make_mesh`` lays out its devices, row-major over ``(dp, tp)``, and
makes the groups of each axis; ``parallel/tp.py`` shards the FFC
generator's output features over ``tp`` (JAX's ``shard_params_tp``).

Stage 2a splits its batch rows instead (JAX's ``_mv_batch_sharding``): the
first ``mv_split`` ranks form a subgroup (``dp_group``), each holds the
full weights and a slice of the rows, and ``all_gather_rows`` collects
what the row folds need.

NCCL reduces CUDA tensors and gloo CPU tensors, unless the caller names a
backend; gloo also reduces CUDA tensors, through the host, which lets two
ranks share one card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import (
    Any, Callable, Dict, List, Optional, Sequence, Tuple, TypeVar,
)

import torch
import torch.distributed as dist

from drawingspinup_torch.core import device as device_setup

T = TypeVar("T")

# Rank r's random stream of a training seeded s starts from
# s + r * RANK_SEED_STRIDE (a prime): rank 0's is the plain path's own.
RANK_SEED_STRIDE = 1_000_003


def env_world_size() -> int:
    """torchrun's ``WORLD_SIZE``, 1 outside torchrun."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_size() -> int:
    """Ranks of the default process group; 1 when none was joined."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def print_main(*args, **kwargs) -> None:
    """``print`` on rank 0 alone."""
    if is_main():
        print(*args, **kwargs)


def rank_seed(seed: int, rank_: Optional[int] = None) -> int:
    """This rank's seed of a random stream seeded ``seed``."""
    return seed + (rank() if rank_ is None else rank_) * RANK_SEED_STRIDE


def init_dp(device=None, backend: Optional[str] = None,
            init_method: Optional[str] = None
            ) -> Tuple[int, int, torch.device]:
    """Join the default process group as torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` say (or keep the one joined) →
    (rank, world size, this rank's device).

    device: None or a bare ``"cuda"`` is ``cuda:{LOCAL_RANK}``; an indexed
    device is kept. backend: NCCL for a CUDA device, gloo for the CPU.
    init_method: torchrun's ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``)
    unless given, e.g. ``file://<path>`` for ranks on one host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = device_setup.setup(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://",
            rank=int(os.environ.get("RANK", "0")),
            world_size=env_world_size())
    return dist.get_rank(), dist.get_world_size(), dev


def entry_device(device) -> torch.device:
    """The device of a CLI: this rank's (``init_dp``) under torchrun with
    more than one rank or in a process group already joined, else
    ``device`` as ``core/device.py`` sets it up."""
    if dist.is_initialized() or env_world_size() > 1:
        return init_dp(device)[2]
    return device_setup.setup(device)


def per_rank(total: int, world: int, tag: str, what: str) -> int:
    """``ceil(total / world)``, at least 1, so that the ranks together
    never take fewer than ``total``; notes a total that does not divide."""
    n = max(-(-total // world), 1)
    if n * world != total and is_main():
        print(f"[{tag}] {what} {total} not divisible by dp={world}: using "
              f"{n}/device ({n * world} total)")
    return n


def mv_split(batch: int, world: int) -> int:
    """JAX's divisor rule: the largest divisor of ``batch`` that is at
    most ``world`` (1: no split)."""
    for cand in range(min(batch, world), 1, -1):
        if batch % cand == 0:
            return cand
    return 1


_GROUPS: Dict[Tuple[object, Any], Any] = {}


def dp_group(dp: int):
    """The subgroup of ranks ``0 .. dp-1`` of the default group → the
    group on its members, None on the ranks past it. Every rank of the
    default group must call this, in the same order (``dist.new_group``'s
    rule); a group is made once per default group and ``dp``. Raises
    without a process group of at least ``dp`` ranks."""
    if world_size() < dp or not dist.is_initialized():
        raise RuntimeError(f"a split over {dp} ranks needs a process group "
                           f"of at least {dp} ranks (have {world_size()})")
    key = (dist.group.WORLD, dp)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(ranks=list(range(dp)))
    return _GROUPS[key] if rank() < dp else None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``(dp, tp)`` mesh: its index on each axis,
    the group of its ``dp`` axis (the ranks of its tp index) and of its
    ``tp`` axis (the ranks of its dp index); the groups are None at world
    size 1."""
    dp: int = 1
    tp: int = 1
    dp_index: int = 0
    tp_index: int = 0
    dp_group: Any = None
    tp_group: Any = None


def make_mesh(dp: int, tp: int = 1) -> Mesh:
    """The mesh of JAX's ``make_mesh(dp · tp, tp=tp)``: rank r at dp index
    r // tp and tp index r % tp. Every rank of the default group must call
    this, in the same order (``dist.new_group``'s rule); the groups are made
    once per default group and shape. Raises when the world size is not
    ``dp · tp``."""
    world = world_size()
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks; the "
                         f"process group has {world}")
    if world == 1:
        return Mesh()
    key = (dist.group.WORLD, (dp, tp))
    if key not in _GROUPS:
        tp_groups = [dist.new_group(ranks=[i * tp + j for j in range(tp)])
                     for i in range(dp)]
        dp_groups = [dist.new_group(ranks=[i * tp + j for i in range(dp)])
                     for j in range(tp)]
        _GROUPS[key] = (dp_groups, tp_groups)
    dp_groups, tp_groups = _GROUPS[key]
    r = rank()
    return Mesh(dp, tp, r // tp, r % tp, dp_groups[r % tp],
                tp_groups[r // tp])


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` of ``group``, concatenated along dim 0 in rank
    order: the global row order when rank r holds the r-th block of rows.
    Every rank's ``t`` has the same shape."""
    t = t.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


@torch.no_grad()
def all_mean_(tensors: Sequence[Optional[torch.Tensor]],
              group=None) -> None:
    """Average ``tensors`` over the ranks of ``group`` (default: all) in
    place, as ``lax.pmean``: the tensors of one dtype flattened into one
    bucket, one ``all_reduce(SUM)`` a bucket, divided by the group's size
    in that dtype, copied back. None entries (a locked hash level's
    gradient) are skipped: every rank passes the same list, its Nones at
    the same places. Without a process group there is nothing to
    average."""
    if not dist.is_initialized():
        return
    world = dist.get_world_size(group)
    buckets: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        if t is not None:
            buckets.setdefault(t.dtype, []).append(t)
    for bucket in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat /= world
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view(t.shape))


def broadcast(obj: T) -> T:
    """Rank 0's ``obj`` (picklable) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on any rank (on every rank alike)."""
    if world_size() == 1:
        return flag
    flags: List[Optional[bool]] = [None] * world_size()
    dist.all_gather_object(flags, bool(flag))
    return any(flags)


def on_main(fn: Callable[[], T]) -> T:
    """``fn()`` on rank 0 alone: every rank waits for it and returns its
    (picklable) result, or raises when it raised (rank 0 its own
    exception, the others a ``RuntimeError`` naming it). The ranks' one
    barrier: a bare barrier would leave them waiting for a rank 0 that
    raised."""
    if world_size() == 1:
        return fn()
    error: Optional[Exception] = None
    outcome: Tuple[Optional[T], Optional[str]] = (None, None)
    if is_main():
        try:
            outcome = (fn(), None)
        except Exception as e:  # every rank must reach the broadcast
            error, outcome = e, (None, f"{type(e).__name__}: {e}")
    result, failure = broadcast(outcome)
    if error is not None:
        raise error
    if failure is not None:
        raise RuntimeError(f"rank 0 failed: {failure}")
    return result
