"""Data-parallel NSR training: the rays of a step over the ranks
(counterpart of ``drawingspinup_tpu/train/nsr_parallel.py``).

Each rank draws and renders its own ``ceil(train_num_rays / world)`` rays
(its own ``Draws``, from its own generator; the probe points are not
split), runs the step's forward and backward, and averages its gradients
and logs with the other ranks (``parallel/mesh.py::all_mean_``) before
the one update that every rank applies alike: JAX's ``shard_map`` over
``dp`` with ``lax.pmean``. The ranked losses (rgb, normal, mask) rank
within each rank's shard, as JAX's dp step ranks within each device's.
bf16 table gradients are averaged in bf16, as ``pmean`` averages them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from drawingspinup_torch.parallel import mesh
from drawingspinup_torch.train import nsr


class TrainStepDP:
    """The data-parallel step over ``world`` ranks: a call takes one step
    with this rank's draws, made with ``draw_cfg``."""

    def __init__(self, cfg: nsr.NSRConfig, opt: nsr.NSROptimizer,
                 world: int):
        self.cfg, self.opt = cfg, opt
        self.rays_per_rank = mesh.per_rank(cfg.train_num_rays, world,
                                           "nsr dp", "train_num_rays")
        # the shard's draws: the config's ray count cut to this rank's
        self.draw_cfg = dataclasses.replace(
            cfg, train_num_rays=self.rays_per_rank)

    def __call__(self, state: nsr.TrainState, data: Dict[str, torch.Tensor],
                 draws: nsr.Draws, n_active: Optional[int] = None
                 ) -> Dict[str, torch.Tensor]:
        return nsr.train_step(self.cfg, self.opt, state, data, draws,
                              n_active=n_active, reduce=mesh.all_mean_)


def make_train_step_dp(cfg: nsr.NSRConfig, opt: nsr.NSROptimizer,
                       world: int) -> TrainStepDP:
    return TrainStepDP(cfg, opt, world)


def production_train_step(cfg: nsr.NSRConfig, opt: nsr.NSROptimizer
                          ) -> TrainStepDP:
    """The step ``pipelines/stage2_recon.py::recon_uid`` takes when the
    process group has more than one rank: over all of its ranks."""
    return make_train_step_dp(cfg, opt, mesh.world_size())
