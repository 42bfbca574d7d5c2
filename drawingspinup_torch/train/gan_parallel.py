"""Data-parallel stage-3 training: the patch batch over the ranks
(counterpart of ``drawingspinup_tpu/train/gan_parallel.py``).

Each rank cuts its own ``ceil(batch_size / world)`` patches with its own
generator and runs ``train/gan.py::train_step_on_batch`` with the ranks'
average in place of ``lax.pmean``: D's gradients before D's update, then
G's gradients and batch-norm running statistics (and the losses) before
G's update, so the generator's adversarial term sees the updated D, as on
one GPU. Each rank normalises with its own batch's statistics, as each JAX
device does: no ``SyncBatchNorm``, and no ``DistributedDataParallel``,
which would broadcast rank 0's buffers where JAX averages them.
"""
from __future__ import annotations

from typing import Dict

import torch

from drawingspinup_torch.core import profiling
from drawingspinup_torch.parallel import mesh
from drawingspinup_torch.pipelines.stage3_data import (
    KeyframeData, sample_patches,
)
from drawingspinup_torch.train import gan


class TrainStepDP:
    """The data-parallel step over ``world`` ranks: ``batch`` cuts this
    rank's patches, ``on_batch`` takes one step on them, a call does
    both."""

    def __init__(self, cfg: gan.GANConfig, world: int):
        self.cfg = cfg
        self.per_rank = mesh.per_rank(cfg.batch_size, world, "gan dp",
                                      "batch_size")

    def batch(self, data: KeyframeData, generator: torch.Generator
              ) -> Dict[str, torch.Tensor]:
        return sample_patches(data, generator, self.per_rank,
                              self.cfg.patch_size)

    def on_batch(self, state: gan.TrainState,
                 batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return gan.train_step_on_batch(self.cfg, state, batch,
                                       reduce=mesh.all_mean_)

    def __call__(self, state: gan.TrainState, data: KeyframeData,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One step under the spans of ``gan.train_step``."""
        with profiling.span("gan.step", unit=True):
            with profiling.span("gan.sample"):
                batch = self.batch(data, generator)
            return self.on_batch(state, batch)


def make_train_step_dp(cfg: gan.GANConfig, world: int) -> TrainStepDP:
    return TrainStepDP(cfg, world)


def production_train_step(cfg: gan.GANConfig) -> TrainStepDP:
    """The step ``pipelines/stage3_translate.py::train_stage`` takes when
    the process group has more than one rank: over all of its ranks."""
    return make_train_step_dp(cfg, mesh.world_size())
