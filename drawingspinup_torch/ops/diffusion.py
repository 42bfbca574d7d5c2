"""DDIM sampling for stage 2a (counterpart of
``drawingspinup_tpu/ops/diffusion.py``).

The reference samples through the diffusers DDIMScheduler of the Wonder3D
checkpoint: SD-1.x scaled_linear betas 0.00085 → 0.012 over 1000 train
steps, leading-spaced timesteps with ``steps_offset`` 1, epsilon or v
prediction. The schedule (``alphas_cumprod``, ``timesteps_for``) is numpy
on the host; a step's scalars are computed there in f32 from integer
timesteps, and the update runs in torch f32 on the latents' device. The
noise of an ``eta`` > 0 step is an argument: the sampler draws it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"     # epsilon | v_prediction
    set_alpha_to_one: bool = False
    steps_offset: int = 1


def alphas_cumprod(cfg: DDIMConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps)
    else:
        raise ValueError(cfg.beta_schedule)
    return np.cumprod(1.0 - betas).astype(np.float32)


def timesteps_for(cfg: DDIMConfig, num_inference_steps: int) -> np.ndarray:
    """diffusers leading-spacing timesteps, descending."""
    ratio = cfg.num_train_timesteps // num_inference_steps
    t = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.int32)
    return t + cfg.steps_offset


def ddim_step(cfg: DDIMConfig, acp: np.ndarray, model_out: torch.Tensor,
              t: int, t_prev: int, sample: torch.Tensor, eta: float = 0.0,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DDIM update x_t → x_{t_prev} (t_prev < 0: the final step). acp:
    the (T,) f32 ``alphas_cumprod`` table."""
    one = np.float32(1.0)
    a_t = acp[int(t)]
    final = one if cfg.set_alpha_to_one else acp[0]
    a_prev = acp[int(t_prev)] if t_prev >= 0 else final
    sq_at, sq_1at = np.sqrt(a_t), np.sqrt(one - a_t)

    if cfg.prediction_type == "epsilon":
        x0 = (sample - float(sq_1at) * model_out) / float(sq_at)
        eps = model_out
    else:  # v_prediction
        x0 = float(sq_at) * sample - float(sq_1at) * model_out
        eps = float(sq_at) * model_out + float(sq_1at) * sample

    sigma = np.float32(eta) * np.sqrt(np.maximum(
        (one - a_prev) / (one - a_t) * (one - a_t / a_prev), np.float32(0)))
    dir_coef = np.sqrt(np.maximum(one - a_prev - sigma * sigma,
                                  np.float32(0)))
    prev = float(np.sqrt(a_prev)) * x0 + float(dir_coef) * eps
    if noise is not None:
        prev = prev + float(sigma) * noise
    return prev


def add_noise(acp: np.ndarray, x0: torch.Tensor, noise: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """sqrt(ᾱ_t)·x0 + sqrt(1 − ᾱ_t)·noise, t a scalar or (B,) tensor."""
    a = torch.as_tensor(acp, device=x0.device)[t.to(x0.device).long()]
    while a.dim() < x0.dim():
        a = a[..., None]
    return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise
