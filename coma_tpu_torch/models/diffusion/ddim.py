"""DDIM scheduler: numpy schedule tables and a tensor step.

Counterpart of ``coma_tpu/models/diffusion/ddim.py``: HF diffusers'
DDIMScheduler as the reference configures it (scaled_linear betas
0.00085 -> 0.012 over 1000 train steps, ``clip_sample=False``,
``set_alpha_to_one=False``, eta=0, epsilon prediction, 'leading' spacing,
``steps_offset=0``). The tables are numpy, as in ``coma_tpu``; the step
(``ddim_step_traced``) takes its coefficients from them as scalars of the
sample's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    timesteps: np.ndarray        # (n,) int32, descending
    alphas_cumprod: np.ndarray   # (T,) f32
    final_alpha_cumprod: float
    num_train_timesteps: int
    num_inference_steps: int

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    @property
    def prev_timesteps(self) -> np.ndarray:
        return self.timesteps - self.num_train_timesteps // self.num_inference_steps

    def alpha_prod(self, t: np.ndarray) -> np.ndarray:
        """alphas_cumprod[t], with final_alpha_cumprod for t < 0."""
        t = np.asarray(t)
        safe = np.clip(t, 0, self.num_train_timesteps - 1)
        return np.where(t >= 0, self.alphas_cumprod[safe], self.final_alpha_cumprod)


def make_ddim_schedule(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    set_alpha_to_one: bool = False,
    steps_offset: int = 0,
) -> DDIMSchedule:
    betas = (
        np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
        ** 2
    )
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1].copy()
    timesteps = timesteps.astype(np.int32) + steps_offset
    return DDIMSchedule(
        timesteps=timesteps,
        alphas_cumprod=alphas_cumprod,
        final_alpha_cumprod=float(1.0 if set_alpha_to_one else alphas_cumprod[0]),
        num_train_timesteps=num_train_timesteps,
        num_inference_steps=num_inference_steps,
    )


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def ddim_step(
    schedule: DDIMSchedule,
    step_index: int,
    model_output: torch.Tensor,  # eps prediction, same shape as sample
    sample: torch.Tensor,        # x_t
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One deterministic DDIM step with Python-float coefficients; returns
    ``(x_{t-1}, x̂0)``."""
    t = int(schedule.timesteps[step_index])
    prev_t = t - schedule.num_train_timesteps // schedule.num_inference_steps
    a_t = float(schedule.alpha_prod(t))
    a_prev = float(schedule.alpha_prod(prev_t))
    pred_x0 = (sample - (1.0 - a_t) ** 0.5 * model_output) / a_t**0.5
    direction = (1.0 - a_prev) ** 0.5 * model_output
    prev_sample = a_prev**0.5 * pred_x0 + direction
    return prev_sample, pred_x0


def ddim_step_traced(
    schedule: DDIMSchedule,
    step_index: int,
    model_output: torch.Tensor,
    sample: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop's step: ᾱ_t and ᾱ_prev read from the tables in the sample's
    dtype and combined in it, as ``coma_tpu``'s traced-index step does."""
    a_t = _scalar(schedule.alpha_prod(schedule.timesteps)[step_index], sample)
    a_prev = _scalar(schedule.alpha_prod(schedule.prev_timesteps)[step_index], sample)
    pred_x0 = (sample - torch.sqrt(1.0 - a_t) * model_output) / torch.sqrt(a_t)
    direction = torch.sqrt(1.0 - a_prev) * model_output
    prev_sample = torch.sqrt(a_prev) * pred_x0 + direction
    return prev_sample, pred_x0


def add_noise(schedule: DDIMSchedule, original: torch.Tensor, noise: torch.Tensor,
              timestep: int) -> torch.Tensor:
    """q(x_t | x_0): sqrt(ᾱ_t)·x0 + sqrt(1-ᾱ_t)·ε."""
    a = _scalar(schedule.alphas_cumprod[timestep], original)
    return torch.sqrt(a) * original + torch.sqrt(1.0 - a) * noise


def inpaint_timesteps(schedule: DDIMSchedule, strength: float) -> Tuple[np.ndarray, int]:
    """The strength-truncated timestep list (diffusers ``get_timesteps``)."""
    init_timestep = min(
        int(schedule.num_inference_steps * strength), schedule.num_inference_steps
    )
    t_start = max(schedule.num_inference_steps - init_timestep, 0)
    return schedule.timesteps[t_start:], t_start
