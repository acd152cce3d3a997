"""Noise schedule tables and the DDIM step (port of models/schedule.py).

Tables are float32 tensors on the CPU, computed as the JAX package computes
them; a step gathers its coefficients as 0-d float32 tensors, which PyTorch
applies to tensors on any device as scalars. The DDPM, DPM-Solver++ and
sigma-space samplers, v-prediction and zero-terminal-SNR rescaling are not
ported yet. ``add_noise`` is the trainer's forward process.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig


@dataclass(frozen=True)
class DiffusionSchedule:
    """Coefficient tables, each [T] float32 (the JAX package's definitions)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alpha_bar: torch.Tensor
    sqrt_1m_alpha_bar: torch.Tensor
    sqrt_recip_alpha_bar: torch.Tensor
    sqrt_recip_m1_alpha_bar: torch.Tensor
    log_var: torch.Tensor
    mean_x0_coef: torch.Tensor
    mean_xt_coef: torch.Tensor
    noise_steps: int


def make_betas(schedule: str, noise_steps: int, beta_start: float, beta_end: float) -> torch.Tensor:
    if schedule == "linear":
        return torch.linspace(beta_start, beta_end, noise_steps, dtype=torch.float32)
    if schedule == "cosine":
        s = 0.008
        t = torch.arange(noise_steps + 1, dtype=torch.float32) / noise_steps
        alpha_bar = torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2
        return torch.clip(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0.0, 0.999)
    if schedule == "cubic":
        return torch.linspace(
            beta_start ** (1.0 / 3.0), beta_end ** (1.0 / 3.0), noise_steps, dtype=torch.float32
        ) ** 3
    raise ValueError(f"unknown noise schedule: {schedule!r}")


def make_schedule(cfg: DDPMConfig) -> DiffusionSchedule:
    if cfg.zero_terminal_snr:
        raise NotImplementedError("zero-terminal-SNR schedules are not ported yet")
    betas = make_betas(cfg.noise_schedule, cfg.noise_steps, cfg.beta_start, cfg.beta_end)
    alphas = 1.0 - betas
    alphas_cumprod = torch.cumprod(alphas, dim=0)
    alpha_bar_prev = torch.cat([torch.ones(1), alphas_cumprod[:-1]])
    variance = betas * (1.0 - alpha_bar_prev) / (1.0 - alphas_cumprod)
    return DiffusionSchedule(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        sqrt_alpha_bar=torch.sqrt(alphas_cumprod),
        sqrt_1m_alpha_bar=torch.sqrt(1.0 - alphas_cumprod),
        sqrt_recip_alpha_bar=alphas_cumprod ** -0.5,
        sqrt_recip_m1_alpha_bar=torch.sqrt(1.0 / alphas_cumprod - 1.0),
        log_var=torch.log(torch.clip(variance, min=1e-20)),
        mean_x0_coef=betas * torch.sqrt(alpha_bar_prev) / (1.0 - alphas_cumprod),
        mean_xt_coef=(1.0 - alpha_bar_prev) * torch.sqrt(alphas) / (1.0 - alphas_cumprod),
        noise_steps=cfg.noise_steps,
    )


def add_noise(
    sched: DiffusionSchedule, original_samples: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor
) -> torch.Tensor:
    """q(x_t | x_0): sqrt(abar_t) x0 + sqrt(1 - abar_t) noise; ``timesteps`` [B] int
    on the samples' device. The gather runs where the tables lie: a caller on
    a CUDA device passes tables moved there once (:func:`schedule_on`)."""
    shape = (-1,) + (1,) * (original_samples.dim() - 1)
    dtype, device = original_samples.dtype, original_samples.device
    t = timesteps.long().to(sched.sqrt_alpha_bar.device)
    a = sched.sqrt_alpha_bar[t].reshape(shape).to(device=device, dtype=dtype)
    b = sched.sqrt_1m_alpha_bar[t].reshape(shape).to(device=device, dtype=dtype)
    return a * original_samples + b * noise


def schedule_on(sched: DiffusionSchedule, device) -> DiffusionSchedule:
    """The schedule with every table moved to ``device``."""
    return dataclasses.replace(sched, **{
        f.name: getattr(sched, f.name).to(device)
        for f in dataclasses.fields(sched) if isinstance(getattr(sched, f.name), torch.Tensor)
    })


def pred_x0_from_eps(sched: DiffusionSchedule, x_t: torch.Tensor, eps: torch.Tensor, t: int) -> torch.Tensor:
    """x0 = x_t / sqrt(abar_t) - sqrt(1/abar_t - 1) * eps."""
    a = sched.sqrt_recip_alpha_bar[t].to(x_t.dtype)
    b = sched.sqrt_recip_m1_alpha_bar[t].to(x_t.dtype)
    return a * x_t - b * eps


def ddim_step(
    sched: DiffusionSchedule,
    pred_noise: torch.Tensor,
    x_t: torch.Tensor,
    t: int,
    t_prev: int,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM step x_t -> x_{t_prev} (Song et al. 2021, Eq. 12); ``t_prev < 0``
    is the final step to x_0. ``eta > 0`` draws noise from ``generator`` (on
    the CPU, moved to x's device). Returns (x_prev, pred_x0)."""
    abar_t = sched.alphas_cumprod[t]
    abar_prev = sched.alphas_cumprod[t_prev] if t_prev >= 0 else torch.tensor(1.0)
    x0 = pred_x0_from_eps(sched, x_t, pred_noise, t)
    sigma = torch.tensor(0.0)
    if eta > 0.0:
        sigma = eta * torch.sqrt((1 - abar_prev) / (1 - abar_t)) * torch.sqrt(1 - abar_t / abar_prev)
    dir_xt = torch.sqrt(torch.clip(1.0 - abar_prev - sigma ** 2, min=0.0)).to(x_t.dtype) * pred_noise
    x_prev = torch.sqrt(abar_prev).to(x_t.dtype) * x0 + dir_xt
    if eta > 0.0 and t_prev >= 0:  # the last step (to x_0) has sigma 0 and draws nothing
        noise = torch.randn(x_t.shape, generator=generator, dtype=torch.float32)
        x_prev = x_prev + sigma.to(x_t.dtype) * noise.to(device=x_t.device, dtype=x_t.dtype)
    return x_prev, x0


def spaced_timesteps(noise_steps: int, num_inference_steps: int) -> list:
    """Evenly spaced descending subsequence, e.g. T=1000, S=50 -> [980, ..., 20, 0]."""
    stride = noise_steps // num_inference_steps
    return [i * stride for i in range(num_inference_steps)][::-1]


def leading_timesteps(num_inference_steps: int) -> list:
    """Raw steps S-1..0 (used when the step count equals the schedule length)."""
    return list(range(num_inference_steps - 1, -1, -1))
