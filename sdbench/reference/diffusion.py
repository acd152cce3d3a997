"""The diffusion arithmetic in float32 (float64 for the schedule's tables):
the DDPM schedule, the sampling timesteps, classifier-free guidance, the DDIM
update, the forward noising, and the UNet's training objective.

- Schedule (Ho et al. 2020): betas linear in [beta_start, beta_end] over T
  steps, alpha_bar the running product of 1 - beta.
- Timesteps for S sampling steps: every (T // S)-th step from 0, descending
  (T = 1000, S = 50: 980, 960, ..., 0); the last step goes to x_0.
- DDIM, eta 0 (Song et al. 2021, Eq. 12): x0 = (x - sqrt(1 - a_t) eps) /
  sqrt(a_t), x_prev = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps, a_prev = 1 at
  the end.
- DPM-Solver++(2M) (Lu et al. 2022) on the same timesteps: with
  lambda = log(sqrt(a) / sqrt(1 - a)) (at the clean end log(1e8), the
  finite stand-in the JAX package and the port take, so that the
  second-order combination stays defined on the last step), h = lambda_prev
  - lambda_t, D = x0 on the first step, else (1 + 1/(2r)) x0 - 1/(2r) x0_last
  with r = (lambda_t - lambda_last) / h; x_prev = (sigma_prev / sigma_t) x +
  sqrt(a_prev) (1 - exp(-h)) D.
- Guidance (Ho & Salimans 2022): eps = eps_u + g (eps_c - eps_u).
- The UNet objective: mean((eps_pred - noise)^2) over x_t = sqrt(a_t) x0 +
  sqrt(1 - a_t) noise.
"""

from __future__ import annotations

import math
from typing import List

import torch


def alpha_bar(ddpm: dict) -> torch.Tensor:
    """alpha_bar [T], float64 on the CPU."""
    if ddpm["noise_schedule"] != "linear":
        raise ValueError(f"unsupported noise schedule {ddpm['noise_schedule']!r}")
    betas = torch.linspace(ddpm["beta_start"], ddpm["beta_end"], ddpm["noise_steps"], dtype=torch.float64)
    return torch.cumprod(1.0 - betas, dim=0)


def sampling_timesteps(noise_steps: int, steps: int) -> List[int]:
    stride = noise_steps // steps
    return [i * stride for i in range(steps)][::-1]


def cfg(eps_uncond: torch.Tensor, eps_cond: torch.Tensor, scale: float) -> torch.Tensor:
    return eps_uncond.float() + scale * (eps_cond.float() - eps_uncond.float())


def ddim_step(abar: torch.Tensor, x: torch.Tensor, eps: torch.Tensor, t: int, t_prev: int) -> torch.Tensor:
    a_t = float(abar[t])
    a_prev = float(abar[t_prev]) if t_prev >= 0 else 1.0
    x0 = (x.float() - (1.0 - a_t) ** 0.5 * eps.float()) / a_t ** 0.5
    return a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps.float()


CLEAN_HALF_LOG_SNR = math.log(1e8)


def half_log_snr(abar: torch.Tensor, t: int) -> float:
    if t < 0:
        return CLEAN_HALF_LOG_SNR
    a = float(abar[t])
    return 0.5 * math.log(a / (1.0 - a))


def dpmpp_2m_step(abar: torch.Tensor, x: torch.Tensor, eps: torch.Tensor, x0_last, t: int, t_prev: int,
                  t_last: int) -> tuple:
    """-> (x_prev, x0): ``x0_last`` is the previous step's data prediction,
    ``t_last`` its timestep (None on the first step)."""
    a_t = float(abar[t])
    a_prev = float(abar[t_prev]) if t_prev >= 0 else 1.0
    x0 = (x.float() - (1.0 - a_t) ** 0.5 * eps.float()) / a_t ** 0.5
    lam = half_log_snr(abar, t)
    h = half_log_snr(abar, t_prev) - lam
    d = x0
    if t_last is not None:
        r = (lam - half_log_snr(abar, t_last)) / h
        d = (1.0 + 0.5 / r) * x0 - (0.5 / r) * x0_last.float()
    return ((1.0 - a_prev) / (1.0 - a_t)) ** 0.5 * x.float() + a_prev ** 0.5 * (-math.expm1(-h)) * d, x0


def q_sample(abar: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    a = abar.to(device=x0.device)[t.long()].float().reshape(-1, 1, 1, 1)
    return a.sqrt() * x0.float() + (1.0 - a).sqrt() * noise.float()


def eps_sq_sum(pred: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The UNet objective's sum of squares; its mean over the batch's elements is the loss."""
    return ((pred.float() - noise.float()) ** 2).sum()

