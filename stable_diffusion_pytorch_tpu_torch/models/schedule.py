"""Noise schedule tables and the sampler steps (port of models/schedule.py).

Tables are float32 tensors on the CPU, computed as the JAX package computes
them; a step gathers its coefficients as 0-d float32 tensors, which PyTorch
applies to tensors on any device as scalars, so a step on the card never
waits for the host or the host for the card. The timesteps are Python ints,
and what JAX selects with ``jnp.where`` on a traced step (the last step, the
first multistep step, the terminal sigma) is a Python branch here.

Steps: DDPM (``ddpm_step``), DDIM (``ddim_step``), DPM-Solver++(2M)
(``dpmpp_2m_step``), and in sigma space Euler (``euler_step``, with
``ancestral_sigmas`` for euler_a) and DPM-Solver++(2M) SDE
(``dpmpp_2m_sde_step``). A stochastic step takes its noise as an argument:
the sampling loop draws it (float32 on the CPU from a seeded generator, so a
seed gives the same image on every device), and the parity tests pass the
JAX loop's own draws. Also the v-prediction conversions, the training
weights ``snr_at`` and ``min_snr_weight``, zero-terminal-SNR
rescaling (``rescale_zero_terminal_snr``) and the even, leading and trailing
spacings. ``add_noise`` is the forward process.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
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


def rescale_zero_terminal_snr(betas: torch.Tensor) -> torch.Tensor:
    """Betas whose terminal alpha_bar is exactly 0 (Lin et al. 2023, Algorithm
    1): sqrt(alpha_bar) shifted and scaled so its first entry stays and its
    last is 0. Meaningful only with v-prediction (eps is undefined at SNR 0)."""
    sqrt_ab = torch.sqrt(torch.cumprod(1.0 - betas, dim=0))
    s0, s_t = sqrt_ab[0], sqrt_ab[-1]
    sqrt_ab = (sqrt_ab - s_t) * s0 / (s0 - s_t)
    ab = sqrt_ab ** 2
    return 1.0 - torch.cat([ab[:1], ab[1:] / ab[:-1]])


def make_schedule(cfg: DDPMConfig) -> DiffusionSchedule:
    betas = make_betas(cfg.noise_schedule, cfg.noise_steps, cfg.beta_start, cfg.beta_end)
    if cfg.zero_terminal_snr:
        betas = rescale_zero_terminal_snr(betas)
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


def q_sample_coefs(sched: DiffusionSchedule, timesteps, device, dtype) -> torch.Tensor:
    """[len(timesteps), 2]: (sqrt(abar_t), sqrt(1 - abar_t)) of each
    timestep, gathered from the CPU tables and moved to ``device`` in
    ``dtype`` in one copy: :func:`add_noise`'s coefficients for a loop that
    runs ``add_noise`` at host-known timesteps without a copy per step (a
    captured loop cannot copy from the host)."""
    t = torch.as_tensor(list(timesteps), dtype=torch.long)
    return torch.stack([sched.sqrt_alpha_bar[t], sched.sqrt_1m_alpha_bar[t]], dim=1).to(device=device, dtype=dtype)


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


def _abar(sched: DiffusionSchedule, t: int) -> torch.Tensor:
    """alpha_bar at t, with t < 0 the clean endpoint (1)."""
    return sched.alphas_cumprod[t] if t >= 0 else torch.tensor(1.0)


def ddpm_step(
    sched: DiffusionSchedule,
    pred_noise: torch.Tensor,
    x_t: torch.Tensor,
    t: int,
    noise: Optional[torch.Tensor],
    repeat_noise: bool = False,
    scale_factor: float = 1.0,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ancestral step x_t -> x_{t-1} (the reference's scheduler.py:141-219).

    ``noise`` is the step's draw in x's shape, or [1, ...] with
    ``repeat_noise`` (one draw shared by the batch); the step at t == 0 adds
    none (``noise`` may be None there). ``x0`` overrides the eps-derived data
    prediction (the v-prediction path). Returns (x_prev, pred_x0)."""
    if x0 is None:
        x0 = pred_x0_from_eps(sched, x_t, pred_noise, t)
    dtype = x_t.dtype
    mean = sched.mean_x0_coef[t].to(dtype) * x0 + sched.mean_xt_coef[t].to(dtype) * x_t
    if t <= 0:
        return mean, x0
    std = torch.exp(0.5 * sched.log_var[t]).to(dtype)
    noise = noise.to(device=x_t.device, dtype=dtype)
    if repeat_noise:
        noise = noise[:1].expand_as(x_t)
    noise = noise * torch.tensor(scale_factor, dtype=dtype)
    return mean + std * noise, x0


def ddim_step(
    sched: DiffusionSchedule,
    pred_noise: torch.Tensor,
    x_t: torch.Tensor,
    t: int,
    t_prev: int,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM step x_t -> x_{t_prev} (Song et al. 2021, Eq. 12); ``t_prev < 0``
    is the final step to x_0. ``eta > 0`` adds ``noise``, else a draw from
    ``generator`` (on the CPU, moved to x's device). ``x0`` overrides the
    eps-derived data prediction (the v-prediction path; finite at alpha_bar
    = 0, where the eps-derived one is not). Returns (x_prev, pred_x0)."""
    abar_t = sched.alphas_cumprod[t]
    abar_prev = _abar(sched, t_prev)
    if x0 is None:
        x0 = pred_x0_from_eps(sched, x_t, pred_noise, t)
    sigma = torch.tensor(0.0)
    if eta > 0.0:
        sigma = eta * torch.sqrt((1 - abar_prev) / (1 - abar_t)) * torch.sqrt(1 - abar_t / abar_prev)
    dir_xt = torch.sqrt(torch.clip(1.0 - abar_prev - sigma ** 2, min=0.0)).to(x_t.dtype) * pred_noise
    x_prev = torch.sqrt(abar_prev).to(x_t.dtype) * x0 + dir_xt
    if eta > 0.0 and t_prev >= 0:  # the last step (to x_0) has sigma 0 and draws nothing
        if noise is None:
            noise = torch.randn(x_t.shape, generator=generator, dtype=torch.float32)
        x_prev = x_prev + sigma.to(x_t.dtype) * noise.to(device=x_t.device, dtype=x_t.dtype)
    return x_prev, x0


def _lambda_of(sched: DiffusionSchedule, t: int) -> torch.Tensor:
    """Half-log-SNR log(alpha_t / sigma_t); t < 0 is the clean endpoint, a
    large finite lambda (alpha_bar 1 - 1e-8, which is 1 in float32)."""
    abar = sched.alphas_cumprod[t] if t >= 0 else torch.tensor(1.0 - 1e-8)
    return torch.log(torch.sqrt(abar) / torch.clamp(torch.sqrt(1.0 - abar), min=1e-8))


def dpmpp_2m_step(
    sched: DiffusionSchedule,
    pred_noise: torch.Tensor,
    x_t: torch.Tensor,
    t: int,
    t_prev: int,
    x0_prev: torch.Tensor,
    t_last: int,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) step (Lu et al. 2022), t -> ``t_prev`` (-1: the
    clean endpoint). ``x0_prev`` is the previous step's data prediction and
    ``t_last`` the step before t; ``t_last >= noise_steps`` marks the first
    step, which falls back to first order. The data combination D is formed
    in float32. Returns (x_next, x0_cur): feed x0_cur back as ``x0_prev``."""
    x0_cur = x0 if x0 is not None else pred_x0_from_eps(sched, x_t, pred_noise, t)
    lam_cur = _lambda_of(sched, t)
    h = _lambda_of(sched, t_prev) - lam_cur
    h_last = lam_cur - _lambda_of(sched, min(t_last, sched.noise_steps - 1))
    if t_last >= sched.noise_steps:
        coef = torch.tensor(0.0)
    else:
        r = h_last / (h if h != 0 else torch.tensor(1.0))
        coef = 1.0 / (2.0 * torch.clamp(torch.abs(r), min=1e-8)) * torch.sign(r)
    d = (1.0 + coef) * x0_cur.float() - coef * x0_prev.float()
    abar_next, abar_cur = _abar(sched, t_prev), sched.alphas_cumprod[t]
    sigma_next = torch.sqrt(torch.clamp(1.0 - abar_next, min=0.0))
    sigma_cur = torch.sqrt(torch.clamp(1.0 - abar_cur, min=1e-16))
    dtype = x_t.dtype
    x_next = ((sigma_next / sigma_cur).to(dtype) * x_t
              + (torch.sqrt(abar_next) * -torch.expm1(-h)).to(dtype) * d.to(dtype))
    return x_next, x0_cur


# v-prediction (Salimans & Ho 2022). With alpha = sqrt(abar), sigma = sqrt(1-abar)
# and x_t = alpha x0 + sigma eps: v = alpha eps - sigma x0, eps = alpha v + sigma x_t,
# x0 = alpha x_t - sigma v.


def alpha_sigma_at(sched: DiffusionSchedule, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, sigma_vp) = (sqrt(abar_t), sqrt(1 - abar_t))."""
    ab = sched.alphas_cumprod[t]
    return torch.sqrt(ab), torch.sqrt(1.0 - ab)


def v_from_eps_x0(x0: torch.Tensor, eps: torch.Tensor, alpha, sigma_vp) -> torch.Tensor:
    """The v target: alpha eps - sigma x0."""
    return alpha * eps - sigma_vp * x0


def eps_from_v(x_t: torch.Tensor, v: torch.Tensor, alpha, sigma_vp) -> torch.Tensor:
    """eps from a v output, computed in float32."""
    return (alpha * v.float() + sigma_vp * x_t.float()).to(x_t.dtype)


def x0_from_v(x_t: torch.Tensor, v: torch.Tensor, alpha, sigma_vp) -> torch.Tensor:
    """x0 from a v output, computed in float32: finite at every SNR, alpha_bar
    = 0 included, which is why zero-terminal-SNR schedules need v."""
    return (alpha * x_t.float() - sigma_vp * v.float()).to(x_t.dtype)


def snr_at(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """SNR(t) = abar_t / (1 - abar_t), the denominator floored at 1e-12;
    ``t`` [B] int on the tables' device."""
    ab = sched.alphas_cumprod[t]
    return ab / torch.clamp(1.0 - ab, min=1e-12)


def min_snr_weight(sched: DiffusionSchedule, t: torch.Tensor, gamma: float,
                   prediction_type: str = "epsilon") -> torch.Tensor:
    """The Min-SNR-gamma loss weight of each example (Hang et al. 2023):
    min(SNR, gamma) / SNR for epsilon, min(SNR, gamma) / (SNR + 1) for v."""
    snr = snr_at(sched, t)
    clipped = torch.clamp(snr, max=gamma)
    if prediction_type == "v_prediction":
        return clipped / (snr + 1.0)
    return clipped / torch.clamp(snr, min=1e-12)


# Sigma space (the k-diffusion convention): sigma_t = sqrt((1 - abar_t) / abar_t),
# x_sigma = x_vp / sqrt(abar_t) = x0 + sigma n; an eps model is the denoiser
# D(x, sigma) = x - sigma eps(x / sqrt(1 + sigma^2), t(sigma)), and the
# probability-flow ODE is dx/dsigma = eps.


def vp_sigmas(sched: DiffusionSchedule) -> torch.Tensor:
    """[T] sigma_t = sqrt((1 - abar_t) / abar_t), ascending in t."""
    ab = sched.alphas_cumprod
    return torch.sqrt((1.0 - ab) / ab)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp``: piecewise-linear in ascending ``xp``, constant past its ends."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(1), right=True), 1, len(xp) - 1)[0]
    df, dx, delta = fp[i] - fp[i - 1], xp[i] - xp[i - 1], x - xp[i - 1]
    tiny = torch.finfo(xp.dtype).eps ** 2  # np.spacing(eps): JAX's guard against dx = 0
    f = fp[i - 1] if abs(dx) <= tiny else fp[i - 1] + (delta / dx) * df
    if x < xp[0]:
        return fp[0]
    if x > xp[-1]:
        return fp[-1]
    return f


def t_from_sigma(sched: DiffusionSchedule, sigma: torch.Tensor) -> torch.Tensor:
    """Fractional timestep of a sigma: log sigma interpolated over the table
    (the UNet is conditioned on t, continuous in its sinusoidal embedding)."""
    return _interp(torch.log(sigma), torch.log(vp_sigmas(sched)),
                   torch.arange(sched.noise_steps, dtype=torch.float32))


def karras_sigmas(sigma_min, sigma_max, num_steps: int, rho: float = 7.0) -> torch.Tensor:
    """Karras et al. (2022) Eq. 5: [num_steps] sigmas from sigma_max down to
    sigma_min (the sampler appends the terminal 0)."""
    ramp = torch.arange(num_steps, dtype=torch.float32) / max(num_steps - 1, 1)  # jnp.linspace(0, 1, n)
    inv_rho = 1.0 / rho
    return (sigma_max ** inv_rho + ramp * (sigma_min ** inv_rho - sigma_max ** inv_rho)) ** rho


def table_sigmas(sched: DiffusionSchedule, timesteps) -> torch.Tensor:
    """Sigmas at the given discrete timesteps."""
    return vp_sigmas(sched)[torch.as_tensor(timesteps)]


def euler_step(x: torch.Tensor, eps: torch.Tensor, sigma, sigma_next) -> torch.Tensor:
    """Explicit Euler step of the probability-flow ODE in sigma space."""
    return x + (sigma_next - sigma).to(x.dtype) * eps


def ancestral_sigmas(sigma, sigma_next, eta: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma_down, sigma_up): step the ODE to sigma_down, then add noise of
    sigma_up, so the marginal lands on sigma_next (down^2 + up^2 = next^2)."""
    sig2, nxt2 = sigma ** 2, sigma_next ** 2
    sigma_up = torch.minimum(sigma_next, eta * torch.sqrt(
        torch.clamp(nxt2 * (sig2 - nxt2) / torch.clamp(sig2, min=1e-20), min=0.0)))
    sigma_down = torch.sqrt(torch.clamp(nxt2 - sigma_up ** 2, min=0.0))
    return sigma_down, sigma_up


def dpmpp_2m_sde_step(
    x: torch.Tensor,
    denoised: torch.Tensor,
    denoised_prev: torch.Tensor,
    sigma: torch.Tensor,
    sigma_next: torch.Tensor,
    h_last: torch.Tensor,
    noise: Optional[torch.Tensor],
    eta: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DPM-Solver++(2M) SDE step (midpoint variant) in sigma space,
    computed in float32 and cast back. ``h_last <= 0`` marks the first step
    (first order); at ``sigma_next == 0`` it returns the data prediction
    (``noise`` may be None there). Returns (x_next, h): carry h as ``h_last``."""
    h = -torch.log(torch.clamp(sigma_next, min=1e-20)) + torch.log(torch.clamp(sigma, min=1e-20))
    if not sigma_next > 0.0:
        return denoised.float().to(x.dtype), h
    eta_h = eta * h
    blend = -torch.expm1(-h - eta_h)  # 1 - exp(-(1 + eta) h)
    df = denoised.float()
    x_next = (sigma_next / torch.clamp(sigma, min=1e-20)) * torch.exp(-eta_h) * x.float() + blend * df
    if h_last > 0.0:
        r = h_last / (h if h != 0 else torch.tensor(1.0))
        x_next = x_next + 0.5 * blend / torch.clamp(r, min=1e-8) * (df - denoised_prev.float())
    noise_scale = sigma_next * torch.sqrt(torch.clamp(-torch.expm1(-2.0 * eta_h), min=0.0))
    x_next = x_next + noise_scale * noise.to(device=x.device).float()
    return x_next.to(x.dtype), h


def spaced_timesteps(noise_steps: int, num_inference_steps: int) -> list:
    """Evenly spaced descending subsequence, e.g. T=1000, S=50 -> [980, ..., 20, 0]."""
    stride = noise_steps // num_inference_steps
    return [i * stride for i in range(num_inference_steps)][::-1]


def leading_timesteps(num_inference_steps: int) -> list:
    """Raw steps S-1..0 (the reference's few-step quirk, and the full schedule)."""
    return list(range(num_inference_steps - 1, -1, -1))


def trailing_timesteps(noise_steps: int, num_inference_steps: int) -> list:
    """Descending subsequence whose first step is T-1, e.g. T=1000, S=50 ->
    [999, 979, ..., 19] (Lin et al. 2023 §3.2; zero-terminal-SNR sampling
    starts at the terminal step). numpy's float32 ``arange``, which the JAX
    package's ``jnp.arange`` calls for a float step, rounded half to even."""
    step = noise_steps / num_inference_steps
    return [int(t) - 1 for t in np.round(np.arange(noise_steps, 0, -step, dtype=np.float32))]
