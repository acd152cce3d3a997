"""LatentDiffusion: UNet + VAE + CLIP + schedule (port of models/latent_diffusion.py).

The JAX package runs the reverse loop as one jitted ``lax.scan`` and keeps one
compiled program per signature (``_jit_cache``). Here each loop is a
:class:`SampleLoop`: a host plan made once (timesteps, step scalars, which
steps draw noise, DeepCache's refresh steps) and a body on tensors alone,
which runs the UNet once per step on the CFG-doubled batch [uncond, cond]
and takes every draw of the loop made beforehand from the seeded generator
(the same draws, in the same order, as the eager loop that draws each step's
noise when it needs it). ``LatentDiffusion.sample_loop`` caches one
:class:`CachedLoop` per signature: on a CUDA device its first call runs the
body eagerly (the warm-up, whose result it returns) and captures it as one
CUDA graph, and every later call replays that graph (``utils/graphs.py``);
on the CPU the body runs eagerly. Every sampler of the JAX package is ported: the discrete ``ddim``, ``ddpm``
and ``dpmpp`` (DPM-Solver++ 2M) and the sigma-space ``euler``, ``euler_a``,
``heun`` and ``dpmpp_sde``, optionally on Karras spacing, with v-prediction,
trailing spacing on zero-terminal-SNR schedules, guidance rescale,
``strength`` (img2img and the hires fix's partial schedule), inpainting
(the known region re-noised and blended in after each step), DeepCache (the
UNet's deep trunk refreshed every N steps, discrete samplers), ControlNet
(one or several nets through :class:`_ControlShim`), prompt weighting and
long prompts (``encode_prompts``) and tiled VAE decode. Each step's scalars
come from the CPU schedule tables on the host as 0-d tensors (read at launch,
so a capture fixes them per signature), the inpaint blend's coefficients are
on the device before the loop, and the loop never reads a device value.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from stable_diffusion_pytorch_tpu_torch.models import schedule as sched_lib
from stable_diffusion_pytorch_tpu_torch.models.blocks import GaussianDistribution
from stable_diffusion_pytorch_tpu_torch.models.prompt_weighting import has_weight_syntax
from stable_diffusion_pytorch_tpu_torch.models.schedule import DiffusionSchedule
from stable_diffusion_pytorch_tpu_torch.utils.graphs import GraphPool

SIGMA_SPACE_SAMPLERS = ("euler", "euler_a", "heun", "dpmpp_sde")
SAMPLERS = ("ddim", "ddpm", "dpmpp") + SIGMA_SPACE_SAMPLERS


def cfg_combine(
    eps_uncond: torch.Tensor, eps_cond: torch.Tensor, guidance_scale: float,
    reference_formula: bool = False,
) -> torch.Tensor:
    """``uncond + g * (cond - uncond)``; the reference's swapped formula
    ``uncond + g * (uncond - cond)`` when ``reference_formula``."""
    if reference_formula:
        return eps_uncond + guidance_scale * (eps_uncond - eps_cond)
    return eps_uncond + guidance_scale * (eps_cond - eps_uncond)


def rescale_cfg(combined: torch.Tensor, cond: torch.Tensor, phi: float) -> torch.Tensor:
    """Guidance rescale (Lin et al. 2023 §3.4): the CFG output's per-sample std
    brought back to the conditional prediction's, blended by ``phi``; in
    float32, with the population std (``jnp.std``'s ddof 0)."""
    dims = tuple(range(1, combined.dim()))
    c32 = combined.float()
    std_cond = cond.float().std(dim=dims, keepdim=True, correction=0)
    std_cfg = c32.std(dim=dims, keepdim=True, correction=0)
    rescaled = c32 * (std_cond / torch.clamp(std_cfg, min=1e-8))
    return (phi * rescaled + (1.0 - phi) * c32).to(combined.dtype)


def make_pred_noise_fn(unet, guidance_scale: float = 1.0, reference_cfg_formula: bool = False,
                       guidance_rescale: float = 0.0):
    """``f(x_t [B,h,w,c], t [B], context [B,S,D], uncond [B,S,D] | None) -> eps``.
    With guidance > 1 the UNet runs once on the doubled batch [uncond, cond];
    ``guidance_rescale > 0`` applies :func:`rescale_cfg` to the model output
    (eps, or v for a v-prediction model). DeepCache's UNet arguments pass
    through: ``deep_cache`` (the trunk of the whole, doubled, batch) and
    ``return_deep``, with which ``f`` returns (eps, trunk)."""
    do_cfg = guidance_scale > 1.0

    def pred_noise(x_t, t, context_emb, uncond_emb=None, **unet_kw):
        return_deep = unet_kw.get("return_deep", False)
        if do_cfg:
            if uncond_emb is None:
                raise ValueError("CFG requires the uncond embedding")
            x_t, t, context_emb = torch.cat([x_t, x_t]), torch.cat([t, t]), torch.cat([uncond_emb, context_emb])
        out = unet(x_t, t, context_emb, **unet_kw)
        out, deep = out if return_deep else (out, None)
        if do_cfg:
            eps_uncond, eps_cond = out.chunk(2)
            out = cfg_combine(eps_uncond, eps_cond, guidance_scale, reference_cfg_formula)
            if guidance_rescale > 0.0:
                out = rescale_cfg(out, eps_cond, guidance_rescale)
        return (out, deep) if return_deep else out

    return pred_noise


class _ControlShim:
    """The UNet as the loops call it, ``f(x, t, context)``, with ControlNet
    residuals: each net runs on the step's input and its hint (tiled when CFG
    doubles the batch), the residuals of several nets sum, each times its
    scale, and the UNet adds them (``UNetModel.forward(control=...)``)."""

    def __init__(self, unet, controlnets: Sequence, control_scales: Sequence[float], hints: Sequence[torch.Tensor]):
        if not len(controlnets) == len(control_scales) == len(hints):
            raise ValueError(f"{len(hints)} hint(s) and {len(control_scales)} scale(s) for "
                             f"{len(controlnets)} ControlNet(s)")
        self.unet = unet
        self.controlnets = list(controlnets)
        self.scales = [float(s) for s in control_scales]
        self.hints = list(hints)

    def __call__(self, x, t, context_emb):
        total_skips = total_mid = None
        for net, scale, hint in zip(self.controlnets, self.scales, self.hints):
            if hint.shape[0] != x.shape[0]:  # CFG doubled the batch
                hint = torch.cat([hint] * (x.shape[0] // hint.shape[0]))
            skips, mid = net(x, t, context_emb, hint)
            s = torch.tensor(scale, dtype=mid.dtype)
            if total_skips is None:
                total_skips, total_mid = [r * s for r in skips], mid * s
            else:
                total_skips = [a + r * s for a, r in zip(total_skips, skips)]
                total_mid = total_mid + mid * s
        return self.unet(x, t, context_emb, control=(tuple(total_skips), total_mid))


def _noise_source(generator: Optional[torch.Generator], noise: Optional[Sequence[torch.Tensor]]):
    """``draw(i, shape, like)``: step i's noise in ``like``'s dtype on its
    device: ``noise[i]`` when a sequence is given (the parity tests pass the
    JAX loop's draws), else float32 drawn on the CPU from ``generator``."""

    def draw(i: int, shape, like: torch.Tensor) -> torch.Tensor:
        n = noise[i] if noise is not None else torch.randn(shape, generator=generator, dtype=torch.float32)
        return n.to(device=like.device, dtype=like.dtype)

    return draw


def _truncate(ts: list, num_steps: int, strength: float) -> list:
    """The final ``round(num_steps * strength)`` steps (at least one), Python's
    ``round`` (halves to even), as the JAX package."""
    if strength >= 1.0:
        return ts
    keep = max(min(round(num_steps * strength), num_steps), 1)
    return ts[num_steps - keep:]


class SampleLoop:
    """One sampling signature's reverse loop, split into a host plan and a
    device body (the JAX package's ``lax.scan`` body and what it closes over).

    The plan, made here once, fixes everything the host decides: the
    timesteps (or sigmas, the fractional UNet timesteps and every step
    coefficient), which steps draw noise and in what order, DeepCache's
    refresh steps and heun's second calls. The body (:meth:`body`) takes
    only tensors: ``x_T``, the context and uncond embeddings, every draw of
    the loop made beforehand (:meth:`predraw`), and where they apply the
    inpaint mask and init latents and the ControlNet hints. It reads no
    device value on the host and copies nothing from the host, so on a CUDA
    device it can be captured as one graph (``LatentDiffusion.sample_loop``).

    Called as ``f(x_T, context_emb, uncond_emb, generator=None, noise=None,
    mask=None, init_latents=None, blend_noise=None)`` it is the eager loop
    :func:`make_sample_fn` returns: each stochastic step draws float32 noise
    on the CPU from ``generator`` when it needs it (or takes step i's from
    ``noise[i]``, the inpaint blend's from ``blend_noise[i]``). The
    pre-drawn route draws the same tensors from the same generator in the
    same order (:attr:`draw_order`), so a seed gives the same x_0 by both."""

    def __init__(self, unet, schedule: DiffusionSchedule, sampler: str, guidance_scale: float,
                 reference_cfg_formula: bool, guidance_rescale: float, inpaint: bool):
        self.unet = unet
        self.schedule = schedule
        self.sampler = sampler
        self.inpaint = inpaint
        self._guidance = (guidance_scale, reference_cfg_formula, guidance_rescale)
        # (step i, "step" or "blend"): the loop's draws in the eager loop's order
        self.draw_order: list = []

    def __call__(self, x_T, context_emb, uncond_emb, generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None, mask: Optional[torch.Tensor] = None,
                 init_latents: Optional[torch.Tensor] = None, blend_noise: Optional[Sequence[torch.Tensor]] = None):
        return self._loop(x_T, context_emb, uncond_emb, _noise_source(generator, noise),
                          _noise_source(generator, blend_noise), mask, init_latents, self.unet)

    def draw_shapes(self, x_shape) -> list:
        """The shape of each draw of :attr:`draw_order` for a ``x_T`` of ``x_shape``."""
        return [self._draw_shape(kind, tuple(x_shape)) for _, kind in self.draw_order]

    def _draw_shape(self, kind: str, x_shape: tuple) -> tuple:
        return x_shape

    def predraw(self, generator: Optional[torch.Generator], x_shape) -> torch.Tensor:
        """Every draw of the loop, float32 on the CPU from ``generator``, one
        ``randn`` per draw in the eager loop's order, flattened into one
        tensor (the body's one copy to the device). DDPM over the full
        schedule (``LatentDiffusion.sample``'s default) draws 999 latents: at
        512x512 batch 4, ~262 MB of float32."""
        parts = [torch.randn(shape, generator=generator, dtype=torch.float32).reshape(-1)
                 for shape in self.draw_shapes(x_shape)]
        return torch.cat(parts) if parts else torch.zeros(0)

    def body(self, x_T, context_emb, uncond_emb, draws, mask=None, init_latents=None, hints=None):
        """The loop on tensors alone: ``draws`` is :meth:`predraw`'s tensor
        (in x_T's dtype on its device for a capture), ``hints`` the ControlNet
        hints (one per net of the shim the loop was built with)."""
        rows, offset = {}, 0
        for (i, kind), shape in zip(self.draw_order, self.draw_shapes(x_T.shape)):
            n = math.prod(shape)
            rows[(i, kind)] = (offset, shape)
            offset += n
        if offset != draws.numel():
            raise ValueError(f"{draws.numel()} pre-drawn values for a loop that draws {offset}")

        def source(kind):
            def draw(i: int, shape, like: torch.Tensor) -> torch.Tensor:
                at, planned = rows[(i, kind)]
                if tuple(shape) != planned:
                    raise ValueError(f"step {i} draws {tuple(shape)}, planned {planned}")
                return draws[at:at + math.prod(planned)].view(planned).to(device=like.device, dtype=like.dtype)
            return draw

        return self._loop(x_T, context_emb, uncond_emb, source("step"), source("blend"), mask, init_latents,
                          self.denoiser(hints))

    def denoiser(self, hints=None):
        """The UNet the loop calls: the one it was built with, or with
        ``hints``, its ControlNet shim over those hints."""
        if hints is None:
            return self.unet
        if not isinstance(self.unet, _ControlShim):
            raise ValueError("ControlNet hints for a loop built without ControlNets")
        return _ControlShim(self.unet.unet, self.unet.controlnets, self.unet.scales, hints)

    def _pred_noise(self, denoiser):
        return make_pred_noise_fn(denoiser, *self._guidance)

    def _loop(self, x_T, context_emb, uncond_emb, draw, draw_blend, mask, init_latents, denoiser):
        raise NotImplementedError


class _DiscreteLoop(SampleLoop):
    """DDIM, DDPM and DPM-Solver++(2M) on the trained grid."""

    def __init__(self, unet, schedule, num_steps, sampler, guidance_scale, reference_cfg_formula, guidance_rescale,
                 inpaint, *, eta, repeat_noise, scale_factor, ascending_loop, leading_timesteps, strength,
                 prediction_type, timestep_spacing, deep_cache_interval):
        super().__init__(unet, schedule, sampler, guidance_scale, reference_cfg_formula, guidance_rescale, inpaint)
        self.eta, self.repeat_noise, self.scale_factor = eta, repeat_noise, scale_factor
        self.prediction_type, self.deep_cache_interval = prediction_type, deep_cache_interval
        if leading_timesteps or num_steps == schedule.noise_steps:
            ts = sched_lib.leading_timesteps(min(num_steps, schedule.noise_steps))
        elif timestep_spacing == "trailing":
            ts = sched_lib.trailing_timesteps(schedule.noise_steps, num_steps)
        else:
            ts = sched_lib.spaced_timesteps(schedule.noise_steps, num_steps)
        ts = _truncate(ts, num_steps, strength)
        # the target of each step (-1: the clean endpoint) and the step before it
        # (noise_steps marks DPM++'s first step)
        steps = list(zip(ts, ts[1:] + [-1], [schedule.noise_steps] + ts[:-1]))
        if ascending_loop:  # reference quirk: iterate the schedule in ascending-t order
            steps = steps[::-1]
        self.steps = steps
        self.start_timestep = steps[0][0]
        for i, (t, t_prev, _) in enumerate(steps):
            if (sampler == "ddim" and eta > 0.0 and t_prev >= 0) or (sampler == "ddpm" and t > 0):
                self.draw_order.append((i, "step"))
            if inpaint and t_prev >= 0:
                self.draw_order.append((i, "blend"))
        self._q_coefs: dict = {}

    def _draw_shape(self, kind: str, x_shape: tuple) -> tuple:
        if kind == "step" and self.sampler == "ddpm" and self.repeat_noise:
            return (1,) + x_shape[1:]
        return x_shape

    def q_coefs(self, device, dtype) -> torch.Tensor:
        """The inpaint blend's (sqrt(abar), sqrt(1 - abar)) at each step's
        target, moved to ``device`` once per loop (the first, eager, run
        makes them, outside any capture)."""
        key = (torch.device(device), dtype)
        if key not in self._q_coefs:
            self._q_coefs[key] = sched_lib.q_sample_coefs(
                self.schedule, [max(t_prev, 0) for _, t_prev, _ in self.steps], device, dtype)
        return self._q_coefs[key]

    def _loop(self, x_T, context_emb, uncond_emb, draw, draw_blend, mask, init_latents, denoiser):
        schedule, sampler, dci = self.schedule, self.sampler, self.deep_cache_interval
        pred_noise = self._pred_noise(denoiser)
        x, x0_prev, deep = x_T, torch.zeros_like(x_T), None
        bsz = x.shape[0]
        noise_shape = self._draw_shape("step", tuple(x.shape))
        coefs = self.q_coefs(x.device, x.dtype) if self.inpaint else None
        for i, (t, t_prev, t_last) in enumerate(self.steps):
            t_batch = torch.full((bsz,), t, dtype=torch.int32, device=x.device)
            if dci > 1 and i % dci == 0:  # DeepCache: refresh the trunk
                eps, deep = pred_noise(x, t_batch, context_emb, uncond_emb, return_deep=True)
            elif dci > 1:
                eps = pred_noise(x, t_batch, context_emb, uncond_emb, deep_cache=deep)
            else:
                eps = pred_noise(x, t_batch, context_emb, uncond_emb)
            x0_v = None
            if self.prediction_type == "v_prediction":
                alpha, sigma_vp = sched_lib.alpha_sigma_at(schedule, t)
                v = eps
                eps = sched_lib.eps_from_v(x, v, alpha, sigma_vp)
                # finite even at alpha_bar = 0 (a zero-terminal-SNR schedule's
                # trailing first step), where the eps-derived x0 is 0 * inf
                x0_v = sched_lib.x0_from_v(x, v, alpha, sigma_vp)
            if sampler == "ddim":
                step_noise = draw(i, x.shape, x) if self.eta > 0.0 and t_prev >= 0 else None
                x, x0 = sched_lib.ddim_step(schedule, eps, x, t, t_prev, self.eta, noise=step_noise, x0=x0_v)
            elif sampler == "dpmpp":
                x, x0 = sched_lib.dpmpp_2m_step(schedule, eps, x, t, t_prev, x0_prev, t_last, x0=x0_v)
            else:
                step_noise = draw(i, noise_shape, x) if t > 0 else None
                x, x0 = sched_lib.ddpm_step(schedule, eps, x, t, step_noise, repeat_noise=self.repeat_noise,
                                            scale_factor=self.scale_factor, x0=x0_v)
            if self.inpaint:  # the kept region at the level just reached; the clean init at the end
                if t_prev >= 0:  # q(x_t_prev | init), its coefficients on the device already
                    known = coefs[i, 0] * init_latents + coefs[i, 1] * draw_blend(i, x.shape, x)
                else:
                    known = init_latents
                x = mask * x + (1.0 - mask) * known
            x0_prev = x0
        return x


class _SigmaLoop(SampleLoop):
    """The sigma-space reverse loop. ``x_T`` keeps the discrete samplers'
    convention, the VP latent at the first timestep, and enters sigma space as
    ``x_T * sqrt(1 + sigma_0^2)`` (1/sqrt(abar) = sqrt(1 + sigma^2)); the
    terminal sigma is 0, where sigma space is VP space again. The UNet sees
    fractional timesteps (float32 ``t_batch``); euler_a and dpmpp_sde take eta
    1 when it is 0; heun's last step (sigma_next = 0) is first order. Every
    sigma, timestep and coefficient is computed on the host before the loop."""

    def __init__(self, unet, schedule, num_steps, sampler, guidance_scale, reference_cfg_formula, guidance_rescale,
                 inpaint, *, eta, strength, karras, prediction_type, timestep_spacing):
        super().__init__(unet, schedule, sampler, guidance_scale, reference_cfg_formula, guidance_rescale, inpaint)
        self.prediction_type = prediction_type
        if timestep_spacing == "trailing":
            ts = sched_lib.trailing_timesteps(schedule.noise_steps, num_steps)
        else:
            ts = sched_lib.spaced_timesteps(schedule.noise_steps, num_steps)
        ts = _truncate(ts, num_steps, strength)
        tab = sched_lib.vp_sigmas(schedule)
        if karras:
            sigmas = sched_lib.karras_sigmas(tab[ts[-1]], tab[ts[0]], len(ts))
        else:
            sigmas = tab[torch.tensor(ts)]
        self.sigmas = torch.cat([sigmas, torch.zeros(1)])
        self.eff_eta = eta if eta > 0.0 else 1.0

        def at(sigma: torch.Tensor):
            """(sigma, t(sigma) as a float, c_in = 1/sqrt(1 + sigma^2)) for one UNet call."""
            return sigma, float(sched_lib.t_from_sigma(schedule, sigma)), 1.0 / torch.sqrt(1.0 + sigma ** 2)

        self.plan = []
        for i, (sigma, sigma_next) in enumerate(zip(self.sigmas[:-1], self.sigmas[1:])):
            step = {"sigma": sigma, "sigma_next": sigma_next, "call": at(sigma)}
            if sampler == "euler_a":
                step["down"], step["up"] = sched_lib.ancestral_sigmas(sigma, sigma_next, self.eff_eta)
            if sampler == "heun" and sigma_next > 0.0:
                step["call2"] = at(torch.clamp(sigma_next, min=1e-8))
            self.plan.append(step)
            if (sampler == "euler_a" and step["up"] > 0.0) or (sampler == "dpmpp_sde" and sigma_next > 0.0):
                self.draw_order.append((i, "step"))
            if inpaint and sigma_next > 0.0:
                self.draw_order.append((i, "blend"))
        self.start_timestep = ts[0]

    def _loop(self, x_T, context_emb, uncond_emb, draw, draw_blend, mask, init_latents, denoiser):
        sampler, sigmas = self.sampler, self.sigmas
        pred_noise = self._pred_noise(denoiser)
        dtype, bsz = x_T.dtype, x_T.shape[0]

        def eval_eps(x_k, call):
            """One denoiser call: sigma-space x -> eps of the VP-space model."""
            sigma, t, c_in = call
            x_vp = x_k * c_in.to(dtype)
            out = pred_noise(x_vp, torch.full((bsz,), t, dtype=torch.float32, device=x_k.device),
                             context_emb, uncond_emb)
            if self.prediction_type == "v_prediction":  # at sigma: alpha = c_in, sigma_vp = sigma * alpha
                out = sched_lib.eps_from_v(x_vp, out, c_in, sigma * c_in)
            return out

        x = x_T * torch.sqrt(1.0 + sigmas[0] ** 2).to(dtype)
        d_prev, h_last = torch.zeros_like(x), torch.tensor(0.0)
        for i, step in enumerate(self.plan):
            sigma, sigma_next = step["sigma"], step["sigma_next"]
            eps = eval_eps(x, step["call"])
            if sampler == "euler":
                x = sched_lib.euler_step(x, eps, sigma, sigma_next)
            elif sampler == "euler_a":
                x_next = sched_lib.euler_step(x, eps, sigma, step["down"])
                if step["up"] > 0.0:
                    x_next = x_next + step["up"].to(dtype) * draw(i, x.shape, x)
                x = x_next
            elif sampler == "heun":
                x_e = sched_lib.euler_step(x, eps, sigma, sigma_next)
                if "call2" in step:  # second order, except on the last step
                    eps2 = eval_eps(x_e, step["call2"])
                    x_e = sched_lib.euler_step(x, 0.5 * (eps + eps2), sigma, sigma_next)
                x = x_e
            else:  # dpmpp_sde
                denoised = x - sigma.to(dtype) * eps
                step_noise = draw(i, x.shape, x) if sigma_next > 0.0 else None
                x, h_last = sched_lib.dpmpp_2m_sde_step(x, denoised, d_prev, sigma, sigma_next, h_last,
                                                        step_noise, self.eff_eta)
                d_prev = denoised
            if self.inpaint:  # the kept region at sigma_next: init + sigma_next * n
                known = init_latents
                if sigma_next > 0.0:
                    known = init_latents + sigma_next.to(dtype) * draw_blend(i, x.shape, x)
                x = mask * x + (1.0 - mask) * known
        return x


def make_sample_fn(
    unet,
    schedule: DiffusionSchedule,
    num_steps: int,
    sampler: str = "ddim",
    guidance_scale: float = 7.5,
    eta: float = 0.0,
    repeat_noise: bool = False,
    scale_factor: float = 1.0,
    reference_cfg_formula: bool = False,
    ascending_loop: bool = False,
    leading_timesteps: bool = False,
    strength: float = 1.0,
    inpaint: bool = False,
    karras: bool = False,
    prediction_type: str = "epsilon",
    timestep_spacing: str = "even",
    guidance_rescale: float = 0.0,
    deep_cache_interval: int = 0,
) -> SampleLoop:
    """Reverse loop ``f(x_T, context_emb, uncond_emb, generator=None, noise=None,
    mask=None, init_latents=None, blend_noise=None) -> x_0``, a
    :class:`SampleLoop` (its ``body`` is what a CUDA graph captures).

    Discrete ``ddim``/``ddpm``/``dpmpp`` step the trained grid; sigma-space
    ``euler``/``euler_a``/``heun``/``dpmpp_sde`` integrate the probability-flow
    ODE/SDE (:class:`_SigmaLoop`). DDIM/DDPM/DPM++ take the evenly
    spaced descending subsequence (``trailing``: from T-1), ``leading_timesteps``
    the reference's raw steps S-1..0, and ``ascending_loop`` its reversed
    order. ``strength < 1`` runs only the final ``round(num_steps * strength)``
    steps; the caller q-samples its latents to the first of them, exposed as
    ``.start_timestep``. Stochastic steps draw float32 noise on the CPU from
    ``generator``, or take step i's from ``noise[i]``.

    ``inpaint``: ``mask`` [B, h, w, 1] is 1 where the loop generates and 0
    where it keeps ``init_latents``; after each step the kept region is
    re-noised to the step's target (its noise drawn as the step noise is, or
    ``blend_noise[i]``) and blended in; at the clean endpoint it is the init
    itself. ``deep_cache_interval = N > 1``: DeepCache (Ma et al. 2023), the
    full UNet on steps 0, N, 2N, ... (decided on the host) and only its
    level-0 blocks against the cached trunk in between; the CFG-doubled batch
    is cached whole. The ``ValueError``s are the JAX package's."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    if prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    if timestep_spacing not in ("even", "trailing"):
        raise ValueError(f"unknown timestep_spacing {timestep_spacing!r}")
    # a zero-terminal-SNR schedule has sigma = inf at its terminal step, and
    # eps-prediction cannot recover x0 there (divide by sqrt(alpha_bar) = 0)
    terminal_zero = bool(schedule.alphas_cumprod[-1] <= 0.0)
    if terminal_zero and sampler in SIGMA_SPACE_SAMPLERS:
        raise ValueError(
            "zero-terminal-SNR schedules have sigma=inf at the terminal step; "
            "use a discrete sampler (ddim/ddpm/dpmpp)"
        )
    if terminal_zero and timestep_spacing == "trailing" and prediction_type == "epsilon":
        raise ValueError(
            "trailing spacing on a zero-terminal-SNR schedule starts at "
            "SNR 0, where eps-prediction is undefined; train and sample with "
            "--prediction-type v_prediction"
        )
    if deep_cache_interval > 1:
        if sampler in SIGMA_SPACE_SAMPLERS:
            raise ValueError("deep_cache_interval supports the discrete samplers (ddim/ddpm/dpmpp) only")
        if not hasattr(unet, "channels_list"):
            raise ValueError("deep_cache_interval needs a plain UNetModel (incompatible with the ControlNet shim)")
        if len(unet.channels_list) < 2:
            raise ValueError("deep_cache_interval needs a >=2-level UNet")
    common = (unet, schedule, num_steps, sampler, guidance_scale, reference_cfg_formula, guidance_rescale, inpaint)
    if sampler in SIGMA_SPACE_SAMPLERS:
        return _SigmaLoop(*common, eta=eta, strength=strength, karras=karras, prediction_type=prediction_type,
                          timestep_spacing=timestep_spacing)
    return _DiscreteLoop(*common, eta=eta, repeat_noise=repeat_noise, scale_factor=scale_factor,
                         ascending_loop=ascending_loop, leading_timesteps=leading_timesteps, strength=strength,
                         prediction_type=prediction_type, timestep_spacing=timestep_spacing,
                         deep_cache_interval=deep_cache_interval)


class CachedLoop:
    """One signature's entry of :class:`LatentDiffusion`'s loop cache: its
    :class:`SampleLoop` and, on the graph route, its CUDA graph
    (``utils/graphs.py:CapturedGraph``).

    A call draws every draw of the loop from ``generator`` first
    (:meth:`SampleLoop.predraw`, the eager loop's order) and moves them to
    the device in one copy. The route is fixed when the model is built: the
    graph route on a CUDA device, the eager one on the CPU or where the
    model was built with ``capture=False`` (``models/build.py:
    sampling_model``). On the eager route a call runs the body. On the
    graph route the signature's first call runs the body eagerly on a side
    stream (the warm-up), returns that result, and captures the body into
    the model's one graph pool (``utils/graphs.py:GraphPool``); each later call copies its inputs into the
    graph's static ones, replays, and clones the output out at once. The
    graphs of one model share their pool and their side stream (the
    allocator reuses a freed block only on its own stream): a capture reuses
    the temporaries of the captures before it, so the pool grows to the
    largest loop's temporaries plus one output per graph, not to their sum.
    That is safe because their replays never overlap (one thread drives a
    model), their inputs live outside the pool and each output is cloned
    before another graph replays. The capture runs with
    ``capture_error_mode="thread_local"``: another thread's CUDA call (the
    server's handler threads make none) cannot break it. A failed capture
    raises, naming the signature, and leaves the process usable; the pool
    it failed in takes no further capture, so the model's next capture
    starts a new pool (the graphs already captured keep theirs). A call
    whose inputs differ from the captured ones, or after a parameter's
    storage moved, raises: nothing runs the eager loop in the graph's
    place. The cache is not bounded, as JAX's is not: besides the shared
    pool, each entry keeps its static inputs (the pre-drawn noise among
    them) and its output."""

    def __init__(self, model: "LatentDiffusion", loop: SampleLoop, key: tuple):
        self.model = model
        self.loop = loop
        self.key = key
        self.graph = None

    @property
    def start_timestep(self) -> int:
        return self.loop.start_timestep

    def describe(self) -> str:
        steps, options, x_shape, x_dtype, device, ctx_shape, _, hints = self.key
        return (f"the sampling loop (steps {steps}, {dict(options)}, x_T {list(x_shape)} {x_dtype} on {device}, "
                f"context {list(ctx_shape)}, hints {hints and [list(s) for s in hints[0]]})")

    def __call__(self, x_T, context_emb, uncond_emb, generator: Optional[torch.Generator] = None, mask=None,
                 init_latents=None, hints=None) -> torch.Tensor:
        """``hints``: the pixel-space ControlNet hints, as ``sample`` takes them."""
        model = self.model
        draws = self.loop.predraw(generator, x_T.shape).to(device=x_T.device, dtype=x_T.dtype)
        inputs = {"x_T": x_T, "context": context_emb, "uncond": uncond_emb, "draws": draws, "mask": mask,
                  "init": init_latents, "hints": model.hint_tensors(hints)}
        if x_T.device.type != "cuda" or not model.capture:
            return self._body(inputs)
        if self.graph is None:
            self.graph = model._graphs.capture(self._body, inputs, what=self.describe(), pinned=model.graph_tensors)
            first, self.graph.first = self.graph.first, None
            return first
        return self.graph.replay(inputs).clone()

    def _body(self, inputs) -> torch.Tensor:
        return self.loop.body(inputs["x_T"], inputs["context"], inputs["uncond"], inputs["draws"],
                              mask=inputs["mask"], init_latents=inputs["init"], hints=inputs["hints"])


class LatentDiffusion:
    """Modules + schedule with the JAX package's method surface."""

    def __init__(self, unet, autoencoder, text_encoder, schedule: DiffusionSchedule, compat=None,
                 compute_dtype: Optional[torch.dtype] = None, capture: bool = True):
        """``capture``: on a CUDA device, capture each sampling signature's
        loop at its first call and replay it after (:class:`CachedLoop`);
        False runs the eager loop on every device."""
        self.unet = unet
        self.autoencoder = autoencoder
        self.text_encoder = text_encoder
        self.noise_scheduler = schedule
        self.compat = compat
        self._compute_dtype = compute_dtype
        self.controlnet: Optional[list] = None  # set by attach_controlnet
        # the loop cache (JAX's ``_jit_cache``): one CachedLoop per signature,
        # and the one memory pool and side stream its CUDA graphs share
        self._capture = bool(capture)
        self._loops: dict = {}
        self._graphs = GraphPool()

    @property
    def capture(self) -> bool:
        """Whether loops are captured on a CUDA device (fixed at build)."""
        return self._capture

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (a training build keeps f32 UNet parameters)."""
        return self._compute_dtype or self.unet.conv_in.weight.dtype

    def attach_controlnet(self, controlnet) -> None:
        """Register one ControlNet (``models/controlnet.py``) or a list of them,
        whose residuals sum; ``sample(control_hint=...)`` then steers through them."""
        self.controlnet = list(controlnet) if isinstance(controlnet, (list, tuple)) else [controlnet]
        self.clear_loop_cache()

    def clear_loop_cache(self) -> None:
        """Drop every cached loop and its graph (``attach_controlnet`` does,
        as the JAX package's clears its ``_jit_cache``)."""
        self._loops.clear()

    def graph_tensors(self) -> list:
        """What a captured loop reads in place: the UNet's and the attached
        ControlNets' parameters and buffers (their pointers must not move
        between replays; a weight load copies in place and keeps them)."""
        modules = [m for m in [self.unet, *(self.controlnet or [])] if isinstance(m, torch.nn.Module)]
        return [t for m in modules for t in (*m.parameters(), *m.buffers())]

    def sample_loop(self, x_like: torch.Tensor, context_emb: torch.Tensor, time_steps: int, control_hint=None,
                    control_scale=1.0, **options) -> "CachedLoop":
        """The cached loop of a signature, made at its first use: ``options``
        are :func:`make_sample_fn`'s keywords, ``x_like`` a tensor of x_T's
        shape, dtype and device (the init latents, for img2img). The key holds
        every field of the JAX package's (steps, sampler, guidance, eta,
        repeat_noise, scale_factor, karras, the prediction type, the spacing,
        the rescale, the shapes of x_T and the context, the hints' shapes and
        scales, the DeepCache interval) and what the port fixes besides: the
        dtypes, the device, strength, inpaint, the compat flags and the
        attached nets."""
        denoiser = self.denoiser(control_hint, control_scale)  # raises on hints without nets
        key = (int(time_steps), tuple(sorted(options.items())), tuple(x_like.shape), x_like.dtype,
               str(x_like.device), tuple(context_emb.shape), context_emb.dtype,
               None if control_hint is None else (tuple(tuple(h.shape) for h in denoiser.hints),
                                                  tuple(denoiser.scales), tuple(id(n) for n in self.controlnet)))
        if key not in self._loops:
            fn = make_sample_fn(denoiser, self.noise_scheduler, time_steps, **options)
            self._loops[key] = CachedLoop(self, fn, key)
        return self._loops[key]

    def hint_tensors(self, control_hint) -> Optional[list]:
        """``control_hint`` (one tensor, or one per attached net) as a list in
        the compute dtype on the UNet's device; None without hints."""
        if control_hint is None:
            return None
        hints = list(control_hint) if isinstance(control_hint, (list, tuple)) else [control_hint]
        return [torch.as_tensor(h).to(device=self.device, dtype=self.dtype) for h in hints]

    def denoiser(self, control_hint=None, control_scale=1.0):
        """What the loops call: the UNet, or with ``control_hint`` (one
        [B, H, W, C] hint per attached net, or one tensor for one net) the
        UNet with the nets' residuals; ``control_scale`` one float for all or
        one per net."""
        if control_hint is None:
            return self.unet
        if self.controlnet is None:
            raise ValueError("call attach_controlnet(...) before sampling with control_hint")
        hints = list(control_hint) if isinstance(control_hint, (list, tuple)) else [control_hint]
        if len(hints) != len(self.controlnet):
            raise ValueError(f"{len(hints)} hint(s) for {len(self.controlnet)} attached ControlNet(s)")
        scales = (list(control_scale) if isinstance(control_scale, (list, tuple))
                  else [control_scale] * len(hints))
        return _ControlShim(self.unet, self.controlnet, scales, self.hint_tensors(hints))

    def encode_prompts(self, prompts: Sequence[str], weighted: Optional[bool] = None) -> torch.Tensor:
        """[B] prompts -> [B, K*77, 768]. ``weighted=None`` detects
        ``(word:1.3)`` emphasis (``prompt_weighting.py``); prompts past 75
        tokens are encoded in K chunks of 77. Both are off in reference-compat
        mode, where brackets stay literal and long prompts are truncated. The
        text tower is captured per signature on a CUDA device unless the model
        was built with ``capture=False`` (``CLIPModel.encode_text``)."""
        prompts = list(prompts)
        compat_mode = self.compat is not None and self.compat.reference_compat
        if weighted is None:
            weighted = not compat_mode and any(has_weight_syntax(p) for p in prompts)
        te, capture = self.text_encoder, self.capture
        if not compat_mode:
            ids, w, k = te.tokenize_chunked(prompts, weighted=weighted)
            if k > 1:
                return te.encode_text_chunked(ids, w, capture=capture)
        if weighted:
            out, w = te.tokenize_weighted(prompts)
            return te.encode_text(out.input_ids, token_weights=w, capture=capture)
        return te.encode_text(te.tokenize(prompts).input_ids, capture=capture)

    def encode_uncond(self, batch_size: int, text: str = "") -> torch.Tensor:
        """The unconditional (or negative-prompt) embedding, weighted and
        chunked as a prompt is, broadcast to the batch."""
        emb = self.encode_prompts([text])
        return emb.expand((batch_size,) + emb.shape[1:])

    @staticmethod
    def align_uncond(uncond: torch.Tensor, context_emb: torch.Tensor) -> torch.Tensor:
        """Tile-and-truncate the uncond sequence to the cond sequence length."""
        if uncond.shape[1] == context_emb.shape[1]:
            return uncond
        s = context_emb.shape[1]
        reps = -(-s // uncond.shape[1])
        return uncond.repeat(1, reps, 1)[:, :s, :]

    @torch.no_grad()
    def encode_image(self, img: torch.Tensor) -> GaussianDistribution:
        """[B, H, W, 3] in [-1, 1] -> the VAE posterior over the latents."""
        return self.autoencoder.encode(img.to(device=self.device))

    @torch.no_grad()
    def sample(
        self,
        noised_sample: torch.Tensor,
        context_emb: torch.Tensor,
        guidance_scale: float = 7.5,
        repeat_noise: bool = False,
        scale_factor: float = 1.0,
        time_steps: Optional[int] = None,
        sampler: str = "ddpm",
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
        negative_prompt: str = "",
        karras: bool = False,
        prediction_type: str = "epsilon",
        timestep_spacing: str = "even",
        guidance_rescale: float = 0.0,
        control_hint=None,
        control_scale=1.0,
        deep_cache_interval: int = 0,
    ) -> torch.Tensor:
        """Reverse loop x_T -> x_0 on the UNet's device. The default sampler is
        DDPM over the full schedule, as the reference's and the JAX package's;
        any of ``SAMPLERS`` may be named. Stochastic samplers draw from
        ``generator`` (seed 0 when None, as the JAX package's key).
        ``control_hint`` (one pixel-space [B, H, W, C] hint in [-1, 1] per
        attached ControlNet) steers every UNet call through them;
        ``deep_cache_interval > 1`` enables DeepCache. The loop is the
        signature's entry of the loop cache (:meth:`sample_loop`): on a CUDA
        device captured at its first call and replayed after it."""
        compat = self.compat
        loop = self.sample_loop(
            noised_sample, context_emb, time_steps or self.noise_scheduler.noise_steps, control_hint, control_scale,
            sampler=sampler, guidance_scale=guidance_scale, eta=eta, repeat_noise=repeat_noise,
            scale_factor=scale_factor, karras=karras, prediction_type=prediction_type,
            timestep_spacing=timestep_spacing, guidance_rescale=guidance_rescale,
            reference_cfg_formula=bool(compat and compat.cfg_formula),
            ascending_loop=bool(compat and compat.ascending_sample_loop),
            # the reference's few-step quirk applies only when a step count is given
            leading_timesteps=bool(compat and compat.ascending_sample_loop and time_steps),
            deep_cache_interval=deep_cache_interval,
        )
        uncond = self.uncond_for(context_emb, guidance_scale, negative_prompt)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return loop(noised_sample, context_emb, uncond, generator, hints=control_hint)

    def uncond_for(self, context_emb: torch.Tensor, guidance_scale: float, negative_prompt: str = "") -> torch.Tensor:
        """The CFG branch's embedding for ``context_emb``: the negative prompt's,
        aligned to its length (zeros without guidance)."""
        if guidance_scale <= 1.0:
            return torch.zeros_like(context_emb)
        uncond = self.encode_uncond(context_emb.shape[0], negative_prompt)
        return self.align_uncond(uncond.to(context_emb.dtype), context_emb)

    @torch.no_grad()
    def decode_latent(self, latent: torch.Tensor, tile: Optional[int] = None,
                      tile_overlap: int = 8) -> torch.Tensor:
        """VAE decode; ``tile`` (a latent-space tile side) decodes overlapping
        tiles one by one and blends them with linear ramps on interior edges,
        bounding the decoder's activations by the tile instead of the image.
        Per-tile GroupNorm statistics make it an approximation of the whole
        decode, as in the JAX package (``decode_latent``), whose tiling this is."""
        h, w = latent.shape[1:3]
        if tile is None or (h <= tile and w <= tile):
            return self.autoencoder.decode(latent)
        if tile <= 2 * tile_overlap:
            raise ValueError(f"tile {tile} must exceed twice the overlap {tile_overlap}")
        f = self.autoencoder.downsample_factor
        stride = tile - tile_overlap
        r = tile_overlap * f
        edge = (torch.arange(r, dtype=torch.float32, device=latent.device) + 1.0) / (r + 1.0)

        def ramp(n_pix: int, lo_open: bool, hi_open: bool) -> torch.Tensor:
            wgt = torch.ones(n_pix, dtype=torch.float32, device=latent.device)
            if lo_open:
                wgt[:r] = edge
            if hi_open:
                wgt[-r:] = edge.flip(0)
            return wgt

        out = acc = None
        for r0 in range(0, max(h - tile_overlap, 1), stride):
            r1 = min(r0 + tile, h)
            r0 = max(r1 - tile, 0)  # a full-size tile even at the edge
            for c0 in range(0, max(w - tile_overlap, 1), stride):
                c1 = min(c0 + tile, w)
                c0 = max(c1 - tile, 0)
                dec = self.autoencoder.decode(latent[:, r0:r1, c0:c1, :]).float()
                if out is None:
                    out = dec.new_zeros((latent.shape[0], h * f, w * f, dec.shape[-1]))
                    acc = dec.new_zeros((1, h * f, w * f, 1))
                wgt = (ramp((r1 - r0) * f, r0 > 0, r1 < h)[:, None]
                       * ramp((c1 - c0) * f, c0 > 0, c1 < w)[None, :])[None, :, :, None]
                out[:, r0 * f:r1 * f, c0 * f:c1 * f, :] += dec * wgt
                acc[:, r0 * f:r1 * f, c0 * f:c1 * f, :] += wgt
        return (out / acc.clamp(min=1e-8)).to(latent.dtype)

    def latent_shape(self, batch: int, image_size: int) -> Tuple[int, int, int, int]:
        f = self.autoencoder.downsample_factor
        return (batch, image_size // f, image_size // f, self.autoencoder.latent_channels)
