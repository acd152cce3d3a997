"""LatentDiffusion: UNet + VAE + CLIP + schedule (port of models/latent_diffusion.py).

The JAX package runs the reverse loop as one ``lax.scan``; here it is a Python
loop that runs the UNet once per step on the CFG-doubled batch [uncond, cond].
Only the DDIM sampler is ported, with ``strength`` (the hires fix's partial
schedule) and tiled VAE decode; ddpm, dpmpp and the sigma-space samplers,
ControlNet, DeepCache, prompt weighting and long prompts wait for later work.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from stable_diffusion_pytorch_tpu_torch.models import schedule as sched_lib
from stable_diffusion_pytorch_tpu_torch.models.schedule import DiffusionSchedule

SAMPLERS = ("ddim",)


def cfg_combine(
    eps_uncond: torch.Tensor, eps_cond: torch.Tensor, guidance_scale: float,
    reference_formula: bool = False,
) -> torch.Tensor:
    """``uncond + g * (cond - uncond)``; the reference's swapped formula
    ``uncond + g * (uncond - cond)`` when ``reference_formula``."""
    if reference_formula:
        return eps_uncond + guidance_scale * (eps_uncond - eps_cond)
    return eps_uncond + guidance_scale * (eps_cond - eps_uncond)


def make_pred_noise_fn(unet, guidance_scale: float = 1.0, reference_cfg_formula: bool = False):
    """``f(x_t [B,h,w,c], t [B], context [B,S,D], uncond [B,S,D] | None) -> eps``.
    With guidance > 1 the UNet runs once on the doubled batch [uncond, cond]."""
    do_cfg = guidance_scale > 1.0

    def pred_noise(x_t, t, context_emb, uncond_emb=None):
        if not do_cfg:
            return unet(x_t, t, context_emb)
        if uncond_emb is None:
            raise ValueError("CFG requires the uncond embedding")
        eps = unet(
            torch.cat([x_t, x_t]), torch.cat([t, t]), torch.cat([uncond_emb, context_emb])
        )
        eps_uncond, eps_cond = eps.chunk(2)
        return cfg_combine(eps_uncond, eps_cond, guidance_scale, reference_cfg_formula)

    return pred_noise


def make_sample_fn(
    unet,
    schedule: DiffusionSchedule,
    num_steps: int,
    sampler: str = "ddim",
    guidance_scale: float = 7.5,
    eta: float = 0.0,
    reference_cfg_formula: bool = False,
    strength: float = 1.0,
) -> Callable:
    """Reverse loop ``f(x_T, context_emb, uncond_emb, generator=None) -> x_0``.

    ``strength < 1`` runs only the final ``round(num_steps * strength)`` steps
    (at least one) of the subsequence; the caller q-samples its latents to the
    first of them, exposed as ``.start_timestep`` (the JAX package's rule,
    Python's ``round``, halves to even)."""
    if sampler not in SAMPLERS:
        raise NotImplementedError(f"sampler {sampler!r} is not ported yet (have {SAMPLERS})")
    if num_steps == schedule.noise_steps:
        ts = sched_lib.leading_timesteps(num_steps)
    else:
        ts = sched_lib.spaced_timesteps(schedule.noise_steps, num_steps)
    if strength < 1.0:
        keep = max(min(round(num_steps * strength), num_steps), 1)
        ts = ts[num_steps - keep:]
    ts_prev = ts[1:] + [-1]
    pred_noise = make_pred_noise_fn(unet, guidance_scale, reference_cfg_formula)

    def sample(x_T, context_emb, uncond_emb, generator: Optional[torch.Generator] = None):
        x = x_T
        bsz = x.shape[0]
        for t, t_prev in zip(ts, ts_prev):
            t_batch = torch.full((bsz,), t, dtype=torch.int32, device=x.device)
            eps = pred_noise(x, t_batch, context_emb, uncond_emb)
            x, _ = sched_lib.ddim_step(schedule, eps, x, t, t_prev, eta, generator)
        return x

    sample.start_timestep = ts[0]
    return sample


class LatentDiffusion:
    """Modules + schedule with the JAX package's method surface."""

    def __init__(self, unet, autoencoder, text_encoder, schedule: DiffusionSchedule, compat=None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.unet = unet
        self.autoencoder = autoencoder
        self.text_encoder = text_encoder
        self.noise_scheduler = schedule
        self.compat = compat
        self._compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (a training build keeps f32 UNet parameters)."""
        return self._compute_dtype or self.unet.conv_in.weight.dtype

    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        """[B] prompts -> [B, 77, 768]; prompts past 75 tokens are truncated
        (the JAX package's long-prompt chunking is not ported yet)."""
        te = self.text_encoder
        return te.encode_text(te.tokenize(list(prompts)).input_ids)

    def encode_uncond(self, batch_size: int, text: str = "") -> torch.Tensor:
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
    def sample(
        self,
        noised_sample: torch.Tensor,
        context_emb: torch.Tensor,
        guidance_scale: float = 7.5,
        time_steps: Optional[int] = None,
        sampler: str = "ddim",
        eta: float = 0.0,
        generator: Optional[torch.Generator] = None,
        negative_prompt: str = "",
    ) -> torch.Tensor:
        """Reverse loop x_T -> x_0 on the UNet's device."""
        num_steps = time_steps or self.noise_scheduler.noise_steps
        fn = make_sample_fn(
            self.unet, self.noise_scheduler, num_steps, sampler=sampler,
            guidance_scale=guidance_scale, eta=eta,
            reference_cfg_formula=bool(self.compat and self.compat.cfg_formula),
        )
        if guidance_scale > 1.0:
            uncond = self.encode_uncond(noised_sample.shape[0], negative_prompt)
        else:
            uncond = torch.zeros_like(context_emb)
        uncond = self.align_uncond(uncond.to(context_emb.dtype), context_emb)
        return fn(noised_sample, context_emb, uncond, generator)

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
