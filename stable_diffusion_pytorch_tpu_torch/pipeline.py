"""Text-to-image sampling (port of stable_diffusion_pytorch_tpu/pipeline.py:sample).

``sample``: tokenize and CLIP-encode the prompts and the uncond prompt, draw
the init noise from a seeded ``torch.Generator``, run DDIM with classifier-free
guidance (the UNet runs once per step on the doubled batch), optionally the
two-stage hires fix (:func:`hires_refine`), VAE-decode (whole or tiled) and
write PNGs. ControlNet, DeepCache, img2img and inpainting are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig
from stable_diffusion_pytorch_tpu_torch.models import schedule as sched_lib
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import SAMPLERS, LatentDiffusion, make_sample_fn
from stable_diffusion_pytorch_tpu_torch.utils.data import detransform, to_img


@dataclass
class SamplingConfig(BaseConfig):
    """The txt2img flags of the JAX package's ``SamplingConfig`` that the port
    serves (same names and defaults; ``--sampler`` lists the ported samplers)."""

    prompt: str = field(default="a cat", metadata={"help": "text prompt to sample."})
    negative_prompt: str = field(
        default="",
        metadata={"help": "negative prompt used as the CFG unconditional branch."},
    )
    image_size: int = field(default=64, metadata={"help": "output image resolution."})
    sampling_steps: int = field(default=50, metadata={"help": "number of denoising steps."})
    sampler: str = field(
        default="ddim",
        metadata={"help": "sampling algorithm.", "choices": list(SAMPLERS)},
    )
    eta: float = field(
        default=0.0,
        metadata={"help": "DDIM eta (0 = deterministic)."},
    )
    num_images: int = field(default=1, metadata={"help": "batch of images to sample."})
    output_dir: str = field(default="output", metadata={"help": "directory for saved PNGs."})
    output_name: str = field(default="txt2img", metadata={"help": "basename for saved PNGs."})
    hires_scale: float = field(
        default=0.0,
        metadata={
            "help": "hires fix: sample at --image-size, latent-upscale by "
            "this factor (e.g. 2), then img2img-refine at high resolution "
            "(> 1 enables)."
        },
    )
    hires_strength: float = field(
        default=0.6,
        metadata={
            "help": "fraction of the schedule re-run at high resolution in "
            "the hires fix."
        },
    )
    vae_tile: int = field(
        default=0,
        metadata={
            "help": "tiled VAE decode: latent-space tile side (e.g. 64) for "
            "large images; 0 = decode whole (bounds decoder activations, "
            "pairs with --hires-scale)."
        },
    )


def upscale_latent(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear resize of a [B, h, w, c] latent to (round(h*scale), round(w*scale)),
    computed in float32 and cast back: ``jax.image.resize(..., "bilinear")``
    when upsampling. The size is passed, not the factor, so the sampling grid
    is out/in of the sizes, as JAX's, also where round(h*scale) is not exact."""
    b, h, w, c = x.shape
    size = (int(round(h * scale)), int(round(w * scale)))
    up = F.interpolate(x.float().permute(0, 3, 1, 2), size=size, mode="bilinear",
                       align_corners=False, antialias=False)
    return up.permute(0, 2, 3, 1).contiguous().to(x.dtype)


@torch.no_grad()
def hires_refine(
    model: LatentDiffusion, x0: torch.Tensor, context_emb: torch.Tensor, *, guidance_scale: float,
    sampler: str, time_steps: int, hires_scale: float, hires_strength: float, negative_prompt: str = "",
    eta: float = 0.0, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stage 2 of the hires fix (the JAX package's ``_hires_refine``): upscale
    the latent, q-sample it to the first step of the final ``hires_strength``
    fraction of the schedule, and denoise that fraction at high resolution.

    The noise is ``noise`` when given, else drawn in float32 on the CPU from
    ``generator`` (the one :func:`sample` seeded), so a seed gives the same
    image on every device; it does not reproduce JAX's ``fold_in`` stream."""
    dtype = model.dtype
    x_up = upscale_latent(x0, hires_scale).to(dtype)
    fn = make_sample_fn(model.unet, model.noise_scheduler, time_steps, sampler=sampler,
                        guidance_scale=guidance_scale, eta=eta, strength=hires_strength)
    if noise is None:
        noise = torch.randn(x_up.shape, generator=generator, dtype=torch.float32)
    noise = noise.to(device=x_up.device, dtype=dtype)
    b = x_up.shape[0]
    t0 = torch.full((b,), fn.start_timestep, dtype=torch.int32, device=x_up.device)
    x_t = sched_lib.add_noise(model.noise_scheduler, x_up, noise, t0)
    if guidance_scale > 1.0:
        uncond = model.align_uncond(model.encode_uncond(b, negative_prompt).to(dtype), context_emb)
    else:
        uncond = torch.zeros_like(context_emb)
    return fn(x_t, context_emb, uncond, generator)


def sample(
    model: LatentDiffusion,
    image_size: int = 64,
    prompt: Union[str, Sequence[str]] = "",
    time_steps: int = 50,
    guidance_scale: float = 7.5,
    save_dir: Optional[str] = "output",
    sampler: str = "ddim",
    eta: float = 0.0,
    num_images: int = 1,
    seed: int = 42,
    name: str = "txt2img",
    negative_prompt: str = "",
    hires_scale: float = 0.0,
    hires_strength: float = 0.6,
    vae_tile: int = 0,
) -> List[np.ndarray]:
    """Sample images; returns HWC uint8 arrays and writes PNGs to ``save_dir``.

    ``prompt`` may be a list (then ``num_images = len(prompt)``). The init
    noise [B, h, w, 4] is drawn in float32 on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to the model's device, so
    a seed gives the same noise on every device.

    ``hires_scale > 1`` enables the two-stage hires fix: sample at
    ``image_size``, upscale the latent by the factor, then refine the final
    ``hires_strength`` fraction of the schedule at high resolution (ddim for a
    sampler other than ddim/ddpm/dpmpp, as in the JAX package).
    ``vae_tile > 0`` decodes in latent tiles of that side."""
    if isinstance(prompt, (list, tuple)):
        prompts = list(prompt)
        num_images = len(prompts)
    else:
        prompts = [prompt] * num_images

    generator = torch.Generator().manual_seed(int(seed))
    shape = model.latent_shape(num_images, image_size)
    noise = torch.randn(shape, generator=generator, dtype=torch.float32)
    noise = noise.to(device=model.device, dtype=model.dtype)

    context_emb = model.encode_prompts(prompts).to(model.dtype)
    x_0 = model.sample(
        noise, context_emb, guidance_scale=guidance_scale, time_steps=time_steps,
        sampler=sampler, eta=eta, generator=generator, negative_prompt=negative_prompt,
    )
    if hires_scale > 1.0:
        x_0 = hires_refine(
            model, x_0, context_emb, guidance_scale=guidance_scale,
            sampler=sampler if sampler in ("ddim", "ddpm", "dpmpp") else "ddim",
            time_steps=time_steps, hires_scale=hires_scale, hires_strength=hires_strength,
            negative_prompt=negative_prompt, eta=eta, generator=generator,
        )
    images = model.decode_latent(x_0, tile=vae_tile or None).float().cpu().numpy()

    outputs = []
    for i in range(num_images):
        digit = detransform(images[i])
        outputs.append(digit)
        if save_dir is not None:
            stem, ext = (name[:-4], name[-4:]) if name.lower().endswith(".png") else (name, "")
            suffix = f"_{i}" if num_images > 1 else ""
            to_img(digit, output_path=save_dir, name=f"{stem}{suffix}{ext}")
    return outputs
