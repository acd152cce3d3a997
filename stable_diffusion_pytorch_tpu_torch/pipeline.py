"""Sampling pipelines (port of stable_diffusion_pytorch_tpu/pipeline.py).

``sample``: tokenize and CLIP-encode the prompts and the uncond prompt
(weighted and chunked as ``LatentDiffusion.encode_prompts`` does), draw
the init noise from seeded ``torch.Generator``s (one per row when the seed is
a list, as the server batches requests), run any sampler of
``models/latent_diffusion.py`` with classifier-free guidance (the UNet runs
once per step on the doubled batch), optionally through attached ControlNets
(``control_image``) or with DeepCache, optionally the two-stage hires fix
(:func:`hires_refine`), VAE-decode (whole or tiled) and write PNGs.
``img2img`` and ``inpaint`` start from an init image's VAE posterior. Every
random draw is float32 on the CPU from the seeded generator, moved to the
card, so a seed gives the same image on every device; it does not reproduce
JAX's key stream. Every reverse loop here (txt2img, img2img, inpaint and
both stages of the hires fix) goes through the model's loop cache
(``LatentDiffusion.sample_loop``): on a card each signature is captured as
one CUDA graph at its first call and replayed after it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig
from stable_diffusion_pytorch_tpu_torch.models import schedule as sched_lib
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import SAMPLERS, LatentDiffusion
from stable_diffusion_pytorch_tpu_torch.utils.data import detransform, read_image, to_img, transform_image


@dataclass
class SamplingConfig(BaseConfig):
    """The JAX package's ``SamplingConfig``: the same fields, defaults, help
    and choices."""

    prompt: str = field(default="a cat", metadata={"help": "text prompt to sample."})
    negative_prompt: str = field(
        default="",
        metadata={"help": "negative prompt used as the CFG unconditional branch."},
    )
    image_size: int = field(default=64, metadata={"help": "output image resolution."})
    sampling_steps: int = field(default=50, metadata={"help": "number of denoising steps."})
    sampler: str = field(
        default="ddim",
        metadata={
            "help": "sampling algorithm (dpmpp = DPM-Solver++ 2M, ~20 steps for "
            "DDIM-50 quality; euler/euler_a/heun/dpmpp_sde are sigma-space "
            "k-diffusion-style samplers).",
            "choices": list(SAMPLERS),
        },
    )
    karras: bool = field(
        default=False,
        metadata={"help": "use Karras sigma spacing for the sigma-space samplers."},
    )
    prediction_type: str = field(
        default="epsilon",
        metadata={
            "help": "what the UNet predicts: epsilon or v_prediction "
            "(SD-2.x-style; must match how the checkpoint was trained).",
            "choices": ["epsilon", "v_prediction"],
        },
    )
    timestep_spacing: str = field(
        default="even",
        metadata={
            "help": "few-step subsequence spacing: even (ends at t=0 side) or "
            "trailing (starts at t=T-1; required for zero-terminal-SNR "
            "checkpoints, Lin et al. 2023).",
            "choices": ["even", "trailing"],
        },
    )
    guidance_rescale: float = field(
        default=0.0,
        metadata={
            "help": "CFG std-rescale factor phi (Lin et al. 2023 §3.4); 0 "
            "disables, 0.7 is the paper's recommendation for zero-SNR "
            "checkpoints at high guidance."
        },
    )
    eta: float = field(
        default=0.0,
        metadata={
            "help": "DDIM eta (0 = deterministic); noise scale for euler_a/"
            "dpmpp_sde (0 means their default of 1)."
        },
    )
    num_images: int = field(default=1, metadata={"help": "batch of images to sample."})
    scale_factor: float = field(default=1.0, metadata={"help": "noise temperature for DDPM."})
    repeat_noise: bool = field(
        default=False, metadata={"help": "share posterior noise across the batch."}
    )
    output_dir: str = field(default="output", metadata={"help": "directory for saved PNGs."})
    output_name: str = field(default="txt2img", metadata={"help": "basename for saved PNGs."})
    unet_checkpoint: Optional[str] = field(
        default=None,
        metadata={
            "help": "Trainer checkpoint (checkpoint-N dir, or a ckpt dir with "
            "'latest' resolution) to load UNet weights from; EMA preferred."
        },
    )
    lora_checkpoint: Optional[str] = field(
        default=None,
        metadata={
            "help": "LoRA trainer checkpoint (from --lora-rank training) to "
            "merge into the UNet weights before sampling."
        },
    )
    lora_scale: float = field(
        default=1.0,
        metadata={
            "help": "merge scale for --lora-checkpoint; equals alpha/rank "
            "used in training (training default alpha=rank -> 1.0)."
        },
    )
    textual_inversion: Optional[str] = field(
        default=None,
        metadata={
            "help": "textual-inversion checkpoint dir (from "
            "train_textual_inversion.py); registers the learned placeholder "
            "token so it can be used in --prompt."
        },
    )
    controlnet_checkpoint: Optional[str] = field(
        default=None,
        metadata={
            "help": "ControlNet checkpoint dir (from train_controlnet.py); "
            "requires --control-image."
        },
    )
    control_image: Optional[str] = field(
        default=None,
        metadata={
            "help": "conditioning image (e.g. edge map) steering sampling "
            "through the loaded ControlNet; comma-separated list for "
            "multi-ControlNet (matching --controlnet-checkpoint order)."
        },
    )
    control_scale: float = field(
        default=1.0,
        metadata={"help": "strength of the ControlNet residuals (0 = off)."},
    )
    deep_cache_interval: int = field(
        default=0,
        metadata={
            "help": "DeepCache: refresh the UNet's deep trunk every N steps "
            "and reuse it in between (N > 1 enables; speed/quality trade; "
            "ddim/ddpm/dpmpp only)."
        },
    )
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


def load_image(image, resolution: int) -> torch.Tensor:
    """A path, an HWC uint8 array or a [-1, 1] float array -> [1, H, W, 3]
    float32 (uint8 resized and center-cropped to ``resolution``)."""
    if isinstance(image, str):
        image = read_image(image, "RGB")
    image = np.asarray(image)
    if image.dtype == np.uint8:
        image = transform_image(image, resolution)
    return torch.from_numpy(np.ascontiguousarray(image[None], np.float32))


def load_mask(mask_image, size) -> torch.Tensor:
    """An inpainting mask (a path, or an array in [0, 1] or [0, 255]; white =
    repaint) at any size -> [1, h, w, 1] in {0, 1} at the latent ``size``
    (h, w). The resize is ``jax.image.resize(..., "nearest")``'s, sampling at
    half-pixel centres: ``nearest-exact``, not ``nearest``."""
    if isinstance(mask_image, str):
        mask_image = read_image(mask_image, "L")
    mask = torch.from_numpy(np.asarray(mask_image, np.float32).copy())
    if mask.max() > 1.0:
        mask = mask / 255.0
    mask = F.interpolate(mask[None, None], size=tuple(size), mode="nearest-exact")[0, 0]
    return (mask > 0.5).float()[None, :, :, None]


def _hints(control_image, image_size: int):
    """``control_image`` (one image or a list, one per attached net) -> hints."""
    if control_image is None:
        return None
    if isinstance(control_image, (list, tuple)):
        return [load_image(i, image_size) for i in control_image]
    return load_image(control_image, image_size)


def _init_latents(model: LatentDiffusion, init_image, image_size: int, generator: torch.Generator) -> torch.Tensor:
    """The init image's VAE posterior sample in the compute dtype; its eps is
    drawn in float32 on the CPU from ``generator``."""
    img = load_image(init_image, image_size).to(device=model.device, dtype=model.dtype)
    posterior = model.encode_image(img)
    eps = torch.randn(posterior.mean.shape, generator=generator, dtype=torch.float32)
    return posterior.sample(eps=eps.to(posterior.mean.device)).to(model.dtype)


def _decode_one(model: LatentDiffusion, x_0: torch.Tensor, save_dir: Optional[str], name: str) -> np.ndarray:
    digit = detransform(model.decode_latent(x_0).float().cpu().numpy()[0])
    if save_dir is not None:
        to_img(digit, output_path=save_dir, name=name)
    return digit


@torch.no_grad()
def img2img(
    model: LatentDiffusion, init_image, prompt: str = "", strength: float = 0.75, image_size: int = 64,
    time_steps: int = 50, guidance_scale: float = 7.5, sampler: str = "ddim", eta: float = 0.0,
    save_dir: Optional[str] = "output", seed: int = 42, name: str = "img2img", negative_prompt: str = "",
    control_image=None, control_scale: float = 1.0,
) -> np.ndarray:
    """Image-to-image: q-sample the init image's latent to the first step of
    the final ``strength`` fraction of the schedule and denoise from there.
    Draws, in this order from ``torch.Generator().manual_seed(seed)``: the
    posterior's eps, the q-sample noise, then the loop's. -> HWC uint8.
    ``control_image`` steers through the attached ControlNet(s)."""
    generator = torch.Generator().manual_seed(int(seed))
    init_latents = _init_latents(model, init_image, image_size, generator)
    ctx = model.encode_prompts([prompt]).to(model.dtype)
    hints = _hints(control_image, image_size)
    loop = model.sample_loop(init_latents, ctx, time_steps, hints, control_scale, sampler=sampler,
                             guidance_scale=guidance_scale, eta=eta, strength=strength)
    noise = torch.randn(init_latents.shape, generator=generator, dtype=torch.float32)
    t0 = torch.full((1,), loop.start_timestep, dtype=torch.int32)
    x_t = sched_lib.add_noise(model.noise_scheduler, init_latents, noise.to(init_latents), t0)
    x_0 = loop(x_t, ctx, model.uncond_for(ctx, guidance_scale, negative_prompt), generator, hints=hints)
    return _decode_one(model, x_0, save_dir, name)


@torch.no_grad()
def inpaint(
    model: LatentDiffusion, init_image, mask_image, prompt: str = "", image_size: int = 64,
    time_steps: int = 50, guidance_scale: float = 7.5, sampler: str = "ddim",
    save_dir: Optional[str] = "output", seed: int = 42, name: str = "inpaint", negative_prompt: str = "",
    control_image=None, control_scale: float = 1.0,
) -> np.ndarray:
    """Latent inpainting: generate inside the mask (white = repaint); after
    each step the rest is the init latent re-noised to the step's level, and
    at the end the init latent itself. Draws from the seeded generator: the
    posterior's eps, the init noise, then the loop's (blend noise included).
    -> HWC uint8."""
    generator = torch.Generator().manual_seed(int(seed))
    init_latents = _init_latents(model, init_image, image_size, generator)
    mask = load_mask(mask_image, init_latents.shape[1:3]).to(device=model.device, dtype=model.dtype)
    ctx = model.encode_prompts([prompt]).to(model.dtype)
    hints = _hints(control_image, image_size)
    loop = model.sample_loop(init_latents, ctx, time_steps, hints, control_scale, sampler=sampler,
                             guidance_scale=guidance_scale, inpaint=True)
    noise = torch.randn(init_latents.shape, generator=generator, dtype=torch.float32).to(init_latents)
    x_0 = loop(noise, ctx, model.uncond_for(ctx, guidance_scale, negative_prompt), generator,
               mask=mask, init_latents=init_latents, hints=hints)
    return _decode_one(model, x_0, save_dir, name)


@torch.no_grad()
def hires_refine(
    model: LatentDiffusion, x0: torch.Tensor, context_emb: torch.Tensor, *, guidance_scale: float,
    sampler: str, time_steps: int, hires_scale: float, hires_strength: float, negative_prompt: str = "",
    eta: float = 0.0, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
    prediction_type: str = "epsilon", timestep_spacing: str = "even", guidance_rescale: float = 0.0,
) -> torch.Tensor:
    """Stage 2 of the hires fix (the JAX package's ``_hires_refine``): upscale
    the latent, q-sample it to the first step of the final ``hires_strength``
    fraction of the schedule, and denoise that fraction at high resolution.

    The noise is ``noise`` when given, else drawn in float32 on the CPU from
    ``generator`` (the one :func:`sample` seeded), so a seed gives the same
    image on every device; it does not reproduce JAX's ``fold_in`` stream."""
    dtype = model.dtype
    x_up = upscale_latent(x0, hires_scale).to(dtype)
    loop = model.sample_loop(x_up, context_emb, time_steps, sampler=sampler, guidance_scale=guidance_scale, eta=eta,
                             strength=hires_strength, prediction_type=prediction_type,
                             timestep_spacing=timestep_spacing, guidance_rescale=guidance_rescale)
    if noise is None:
        noise = torch.randn(x_up.shape, generator=generator, dtype=torch.float32)
    noise = noise.to(device=x_up.device, dtype=dtype)
    b = x_up.shape[0]
    t0 = torch.full((b,), loop.start_timestep, dtype=torch.int32, device=x_up.device)
    x_t = sched_lib.add_noise(model.noise_scheduler, x_up, noise, t0)
    return loop(x_t, context_emb, model.uncond_for(context_emb, guidance_scale, negative_prompt), generator)


def sample(
    model: LatentDiffusion,
    image_size: int = 64,
    prompt: Union[str, Sequence[str]] = "",
    time_steps: int = 50,
    guidance_scale: float = 7.5,
    scale_factor: float = 1.0,
    save_dir: Optional[str] = "output",
    sampler: str = "ddim",
    eta: float = 0.0,
    num_images: int = 1,
    repeat_noise: bool = False,
    seed: Union[int, Sequence[int]] = 42,
    name: str = "txt2img",
    negative_prompt: str = "",
    karras: bool = False,
    prediction_type: str = "epsilon",
    timestep_spacing: str = "even",
    guidance_rescale: float = 0.0,
    control_image=None,
    control_scale: float = 1.0,
    deep_cache_interval: int = 0,
    hires_scale: float = 0.0,
    hires_strength: float = 0.6,
    vae_tile: int = 0,
) -> List[np.ndarray]:
    """Sample images; returns HWC uint8 arrays and writes PNGs to ``save_dir``.

    ``prompt`` may be a list (then ``num_images = len(prompt)``). The init
    noise [B, h, w, 4] is drawn in float32 on the CPU from
    ``torch.Generator().manual_seed(seed)`` (U[0, 1) under the compat switch
    ``uniform_init_noise``) and moved to the model's device, so a seed gives
    the same noise on every device; the sampling loop draws on from the same
    generator. ``seed`` may be a list, one per row (batched serving): each row
    draws its init noise from its own generator, and the loop draws from the
    first row's (the JAX package keeps the first row's loop key), so a
    request's image does not depend on its batch mates (for the stochastic
    samplers, only as the batch's first row); on the CPU it is the solo
    render's bytes.

    ``control_image`` (a path, an HWC uint8 or a [-1, 1] float array; a list
    for several nets) steers sampling through the attached ControlNet(s)
    (``model.attach_controlnet``), scaled by ``control_scale``;
    ``deep_cache_interval = N > 1`` enables DeepCache (the UNet's deep trunk
    refreshed every N steps).

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

    shape = model.latent_shape(num_images, image_size)
    draw = torch.rand if (model.compat is not None and model.compat.uniform_init_noise) else torch.randn
    if isinstance(seed, (list, tuple)):
        if len(seed) != num_images:
            raise ValueError(f"{len(seed)} seeds for {num_images} images: one seed per image")
        generators = [torch.Generator().manual_seed(int(s)) for s in seed]
        noise = torch.cat([draw((1,) + tuple(shape[1:]), generator=g, dtype=torch.float32) for g in generators])
        generator = generators[0]
    else:
        generator = torch.Generator().manual_seed(int(seed))
        noise = draw(shape, generator=generator, dtype=torch.float32)
    noise = noise.to(device=model.device, dtype=model.dtype)

    context_emb = model.encode_prompts(prompts).to(model.dtype)
    guidance = dict(prediction_type=prediction_type, timestep_spacing=timestep_spacing,
                    guidance_rescale=guidance_rescale)
    x_0 = model.sample(
        noise, context_emb, guidance_scale=guidance_scale, repeat_noise=repeat_noise, scale_factor=scale_factor,
        time_steps=time_steps, sampler=sampler, eta=eta, generator=generator, negative_prompt=negative_prompt,
        karras=karras, control_hint=_hints(control_image, image_size), control_scale=control_scale,
        deep_cache_interval=deep_cache_interval, **guidance,
    )
    if hires_scale > 1.0:
        x_0 = hires_refine(
            model, x_0, context_emb, guidance_scale=guidance_scale,
            sampler=sampler if sampler in ("ddim", "ddpm", "dpmpp") else "ddim",
            time_steps=time_steps, hires_scale=hires_scale, hires_strength=hires_strength,
            negative_prompt=negative_prompt, eta=eta, generator=generator, **guidance,
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
