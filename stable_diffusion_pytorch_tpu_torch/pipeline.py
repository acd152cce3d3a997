"""Text-to-image sampling (port of stable_diffusion_pytorch_tpu/pipeline.py:sample).

``sample``: tokenize and CLIP-encode the prompts and the uncond prompt, draw
the init noise from a seeded ``torch.Generator``, run DDIM with classifier-free
guidance (the UNet runs once per step on the doubled batch), VAE-decode and
write PNGs. Hires fix, ControlNet, DeepCache, tiled decode, img2img and
inpainting are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.config import BaseConfig
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import SAMPLERS, LatentDiffusion
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
) -> List[np.ndarray]:
    """Sample images; returns HWC uint8 arrays and writes PNGs to ``save_dir``.

    ``prompt`` may be a list (then ``num_images = len(prompt)``). The init
    noise [B, h, w, 4] is drawn in float32 on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to the model's device, so
    a seed gives the same noise on every device."""
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
    images = model.decode_latent(x_0).float().cpu().numpy()

    outputs = []
    for i in range(num_images):
        digit = detransform(images[i])
        outputs.append(digit)
        if save_dir is not None:
            stem, ext = (name[:-4], name[-4:]) if name.lower().endswith(".png") else (name, "")
            suffix = f"_{i}" if num_images > 1 else ""
            to_img(digit, output_path=save_dir, name=f"{stem}{suffix}{ext}")
    return outputs
