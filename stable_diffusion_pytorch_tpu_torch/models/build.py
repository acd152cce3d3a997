"""Model assembly with seeded random weights (port of models/build.py).

No pretrained weights ship with the repository, so every module is initialized
from ``seed`` the way the JAX package initializes it: LeCun-normal conv and
linear weights, zero biases, unit GroupNorm/LayerNorm scales, and zero weights
where the JAX package zero-initializes (each ResBlock's last conv, each
SpatialTransformer's ``proj_out``). The draws differ from JAX's PRNG; parity
tests load JAX weights through ``utils/convert.py`` instead. Loading
reference-format ``unet.pt``/``vae.pt`` checkpoints is not ported yet.

Precision: for inference the parameters are cast to the compute dtype once, at
build time (the JAX package casts f32 parameters per op, which gives the same
result in inference); GroupNorm affine parameters stay f32, as the kernels take
them. For training (``for_training=True``) the UNet keeps f32 trainable
parameters and the trainer computes in the compute dtype under
``torch.autocast``, the counterpart of Flax's ``dtype=bf16`` over
``param_dtype=f32``; CLIP and the VAE are frozen and cast as for inference.

Entry points run on the card: ``device`` defaults to ``"cuda"``, and without a
CUDA device only an explicit ``"cpu"`` runs (:func:`require_device`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from stable_diffusion_pytorch_tpu_torch.config import (
    AutoencoderConfig,
    ClipConfig,
    DDPMConfig,
    UnetConfig,
)
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL
from stable_diffusion_pytorch_tpu_torch.models.blocks import GroupNorm, ResBlock, SpatialTransformer
from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPModel, CLIPTextTransformer
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
from stable_diffusion_pytorch_tpu_torch.utils.compat import CompatConfig

_DTYPES = {"no": torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.bfloat16}


def resolve_dtype(mixed_precision: str, device: Union[str, torch.device]) -> torch.dtype:
    """``--mixed-precision`` -> compute dtype: bf16 on a CUDA device (fp16 maps
    to bf16, as in the JAX package), float32 on the CPU."""
    if torch.device(device).type != "cuda":
        return torch.float32
    return _DTYPES.get(mixed_precision, torch.float32)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.01, generator=generator)
    for m in module.modules():
        if isinstance(m, ResBlock):
            m.out_layers[3].weight.zero_()
        elif isinstance(m, SpatialTransformer):
            m.proj_out.weight.zero_()


def cast_for_inference(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast once to the compute dtype, keep GroupNorm affine params f32, freeze.
    Conv weights go to ``channels_last``, the layout of the NHWC activations,
    so cuDNN does not convert them on every call."""
    module.to(dtype=dtype, memory_format=torch.channels_last)
    for m in module.modules():
        if isinstance(m, GroupNorm):
            m.float()
    return module.eval().requires_grad_(False)


def require_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; raises when it is a CUDA device and none
    is present, naming the explicit CPU option."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless asked "
            "for the CPU: pass --device cpu (device='cpu')"
        )
    return device


def prepare_for_training(module: nn.Module) -> nn.Module:
    """f32 trainable parameters (GroupNorm affine included), conv weights in
    ``channels_last``; the compute dtype comes from autocast in the step.

    The module stays in eval mode: the JAX package's train step calls the
    UNet with its default ``deterministic=True``, so ``--dropout`` (default
    0.1) never drops anything in training there, and not here either."""
    module.to(dtype=torch.float32, memory_format=torch.channels_last)
    return module.eval().requires_grad_(True)


def build_models(
    unet_cfg: UnetConfig,
    vae_cfg: AutoencoderConfig,
    clip_cfg: ClipConfig,
    ddpm_cfg: DDPMConfig,
    compat: Optional[CompatConfig] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    for_training: bool = False,
) -> LatentDiffusion:
    """Schedule + UNet + CLIP + VAE on ``device``, seeded. ``dtype`` is the
    compute dtype: every module is cast to it for inference; with
    ``for_training`` the UNet keeps f32 trainable parameters instead."""
    compat = compat.resolved() if compat is not None else CompatConfig()
    device = require_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    with device:
        unet = UNetModel(
            vae_cfg.latent_channels, vae_cfg.groups, unet_cfg,
            flipped_time_embedding=compat.flipped_time_embedding,
            bottleneck_default_groups=compat.bottleneck_default_groups,
        )
        vae = AutoEncoderKL(vae_cfg, bottleneck_default_groups=compat.bottleneck_default_groups)
        text = CLIPTextTransformer(max_positions=clip_cfg.max_seq_len)
    for module in (unet, vae, text):
        init_weights(module, generator)
        if for_training and module is unet:
            prepare_for_training(module)
        else:
            cast_for_inference(module, dtype)
    return LatentDiffusion(
        unet, vae, CLIPModel(clip_cfg, text), make_schedule(ddpm_cfg), compat=compat,
        compute_dtype=dtype,
    )
