"""Model assembly: staged pretrained weights where they are, else seeded random
ones (port of models/build.py).

Pretrained weights (the JAX package's ``build_models``): ``pretrained_dir``
(by default the CLIP config's ``model_dir``, ``data/pretrained``; ``None``
for none) is searched, each hit loaded by name with ``strict=True`` and
logged loudly:

- ``unet.pt``: a reference-format UNet state dict (the reference's torch
  names, which the port's UNet carries), read by
  ``utils/checkpoint.py:load_reference_checkpoint``;
- the VAE, in the JAX package's order: ``vae/``, a diffusers AutoencoderKL
  directory (``models/diffusers_vae.py``: its ``config.json`` sets the
  module, whose latent channels then override ``--latent-channels``, with a
  warning), else ``vae.pt``, a reference-format from-scratch ``AutoEncoderKL``;
- the text encoder from the CLIP config's own ``model_dir``, as the JAX
  package's ``CLIPModel`` reads it (``models/clip.py:load_text_encoder``:
  ``text_encoder/model.safetensors`` or ``pytorch_model.bin``, HF names).

The log names what was loaded ("pretrained weights loaded: [...]") and warns
of what was not. A loaded state dict goes through the same dtype rules as
random weights below.

Every module not loaded is initialized from ``seed`` the way the JAX package
initializes it: LeCun-normal conv and linear weights, zero biases, unit
GroupNorm/LayerNorm scales, and zero weights where the JAX package
zero-initializes (each ResBlock's last conv, each SpatialTransformer's
``proj_out``). The draws differ from JAX's PRNG; parity tests load JAX
weights through ``utils/convert.py`` or a staged directory instead. Every
module is drawn, loaded or not, so the random ones do not depend on what is
staged.

Precision: for inference the parameters are cast to the compute dtype once, at
build time (the JAX package casts f32 parameters per op, which gives the same
result in inference); GroupNorm affine parameters stay f32, as the kernels take
them. For training (``for_training=True``) the UNet keeps f32 trainable
parameters and the trainer computes in the compute dtype under
``torch.autocast``, the counterpart of Flax's ``dtype=bf16`` over
``param_dtype=f32``; CLIP and the VAE are frozen and cast as for inference.

The autoencoder trainer builds the VAE alone (:func:`build_autoencoder`), with
f32 trainable parameters as the UNet has for its trainer.

A LoRA (``models/lora.py``) given to :func:`build_models` is merged into the
UNet's f32 weights before the cast, and :func:`load_unet_weights` merges one
into a trained checkpoint's f32 weights before the copy; :func:`load_controlnets`
builds ControlNets to match the UNet and loads their checkpoints; the
ControlNet trainer takes one built with f32 trainable parameters.

Entry points run on the card: ``device`` defaults to ``"cuda"``, and without a
CUDA device only an explicit ``"cpu"`` runs (:func:`require_device`).
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

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
from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPModel, CLIPTextTransformer, load_text_encoder
from stable_diffusion_pytorch_tpu_torch.models.controlnet import ControlNet
from stable_diffusion_pytorch_tpu_torch.models.diffusers_vae import (
    DiffusersAutoencoderKL,
    read_diffusers_vae_state,
    read_vae_config,
)
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion
from stable_diffusion_pytorch_tpu_torch.models.lora import merge_lora
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import (
    check_unet_params,
    load_params_for_inference,
    load_reference_checkpoint,
    resolve_checkpoint,
)
from stable_diffusion_pytorch_tpu_torch.utils.compat import CompatConfig

# build_models' default pretrained_dir: the CLIP config's model_dir
FROM_CLIP_CFG = "__from_clip_cfg__"
_DTYPES = {"no": torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.bfloat16}


def resolve_dtype(mixed_precision: str, device: Union[str, torch.device]) -> torch.dtype:
    """``--mixed-precision`` -> compute dtype: bf16 on a CUDA device (fp16 maps
    to bf16, as in the JAX package), float32 on the CPU."""
    if torch.device(device).type != "cuda":
        return torch.float32
    return _DTYPES.get(mixed_precision, torch.float32)


# the torch layers of the port's modules whose constructors run a default init
_DEFAULT_INIT = (nn.Linear, nn.Conv2d, nn.Embedding, nn.LayerNorm)


@contextlib.contextmanager
def without_default_init() -> Iterator[None]:
    """Construct modules without the default init of their torch layers (their
    storage is left as allocated): :func:`init_weights` (or a strict load)
    sets every parameter of the port's modules afterwards, and they hold no
    buffer, so no value changes, and the full-size CLIP tower's 123 M
    parameters are drawn once, not twice. Construction here runs on one thread; the layers' methods are
    restored on exit."""
    owners = {next(c for c in cls.__mro__ if "reset_parameters" in c.__dict__) for cls in _DEFAULT_INIT}
    saved = {cls: cls.__dict__["reset_parameters"] for cls in owners}
    try:
        for cls in owners:
            cls.reset_parameters = lambda self: None
        yield
    finally:
        for cls, method in saved.items():
            cls.reset_parameters = method


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
    """Cast once to the compute dtype, keep GroupNorm affine params f32 (their
    f32 values as they were, not rounded through the compute dtype), freeze.
    Conv weights go to ``channels_last``, the layout of the NHWC activations,
    so cuDNN does not convert them on every call."""
    affine = [(m, m.weight.data.float(), m.bias.data.float()) for m in module.modules() if isinstance(m, GroupNorm)]
    module.to(dtype=dtype, memory_format=torch.channels_last)
    for m, weight, bias in affine:
        m.weight.data, m.bias.data = weight, bias
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


def build_autoencoder(
    vae_cfg: AutoencoderConfig,
    compat: Optional[CompatConfig] = None,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
) -> AutoEncoderKL:
    """The VAE alone for training (the autoencoder trainer): f32 trainable
    parameters on ``device``, seeded as :func:`build_models` seeds it."""
    compat = compat.resolved() if compat is not None else CompatConfig()
    device = require_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    with device, without_default_init():
        vae = AutoEncoderKL(vae_cfg, bottleneck_default_groups=compat.bottleneck_default_groups)
    init_weights(vae, generator)
    return prepare_for_training(vae)


def find_pretrained(pretrained_dir: Optional[str]) -> dict:
    """The staged weights under ``pretrained_dir``, read to the CPU: ``"unet"``
    (the ``unet.pt`` state dict) and ``"vae"`` (``(tag, state, diffusers
    config or None)``, ``vae/`` before ``vae.pt``), each where found."""
    found: dict = {}
    if not pretrained_dir:
        return found
    path = os.path.join(pretrained_dir, "unet.pt")
    if os.path.exists(path):
        found["unet"] = load_reference_checkpoint(path)
    vae_dir = os.path.join(pretrained_dir, "vae")
    state = read_diffusers_vae_state(vae_dir) if os.path.isdir(vae_dir) else None
    if state is not None:
        found["vae"] = (f"diffusers AutoencoderKL from {vae_dir}", state, read_vae_config(vae_dir))
    elif os.path.exists(os.path.join(pretrained_dir, "vae.pt")):
        path = os.path.join(pretrained_dir, "vae.pt")
        found["vae"] = (f"reference-format AutoEncoderKL from {path}", load_reference_checkpoint(path), None)
    return found


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
    remat: str = "none",
    lora: Optional[Tuple[Dict[str, torch.Tensor], float]] = None,
    pretrained_dir: Optional[str] = FROM_CLIP_CFG,
    logger=None,
) -> LatentDiffusion:
    """Schedule + UNet + CLIP + VAE on ``device``: staged weights under
    ``pretrained_dir`` (module docstring; default the CLIP config's
    ``model_dir``, ``None`` for none), the rest seeded. ``dtype`` is the
    compute dtype: every module is cast to it for inference; with
    ``for_training`` the UNet keeps f32 trainable parameters instead.
    ``remat`` is the UNet's per-block remat policy (``--remat-policy``).
    ``lora`` = (factors, scale) is merged into the UNet's f32 weights first.
    ``logger`` gets the JAX package's lines on what was loaded."""
    compat = compat.resolved() if compat is not None else CompatConfig()
    device = require_device(device)
    if pretrained_dir == FROM_CLIP_CFG:
        pretrained_dir = clip_cfg.model_dir
    found = find_pretrained(pretrained_dir)
    vae_tag, vae_state, diffusers_cfg = found.get("vae", (None, None, None))
    if diffusers_cfg is not None and diffusers_cfg["latent_channels"] != vae_cfg.latent_channels and logger:
        logger.warning(f"pretrained VAE latent_channels={diffusers_cfg['latent_channels']} "
                       f"overrides --latent-channels={vae_cfg.latent_channels}")
    generator = torch.Generator(device=device).manual_seed(seed)
    with device, without_default_init():
        unet = UNetModel(
            vae_cfg.latent_channels, vae_cfg.groups, unet_cfg,
            flipped_time_embedding=compat.flipped_time_embedding,
            bottleneck_default_groups=compat.bottleneck_default_groups,
            remat=remat,
        )
        if diffusers_cfg is not None:
            vae = DiffusersAutoencoderKL(**diffusers_cfg)
        else:
            vae = AutoEncoderKL(vae_cfg, bottleneck_default_groups=compat.bottleneck_default_groups)
        text = CLIPTextTransformer(max_positions=clip_cfg.max_seq_len)
    for module in (unet, vae, text):
        init_weights(module, generator)
    unet_pretrained = "unet" in found
    with torch.no_grad():
        if unet_pretrained:
            unet.load_state_dict(found.pop("unet"), strict=True)
        if vae_state is not None:
            vae.load_state_dict(vae_state, strict=True)
    del found, vae_state
    clip_pretrained = load_text_encoder(text, clip_cfg.model_dir)
    for module in (unet, vae, text):
        if lora is not None and module is unet:
            unet.load_state_dict(merge_lora(unet.state_dict(), *lora), strict=True)
        if for_training and module is unet:
            prepare_for_training(module)
        else:
            cast_for_inference(module, dtype)
    if logger is not None:
        loaded = [name for name, ok in (("unet", unet_pretrained), ("vae", vae_tag is not None),
                                        ("clip", clip_pretrained)) if ok]
        missing = [name for name in ("unet", "vae", "clip") if name not in loaded]
        logger.info(f"pretrained weights loaded: {loaded or 'NONE'}" + (f" ({vae_tag})" if vae_tag else ""))
        if missing:
            logger.warning(f"pretrained weights NOT found for {missing} under {pretrained_dir!r} "
                           "— these components are randomly initialized")
    return LatentDiffusion(
        unet, vae, CLIPModel(clip_cfg, text, pretrained=clip_pretrained), make_schedule(ddpm_cfg), compat=compat,
        compute_dtype=dtype,
    )


def sampling_model(model: LatentDiffusion, weights: Optional[Dict[str, torch.Tensor]] = None,
                   capture: bool = False) -> LatentDiffusion:
    """A training build (f32 UNet computing under autocast) as the sampling
    path takes it: the UNet copied, ``weights`` (by parameter name, e.g. a
    LoRA's merged weights) copied over its parameters in float32, and cast
    to the compute dtype as :func:`build_models` casts for inference; the
    frozen VAE and text encoder (cast already) and any attached ControlNets
    shared. ``capture`` is :class:`LatentDiffusion`'s. The rule: a model made
    for one render runs the eager loop (the default, off): the trainers'
    ``log_images`` (the UNet's, textual inversion's and the ControlNet's)
    each build a fresh one mid-training, where a captured loop would be a
    warm-up and a capture for a single use and its graph pool would sit on
    the card beside the training step's. A model that renders many batches of one signature
    captures it: DreamBooth's class images (``scripts/train_dreambooth.py``,
    before training starts) replay one graph per batch size."""
    unet = copy.deepcopy(model.unet)
    if weights:
        with torch.no_grad():
            params = dict(unet.named_parameters())
            for name, w in weights.items():
                params[name].copy_(w)
    unet = cast_for_inference(unet, model.dtype)
    out = LatentDiffusion(unet, model.autoencoder, model.text_encoder, model.noise_scheduler, compat=model.compat,
                          compute_dtype=model.dtype, capture=capture)
    out.controlnet = model.controlnet
    return out


@torch.no_grad()
def load_unet_weights(unet: UNetModel, path: str, lora: Optional[str] = None, lora_scale: float = 1.0) -> str:
    """Copy a UNet trainer checkpoint's weights (EMA preferred) into ``unet``
    in place, in its dtype and on its device, with the LoRA checkpoint
    ``lora`` merged into the checkpoint's float32 weights first; -> the
    checkpoint loaded. A checkpoint that is not this UNet's, or a LoRA that
    does not fit it, raises before any weight is copied, so a failed load
    leaves ``unet`` as it was."""
    path = resolve_checkpoint(path)
    params = load_params_for_inference(path)
    check_unet_params(unet, params, path)
    if lora:
        params = merge_lora(params, load_params_for_inference(resolve_checkpoint(lora)), lora_scale)
    unet.load_state_dict(params, strict=True)
    return path


def build_controlnet(
    unet_cfg: UnetConfig,
    vae_cfg: AutoencoderConfig,
    compat: Optional[CompatConfig] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
    seed: int = 0,
    for_training: bool = False,
) -> ControlNet:
    """A ControlNet matching the UNet of ``unet_cfg`` (its hint reaches the
    latent resolution through one stride-2 conv per VAE level), seeded as
    :func:`build_models` seeds, zero convs at zero, cast for inference or,
    ``for_training``, with f32 trainable parameters (the ControlNet trainer's)."""
    compat = compat.resolved() if compat is not None else CompatConfig()
    device = require_device(device)
    with device, without_default_init():
        net = ControlNet(vae_cfg.latent_channels, vae_cfg.groups, unet_cfg,
                         hint_downsamples=len(vae_cfg.autoencoder_channels_list) - 1,
                         flipped_time_embedding=compat.flipped_time_embedding)
    init_weights(net, torch.Generator(device=device).manual_seed(seed))
    if for_training:
        return prepare_for_training(net.zero_init())
    return cast_for_inference(net.zero_init(), dtype)


@torch.no_grad()
def load_controlnets(
    paths: Sequence[str],
    unet_cfg: UnetConfig,
    vae_cfg: AutoencoderConfig,
    compat: Optional[CompatConfig] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> list:
    """One ControlNet per checkpoint (the port's layout, ``models/controlnet.py``;
    EMA weights preferred), each loaded by name with ``strict=True``."""
    nets = []
    for path in paths:
        net = build_controlnet(unet_cfg, vae_cfg, compat, dtype, device)
        net.load_state_dict(load_params_for_inference(resolve_checkpoint(path)), strict=True)
        nets.append(net)
    return nets
