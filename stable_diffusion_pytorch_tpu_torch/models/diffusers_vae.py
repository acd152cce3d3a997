"""The diffusers AutoencoderKL, channel-last (port of stable_diffusion_pytorch_tpu/models/diffusers_vae.py).

The frozen VAE the reference's UNet trainer swaps in (SD-1.5's ``vae``),
staged as a diffusers directory (``config.json`` beside
``diffusion_pytorch_model.safetensors`` or ``.bin``). Its parameters carry
diffusers' own names (``encoder.down_blocks.{i}.resnets.{j}.conv1``,
``decoder.mid_block.attentions.0.to_q``, ...), so a diffusers state dict
loads with ``strict=True``; :func:`diffusers_vae_state` first maps the
pre-0.15 attention names (``query``/``key``/``value``/``proj_attn``,
``norm`` for ``group_norm``) and squeezes their 1x1-conv-shaped weights, as
the JAX package's ``convert_diffusers_vae_state`` does.

Architecture (JAX ``diffusers_vae.py:44-240``): encoder conv_in, per level
``layers_per_block`` ResnetBlock2Ds then a stride-2 conv after an asymmetric
(0,1)x(0,1) pad (not after the last level), the mid block (resnet,
single-head attention over h*w tokens, resnet), GroupNorm+SiLU, conv_out to
2x the latent channels, quant_conv; decoder post_quant_conv, conv_in, mid
block, per reversed level ``layers_per_block + 1`` resnets then nearest x2 +
conv (not after the last), GroupNorm+SiLU, conv_out. Every GroupNorm has eps
1e-6 and runs through ``ops/groupnorm.py:group_norm`` (K6 on the card); the
mid-block attention through ``ops/attention.py:multi_head_attention`` (K1,
one head of the level's width: 512 in SD-1.5). The posterior's log-variance
is clamped to [-30, 20]; no 0.18215 scaling is applied.

The call surface is the from-scratch ``AutoEncoderKL``'s (``encode`` -> the
posterior, ``decode``, ``forward``, ``latent_channels``,
``downsample_factor``, ``channels_list``), so ``LatentDiffusion``, the
pipelines and the trainers' frozen encode take either.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_pytorch_tpu_torch.models.blocks import (
    Conv2d,
    GaussianDistribution,
    GroupNorm,
    UpSample,
    conv1x1,
    conv3x3,
)
from stable_diffusion_pytorch_tpu_torch.ops.attention import multi_head_attention
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import read_weights

EPS = 1e-6
# SD-1.5's vae/config.json, where a staged one is silent
DEFAULT_CONFIG = dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=(128, 256, 512, 512),
                      layers_per_block=2, groups=32)


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D without a time embedding: GN+SiLU, conv, GN+SiLU,
    conv, plus the input (through a 1x1 conv where the width changes)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=EPS)
        self.conv1 = conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=EPS)
        self.conv2 = conv3x3(out_channels, out_channels)
        self.conv_shortcut = conv1x1(in_channels, out_channels) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x, silu=True)), silu=True))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class AttentionBlock(nn.Module):
    """The mid block's attention: GN, one head over the h*w tokens (head dim =
    channels), the out projection, plus the input."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.group_norm(x).reshape(b, hh * ww, c)
        q, k, v = (p(h)[:, :, None, :] for p in (self.to_q, self.to_k, self.to_v))
        attn = multi_head_attention(q, k, v, c ** -0.5).reshape(b, hh * ww, c)
        return x + self.to_out[0](attn).reshape(b, hh, ww, c)


class MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Downsample(nn.Module):
    """diffusers Downsample2D: pad (0,1) on each spatial dim, 3x3 stride-2 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _Level(nn.Module):
    """One down (or up) block: its resnets, then its resampler where it has one."""

    def __init__(self, resnets: Sequence[nn.Module], sampler: Optional[nn.Module], kind: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.kind = kind  # "downsamplers" or "upsamplers", diffusers' name
        if sampler is not None:
            setattr(self, kind, nn.ModuleList([sampler]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        samplers = getattr(self, self.kind, None)
        return x if samplers is None else samplers[0](x)


class Encoder(nn.Module):
    def __init__(self, in_channels, latent_channels, block_out_channels, layers_per_block, groups):
        super().__init__()
        chs = list(block_out_channels)
        self.conv_in = conv3x3(in_channels, chs[0])
        self.down_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            resnets = [ResnetBlock(prev if j == 0 else ch, ch, groups) for j in range(layers_per_block)]
            last = i == len(chs) - 1
            self.down_blocks.append(_Level(resnets, None if last else Downsample(ch), "downsamplers"))
            prev = ch
        self.mid_block = MidBlock(chs[-1], groups)
        self.conv_norm_out = GroupNorm(groups, chs[-1], eps=EPS)
        self.conv_out = conv3x3(chs[-1], 2 * latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x), silu=True))


class Decoder(nn.Module):
    def __init__(self, latent_channels, out_channels, block_out_channels, layers_per_block, groups):
        super().__init__()
        chs = list(reversed(block_out_channels))
        self.conv_in = conv3x3(latent_channels, chs[0])
        self.mid_block = MidBlock(chs[0], groups)
        self.up_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            resnets = [ResnetBlock(prev if j == 0 else ch, ch, groups) for j in range(layers_per_block + 1)]
            last = i == len(chs) - 1
            self.up_blocks.append(_Level(resnets, None if last else UpSample(ch), "upsamplers"))
            prev = ch
        self.conv_norm_out = GroupNorm(groups, chs[-1], eps=EPS)
        self.conv_out = conv3x3(chs[-1], out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class DiffusersAutoencoderKL(nn.Module):
    """diffusers AutoencoderKL with the from-scratch VAE's call surface."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, latent_channels: int = 4,
                 block_out_channels: Sequence[int] = DEFAULT_CONFIG["block_out_channels"],
                 layers_per_block: int = 2, groups: int = 32):
        super().__init__()
        self.latent_channels = latent_channels
        self.channels_list = list(block_out_channels)
        self.encoder = Encoder(in_channels, latent_channels, block_out_channels, layers_per_block, groups)
        self.decoder = Decoder(latent_channels, out_channels, block_out_channels, layers_per_block, groups)
        self.quant_conv = conv1x1(2 * latent_channels, 2 * latent_channels)
        self.post_quant_conv = conv1x1(latent_channels, latent_channels)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.channels_list) - 1)

    def encode(self, img: torch.Tensor) -> GaussianDistribution:
        """img [B, H, W, in_ch] -> posterior over [B, H/f, W/f, latent_ch],
        the log-variance clamped to [-30, 20]."""
        dtype = self.quant_conv.weight.dtype
        mean, log_var = self.quant_conv(self.encoder(img.to(dtype))).chunk(2, dim=-1)
        return GaussianDistribution(mean, log_var.clamp(-30.0, 20.0))

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """latent [B, h, w, latent_ch] -> image [B, H, W, out_ch] (``.sample``)."""
        if latent.shape[-1] != self.latent_channels:
            raise ValueError(f"latent has {latent.shape[-1]} channels, expected {self.latent_channels}")
        dtype = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(latent.to(dtype)))

    def forward(self, img: torch.Tensor, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, GaussianDistribution]:
        """encode -> the posterior's sample (noise ``eps`` or drawn from
        ``generator``) or, with neither, its mode -> decode."""
        posterior = self.encode(img)
        z = posterior.mode() if generator is None and eps is None else posterior.sample(generator, eps)
        return self.decode(z), posterior


# the pre-0.15 mid-block attention names -> today's
_OLD_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0", "norm": "group_norm"}
_ATTENTION_KEY = re.compile(r"^(.*\.mid_block\.attentions\.0\.)([a-z_]+(?:\.0)?)\.(weight|bias)$")


def diffusers_vae_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict in :class:`DiffusersAutoencoderKL`'s
    names: old attention names mapped to today's, and 1x1-conv-shaped
    attention projections [O, I, 1, 1] squeezed to [O, I]."""
    out = {}
    for key, value in state.items():
        m = _ATTENTION_KEY.match(key)
        if m:
            name = _OLD_ATTENTION.get(m.group(2), m.group(2))
            if value.dim() == 4:
                value = value[:, :, 0, 0]
            key = f"{m.group(1)}{name}.{m.group(3)}"
        out[key] = value
    return out


def read_vae_config(vae_dir: str) -> dict:
    """Module kwargs from a diffusers ``config.json`` (SD-1.5's without one)."""
    out = dict(DEFAULT_CONFIG)
    path = os.path.join(vae_dir, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        out.update(
            in_channels=raw.get("in_channels", 3), out_channels=raw.get("out_channels", 3),
            latent_channels=raw.get("latent_channels", 4),
            block_out_channels=tuple(raw.get("block_out_channels", out["block_out_channels"])),
            layers_per_block=raw.get("layers_per_block", 2), groups=raw.get("norm_num_groups", 32),
        )
    return out


def read_diffusers_vae_state(vae_dir: str) -> Optional[Dict[str, torch.Tensor]]:
    """The staged weights of a diffusers VAE directory, in this module's names
    (``diffusion_pytorch_model.safetensors``, ``model.safetensors``,
    ``diffusion_pytorch_model.bin``, ``pytorch_model.bin``: the first found),
    or None."""
    for name in ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin"):
        path = os.path.join(vae_dir, name)
        if os.path.exists(path):
            return diffusers_vae_state(read_weights(path))
    return None


@torch.no_grad()
def load_diffusers_vae(vae_dir: str, device="cpu") -> Optional[DiffusersAutoencoderKL]:
    """The staged diffusers VAE of ``vae_dir`` (its ``config.json`` and
    weights, loaded strictly) with f32 parameters on ``device``, eval mode,
    frozen; None when no weights are staged there."""
    state = read_diffusers_vae_state(vae_dir)
    if state is None:
        return None
    with torch.device(device):
        vae = DiffusersAutoencoderKL(**read_vae_config(vae_dir))
    vae.load_state_dict(state, strict=True)
    return vae.to(memory_format=torch.channels_last).eval().requires_grad_(False)
