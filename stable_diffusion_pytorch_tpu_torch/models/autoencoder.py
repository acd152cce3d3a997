"""KL VAE, channel-last (port of stable_diffusion_pytorch_tpu/models/autoencoder.py).

Kept reference quirks: the decoder walks the channel list in reverse from
``channels_list[0]`` (so its bottleneck runs at ``channels_list[0]``), and the
bottleneck's single-head attention is not residual. Names follow the reference
torch VAE (``encoder.down.{i}.0``, ``decoder.up.{i}.1.0.conv``, ...). The
encoder returns the posterior (:class:`GaussianDistribution`) the UNet trainer
samples latents from; text-to-image runs only ``decode``; the autoencoder
trainer runs the whole pass, :meth:`AutoEncoderKL.forward`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig
from stable_diffusion_pytorch_tpu_torch.models.blocks import (
    CrossAttention,
    DownSample,
    GaussianDistribution,
    GroupNorm,
    ResBlock,
    UpSample,
    conv1x1,
    conv3x3,
)
from stable_diffusion_pytorch_tpu_torch.models.unet import plan_input_blocks, plan_output_blocks


def _bottleneck(channels: int, groups: int, first_groups: int) -> nn.ModuleList:
    """ResBlock, raw single-head CrossAttention (no residual), ResBlock."""
    return nn.ModuleList([
        ResBlock(channels, groups=first_groups),
        CrossAttention(channels, n_heads=1, d_head=channels),
        ResBlock(channels, groups=groups),
    ])


def _run_bottleneck(bottleneck: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    res1, attn, res2 = bottleneck
    return res2(attn(res1(x)))


class Encoder(nn.Module):
    def __init__(self, in_channels, out_channels, channels_list, num_res_blocks, groups,
                 bottleneck_default_groups=False):
        super().__init__()
        ch0 = channels_list[0]
        self.conv_in = conv3x3(in_channels, ch0)
        plan, _, mid_ch, _, _ = plan_input_blocks(ch0, channels_list, num_res_blocks, None)
        self.down = nn.ModuleList(
            nn.ModuleList([ResBlock(b[1], b[2], groups=groups) if b[0] == "res" else DownSample(b[1])])
            for b in plan
        )
        self.bottleneck = _bottleneck(mid_ch, groups, 2 if bottleneck_default_groups else groups)
        self.out = nn.Sequential(GroupNorm(groups, mid_ch), nn.SiLU(), conv3x3(mid_ch, 2 * out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for (layer,) in self.down:
            x = layer(x)
        x = _run_bottleneck(self.bottleneck, x)
        return self.out[2](self.out[0](x, silu=True))


class Decoder(nn.Module):
    def __init__(self, latent_channels, out_channels, channels_list, num_res_blocks, groups,
                 bottleneck_default_groups=False):
        super().__init__()
        ch0 = channels_list[0]
        self.conv_in = conv3x3(latent_channels, ch0)
        self.bottleneck = _bottleneck(ch0, groups, 2 if bottleneck_default_groups else groups)
        plan, out_ch = plan_output_blocks(channels_list, num_res_blocks, None, [], ch0, 0)
        self.up = nn.ModuleList()
        for _, ic, oc, _, upsample in plan:
            layers = [ResBlock(ic, oc, groups=groups)]
            if upsample:
                layers.append(nn.ModuleList([UpSample(oc)]))
            self.up.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm(groups, out_ch), nn.SiLU(), conv3x3(out_ch, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _run_bottleneck(self.bottleneck, self.conv_in(x))
        for layers in self.up:
            x = layers[0](x)
            if len(layers) > 1:
                x = layers[1][0](x)
        return self.out[2](self.out[0](x, silu=True))


class AutoEncoderKL(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, bottleneck_default_groups: bool = False):
        super().__init__()
        if cfg.out_channels is not None and cfg.out_channels != cfg.in_channels:
            raise ValueError(
                f"input channels({cfg.in_channels}) should equal output channels({cfg.out_channels})"
            )
        channels = list(cfg.autoencoder_channels_list)
        self.latent_channels = cfg.latent_channels
        self.channels_list = channels
        self.encoder = Encoder(cfg.in_channels, cfg.latent_channels, channels,
                               cfg.autoencoder_num_res_blocks, cfg.groups, bottleneck_default_groups)
        self.decoder = Decoder(cfg.latent_channels, cfg.out_channels or cfg.in_channels, channels,
                               cfg.autoencoder_num_res_blocks, cfg.groups, bottleneck_default_groups)
        self.quant_conv = conv1x1(2 * cfg.latent_channels, 2 * cfg.latent_channels)
        self.post_quant_conv = conv1x1(cfg.latent_channels, cfg.latent_channels)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.channels_list) - 1)

    def encode(self, img: torch.Tensor) -> GaussianDistribution:
        """img [B, H, W, in_ch] -> posterior over [B, H/f, W/f, latent_ch]."""
        dtype = self.quant_conv.weight.dtype
        return GaussianDistribution.from_moments(self.quant_conv(self.encoder(img.to(dtype))))

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """latent [B, h, w, latent_ch] -> image [B, H, W, out_ch]."""
        if latent.shape[-1] != self.latent_channels:
            raise ValueError(f"latent has {latent.shape[-1]} channels, expected {self.latent_channels}")
        dtype = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(latent.to(dtype)))

    def forward(
        self,
        img: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        eps: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, GaussianDistribution]:
        """encode -> sample -> decode (the JAX ``__call__`` with a sample key):
        -> (reconstruction, posterior). The latent is a posterior sample with
        noise ``eps`` (or drawn from ``generator``) when either is given, its
        mode otherwise."""
        posterior = self.encode(img)
        if generator is None and eps is None:
            z = posterior.mode()
        else:
            z = posterior.sample(generator, eps)
        return self.decode(z), posterior
