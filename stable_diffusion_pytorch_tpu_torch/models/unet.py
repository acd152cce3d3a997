"""Conditional UNet eps(x_t, t, context), channel-last (port of models/unet.py).

The topology comes from the same static plans as the JAX package
(:func:`plan_input_blocks`, :func:`plan_output_blocks`; a test pins them equal).
Module names are the reference torch UNet's (``time_embedding.0``,
``input_blocks.{i}.0``, ``middle_block.1``, ``output_blocks.{i}.{j}.0.conv``,
``out.2``), the layout ``utils/convert.py`` writes. Kept quirks: the first
bottleneck ResBlock may use 2 groups (compat ``bottleneck_default_groups``) and
the bottleneck attention takes its d_head from the last input-level attention.
ControlNet residuals, DeepCache and rematerialization are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_pytorch_tpu_torch.config import UnetConfig
from stable_diffusion_pytorch_tpu_torch.models.blocks import (
    DownSample,
    GroupNorm,
    ResBlock,
    SpatialTransformer,
    UpSample,
    conv3x3,
    sinusoidal_time_proj,
)


def plan_input_blocks(
    in_channels: int,
    channels_list: Sequence[int],
    num_res_blocks: int,
    attention_resolutions: Optional[Sequence[int]],
) -> Tuple[list, List[int], int, Optional[int], int]:
    """Encoder-side plan: (blocks, skip_channels, mid_ch, d_head_src, attn_mult);
    each block is ("res", in, out, attn) or ("down", ch)."""
    blocks = []
    skip_channels = [in_channels]
    in_ch = in_channels
    attn_mult = 1
    d_head_src = None
    levels = len(channels_list)
    for level in range(levels):
        for _ in range(num_res_blocks):
            out_ch = channels_list[level]
            attn = attention_resolutions is not None and attn_mult in attention_resolutions
            if attn:
                d_head_src = out_ch
            blocks.append(("res", in_ch, out_ch, attn))
            in_ch = out_ch
            skip_channels.append(in_ch)
        if level != levels - 1:
            blocks.append(("down", in_ch))
            skip_channels.append(in_ch)
            attn_mult *= 2
    return blocks, skip_channels, in_ch, d_head_src, attn_mult


def plan_output_blocks(
    channels_list: Sequence[int],
    num_res_blocks: int,
    attention_resolutions: Optional[Sequence[int]],
    skip_channels: List[int],
    in_ch: int,
    attn_mult: int,
) -> Tuple[list, int]:
    """Decoder-side plan: entries ("res", in+skip, out, attn, upsample)."""
    blocks = []
    skips = list(skip_channels)
    levels = len(channels_list)
    for level in reversed(range(levels)):
        for res_block in range(num_res_blocks + 1):
            out_ch = channels_list[level]
            skip_ch = skips.pop() if skips else 0
            attn = attention_resolutions is not None and attn_mult in attention_resolutions
            upsample = level != 0 and res_block == num_res_blocks
            blocks.append(("res", in_ch + skip_ch, out_ch, attn, upsample))
            in_ch = out_ch
            if upsample and attn_mult:
                attn_mult //= 2
    return blocks, in_ch


class UNetModel(nn.Module):
    def __init__(
        self,
        latent_channels: int,
        groups: int,
        cfg: UnetConfig,
        flipped_time_embedding: bool = False,
        bottleneck_default_groups: bool = False,
    ):
        super().__init__()
        channels = list(cfg.channels_list)
        ch0 = channels[0]
        t_dim = cfg.time_emb_dim or ch0 * 4
        self.ch0 = ch0
        self.latent_channels = latent_channels
        self.flipped_time_embedding = flipped_time_embedding
        self.context_dim = cfg.context_dim

        def transformer(ch: int, d_head: int) -> SpatialTransformer:
            return SpatialTransformer(
                ch, cfg.n_heads, d_head, cfg.n_layers, cfg.dropout, cfg.context_dim, groups
            )

        self.time_embedding = nn.Sequential(
            nn.Linear(ch0, t_dim), nn.SiLU(), nn.Linear(t_dim, t_dim)
        )
        self.conv_in = conv3x3(latent_channels, ch0)

        in_plan, skip_channels, mid_ch, d_head_src, attn_mult = plan_input_blocks(
            ch0, channels, cfg.num_res_blocks, cfg.attention_resolutions
        )
        self.input_blocks = nn.ModuleList()
        for block in in_plan:
            if block[0] == "res":
                _, ic, oc, attn = block
                layers = [ResBlock(ic, oc, t_dim, groups)]  # input blocks: no dropout
                if attn:
                    layers.append(transformer(oc, oc // cfg.n_heads))
            else:
                layers = [DownSample(block[1])]
            self.input_blocks.append(nn.ModuleList(layers))

        d_head = (d_head_src if d_head_src else mid_ch) // cfg.n_heads
        self.middle_block = nn.ModuleList([
            ResBlock(mid_ch, mid_ch, t_dim, 2 if bottleneck_default_groups else groups, cfg.dropout),
            transformer(mid_ch, d_head),
            ResBlock(mid_ch, mid_ch, t_dim, groups, cfg.dropout),
        ])

        out_plan, out_ch = plan_output_blocks(
            channels, cfg.num_res_blocks, cfg.attention_resolutions, skip_channels, mid_ch, attn_mult
        )
        self.output_blocks = nn.ModuleList()
        for _, ic, oc, attn, upsample in out_plan:
            layers = [ResBlock(ic, oc, t_dim, groups, cfg.dropout)]
            if attn:
                layers.append(transformer(oc, oc // cfg.n_heads))
            if upsample:
                layers.append(nn.ModuleList([UpSample(oc)]))
            self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.Sequential(GroupNorm(groups, out_ch), nn.SiLU(), conv3x3(out_ch, latent_channels))

    def forward(
        self, x: torch.Tensor, timesteps: torch.Tensor, context_emb: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """x [B, h, w, latent_channels], timesteps [B], context [B, S, context_dim]."""
        dtype = self.conv_in.weight.dtype
        if context_emb is not None:
            if context_emb.shape[-1] != self.context_dim:
                raise ValueError(f"context dim {context_emb.shape[-1]} != {self.context_dim}")
            context_emb = context_emb.to(dtype)
        t = sinusoidal_time_proj(timesteps, self.ch0, flipped=self.flipped_time_embedding)
        t_emb = self.time_embedding[2](F.silu(self.time_embedding[0](t.to(dtype))))

        x = self.conv_in(x.to(dtype))
        skips = [x]
        for layers in self.input_blocks:
            for layer in layers:
                x = self._run(layer, x, t_emb, context_emb)
            skips.append(x)

        res1, attn, res2 = self.middle_block
        x = res2(attn(res1(x, t_emb), context_emb), t_emb)

        for layers in self.output_blocks:
            x = layers[0](x, t_emb, skip_cat=skips.pop())
            for layer in layers[1:]:
                x = self._run(layer, x, t_emb, context_emb)

        x = self.out[0](x, silu=True)
        return self.out[2](x)

    @staticmethod
    def _run(layer: nn.Module, x, t_emb, context_emb):
        if isinstance(layer, ResBlock):
            return layer(x, t_emb)
        if isinstance(layer, SpatialTransformer):
            return layer(x, context_emb)
        if isinstance(layer, nn.ModuleList):  # the up-path UpSample, nested as in the reference
            return layer[0](x)
        return layer(x)
