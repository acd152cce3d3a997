"""ControlNet inference (port of stable_diffusion_pytorch_tpu/models/controlnet.py).

A copy of the UNet's encoder (``conv_in``, the time MLP, the input blocks and
the bottleneck, from :func:`models.unet.plan_input_blocks`), conditioned on a
pixel-space hint image, whose every skip feature and bottleneck output pass
through a zero-initialized 1x1 conv; the UNet adds them to its own
(``UNetModel.forward(control=...)``, Zhang et al. 2023).

Names: the encoder copy uses the port UNet's own (``time_embedding.0``,
``conv_in``, ``input_blocks.{i}.*``, ``middle_block.*``), so
:func:`init_controlnet_from_unet` copies name for name; the rest follows the
original ControlNet's state dict: ``input_hint_block.{0,2,...,14}`` (SiLUs at
the odd indices), ``zero_convs.{i}`` and ``middle_block_out``. A checkpoint is
the port's own layout: a ``train_state.pt`` (``utils/checkpoint.py``) whose
``params`` (or ``ema_params``) is this module's state dict.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_pytorch_tpu_torch.config import UnetConfig
from stable_diffusion_pytorch_tpu_torch.models.blocks import (
    DownSample,
    ResBlock,
    SpatialTransformer,
    conv1x1,
    conv3x3,
    sinusoidal_time_proj,
)
from stable_diffusion_pytorch_tpu_torch.models.unet import plan_input_blocks

HINT_CHANNELS = 3  # an RGB hint image
HINT_WIDTHS = (16, 32, 96, 256)


def hint_block(out_channels: int, downsamples: int) -> nn.Sequential:
    """Pixel-space hint -> latent-resolution features: conv + SiLU, then per
    downsample a conv and a stride-2 conv (each + SiLU), then the zero-init
    output conv (the JAX ``HintEmbedding``'s widths 16-32-96-256)."""
    layers: List[nn.Module] = [conv3x3(HINT_CHANNELS, HINT_WIDTHS[0]), nn.SiLU()]
    ch = HINT_WIDTHS[0]
    for i in range(downsamples):
        w = HINT_WIDTHS[min(i + 1, len(HINT_WIDTHS) - 1)]
        layers += [conv3x3(ch, w), nn.SiLU(), conv3x3(w, w, stride=2), nn.SiLU()]
        ch = w
    layers.append(conv3x3(ch, out_channels))
    return nn.Sequential(*layers)


class ControlNet(nn.Module):
    """``forward(x, t, context, hint) -> (skip residuals, bottleneck residual)``
    in the form ``UNetModel.forward(control=...)`` takes."""

    def __init__(
        self,
        latent_channels: int,
        groups: int,
        cfg: UnetConfig,
        hint_downsamples: int = 3,
        flipped_time_embedding: bool = False,
    ):
        super().__init__()
        channels = list(cfg.channels_list)
        ch0 = channels[0]
        t_dim = cfg.time_emb_dim or ch0 * 4
        self.ch0 = ch0
        self.flipped_time_embedding = flipped_time_embedding

        def transformer(ch: int, d_head: int) -> SpatialTransformer:
            return SpatialTransformer(ch, cfg.n_heads, d_head, cfg.n_layers, cfg.dropout, cfg.context_dim, groups)

        self.time_embedding = nn.Sequential(nn.Linear(ch0, t_dim), nn.SiLU(), nn.Linear(t_dim, t_dim))
        self.conv_in = conv3x3(latent_channels, ch0)
        self.input_hint_block = hint_block(ch0, hint_downsamples)
        in_plan, _, mid_ch, d_head_src, _ = plan_input_blocks(
            ch0, channels, cfg.num_res_blocks, cfg.attention_resolutions)
        self.input_blocks = nn.ModuleList()
        self.zero_convs = nn.ModuleList([conv1x1(ch0, ch0)])
        for block in in_plan:
            if block[0] == "res":
                _, ic, oc, attn = block
                layers = [ResBlock(ic, oc, t_dim, groups)]
                if attn:
                    layers.append(transformer(oc, oc // cfg.n_heads))
            else:
                oc = block[1]
                layers = [DownSample(oc)]
            self.input_blocks.append(nn.ModuleList(layers))
            self.zero_convs.append(conv1x1(oc, oc))
        # the bottleneck keeps the UNet's inherited d_head; its first ResBlock
        # takes ``groups`` (the JAX ControlNet has no 2-group quirk)
        d_head = (d_head_src if d_head_src else mid_ch) // cfg.n_heads
        self.middle_block = nn.ModuleList([
            ResBlock(mid_ch, mid_ch, t_dim, groups, cfg.dropout),
            transformer(mid_ch, d_head),
            ResBlock(mid_ch, mid_ch, t_dim, groups, cfg.dropout),
        ])
        self.middle_block_out = conv1x1(mid_ch, mid_ch)

    def zero_init(self) -> "ControlNet":
        """Zero the weights and biases of the hint block's output conv and of
        every zero conv: the net adds nothing until trained (the JAX package's
        init)."""
        with torch.no_grad():
            for conv in (self.input_hint_block[-1], *self.zero_convs, self.middle_block_out):
                conv.weight.zero_()
                conv.bias.zero_()
        return self

    def forward(
        self, x: torch.Tensor, timesteps: torch.Tensor, context_emb: Optional[torch.Tensor],
        hint: torch.Tensor,
    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """x [B, h, w, latent_channels]; hint [B, h*2^n, w*2^n, 3]."""
        dtype = self.conv_in.weight.dtype
        if context_emb is not None:
            context_emb = context_emb.to(dtype)
        t = sinusoidal_time_proj(timesteps, self.ch0, flipped=self.flipped_time_embedding)
        t_emb = self.time_embedding[2](F.silu(self.time_embedding[0](t.to(dtype))))
        x = self.conv_in(x.to(dtype)) + self.input_hint_block(hint.to(dtype))
        residuals = [self.zero_convs[0](x)]
        for layers, zero_conv in zip(self.input_blocks, self.zero_convs[1:]):
            for layer in layers:
                x = _run(layer, x, t_emb, context_emb)
            residuals.append(zero_conv(x))
        for layer in self.middle_block:
            x = _run(layer, x, t_emb, context_emb)
        return tuple(residuals), self.middle_block_out(x)


def _run(layer: nn.Module, x, t_emb, context_emb):
    if isinstance(layer, ResBlock):
        return layer(x, t_emb)
    if isinstance(layer, SpatialTransformer):
        return layer(x, context_emb)
    return layer(x)


@torch.no_grad()
def init_controlnet_from_unet(unet: nn.Module, controlnet: ControlNet) -> ControlNet:
    """Copy the UNet's encoder weights into ``controlnet`` name for name (the
    hint block and the zero convs keep theirs), as the paper starts training."""
    own = controlnet.state_dict()
    for name, value in unet.state_dict().items():
        if name in own:
            own[name].copy_(value)
    return controlnet
