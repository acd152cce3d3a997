"""Building blocks of the UNet and VAE (port of stable_diffusion_pytorch_tpu/models/blocks.py).

Activations are channel-last, [B, H, W, C], as in the JAX package. A contiguous
NHWC tensor permuted to NCHW is an NCHW tensor in ``channels_last`` memory
format, which cuDNN convolutions keep, so the convs below take and return NHWC
with no copies. Parameter names follow the reference torch modules
(``in_layers.0``, ``out_layers.3``, ``transformer_blocks.0.self_attn.to_q``,
...) so a reference-format state dict loads with ``strict=True``; modules that
hold no parameters (SiLU, Dropout) sit at their reference indices only to keep
that numbering.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from stable_diffusion_pytorch_tpu_torch.ops.attention import multi_head_attention
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import group_norm, group_norm_cat


def sinusoidal_time_proj(
    time_steps: torch.Tensor, emb_dim: int, max_len: int = 10000, flipped: bool = False
) -> torch.Tensor:
    """Sinusoidal timestep embedding -> [B, emb_dim] f32. ``flipped=True`` is
    the reference's sign-flipped frequencies (compat ``flipped_time_embedding``)."""
    half = emb_dim // 2
    sign = 1.0 if flipped else -1.0
    idx = torch.arange(half, dtype=torch.float32, device=time_steps.device)
    freq = torch.exp(sign * math.log(max_len) / half * idx)
    args = time_steps.float()[:, None] * freq[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class GaussianDistribution:
    """Diagonal Gaussian posterior over channel-last latents: ``moments``
    [B, h, w, 2*C] split along channels into (mean, log_var)."""

    def __init__(self, mean: torch.Tensor, log_var: torch.Tensor):
        self.mean = mean
        self.log_var = log_var

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "GaussianDistribution":
        mean, log_var = moments.chunk(2, dim=-1)
        return cls(mean, log_var)

    def sample(self, generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + eps * exp(log_var / 2), eps ~ N(0, I) from ``generator`` (on
        the mean's device) unless given."""
        std = torch.exp(0.5 * self.log_var)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
        return self.mean + eps.to(std.dtype) * std

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q || N(0, I)) summed over all but the batch dim -> [B] f32."""
        mean, log_var = self.mean.float(), self.log_var.float()
        return 0.5 * torch.sum(mean**2 + torch.exp(log_var) - 1.0 - log_var, dim=tuple(range(1, mean.dim())))


class GroupNorm(nn.Module):
    """GroupNorm(+SiLU) over channel-last input, through ops.groupnorm.

    ``forward(x, skip_cat)`` normalizes the virtual concat(x, skip_cat) with
    joint statistics. ``weight``/``bias`` stay float32 when the model is cast
    to bf16 (the kernels take f32 affine parameters, as the TPU kernel did)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(
        self, x: torch.Tensor, skip_cat: Optional[torch.Tensor] = None, silu: bool = False
    ) -> torch.Tensor:
        if skip_cat is not None:
            return group_norm_cat(
                x, skip_cat, self.weight, self.bias, self.num_groups, self.eps, silu
            )
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, silu)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channel-last [B, H, W, C] tensors (torch-style padding)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)


def conv1x1(in_ch: int, out_ch: int) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1)


class UpSample(nn.Module):
    """Nearest x2 upsample + 3x3 conv. The JAX package computes the same
    function through a phase decomposition (a FLOP trick, not ported)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = conv3x3(channels, out_channels or channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(up.permute(0, 2, 3, 1))


class DownSample(nn.Module):
    """Stride-2 3x3 conv, padding 1 (equal to the reference's conv + nearest x0.5)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None):
        super().__init__()
        self.conv = conv3x3(channels, out_channels or channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResBlock(nn.Module):
    """GN+SiLU+conv, + time projection, GN+SiLU+(dropout)+conv, 1x1 skip.

    ``skip_cat`` is a second input concatenated after ``x`` along channels
    (the UNet up-path skip). The concat stays virtual: the opening GroupNorm
    normalizes both parts with joint statistics (``group_norm_cat``), and the
    1x1 residual conv applies its kernel split in two."""

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        time_emb_dim: Optional[int] = None,
        groups: int = 2,
        dropout: float = 0.0,
    ):
        super().__init__()
        out_channels = out_channels or in_channels
        if in_channels % groups:
            raise ValueError(f"in_channels({in_channels}) must be divisible by groups({groups})")
        self.in_layers = nn.Sequential(
            GroupNorm(groups, in_channels), nn.SiLU(), conv3x3(in_channels, out_channels)
        )
        self.time_embedding = (
            nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, out_channels))
            if time_emb_dim is not None
            else None
        )
        self.out_layers = nn.Sequential(
            GroupNorm(groups, out_channels),
            nn.SiLU(),
            nn.Dropout(dropout),
            conv3x3(out_channels, out_channels),
        )
        self.skip_connection = (
            conv1x1(in_channels, out_channels) if in_channels != out_channels else None
        )

    def forward(
        self,
        x: torch.Tensor,
        time_emb: Optional[torch.Tensor] = None,
        skip_cat: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        h = self.in_layers[0](x, skip_cat, silu=True)
        h = self.in_layers[2](h)
        if self.time_embedding is not None and time_emb is not None:
            t = self.time_embedding[1](F.silu(time_emb.to(h.dtype)))
            h = h + t[:, None, None, :]
        h = self.out_layers[0](h, silu=True)
        h = self.out_layers[2](h)
        h = self.out_layers[3](h)

        if skip_cat is None:
            res = x if self.skip_connection is None else self.skip_connection(x)
            return h + res
        c1 = x.shape[-1]
        if self.skip_connection is not None:
            w = self.skip_connection.weight[:, :, 0, 0]  # [C_out, C_in]
            res = F.linear(x, w[:, :c1], self.skip_connection.bias) + F.linear(skip_cat, w[:, c1:])
            return h + res
        return torch.cat([h[..., :c1] + x, h[..., c1:] + skip_cat], dim=-1)


class CrossAttention(nn.Module):
    """Multi-head self/cross attention on [B, N, C] tokens or [B, H, W, C] maps.

    Self-attention concatenates the to_q/to_k/to_v weights and runs one matmul
    (the JAX package's fused QKV); the q/k/v views of its output go to the
    kernel as they are, strided. Under tensor parallelism (``tp``, set by
    ``parallel/tensor_parallel.py:shard_unet``) the weights hold this rank's
    heads and the output projection's matching columns: the kernel runs on
    the local heads, the partial outputs are summed over the model group and
    the bias is added once, after the sum."""

    tp = None

    def __init__(
        self,
        query_dim: int,
        context_dim: Optional[int] = None,
        n_heads: int = 1,
        d_head: int = 1,
        dropout: float = 0.0,
    ):
        super().__init__()
        self.n_heads = n_heads
        self.d_head = d_head
        d_model = n_heads * d_head
        context_dim = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, d_model, bias=False)
        self.to_k = nn.Linear(context_dim, d_model, bias=False)
        self.to_v = nn.Linear(context_dim, d_model, bias=False)
        self.out = nn.Sequential(nn.Linear(d_model, query_dim), nn.Dropout(dropout))

    def forward(
        self,
        query: torch.Tensor,
        context_emb: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        shape = query.shape
        if query.dim() == 4:
            query = query.reshape(shape[0], shape[1] * shape[2], shape[3])
        b, n, _ = query.shape
        tp = self.tp
        heads = self.n_heads if tp is None else self.n_heads // tp.size
        d_model = heads * self.d_head
        if tp is not None:
            query, context_emb = tp.enter(query), tp.enter(context_emb)
        if context_emb is None:
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight], dim=0)
            q, k, v = F.linear(query, w).split(d_model, dim=-1)
        else:
            context_emb = context_emb.to(query.dtype)
            q, k, v = self.to_q(query), self.to_k(context_emb), self.to_v(context_emb)
        m = k.shape[1]
        out = multi_head_attention(
            q.view(b, n, heads, self.d_head),
            k.view(b, m, heads, self.d_head),
            v.view(b, m, heads, self.d_head),
            scale=1.0 / math.sqrt(self.d_head),
            mask=mask,
        )
        out = out.reshape(b, n, d_model)
        if tp is None:
            out = self.out(out)
        else:
            proj = self.out[0]
            out = tp.exit(F.linear(out, proj.weight))
            out = self.out[1](out + proj.bias.to(out.dtype))
        return out.reshape(shape[:-1] + (out.shape[-1],))


class GEGLU(nn.Module):
    """(xW + b) * GELU(xV + c), exact (erf) GELU."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.proj = nn.Linear(in_features, 2 * out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU -> Dropout -> Linear. Under tensor parallelism (``tp``) the GEGLU
    holds this rank's slice of the value and of the gate and the down
    projection the matching columns: the partial outputs are summed over the
    model group, then the bias is added once."""

    tp = None

    def __init__(self, d_model: int, dim_mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            GEGLU(d_model, dim_mult * d_model),
            nn.Dropout(dropout),
            nn.Linear(dim_mult * d_model, d_model),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            return self.net(x)
        down = self.net[2]
        out = tp.exit(F.linear(self.net[1](self.net[0](tp.enter(x))), down.weight))
        return out + down.bias.to(out.dtype)


class BasicTransformerBlock(nn.Module):
    """Post-norm block, norm(x + sublayer(x)): self-attn, cross-attn, feed-forward."""

    def __init__(
        self, d_model: int, n_heads: int, d_head: int, dropout: float = 0.0, context_dim: int = 768
    ):
        super().__init__()
        self.self_attn = CrossAttention(d_model, d_model, n_heads, d_head, dropout)
        self.cross_attn = CrossAttention(d_model, context_dim, n_heads, d_head, dropout)
        self.ffn = FeedForward(d_model, dropout=dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, context_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        x = self.norm2(x + self.cross_attn(x, context_emb))
        return self.norm3(x + self.ffn(x))


class SpatialTransformer(nn.Module):
    """GN -> 1x1 proj_in -> tokens -> transformer blocks -> 1x1 proj_out -> + input."""

    def __init__(
        self,
        in_channels: int,
        n_heads: int,
        d_head: int,
        n_layers: int = 1,
        dropout: float = 0.0,
        context_dim: Optional[int] = None,
        groups: int = 2,
    ):
        super().__init__()
        self.norm = GroupNorm(groups, in_channels)
        self.proj_in = conv1x1(in_channels, in_channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(in_channels, n_heads, d_head, dropout, context_dim)
            for _ in range(n_layers)
        )
        self.proj_out = conv1x1(in_channels, in_channels)

    def forward(self, x: torch.Tensor, context_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context_emb)
        return self.proj_out(y.reshape(b, h, w, c)) + x
