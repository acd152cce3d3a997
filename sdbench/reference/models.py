"""Plain float32 copies of the three models the cells run: the latent
diffusion UNet, the KL-f8 autoencoder and the CLIP ViT-L/14 text tower.

They hold their parameters under the reference-format names (the from-scratch
reference repository's torch names for the UNet, diffusers' for the VAE,
Hugging Face's ``text_model.*`` names for the text tower), so one state dict made from the
seed loads into them and into the program with ``strict=True``. Activations
are channel-last [B, H, W, C]. At the widths of each configuration file:

- UNet: ResBlocks (GroupNorm+SiLU, 3x3 conv, + the time projection,
  GroupNorm+SiLU, 3x3 conv, 1x1 skip where the width changes); spatial
  transformers (GroupNorm, 1x1 proj_in, post-norm blocks of self attention,
  cross attention on the text context and a GEGLU feed-forward, 1x1
  proj_out, + input); stride-2 conv down, nearest x2 + conv up; the up path
  concatenates each skip after its input.
- VAE: the published KL-f8 autoencoder in diffusers' layout and names
  (``encoder.down_blocks.0.resnets.0.conv1``, ...): residual blocks without
  time (norms at eps 1e-6), a stride-2 conv after a far-edge pad, a mid
  block of resnet, a residual single-head attention after a GroupNorm, and
  resnet at the widest level, the decoder starting there and walking the
  levels in reverse with one resnet more each; quant and post-quant 1x1
  convs; the posterior is (mean, log variance clamped to [-30, 20]).
- Text tower: pre-norm CLIP layers, causal mask, quick-GELU, final LayerNorm.

Nothing here is imported from the program; every parameter is created on the
``meta`` device and replaced by the loaded tensors (``load_state_dict(...,
assign=True)``), so building a model allocates nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from reference.numerics import (
    Prec,
    attention,
    conv_nhwc,
    group_norm_nhwc,
    layer_norm,
    linear,
    time_embedding,
)


VAE_EPS = 1e-6


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"), requires_grad=False)


class Lin(nn.Module):
    def __init__(self, prec: Prec, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.prec = prec
        self.weight = _param(n_out, n_in)
        self.bias = _param(n_out) if bias else None

    def forward(self, x):
        return linear(self.prec, x, self.weight, self.bias)


class Conv(nn.Module):
    def __init__(self, prec: Prec, n_in: int, n_out: int, k: int, stride: int = 1):
        super().__init__()
        self.prec = prec
        self.stride, self.padding = stride, k // 2
        self.weight = _param(n_out, n_in, k, k)
        self.bias = _param(n_out)

    def forward(self, x):
        return conv_nhwc(self.prec, x, self.weight, self.bias, self.stride, self.padding)


class GroupNorm(nn.Module):
    """GroupNorm over channel-last maps; ``forward(x, skip)`` normalizes
    concat(x, skip) along channels, ``silu`` applies SiLU after."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = _param(channels)
        self.bias = _param(channels)

    def forward(self, x, skip=None, silu=False):
        if skip is not None:
            x = torch.cat([x.float(), skip.float()], dim=-1)
        return group_norm_nhwc(x, self.groups, self.weight, self.bias, self.eps, silu)


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = _param(d)
        self.bias = _param(d)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = _param(n, d)


class ResBlock(nn.Module):
    def __init__(self, prec, c_in, c_out=None, t_dim=None, groups=32):
        super().__init__()
        c_out = c_out or c_in
        self.in_layers = nn.Sequential(GroupNorm(groups, c_in), nn.SiLU(), Conv(prec, c_in, c_out, 3))
        self.time_embedding = nn.Sequential(nn.SiLU(), Lin(prec, t_dim, c_out)) if t_dim else None
        self.out_layers = nn.Sequential(GroupNorm(groups, c_out), nn.SiLU(), nn.Dropout(0.0),
                                        Conv(prec, c_out, c_out, 3))
        self.skip_connection = Conv(prec, c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, t_emb=None, skip=None):
        h = self.in_layers[2](self.in_layers[0](x, skip, silu=True))
        if self.time_embedding is not None and t_emb is not None:
            h = h + self.time_embedding[1](F.silu(t_emb))[:, None, None, :]
        h = self.out_layers[3](self.out_layers[0](h, silu=True))
        if skip is not None:
            x = torch.cat([x.float(), skip.float()], dim=-1)
        return h + (x.float() if self.skip_connection is None else self.skip_connection(x))


class CrossAttention(nn.Module):
    """Multi-head attention on [B, N, C] tokens or [B, H, W, C] maps, no mask."""

    def __init__(self, prec, query_dim, context_dim=None, n_heads=1, d_head=1):
        super().__init__()
        self.prec, self.n_heads, self.d_head = prec, n_heads, d_head
        d = n_heads * d_head
        self.to_q = Lin(prec, query_dim, d, bias=False)
        self.to_k = Lin(prec, context_dim or query_dim, d, bias=False)
        self.to_v = Lin(prec, context_dim or query_dim, d, bias=False)
        self.out = nn.Sequential(Lin(prec, d, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None):
        shape = x.shape
        x = x.reshape(shape[0], -1, shape[-1])
        ctx = x if context is None else context
        b, n, m = x.shape[0], x.shape[1], ctx.shape[1]
        q = self.to_q(x).view(b, n, self.n_heads, self.d_head)
        k = self.to_k(ctx).view(b, m, self.n_heads, self.d_head)
        v = self.to_v(ctx).view(b, m, self.n_heads, self.d_head)
        o = attention(self.prec, q, k, v, 1.0 / math.sqrt(self.d_head)).reshape(b, n, -1)
        return self.out[0](o).reshape(shape[:-1] + (-1,))


class GEGLU(nn.Module):
    def __init__(self, prec, d_in, d_out):
        super().__init__()
        self.proj = Lin(prec, d_in, 2 * d_out)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, prec, d, mult=4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(prec, d, mult * d), nn.Dropout(0.0), Lin(prec, mult * d, d))

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    """Post-norm: norm(x + sublayer(x)) for self attention, cross attention, feed-forward."""

    def __init__(self, prec, d, n_heads, d_head, context_dim):
        super().__init__()
        self.self_attn = CrossAttention(prec, d, d, n_heads, d_head)
        self.cross_attn = CrossAttention(prec, d, context_dim, n_heads, d_head)
        self.ffn = FeedForward(prec, d)
        self.norm1, self.norm2, self.norm3 = LayerNorm(d), LayerNorm(d), LayerNorm(d)

    def forward(self, x, context):
        x = self.norm1(x + self.self_attn(x))
        x = self.norm2(x + self.cross_attn(x, context))
        return self.norm3(x + self.ffn(x))


class SpatialTransformer(nn.Module):
    def __init__(self, prec, c, n_heads, d_head, n_layers, context_dim, groups):
        super().__init__()
        self.norm = GroupNorm(groups, c)
        self.proj_in = Conv(prec, c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(prec, c, n_heads, d_head, context_dim) for _ in range(n_layers))
        self.proj_out = Conv(prec, c, c, 1)

    def forward(self, x, context):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context)
        return self.proj_out(y.reshape(b, h, w, c)) + x.float()


class Down(nn.Module):
    def __init__(self, prec, c):
        super().__init__()
        self.conv = Conv(prec, c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(x)


class Up(nn.Module):
    def __init__(self, prec, c):
        super().__init__()
        self.conv = Conv(prec, c, c, 3)

    def forward(self, x):
        up = F.interpolate(x.float().permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self.conv(up.permute(0, 2, 3, 1))


def _encoder_plan(ch0: int, channels: Sequence[int], n_res: int, attn_levels: Optional[Sequence[int]]):
    """(blocks, skip widths, bottleneck width, width of the last attention
    level, attention multiplier at the bottleneck); a block is ("res", in,
    out, attn) or ("down", width)."""
    blocks, skips, c, mult, attn_src = [], [ch0], ch0, 1, None
    for level, width in enumerate(channels):
        for _ in range(n_res):
            attn = attn_levels is not None and mult in attn_levels
            attn_src = width if attn else attn_src
            blocks.append(("res", c, width, attn))
            c = width
            skips.append(c)
        if level != len(channels) - 1:
            blocks.append(("down", c))
            skips.append(c)
            mult *= 2
    return blocks, skips, c, attn_src, mult


def _decoder_plan(channels, n_res, attn_levels, skips, c, mult):
    """("res", in + skip, out, attn, upsample) for each up-path block."""
    blocks, skips = [], list(skips)
    for level in reversed(range(len(channels))):
        for i in range(n_res + 1):
            skip = skips.pop() if skips else 0
            attn = attn_levels is not None and mult in attn_levels
            up = level != 0 and i == n_res
            blocks.append(("res", c + skip, channels[level], attn, up))
            c = channels[level]
            if up and mult:
                mult //= 2
    return blocks, c


class UNet(nn.Module):
    """eps(x [B, h, w, 4], t [B], context [B, S, 768]) -> [B, h, w, 4], float32."""

    def __init__(self, unet: dict, latent_channels: int, groups: int, prec: Optional[Prec] = None):
        super().__init__()
        self.prec = prec = prec or Prec()
        ch = list(unet["channels_list"])
        ch0, heads, n_res = ch[0], unet["n_heads"], unet["num_res_blocks"]
        t_dim = unet.get("time_emb_dim") or 4 * ch0
        ctx_dim, layers, attn_levels = unet["context_dim"], unet["n_layers"], unet["attention_resolutions"]
        self.ch0 = ch0

        def st(c, d_head):
            return SpatialTransformer(prec, c, heads, d_head, layers, ctx_dim, groups)

        self.time_embedding = nn.Sequential(Lin(prec, ch0, t_dim), nn.SiLU(), Lin(prec, t_dim, t_dim))
        self.conv_in = Conv(prec, latent_channels, ch0, 3)
        plan, skips, mid, attn_src, mult = _encoder_plan(ch0, ch, n_res, attn_levels)
        self.input_blocks = nn.ModuleList()
        for blk in plan:
            if blk[0] == "res":
                mods = [ResBlock(prec, blk[1], blk[2], t_dim, groups)]
                if blk[3]:
                    mods.append(st(blk[2], blk[2] // heads))
            else:
                mods = [Down(prec, blk[1])]
            self.input_blocks.append(nn.ModuleList(mods))
        self.middle_block = nn.ModuleList([ResBlock(prec, mid, mid, t_dim, groups),
                                           st(mid, (attn_src or mid) // heads),
                                           ResBlock(prec, mid, mid, t_dim, groups)])
        out_plan, c_out = _decoder_plan(ch, n_res, attn_levels, skips, mid, mult)
        self.output_blocks = nn.ModuleList()
        for _, c_in, c, attn, up in out_plan:
            mods = [ResBlock(prec, c_in, c, t_dim, groups)]
            if attn:
                mods.append(st(c, c // heads))
            if up:
                mods.append(nn.ModuleList([Up(prec, c)]))
            self.output_blocks.append(nn.ModuleList(mods))
        self.out = nn.Sequential(GroupNorm(groups, c_out), nn.SiLU(), Conv(prec, c_out, latent_channels, 3))

    def _layer(self, layer, x, t_emb, context):
        if isinstance(layer, ResBlock):
            return layer(x, t_emb)
        if isinstance(layer, SpatialTransformer):
            return layer(x, context)
        if isinstance(layer, nn.ModuleList):
            return layer[0](x)
        return layer(x)

    def forward(self, x, t, context):
        t_emb = self.time_embedding[2](F.silu(self.time_embedding[0](time_embedding(t, self.ch0))))
        context = context.float()
        x = self.conv_in(x.float())
        skips = [x]
        for mods in self.input_blocks:
            for layer in mods:
                x = self._layer(layer, x, t_emb, context)
            skips.append(x)
        for layer in self.middle_block:
            x = self._layer(layer, x, t_emb, context)
        for mods in self.output_blocks:
            x = mods[0](x, t_emb, skip=skips.pop())
            for layer in mods[1:]:
                x = self._layer(layer, x, t_emb, context)
        return self.out[2](self.out[0](x, silu=True))


class ResnetBlock(nn.Module):
    """The autoencoder's residual block: GroupNorm+SiLU, 3x3 conv,
    GroupNorm+SiLU, 3x3 conv, plus the input (through a 1x1 conv where the
    width changes); every norm's eps 1e-6."""

    def __init__(self, prec, c_in, c_out, groups):
        super().__init__()
        self.norm1 = GroupNorm(groups, c_in, eps=VAE_EPS)
        self.conv1 = Conv(prec, c_in, c_out, 3)
        self.norm2 = GroupNorm(groups, c_out, eps=VAE_EPS)
        self.conv2 = Conv(prec, c_out, c_out, 3)
        self.conv_shortcut = Conv(prec, c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x, silu=True)), silu=True))
        return (x.float() if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class VAEAttention(nn.Module):
    """The mid block's attention: GroupNorm, one head as wide as the map over
    its h*w tokens (biased q, k, v and out projections), plus the input."""

    def __init__(self, prec, c, groups):
        super().__init__()
        self.prec, self.n_heads, self.d_head = prec, 1, c
        self.group_norm = GroupNorm(groups, c, eps=VAE_EPS)
        self.to_q, self.to_k, self.to_v = Lin(prec, c, c), Lin(prec, c, c), Lin(prec, c, c)
        self.to_out = nn.ModuleList([Lin(prec, c, c)])

    def forward(self, x):
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = (p(t).view(b, h * w, 1, c) for p in (self.to_q, self.to_k, self.to_v))
        o = attention(self.prec, q, k, v, 1.0 / math.sqrt(c)).reshape(b, h * w, c)
        return x.float() + self.to_out[0](o).reshape(b, h, w, c)


class MidBlock(nn.Module):
    def __init__(self, prec, c, groups):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(prec, c, c, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(prec, c, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Downsample(nn.Module):
    """Pad one row and one column at the far edges, 3x3 stride-2 conv."""

    def __init__(self, prec, c):
        super().__init__()
        self.conv = Conv(prec, c, c, 3, stride=2)
        self.conv.padding = 0

    def forward(self, x):
        return self.conv(F.pad(x.float(), (0, 0, 0, 1, 0, 1)))


class Level(nn.Module):
    """One down or up block: its resnets, then its resampler where it has one
    (held under ``downsamplers`` or ``upsamplers``)."""

    def __init__(self, resnets, sampler, kind):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.kind = kind
        if sampler is not None:
            setattr(self, kind, nn.ModuleList([sampler]))

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        samplers = getattr(self, self.kind, None)
        return x if samplers is None else samplers[0](x)


class Encoder(nn.Module):
    def __init__(self, prec, c_in, latent, channels, n_res, groups):
        super().__init__()
        self.conv_in = Conv(prec, c_in, channels[0], 3)
        self.down_blocks, c = nn.ModuleList(), channels[0]
        for i, width in enumerate(channels):
            resnets = [ResnetBlock(prec, c if j == 0 else width, width, groups) for j in range(n_res)]
            last = i == len(channels) - 1
            self.down_blocks.append(Level(resnets, None if last else Downsample(prec, width), "downsamplers"))
            c = width
        self.mid_block = MidBlock(prec, c, groups)
        self.conv_norm_out = GroupNorm(groups, c, eps=VAE_EPS)
        self.conv_out = Conv(prec, c, 2 * latent, 3)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x), silu=True))


class Decoder(nn.Module):
    def __init__(self, prec, latent, c_out, channels, n_res, groups):
        super().__init__()
        widths = list(reversed(channels))
        self.conv_in = Conv(prec, latent, widths[0], 3)
        self.mid_block = MidBlock(prec, widths[0], groups)
        self.up_blocks, c = nn.ModuleList(), widths[0]
        for i, width in enumerate(widths):
            resnets = [ResnetBlock(prec, c if j == 0 else width, width, groups) for j in range(n_res + 1)]
            last = i == len(widths) - 1
            self.up_blocks.append(Level(resnets, None if last else Up(prec, width), "upsamplers"))
            c = width
        self.conv_norm_out = GroupNorm(groups, c, eps=VAE_EPS)
        self.conv_out = Conv(prec, c, c_out, 3)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class AutoEncoderKL(nn.Module):
    """encode(img [B, H, W, 3]) -> (mean, log_var clamped to [-30, 20]);
    decode(z [B, h, w, 4]) -> img."""

    def __init__(self, vae: dict, prec: Optional[Prec] = None):
        super().__init__()
        self.prec = prec = prec or Prec()
        ch, n_res, groups = list(vae["autoencoder_channels_list"]), vae["autoencoder_num_res_blocks"], vae["groups"]
        latent, c_in = vae["latent_channels"], vae["in_channels"]
        self.encoder = Encoder(prec, c_in, latent, ch, n_res, groups)
        self.decoder = Decoder(prec, latent, vae["out_channels"], ch, n_res, groups)
        self.quant_conv = Conv(prec, 2 * latent, 2 * latent, 1)
        self.post_quant_conv = Conv(prec, latent, latent, 1)
        self.factor = 2 ** (len(ch) - 1)

    def encode(self, img):
        mean, log_var = self.quant_conv(self.encoder(img.float())).chunk(2, dim=-1)
        return mean, log_var.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.float()))


class CLIPAttention(nn.Module):
    def __init__(self, prec, d, heads):
        super().__init__()
        self.prec, self.heads = prec, heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Lin(prec, d, d) for _ in range(4))

    def forward(self, x, mask):
        b, s, d = x.shape
        dh = d // self.heads
        q, k, v = (p(x).view(b, s, self.heads, dh) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention(self.prec, q, k, v, dh ** -0.5, mask).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, prec, d, inner):
        super().__init__()
        self.fc1, self.fc2 = Lin(prec, d, inner), Lin(prec, inner, d)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPLayer(nn.Module):
    def __init__(self, prec, d, heads, inner):
        super().__init__()
        self.self_attn = CLIPAttention(prec, d, heads)
        self.layer_norm1 = LayerNorm(d)
        self.mlp = CLIPMLP(prec, d, inner)
        self.layer_norm2 = LayerNorm(d)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Holder(nn.Module):
    pass


class TextTower(nn.Module):
    """CLIP text transformer: ids [B, S] -> last hidden state [B, S, d]."""

    def __init__(self, clip: dict, prec: Optional[Prec] = None):
        super().__init__()
        self.prec = prec = prec or Prec()
        d, layers, heads = clip["d_model"], clip["n_layers"], clip["n_heads"]
        tm = self.text_model = _Holder()
        tm.embeddings = _Holder()
        tm.embeddings.token_embedding = Embedding(clip["vocab_size"], d)
        tm.embeddings.position_embedding = Embedding(clip["max_seq_len"], d)
        tm.encoder = _Holder()
        tm.encoder.layers = nn.ModuleList(CLIPLayer(prec, d, heads, clip["intermediate"]) for _ in range(layers))
        tm.final_layer_norm = LayerNorm(d)

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        emb = tm.embeddings
        x = emb.token_embedding.weight.float()[ids.long()] + emb.position_embedding.weight.float()[:s]
        mask = torch.triu(torch.ones((s, s), dtype=torch.bool, device=ids.device), diagonal=1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


def build(kind: str, config: dict, prec: Optional[Prec] = None) -> nn.Module:
    """``kind`` "unet", "vae" or "clip" at the widths of a configuration file's dict."""
    if kind == "unet":
        return UNet(config["unet"], config["vae"]["latent_channels"], config["vae"]["groups"], prec)
    if kind == "vae":
        return AutoEncoderKL(config["vae"], prec)
    if kind == "clip":
        return TextTower(config["clip"], prec)
    raise ValueError(f"unknown model {kind!r}")


def load(module: nn.Module, state: dict, trainable: bool = False) -> nn.Module:
    """Every parameter from ``state`` in float32, strictly by name."""
    module.load_state_dict({k: v.float() for k, v in state.items()}, strict=True, assign=True)
    for p in module.parameters():
        p.requires_grad_(trainable)
    return module
