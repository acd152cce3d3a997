"""The reference's arithmetic: plain float32 PyTorch with TF32 off, and the
control's float8 (e4m3) rounding of every product's inputs.

The control is the reference put in the program's place one precision below
the configuration's bf16: each matrix product and convolution takes its
inputs rounded to float8 e4m3 with a per-tensor scale (amax / 448), and
accumulates in float32; so does each stage's output where the control hands
it on (``Prec.out``). Normalizations, softmax and the elementwise rest stay
float32, as the program keeps them in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Prec:
    """Shared by every layer of one reference model: ``fp8`` turns the control on."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to float8 e4m3 under the control, else as it is (float32)."""
        x = x.float()
        if not self.fp8:
            return x
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def out(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(x)


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 (the card would otherwise round the
    inputs of a float32 matmul or convolution to TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def linear(prec: Prec, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(prec.q(x), prec.q(w), None if b is None else b.float())


def conv_nhwc(prec: Prec, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """A convolution on channel-last [B, H, W, C] maps."""
    y = F.conv2d(prec.q(x).permute(0, 3, 1, 2), prec.q(w), None if b is None else b.float(), stride, padding)
    return y.permute(0, 2, 3, 1)


def attention(prec: Prec, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              mask: Optional[torch.Tensor] = None, rows: int = 1024) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, N, H, D] / [B, M, H, D] in float32,
    ``rows`` queries at a time (the scores of a 4096-token map would take
    gigabytes at once). ``mask`` [N, M] bool, True = masked out."""
    qh, kh, vh = (prec.q(t).permute(0, 2, 1, 3) for t in (q, k, v))
    out = []
    for i in range(0, qh.shape[2], rows):
        s = torch.matmul(qh[:, :, i:i + rows], kh.transpose(-1, -2)) * scale
        if mask is not None:
            s = s.masked_fill(mask[i:i + rows], torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1)
        out.append(torch.matmul(prec.q(p), vh))
    return torch.cat(out, dim=2).permute(0, 2, 1, 3)


def group_norm_nhwc(x: torch.Tensor, groups: int, w: torch.Tensor, b: torch.Tensor, eps: float,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) over [B, H, W, C] in float32, biased variance."""
    bsz, h, wd, c = x.shape
    g = x.float().reshape(bsz, h * wd, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(bsz, h, wd, c) * w.float() + b.float()
    return F.silu(y) if silu else y


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def time_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features [B, dim]: sin half, then cos half."""
    half = dim // 2
    freq = torch.exp(-math.log(max_period) / half * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freq[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
