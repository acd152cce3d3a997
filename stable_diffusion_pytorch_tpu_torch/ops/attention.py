"""Attention dispatch (port of stable_diffusion_pytorch_tpu/ops/attention.py).

Layout, as in the JAX package: q [B, N, H, D], k/v [B, M, H, D] -> [B, N, H, D].
Unmasked attention (UNet self/cross attention, the VAE bottlenecks, the
CLIP vision tower) goes to the flash-attention kernel wrapper; masked
attention (the CLIP text tower's causal mask) never reached the TPU kernel
either and runs as :func:`xla_attention` on every device.
"""

from __future__ import annotations

from typing import Optional

import torch


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention: f32 scores -> f32 softmax -> P in the input dtype -> P.V.

    ``mask`` is boolean, broadcastable to [B, H, N, M], True = masked out (the
    JAX package's convention, filled with the f32 minimum)."""
    dtype = q.dtype
    sim = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if mask is not None:
        sim = sim.masked_fill(mask, torch.finfo(torch.float32).min)
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.to(dtype).float(), v.float())
    return out.to(dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Entry point of every attention layer: q [B,N,H,D], k/v [B,M,H,D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is not None:
        return xla_attention(q, k, v, scale, mask)
    from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, scale)
