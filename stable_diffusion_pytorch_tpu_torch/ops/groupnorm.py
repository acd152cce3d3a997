"""GroupNorm (+ optional fused SiLU) over channel-last tensors.

Port of stable_diffusion_pytorch_tpu/ops/groupnorm.py. ``x`` is [B, ..., C];
statistics are f32 with var = E[x^2] - E[x]^2 and eps 1e-5, as in the JAX
package. :func:`group_norm` and :func:`group_norm_cat` dispatch to the kernel
wrappers in ``ops/fused_groupnorm.py``, which take every shape (there is no
eligibility gate like the TPU's C % 128 == 0); the ``xla_*`` functions are the
plain versions those wrappers run for CPU tensors.
"""

from __future__ import annotations

import torch


def group_stats(sums: torch.Tensor, sumsq: torch.Tensor, num_groups: int, n: int, eps: float):
    """Per-channel [B, C] sums -> per-channel mean and 1/std [B, 1, C]."""
    b, c = sums.shape
    cpg = c // num_groups
    mean_g = sums.view(b, num_groups, cpg).sum(-1) / n
    var_g = sumsq.view(b, num_groups, cpg).sum(-1) / n - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cpg, dim=1)[:, None, :]
    inv_c = inv_g.repeat_interleave(cpg, dim=1)[:, None, :]
    return mean_c, inv_c


def xla_group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """Plain GroupNorm(+SiLU) of channel-last x, matching torch.nn.GroupNorm."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    b = x.shape[0]
    xf = x.float().reshape(b, -1, c)
    n = xf.shape[1] * (c // num_groups)
    mean_c, inv_c = group_stats(xf.sum(1), (xf * xf).sum(1), num_groups, n, eps)
    y = (xf - mean_c) * inv_c * scale.float() + bias.float()
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(x.dtype)


def xla_group_norm_cat(
    x: torch.Tensor,
    s: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """Plain GroupNorm(+SiLU) of concat(x, s) along channels with joint group
    statistics (groups may straddle the boundary between the two parts)."""
    c1, c2 = x.shape[-1], s.shape[-1]
    c = c1 + c2
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if x.shape[:-1] != s.shape[:-1]:
        raise ValueError(f"shapes differ outside channels: {x.shape} vs {s.shape}")
    b = x.shape[0]
    xf = x.float().reshape(b, -1, c1)
    sf = s.float().reshape(b, -1, c2)
    n = xf.shape[1] * (c // num_groups)
    sums = torch.cat([xf.sum(1), sf.sum(1)], dim=-1)
    sumsq = torch.cat([(xf * xf).sum(1), (sf * sf).sum(1)], dim=-1)
    mean_c, inv_c = group_stats(sums, sumsq, num_groups, n, eps)
    y = (torch.cat([xf, sf], dim=-1) - mean_c) * inv_c * scale.float() + bias.float()
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape[:-1] + (c,)).to(x.dtype)


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm

    return fused_group_norm(x.contiguous(), scale, bias, num_groups, eps, apply_silu)


def group_norm_cat(
    x: torch.Tensor,
    s: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+SiLU) of the virtual concat(x, s): returns the normalized
    [..., C1+C2] tensor; the raw concatenation is never stored."""
    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm_cat

    return fused_group_norm_cat(
        x.contiguous(), s.contiguous(), scale, bias, num_groups, eps, apply_silu
    )
