"""GroupNorm(+SiLU) kernels for Hopper: wrappers around the Triton kernels.

Replaces the Pallas TPU kernels ``stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py``
``_gn_kernel`` (launched from ``pallas_group_norm``) and ``_gn_cat_kernel``
(from ``pallas_group_norm_cat``). The kernels are in ``ops/groupnorm_triton.py``.

What bounds them on this card: no matrix product, about 10 FLOPs per element,
so memory bandwidth. The floor is one read of x for the statistics plus one
read of x and one write of y for the normalize pass.

What the design does about it, and what did not carry over from the TPU:

- The TPU kernel holds one whole batch element in VMEM (hence its 1.8 MB
  gate). A Hopper block has at most 227 KB of shared memory, the UNet's
  320 x 64^2 bf16 map is 2.6 MB, the VAE decoder normalizes 128 x 512^2 maps,
  and one block per image would leave most of the 132 SMs idle. So the
  statistics are split across many programs (per-channel partial sums over a
  split of the rows, coalesced along channels), a small second kernel reduces
  each group's partials to mean and 1/std, and a separate pass normalizes.
  Nothing is held on chip across passes; the second read of x is the price.
- Groups of 10 (320/32), 4 (128/32), 60 or 30 channels are no power of two and
  a group of the up-path concat straddles the boundary at channel 1280 (or
  640). Statistics are kept per channel until ``gn_finalize``, which sums a
  group's channel range regardless of which part each channel came from, so
  joint statistics need no special case. The TPU's [C, G] membership-matrix
  trick was a lane-layout device and is not used.
- The concat variant runs the partial-sum and normalize kernels once per part
  with a channel offset and writes only the normalized concat: the raw concat
  is never stored.

Every shape on the path is taken: any C, any number of groups that divides C,
any spatial size. The plain versions are ``ops/groupnorm.py:xla_group_norm``
and ``xla_group_norm_cat``; the wrappers take them only for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from stable_diffusion_pytorch_tpu_torch.ops import native
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import (
    xla_group_norm,
    xla_group_norm_cat,
)

LAUNCHES = native.counter("group_norm")
CAT_LAUNCHES = native.counter("group_norm_cat")

_TILE = 4096           # elements per program in the row/channel passes
_MAX_SPLITS = 64       # row splits of the statistics pass


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check(parts, scale, bias, num_groups) -> None:
    x = parts[0]
    if not x.is_cuda or any(p.device != x.device for p in parts):
        raise ValueError(f"group norm kernel: inputs must share one CUDA device ({x.device})")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(p.dtype != x.dtype for p in parts):
        raise TypeError(f"group norm kernel takes float32 or bfloat16 inputs ({x.dtype})")
    if x.dim() < 2 or any(p.shape[:-1] != x.shape[:-1] for p in parts):
        raise ValueError(f"group norm kernel: [B, ..., C] inputs with equal [B, ...] "
                         f"({[tuple(p.shape) for p in parts]})")
    if any(not p.is_contiguous() for p in parts):
        raise ValueError("group norm kernel: inputs must be contiguous")
    c = sum(p.shape[-1] for p in parts)
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"group norm kernel: {name} must be contiguous float32 [{c}] "
                             f"on {x.device} (got {t.dtype} {tuple(t.shape)} on {t.device})")


def _launch(parts, scale, bias, num_groups, eps, apply_silu) -> torch.Tensor:
    """Run the three kernels over the channel concat of ``parts`` (1 or 2)."""
    native.import_triton()
    from stable_diffusion_pytorch_tpu_torch.ops import groupnorm_triton as k

    x = parts[0]
    b = x.shape[0]
    s = math.prod(x.shape[1:-1])
    c = sum(p.shape[-1] for p in parts)
    cpg = c // num_groups
    out = torch.empty(x.shape[:-1] + (c,), dtype=x.dtype, device=x.device)

    widths = [p.shape[-1] for p in parts]
    block_c = min(128, _next_pow2(max(widths)))
    block_s = max(16, _TILE // block_c)
    n_split = min(_MAX_SPLITS, _cdiv(s, block_s))
    rows_per_prog = _cdiv(_cdiv(s, n_split), block_s) * block_s
    n_split = _cdiv(s, rows_per_prog)

    psum = torch.empty((b, n_split, c), dtype=torch.float32, device=x.device)
    psq = torch.empty_like(psum)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)

    with torch.cuda.device(x.device):
        offset = 0
        for p, cp in zip(parts, widths):
            k.gn_partial_sums[(b, n_split, _cdiv(cp, block_c))](
                p, psum, psq, s, cp, c, offset, rows_per_prog, n_split,
                BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4,
            )
            offset += cp
        k.gn_finalize[(b, num_groups)](
            psum, psq, mean, rstd, n_split, c, cpg, num_groups, float(s * cpg), float(eps),
            BLOCK_P=_next_pow2(n_split), BLOCK_G=_next_pow2(cpg), num_warps=4,
        )
        offset = 0
        for p, cp in zip(parts, widths):
            k.gn_normalize[(b, _cdiv(s, block_s), _cdiv(cp, block_c))](
                p, out, mean, rstd, scale, bias, s, cp, c, offset, cpg, num_groups,
                APPLY_SILU=bool(apply_silu), BLOCK_S=block_s, BLOCK_C=block_c, num_warps=4,
            )
            offset += cp
    return out


def fused_group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+SiLU) of channel-last x [B, ..., C] (K6).

    CPU tensors run the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return xla_group_norm(x, scale, bias, num_groups, eps, apply_silu)
    _check([x], scale, bias, num_groups)
    out = _launch([x], scale, bias, num_groups, eps, apply_silu)
    LAUNCHES.hit((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1], num_groups,
                  bool(apply_silu), str(x.dtype)))
    return out


def fused_group_norm_cat(
    x: torch.Tensor,
    s: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+SiLU) of the virtual concat(x, s) -> [..., C1+C2] (K8).

    CPU tensors run the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu" and s.device.type == "cpu":
        return xla_group_norm_cat(x, s, scale, bias, num_groups, eps, apply_silu)
    _check([x, s], scale, bias, num_groups)
    out = _launch([x, s], scale, bias, num_groups, eps, apply_silu)
    CAT_LAUNCHES.hit((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1], s.shape[-1],
                      num_groups, bool(apply_silu), str(x.dtype)))
    return out
