"""GroupNorm(+SiLU) kernels for Hopper: wrappers around the Triton kernels, and
the autograd Functions that pair each forward with its backward.

Replaces the Pallas TPU kernels ``stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py``
``_gn_kernel`` (launched from ``pallas_group_norm``), ``_gn_cat_kernel``
(from ``pallas_group_norm_cat``) and ``_gn_bwd_kernel`` (from
``pallas_group_norm_bwd``, the backward of ``_gn_kernel``). The kernels are in
``ops/groupnorm_triton.py``. The JAX package has no kernel for the concat
form's backward (its custom VJP differentiates ``xla_group_norm_cat``); here
it runs the ``_gn_bwd_kernel`` port over the two parts with joint statistics,
the way the concat forward reuses the forward's kernels.

What bounds them on this card: no matrix product, about 10 FLOPs per element,
so memory bandwidth. The forward's floor is one read of x for the statistics
plus one read of x and one write of y for the normalize pass. The backward
reads x and dy twice (partial sums, then dx) and writes dx once; it takes
each group's mean and 1/std from the forward instead of recomputing them.

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
any spatial size. The plain versions are ``ops/groupnorm.py:xla_group_norm``,
``xla_group_norm_cat`` and :func:`group_norm_bwd_plain`; the wrappers take
them only for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from stable_diffusion_pytorch_tpu_torch.ops import native
from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import (
    group_stats,
    xla_group_norm,
    xla_group_norm_cat,
)

LAUNCHES = native.counter("group_norm")
CAT_LAUNCHES = native.counter("group_norm_cat")
BWD_LAUNCHES = native.counter("group_norm_bwd")

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


def _tiling(widths, s: int):
    """(block_s, block_c, n_split, rows_per_prog) of the row-split passes."""
    block_c = min(128, _next_pow2(max(widths)))
    block_s = max(16, _TILE // block_c)
    n_split = min(_MAX_SPLITS, _cdiv(s, block_s))
    rows_per_prog = _cdiv(_cdiv(s, n_split), block_s) * block_s
    return block_s, block_c, _cdiv(s, rows_per_prog), rows_per_prog


def _launch(parts, scale, bias, num_groups, eps, apply_silu):
    """Run the three forward kernels over the channel concat of ``parts`` (1 or
    2) -> (out, mean, rstd), the statistics f32 [B, G]."""
    native.import_triton()
    from stable_diffusion_pytorch_tpu_torch.ops import groupnorm_triton as k

    x = parts[0]
    b = x.shape[0]
    s = math.prod(x.shape[1:-1])
    widths = [p.shape[-1] for p in parts]
    c = sum(widths)
    cpg = c // num_groups
    out = torch.empty(x.shape[:-1] + (c,), dtype=x.dtype, device=x.device)
    block_s, block_c, n_split, rows_per_prog = _tiling(widths, s)

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
    return out, mean, rstd


def _launch_bwd(parts, dy, scale, bias, mean, rstd, num_groups, apply_silu):
    """Run the four backward kernels (K7) over the channel concat of ``parts``
    -> ([dx per part], dscale, dbias)."""
    native.import_triton()
    from stable_diffusion_pytorch_tpu_torch.ops import groupnorm_triton as k

    x = parts[0]
    b = x.shape[0]
    s = math.prod(x.shape[1:-1])
    widths = [p.shape[-1] for p in parts]
    c = sum(widths)
    cpg = c // num_groups
    block_s, block_c, n_split, rows_per_prog = _tiling(widths, s)
    dev = x.device

    pdb = torch.empty((b, n_split, c), dtype=torch.float32, device=dev)
    pds = torch.empty_like(pdb)
    s1 = torch.empty((b, num_groups), dtype=torch.float32, device=dev)
    s2 = torch.empty_like(s1)
    dscale = torch.empty(c, dtype=torch.float32, device=dev)
    dbias = torch.empty_like(dscale)
    dxs = [torch.empty_like(p) for p in parts]
    silu = bool(apply_silu)

    with torch.cuda.device(dev):
        offset = 0
        for p, cp in zip(parts, widths):
            k.gn_bwd_partial_sums[(b, n_split, _cdiv(cp, block_c))](
                p, dy, mean, rstd, scale, bias, pdb, pds, s, cp, c, offset, cpg, num_groups,
                rows_per_prog, n_split, APPLY_SILU=silu, BLOCK_S=block_s, BLOCK_C=block_c,
                num_warps=4,
            )
            offset += cp
        k.gn_bwd_finalize[(b, num_groups)](
            pdb, pds, scale, s1, s2, n_split, c, cpg, num_groups,
            BLOCK_P=_next_pow2(n_split), BLOCK_G=_next_pow2(cpg), num_warps=4,
        )
        k.gn_bwd_param_grads[(_cdiv(c, 128),)](
            pdb, pds, dscale, dbias, b * n_split, c, BLOCK_R=32, BLOCK_C=128, num_warps=4,
        )
        offset = 0
        for p, dx, cp in zip(parts, dxs, widths):
            k.gn_bwd_dx[(b, _cdiv(s, block_s), _cdiv(cp, block_c))](
                p, dy, dx, mean, rstd, scale, bias, s1, s2, s, cp, c, offset, cpg, num_groups,
                1.0 / float(s * cpg), APPLY_SILU=silu, BLOCK_S=block_s, BLOCK_C=block_c,
                num_warps=4,
            )
            offset += cp
    return dxs, dscale, dbias


def group_norm_bwd_plain(parts, dy, scale, bias, num_groups, eps=1e-5, apply_silu=False):
    """Plain GroupNorm(+SiLU) backward over the channel concat of ``parts`` ->
    ([dx per part], dscale, dbias): the JAX package's ``_gn_bwd_kernel`` math
    (statistics recomputed from x, var = E[x^2] - E[x]^2)."""
    b = parts[0].shape[0]
    widths = [p.shape[-1] for p in parts]
    c = sum(widths)
    x = torch.cat([p.float().reshape(b, -1, p.shape[-1]) for p in parts], dim=-1)
    g = dy.float().reshape(b, -1, c)
    n = x.shape[1] * (c // num_groups)
    mean_c, inv_c = group_stats(x.sum(1), (x * x).sum(1), num_groups, n, eps)
    xhat = (x - mean_c) * inv_c
    w = scale.float()
    if apply_silu:
        y = xhat * w + bias.float()
        sig = torch.sigmoid(y)
        g = g * (sig * (1.0 + y * (1.0 - sig)))
    dbias = g.sum((0, 1))
    dscale = (g * xhat).sum((0, 1))
    dxhat = g * w
    cpg = c // num_groups
    s1 = dxhat.sum(1).view(b, num_groups, cpg).sum(-1).repeat_interleave(cpg, dim=1)[:, None, :]
    s2 = (dxhat * xhat).sum(1).view(b, num_groups, cpg).sum(-1).repeat_interleave(cpg, dim=1)[:, None, :]
    dx = inv_c * (dxhat - (s1 + xhat * s2) / n)
    dxs = [d.reshape(p.shape).to(p.dtype) for d, p in zip(dx.split(widths, dim=-1), parts)]
    return dxs, dscale.to(scale.dtype), dbias.to(bias.dtype)


def group_norm_bwd(parts, dy, scale, bias, mean, rstd, num_groups, eps=1e-5, apply_silu=False):
    """GroupNorm(+SiLU) backward over the channel concat of ``parts`` (1 or 2)
    -> ([dx per part], dscale, dbias). CUDA tensors launch K7 with the
    forward's ``mean``/``rstd`` (f32 [B, G]); CPU tensors run the plain
    version, which recomputes the statistics."""
    if parts[0].device.type == "cpu":
        return group_norm_bwd_plain(parts, dy, scale, bias, num_groups, eps, apply_silu)
    dy = dy.contiguous()
    _check(parts, scale, bias, num_groups)
    x = parts[0]
    c = sum(p.shape[-1] for p in parts)
    if dy.shape != x.shape[:-1] + (c,) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"group norm backward: dy must be {tuple(x.shape[:-1]) + (c,)} {x.dtype} on {x.device} "
                         f"(got {tuple(dy.shape)} {dy.dtype} on {dy.device})")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t is None or t.shape != (x.shape[0], num_groups) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"group norm backward: {name} must be the forward's f32 [B, G] statistics")
    dxs, dscale, dbias = _launch_bwd(parts, dy, scale, bias, mean, rstd, num_groups, apply_silu)
    BWD_LAUNCHES.hit((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1],
                      parts[1].shape[-1] if len(parts) > 1 else 0, num_groups,
                      bool(apply_silu), str(x.dtype)))
    return dxs, dscale, dbias


def _bwd(ctx, dy):
    """Shared backward of the two Functions -> grads of (parts..., scale, bias)."""
    *parts, scale, bias, mean, rstd = ctx.saved_tensors
    dxs, dscale, dbias = group_norm_bwd(parts, dy, scale, bias, mean, rstd, ctx.num_groups, ctx.eps, ctx.silu)
    return (*dxs, dscale, dbias)


class GroupNormFn(torch.autograd.Function):
    """GroupNorm(+SiLU): K6 forward and K7 backward on CUDA tensors, the plain
    forward and backward on CPU tensors."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        out, mean, rstd = _forward(x, None, scale, bias, num_groups, eps, apply_silu)
        ctx.num_groups, ctx.eps, ctx.silu = num_groups, eps, bool(apply_silu)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        dx, dscale, dbias = _bwd(ctx, dy)
        return dx, dscale, dbias, None, None, None


class GroupNormCatFn(torch.autograd.Function):
    """GroupNorm(+SiLU) of the virtual concat(x, s): K8 forward and the K7
    kernels over both parts backward on CUDA tensors, plain versions on CPU."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, s, scale, bias, num_groups, eps, apply_silu):
        out, mean, rstd = _forward(x, s, scale, bias, num_groups, eps, apply_silu)
        ctx.num_groups, ctx.eps, ctx.silu = num_groups, eps, bool(apply_silu)
        ctx.save_for_backward(x, s, scale, bias, mean, rstd)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        dx, ds, dscale, dbias = _bwd(ctx, dy)
        return dx, ds, dscale, dbias, None, None, None


def _forward(x, s, scale, bias, num_groups, eps, apply_silu):
    """One forward (K6 or, with ``s``, K8) -> (out, mean, rstd); CPU tensors
    run the plain version and return no statistics."""
    if s is None:
        if x.device.type == "cpu":
            return xla_group_norm(x, scale, bias, num_groups, eps, apply_silu), None, None
        _check([x], scale, bias, num_groups)
        out, mean, rstd = _launch([x], scale, bias, num_groups, eps, apply_silu)
        LAUNCHES.hit((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1], num_groups,
                      bool(apply_silu), str(x.dtype)))
        return out, mean, rstd
    if x.device.type == "cpu" and s.device.type == "cpu":
        return xla_group_norm_cat(x, s, scale, bias, num_groups, eps, apply_silu), None, None
    _check([x, s], scale, bias, num_groups)
    out, mean, rstd = _launch([x, s], scale, bias, num_groups, eps, apply_silu)
    CAT_LAUNCHES.hit((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1], s.shape[-1],
                      num_groups, bool(apply_silu), str(x.dtype)))
    return out, mean, rstd


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+SiLU) of channel-last x [B, ..., C] (K6; backward K7).

    CPU tensors run the plain versions; CUDA tensors launch the kernels or raise."""
    if _records_grad(x, scale, bias):
        return GroupNormFn.apply(x, scale, bias, num_groups, eps, apply_silu)
    return _forward(x, None, scale, bias, num_groups, eps, apply_silu)[0]


def fused_group_norm_cat(
    x: torch.Tensor,
    s: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    apply_silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+SiLU) of the virtual concat(x, s) -> [..., C1+C2] (K8;
    backward: the K7 kernels over both parts).

    CPU tensors run the plain versions; CUDA tensors launch the kernels or raise."""
    if _records_grad(x, s, scale, bias):
        return GroupNormCatFn.apply(x, s, scale, bias, num_groups, eps, apply_silu)
    return _forward(x, s, scale, bias, num_groups, eps, apply_silu)[0]
