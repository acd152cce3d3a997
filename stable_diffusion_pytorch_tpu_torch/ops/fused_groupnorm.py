"""GroupNorm(+SiLU) kernels for Hopper: the wrappers, their launch plan, and
the autograd Functions that pair each forward with its backward.

Replaces the Pallas TPU kernels ``stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py``
``_gn_kernel`` (launched from ``pallas_group_norm``), ``_gn_cat_kernel``
(from ``pallas_group_norm_cat``) and ``_gn_bwd_kernel`` (from
``pallas_group_norm_bwd``, the backward of ``_gn_kernel``):

- K6, GroupNorm(+SiLU) forward: CUDA C++ ``csrc/group_norm.cu``, one launch
  on thread-block clusters. A cluster of up to 16 CTAs owns a (batch
  element, slice of whole groups), its CTAs split the rows, keep them in
  shared memory where they fit, meet through distributed shared memory for
  the group statistics, and write y once (the design is at the top of the
  source). :func:`gn_launch_plan` chooses the slice width, the cluster size
  and whether the rows stay on chip.
- K8 (the concat form) and K7 (the backward, also the concat form's): Triton,
  ``ops/groupnorm_triton.py``. The JAX package has no kernel for the concat
  form's backward (its custom VJP differentiates ``xla_group_norm_cat``);
  here it runs the ``_gn_bwd_kernel`` port over the two parts with joint
  statistics, the way the concat forward reuses the forward's kernels.

What bounds them on this card: no matrix product, about 10 FLOPs per element,
so memory bandwidth. The forward's floor is one read of x and one write of y.
The backward reads x and dy twice (partial sums, then dx) and writes dx once;
it takes each group's mean and 1/std from the forward instead of recomputing
them.

The Triton kernels (K7, K8), and what did not carry over from the TPU:

- The TPU kernel holds one whole batch element in VMEM (hence its 1.8 MB
  gate). There, the statistics are split across many programs (per-channel
  partial sums over a split of the rows, coalesced along channels), a small
  second kernel reduces each group's partials to mean and 1/std (or S1, S2),
  and a separate pass normalizes (or forms dx). Nothing is held on chip
  across passes; the second read of x is the price.
- Groups of 10 (320/32), 4 (128/32), 60 or 30 channels are no power of two and
  a group of the up-path concat straddles the boundary at channel 1280 (or
  640). Statistics are kept per channel until the finalize kernel, which sums
  a group's channel range regardless of which part each channel came from, so
  joint statistics need no special case. The TPU's [C, G] membership-matrix
  trick was a lane-layout device and is not used.
- The concat variant runs the partial-sum and normalize kernels once per part
  with a channel offset and writes only the normalized concat: the raw concat
  is never stored.

Every shape on the path is taken: any C, any number of groups that divides C,
any spatial size (K6: a slice of at most 256 vectors of up to 16 bytes,
2048 bf16 channels). The plain versions are
``ops/groupnorm.py:xla_group_norm``, ``xla_group_norm_cat`` and
:func:`group_norm_bwd_plain`; the wrappers take them only for CPU tensors.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

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


# K6's launch plan (csrc/group_norm.cu), tuned on the H100 over the model's
# largest maps (PERF.md, section 6)
GN_THREADS = 256            # per CTA
GN_MAX_CLUSTER = 16         # CTAs per cluster (non-portable above 8)
GN_FILL_CTAS = 128          # about one CTA per SM of the H100's 132: eight clusters of 16
GN_RESIDENT_BYTES = 96 * 1024  # a CTA's rows kept in shared memory: two CTAs fit an SM
GN_SMEM_MAX = 232448        # shared memory a block can use (227 KB)
GN_MIN_ROWS = 16            # rows per CTA below which the cluster stops growing
GN_SECTOR_BYTES = 32        # device memory moves whole 32-byte sectors


class GnPlan(NamedTuple):
    """One K6 launch: ``groups_per_slice`` whole groups per cluster, ``cluster``
    CTAs splitting the ``rows`` of a batch element, ``rows_per_cta`` each,
    loads of ``vec`` elements, the rows kept in shared memory (``resident``)
    or read twice, and ``smem`` bytes of dynamic shared memory per CTA."""

    groups_per_slice: int
    n_slices: int
    cluster: int
    rows_per_cta: int
    vec: int
    resident: bool
    smem: int


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


@functools.lru_cache(maxsize=None)
def gn_launch_plan(batch: int, rows: int, channels: int, groups: int, elem_bytes: int,
                   align_bytes: int = 16) -> GnPlan:
    """The launch plan of K6 for x [batch, rows, channels] of ``elem_bytes``
    per element whose base address is a multiple of ``align_bytes``: a pure
    function of the shape, which the tests check over the model's shapes.

    Loads take the widest vector (up to 16 bytes) that divides the channels
    and the alignment. A slice is a run of whole groups whose width that
    vector divides; slices whose row segment fills whole 32-byte sectors are
    preferred (narrower ones fetch each sector once per slice). The slice is
    the widest (wider segments read better) that puts ``GN_FILL_CTAS`` CTAs
    on the card at this batch with a cluster of at most 16 and keeps each
    CTA's rows within ``GN_RESIDENT_BYTES`` of shared memory; else the widest
    that fills the card, its rows streamed; else the narrowest, with the
    largest cluster the rows allow. Measured on the H100 over the model's
    largest maps, these beat narrower slices on more CTAs (PERF.md, section 6).
    The CTAs of a cluster split the rows evenly (none is empty)."""
    if channels % groups:
        raise ValueError(f"channels {channels} not divisible by groups {groups}")
    cpg = channels // groups
    vec = max(v for v in (8, 4, 2, 1)
              if v * elem_bytes <= min(16, align_bytes) and channels % v == 0)
    slices = [g for g in _divisors(groups) if (g * cpg) % vec == 0 and g * cpg // vec <= GN_THREADS]
    if not slices:
        raise ValueError(f"group norm kernel: no slice of whole groups fits {GN_THREADS} loads "
                         f"of {vec} elements ({channels} channels, {groups} groups)")
    slices = [g for g in slices if g * cpg * elem_bytes >= GN_SECTOR_BYTES] or slices
    cap = max(1, min(GN_MAX_CLUSTER, -(-rows // GN_MIN_ROWS)))

    def to_fill(gps):  # the cluster that puts GN_FILL_CTAS CTAs on the card
        return -(-GN_FILL_CTAS // (batch * (groups // gps)))

    def to_fit(gps):  # the cluster that keeps a CTA's rows in shared memory
        return -(-rows * gps * cpg * elem_bytes // GN_RESIDENT_BYTES)

    widest = list(reversed(slices))
    gps = next((g for g in widest if max(to_fill(g), to_fit(g)) <= cap), None)
    if gps is not None:
        cluster = max(to_fill(gps), to_fit(gps), 1)
    else:
        gps = next((g for g in widest if to_fill(g) <= cap), slices[0])
        cluster = min(cap, max(to_fill(gps), 1))
    width = gps * cpg
    rows_per_cta = -(-rows // cluster)
    cluster = -(-rows // rows_per_cta)
    buf = rows_per_cta * width * elem_bytes
    resident = buf <= GN_RESIDENT_BYTES
    lanes = GN_THREADS // (width // vec)  # rows in flight in a CTA
    smem = (-(-buf // 16) * 16 if resident else 0) + 2 * lanes * width * 4 + 4 * gps * 4
    return GnPlan(gps, groups // gps, cluster, rows_per_cta, vec, resident, smem)


def _launch_gn(x, scale, bias, num_groups, eps, apply_silu):
    """K6 on channel-last x [B, ..., C] -> (out, mean, rstd), one launch."""
    b, c = x.shape[0], x.shape[-1]
    s = math.prod(x.shape[1:-1])
    elem = x.element_size()
    align = x.data_ptr() & -x.data_ptr()  # the largest power of two dividing the address
    plan = gn_launch_plan(b, s, c, num_groups, elem, min(16, align))
    out = torch.empty_like(x)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib = native.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sd_group_norm_forward(
            0 if x.dtype == torch.float32 else 1, x.data_ptr(), out.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), b, s, c, num_groups,
            plan.groups_per_slice, plan.cluster, plan.rows_per_cta, plan.vec, int(plan.resident),
            plan.smem, int(bool(apply_silu)), float(eps), stream,
        )
    if rc != 0:
        raise RuntimeError(f"group_norm kernel launch failed: CUDA error {rc} (plan {plan})")
    return out, mean, rstd


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


def _launch_cat(parts, scale, bias, num_groups, eps, apply_silu):
    """Run the three Triton forward kernels (K8) over the channel concat of
    ``parts`` -> (out, mean, rstd), the statistics f32 [B, G]."""
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
        out, mean, rstd = _launch_gn(x, scale, bias, num_groups, eps, apply_silu)
        LAUNCHES.hit((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1], num_groups,
                      bool(apply_silu), str(x.dtype)))
        return out, mean, rstd
    if x.device.type == "cpu" and s.device.type == "cpu":
        return xla_group_norm_cat(x, s, scale, bias, num_groups, eps, apply_silu), None, None
    _check([x, s], scale, bias, num_groups)
    out, mean, rstd = _launch_cat([x, s], scale, bias, num_groups, eps, apply_silu)
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
