"""GroupNorm(+SiLU) kernels for Hopper: the wrappers, their launch plan, and
the autograd Functions that pair each forward with its backward.

Replaces the Pallas TPU kernels ``stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py``
``_gn_kernel`` (launched from ``pallas_group_norm``), ``_gn_cat_kernel``
(from ``pallas_group_norm_cat``) and ``_gn_bwd_kernel`` (from
``pallas_group_norm_bwd``, the backward of ``_gn_kernel``), each one CUDA C++
launch on thread-block clusters:

- K6, GroupNorm(+SiLU) forward, and K8, its concat form (the normalized
  concat of two channel parts, the raw concat never stored):
  ``csrc/group_norm.cu``, two kernels on one body. A cluster of up to 16
  CTAs owns a (batch element, slice of whole groups), its CTAs split the
  rows, keep them in shared memory where they fit, meet through distributed
  shared memory for the group statistics, and write y once (the design is
  at the top of the source). In K8 each thread's vector column lies in one
  part, so groups that straddle the parts need no special case.
- K7, the backward (also the concat form's): ``csrc/group_norm_bwd.cu``, the
  same clusters over x and dy, S1 and S2 met through distributed shared
  memory, dx written once, dgamma and dbeta summed over the batch inside the
  launch by the last cluster of each slice. The JAX package has no kernel
  for the concat form's backward (its custom VJP differentiates
  ``xla_group_norm_cat``); here K7 runs over the two parts with joint
  statistics, the way K8 runs the forward.

:func:`gn_launch_plan` chooses the slice width, the cluster size and whether
the rows stay on chip, for all three.

What bounds them on this card: no matrix product, 10-20 FLOPs per element,
so memory bandwidth. The forward's floor is one read of x and one write of
y; the backward's one read of x and dy and one write of dx. The backward
takes each group's mean and 1/std from the forward instead of recomputing
them.

Every shape on the path is taken: any C, any number of groups that divides C,
any spatial size (a slice of at most 256 vectors of up to 16 bytes, 2048 bf16
channels). The plain versions are ``ops/groupnorm.py:xla_group_norm``,
``xla_group_norm_cat`` and :func:`group_norm_bwd_plain`; the wrappers take
them only for CPU tensors.
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


# The launch plan of the cluster kernels (csrc/group_norm.cu,
# csrc/group_norm_bwd.cu), tuned on the H100 over the model's largest maps
# (PERF.md, section 6)
GN_THREADS = 256            # per CTA
GN_MAX_CLUSTER = 16         # CTAs per cluster (non-portable above 8)
GN_FILL_CTAS = 128          # about one CTA per SM of the H100's 132: eight clusters of 16
GN_RESIDENT_BYTES = 96 * 1024  # a CTA's rows kept in shared memory: two CTAs fit an SM
GN_SMEM_MAX = 232448        # shared memory a block can use (227 KB)
GN_MIN_ROWS = 16            # rows per CTA below which the cluster stops growing
GN_SECTOR_BYTES = 32        # device memory moves whole 32-byte sectors
GN_BWD_MAX_VECS = 16        # the backward's vectors per slice row: 16 rows in flight a CTA pass


class GnPlan(NamedTuple):
    """One cluster launch: ``groups_per_slice`` whole groups per cluster,
    ``cluster`` CTAs splitting the ``rows`` of a batch element,
    ``rows_per_cta`` each, loads of ``vec`` elements, the rows kept in shared
    memory (``resident``) or read twice, and ``smem`` bytes of dynamic shared
    memory per CTA."""

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
                   align_bytes: int = 16, split: int = 0, inputs: int = 1) -> GnPlan:
    """The launch plan of K6 (and K8, K7) for x [batch, rows, channels] of
    ``elem_bytes`` per element whose base addresses are multiples of
    ``align_bytes``: a pure function of the shape, which the tests check over
    the model's shapes.

    ``split`` > 0: the channels are the concat of two parts, the first
    ``split`` wide (K8, and K7 of the concat form); the vector divides both,
    so each thread's vector column lies in one part. ``inputs``: the arrays
    read per element and kept in shared memory together, 1 for the forwards
    (x), 2 for the backward (x and dy, which share the resident budget; its
    layout also holds two floats per slice channel).

    Loads take the widest vector (up to 16 bytes) that divides the channels
    (and the parts) and the alignment. A slice is a run of whole groups whose
    width that vector divides; slices whose row segment fills whole 32-byte
    sectors are preferred (narrower ones fetch each sector once per slice).
    The slice is the widest (wider segments read better) that puts
    ``GN_FILL_CTAS`` CTAs on the card at this batch with a cluster of at most
    16 and keeps each CTA's rows within ``GN_RESIDENT_BYTES`` of shared
    memory; else the widest that fills the card, its rows streamed; else the
    narrowest, with the largest cluster the rows allow. Measured on the H100
    over the model's largest maps, these beat narrower slices on more CTAs
    (PERF.md, section 6). The backward's slices are at most
    ``GN_BWD_MAX_VECS`` vectors wide where the groups allow: its threads
    hold more registers, two rows of x and dy each in flight, and wide
    slices left a CTA pass with a row or two (measured on the H100, PERF.md,
    section 6). The CTAs of a cluster split the rows evenly (none is
    empty)."""
    if channels % groups:
        raise ValueError(f"channels {channels} not divisible by groups {groups}")
    if not 0 <= split < channels:
        raise ValueError(f"first part of {split} channels outside the {channels} channels")
    cpg = channels // groups
    vec = max(v for v in (8, 4, 2, 1)
              if v * elem_bytes <= min(16, align_bytes) and channels % v == 0 and split % v == 0)
    max_vecs = GN_THREADS if inputs == 1 else GN_BWD_MAX_VECS
    whole = [g for g in _divisors(groups) if (g * cpg) % vec == 0]
    slices = [g for g in whole if g * cpg // vec <= max_vecs] or [g for g in whole if g * cpg // vec <= GN_THREADS]
    if not slices:
        raise ValueError(f"group norm kernel: no slice of whole groups fits {GN_THREADS} loads "
                         f"of {vec} elements ({channels} channels, {groups} groups)")
    slices = [g for g in slices if g * cpg * elem_bytes >= GN_SECTOR_BYTES] or slices
    cap = max(1, min(GN_MAX_CLUSTER, -(-rows // GN_MIN_ROWS)))

    def to_fill(gps):  # the cluster that puts GN_FILL_CTAS CTAs on the card
        return -(-GN_FILL_CTAS // (batch * (groups // gps)))

    def to_fit(gps):  # the cluster that keeps a CTA's rows in shared memory
        return -(-rows // max(1, GN_RESIDENT_BYTES // (gps * cpg * elem_bytes * inputs)))

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
    resident = inputs * buf <= GN_RESIDENT_BYTES
    lanes = GN_THREADS // (width // vec)  # rows in flight in a CTA
    smem = (inputs * (-(-buf // 16) * 16) if resident else 0) + 2 * lanes * width * 4 + 4 * gps * 4
    if inputs == 2:  # the backward's gamma-weighted channel sums
        smem += 2 * width * 4
    return GnPlan(gps, groups // gps, cluster, rows_per_cta, vec, resident, smem)


def _align(x: torch.Tensor) -> int:
    """The largest power of two (up to 16) dividing the tensor's address."""
    return min(16, x.data_ptr() & -x.data_ptr())


def _launch_gn(parts, scale, bias, num_groups, eps, apply_silu):
    """K6 on channel-last x [B, ..., C] (one part) or K8 on the concat of two
    parts -> (out [B, ..., C0 + C1], mean, rstd), one launch."""
    x = parts[0]
    b, c0 = x.shape[0], x.shape[-1]
    s = math.prod(x.shape[1:-1])
    if len(parts) == 1:
        x1, c1 = None, 0
        plan = gn_launch_plan(b, s, c0, num_groups, x.element_size(), _align(x))
        out = torch.empty_like(x)
    else:
        x1 = parts[1]
        c1 = x1.shape[-1]
        plan = gn_launch_plan(b, s, c0 + c1, num_groups, x.element_size(), min(_align(x), _align(x1)), c0)
        out = x.new_empty(x.shape[:-1] + (c0 + c1,))
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib = native.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.sd_group_norm_forward(
            0 if x.dtype == torch.float32 else 1, x.data_ptr(), None if x1 is None else x1.data_ptr(),
            out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), b, s,
            c0, c1, num_groups, plan.groups_per_slice, plan.cluster, plan.rows_per_cta, plan.vec,
            int(plan.resident), plan.smem, int(bool(apply_silu)), float(eps), stream,
        )
    if rc != 0:
        raise RuntimeError(f"group norm kernel launch failed: CUDA error {rc} (plan {plan})")
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


# K7's per-slice counters, one array per device: zero when made (at the first
# call, which a CUDA graph's capture follows after its warm-up), and every
# launch leaves them zero. Launches on a device run in stream order: the port
# queues its work on one stream, and a captured graph replays on it.
_BWD_COUNTERS: dict = {}


def _bwd_counter(device, n_slices: int) -> torch.Tensor:
    ctr = _BWD_COUNTERS.get(device)
    if ctr is None or ctr.numel() < n_slices:
        if torch.cuda.is_current_stream_capturing():
            # made under capture, the array would live in the graph's pool and
            # its zero fill would run only at replays: the warm-up makes it
            raise RuntimeError("group norm backward: K7's slice counters must exist before CUDA graph capture; "
                               "run the step once outside capture first")
        ctr = _BWD_COUNTERS[device] = torch.zeros(max(64, n_slices), dtype=torch.int32, device=device)
    return ctr


def _launch_bwd(parts, dy, scale, bias, mean, rstd, num_groups, apply_silu):
    """K7 over the channel concat of ``parts`` (1 or 2) -> ([dx per part],
    dscale, dbias), one launch."""
    x = parts[0]
    b, c0 = x.shape[0], x.shape[-1]
    s = math.prod(x.shape[1:-1])
    x1 = parts[1] if len(parts) > 1 else None
    c1 = 0 if x1 is None else x1.shape[-1]
    c = c0 + c1
    dev = x.device
    align = min(_align(p) for p in (*parts, dy))
    plan = gn_launch_plan(b, s, c, num_groups, x.element_size(), align, c0 if c1 else 0, 2)
    dxs = [torch.empty_like(p) for p in parts]
    partial = torch.empty((2, b, c), dtype=torch.float32, device=dev)
    dscale = torch.empty(c, dtype=torch.float32, device=dev)
    dbias = torch.empty_like(dscale)
    lib = native.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counter = _bwd_counter(dev, plan.n_slices)
        rc = lib.sd_group_norm_backward(
            0 if x.dtype == torch.float32 else 1, x.data_ptr(), None if x1 is None else x1.data_ptr(),
            dy.data_ptr(), dxs[0].data_ptr(), None if x1 is None else dxs[1].data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(), partial.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), counter.data_ptr(), b, s, c0, c1, num_groups,
            plan.groups_per_slice, plan.cluster, plan.rows_per_cta, plan.vec, int(plan.resident),
            plan.smem, int(bool(apply_silu)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"group norm backward kernel launch failed: CUDA error {rc} (plan {plan})")
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
    """GroupNorm(+SiLU) of the virtual concat(x, s): K8 forward and K7 over
    both parts backward on CUDA tensors, plain versions on CPU."""

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
        out, mean, rstd = _launch_gn([x], scale, bias, num_groups, eps, apply_silu)
        # the launch key holds eps: the diffusers VAE normalizes at 1e-6, the rest at 1e-5
        LAUNCHES.hit((x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1], num_groups,
                      bool(apply_silu), float(eps), str(x.dtype)))
        return out, mean, rstd
    if x.device.type == "cpu" and s.device.type == "cpu":
        return xla_group_norm_cat(x, s, scale, bias, num_groups, eps, apply_silu), None, None
    _check([x, s], scale, bias, num_groups)
    out, mean, rstd = _launch_gn([x, s], scale, bias, num_groups, eps, apply_silu)
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
    backward: K7 over both parts).

    CPU tensors run the plain versions; CUDA tensors launch the kernels or raise."""
    if _records_grad(x, s, scale, bias):
        return GroupNormCatFn.apply(x, s, scale, bias, num_groups, eps, apply_silu)
    return _forward(x, s, scale, bias, num_groups, eps, apply_silu)[0]
