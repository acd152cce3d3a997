"""Flash attention, forward and backward: wrappers around the CUDA kernels, their
plain versions, and the autograd Function that joins them.

Forward: replaces the Pallas TPU kernels ``stable_diffusion_pytorch_tpu/ops/flash_attention.py``
``_fa_kernel`` (resident K/V) and ``_fa_kernel_stream`` (kv past 9216 tokens);
CUDA C++ in ``csrc/flash_attention.cu``, whose online softmax over kv tiles
serves every kv length, so the forward has no resident/streaming split.
Backward, two kernel sets, both CUDA C++:

- fused, K3 (``csrc/flash_attention_bwd.cu``): replaces ``ops/flash_attention_bwd.py``
  ``_fused_bwd_kernel`` (``flash_attention_bwd_fused``, the JAX package's default);
  kv-outer with dq added by atomics.
- split, K4/K5 (``csrc/flash_attention_bwd_split.cu``): replaces ``_dq_kernel``
  and ``_dkv_kernel`` (``flash_attention_bwd``, ``SD_FLASH_BWD=split``) and
  ``_sbwd_stats_kernel``, ``_sbwd_dq_kernel`` and ``_sbwd_dkv_kernel``
  (``flash_attention_bwd_streaming``); a q-outer dq kernel and a kv-outer
  dk/dv kernel, no atomics, the same result on every run.

:func:`backward_route` picks between them by the JAX package's rule
(``_flash_bwd``): the split kernels past the 9216-token crossover or under
``SD_FLASH_BWD=split``, K3 otherwise. The crossover is the TPU's VMEM limit,
kept as the selection rule until a measurement on the card moves it. All are
built for sm_90a by ``ops/native.py``; their design notes are at the top of
each source. The forward takes any D up to 512 and any kv length, the backward
any D up to 160 (the UNet's widest head), strided q/k/v views included (the
fused-QKV split hands them non-contiguous views).

:func:`flash_attention_plain` is the forward in plain PyTorch (the JAX package's
``xla_attention`` math) and :func:`flash_attention_bwd_plain` the backward of
both kernel sets (its ``xla_attention_bwd``). The wrappers take them only for
CPU tensors.

:func:`flash_attention` is what the model calls. When autograd records (grad
enabled and an input requires grad) it goes through :class:`FlashAttention`,
whose forward also keeps the row log-sum-exp for the backward kernels;
otherwise it launches the forward kernel alone, as inference always has.
"""

from __future__ import annotations

import ctypes
import os
from typing import Mapping, Optional, Tuple

import torch

from stable_diffusion_pytorch_tpu_torch.ops import native
from stable_diffusion_pytorch_tpu_torch.ops.attention import xla_attention

LAUNCHES = native.counter("flash_attention")
BWD_LAUNCHES = native.counter("flash_attention_bwd")
SPLIT_BWD_LAUNCHES = native.counter("flash_attention_bwd_split")
MAX_HEAD_DIM = 512      # the largest padded head dim csrc/flash_attention.cu instantiates
MAX_BWD_HEAD_DIM = 160  # the same for both backward sources
KV_RESIDENT_MAX = 9216  # the JAX package's backward crossover, in kv tokens padded to 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    return xla_attention(q, k, v, scale)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Einsum gradients with f32 scores (the JAX package's ``xla_attention_bwd``)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, max_d: int, name: str) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"{name}: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16 q/k/v of one dtype "
            f"(got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name}: q [B,N,H,D], k/v [B,M,H,D] "
            f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})"
        )
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(
            f"{name}: batch/heads/head dim differ between q "
            f"{tuple(q.shape)} and k/v {tuple(k.shape)}"
        )
    if min(q.shape) == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: empty input")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim of q, k, v must be contiguous")
    if d > max_d:
        raise ValueError(f"{name}: head dim {d} exceeds the kernel's {max_d}")


def _strides(*tensors) -> list:
    return [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]


def _forward_kernel(q, k, v, scale: float, with_lse: bool):
    """Launch the forward kernel -> (out, lse or None); lse is f32 [B, H, N]."""
    _check(q, k, v, MAX_HEAD_DIM, "flash_attention")
    lib = native.load_library()
    b, n, h, d = q.shape
    m = k.shape[1]
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sd_flash_attention_forward(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, n, m, d, *_strides(q, k, v, out), float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES.hit((b, n, m, h, d, str(q.dtype)))
    return out, lse


def backward_route(kv_len: int, env: Mapping[str, str] = os.environ) -> str:
    """``"split"`` (K4/K5) or ``"fused"`` (K3) for a backward over ``kv_len`` kv
    tokens: the JAX package's ``_flash_bwd`` rule, split past the crossover
    (kv padded to 128) or under ``SD_FLASH_BWD=split``, fused otherwise."""
    if -(-kv_len // 128) * 128 > KV_RESIDENT_MAX or env.get("SD_FLASH_BWD") == "split":
        return "split"
    return "fused"


def _check_bwd(q, k, v, out, do, lse, name: str):
    """Validate a backward launch's inputs -> the 15 (batch, token, head) strides."""
    _check(q, k, v, MAX_BWD_HEAD_DIM, name)
    if out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(
            f"{name}: out/do must be {tuple(q.shape)} {q.dtype} "
            f"(got {tuple(out.shape)} {out.dtype}, {tuple(do.shape)} {do.dtype})"
        )
    if out.stride(-1) != 1 or do.stride(-1) != 1 or out.device != q.device or do.device != q.device:
        raise ValueError(f"{name}: out and do must lie on q's device with a contiguous head dim")
    b, n, h, _ = q.shape
    if lse is None or lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be the forward's contiguous f32 [B, H, N]")
    return (ctypes.c_longlong * 15)(*_strides(q, k, v, out, do))


def flash_attention_bwd(q, k, v, out, do, lse, scale: float):
    """Launch the fused backward kernel (K3) -> (dq, dk, dv), contiguous [B, L, H, D]."""
    strides = _check_bwd(q, k, v, out, do, lse, "flash_attention_bwd")
    lib = native.load_library()
    b, n, h, d = q.shape
    m = k.shape[1]
    dev = q.device
    dq_acc = torch.zeros((b, n, h, d), dtype=torch.float32, device=dev)
    dq = dq_acc if q.dtype == torch.float32 else torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, m, h, d), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sd_flash_attention_backward(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            None if dq is dq_acc else dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, m, d, strides, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES.hit((b, n, m, h, d, str(q.dtype)))
    return dq, dk, dv


def flash_attention_bwd_split(q, k, v, out, do, lse, scale: float):
    """Launch the split backward kernels (K4/K5) -> (dq, dk, dv), contiguous
    [B, L, H, D]; no atomics, so two launches on the same inputs agree bit for bit."""
    strides = _check_bwd(q, k, v, out, do, lse, "flash_attention_bwd_split")
    lib = native.load_library()
    b, n, h, d = q.shape
    m = k.shape[1]
    dev = q.device
    dq = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    dk = torch.empty((b, m, h, d), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sd_flash_attention_backward_split(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, m, d, strides, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_split kernel launch failed: CUDA error {rc}")
    SPLIT_BWD_LAUNCHES.hit((b, n, m, h, d, str(q.dtype)))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v with the K1 forward and, by :func:`backward_route`,
    the K3 or the split (K4/K5) backward on CUDA tensors; the plain forward and
    backward on CPU tensors."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale: float):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale), None
        else:
            out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, do, ctx.scale)
        else:
            split = backward_route(k.shape[1]) == "split"
            bwd = flash_attention_bwd_split if split else flash_attention_bwd
            dq, dk, dv = bwd(q, k, v, out, do, lse, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale) v; q [B,N,H,D], k/v [B,M,H,D] -> [B,N,H,D].

    CPU tensors run the plain versions; CUDA tensors launch the kernels or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, float(scale))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    return _forward_kernel(q, k, v, scale, with_lse=False)[0]
