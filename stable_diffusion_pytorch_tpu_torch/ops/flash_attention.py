"""Flash-attention forward: wrapper around the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``stable_diffusion_pytorch_tpu/ops/flash_attention.py``
``_fa_kernel`` (launched from ``_flash_fwd_impl``). The kernel is CUDA C++ in
``csrc/flash_attention.cu``, built for sm_90a by ``ops/native.py``; its design
notes are at the top of that file. The TPU's 128-lane padding of D and its
resident/streaming split at 9216 kv tokens were VMEM mechanics and do not carry
over: the kernel takes any D up to 256 and any kv length, strided q/k/v views
included (the fused-QKV split hands it non-contiguous views).

:func:`flash_attention_plain` is the same function in plain PyTorch (the JAX
package's ``xla_attention`` math). The wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from stable_diffusion_pytorch_tpu_torch.ops import native
from stable_diffusion_pytorch_tpu_torch.ops.attention import xla_attention

LAUNCHES = native.counter("flash_attention")
MAX_HEAD_DIM = 256  # the largest padded head dim csrc/flash_attention.cu instantiates

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    return xla_attention(q, k, v, scale)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q/k/v of one dtype "
            f"(got {q.dtype}, {k.dtype}, {v.dtype})"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q [B,N,H,D], k/v [B,M,H,D] "
            f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})"
        )
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: batch/heads/head dim differ between q "
            f"{tuple(q.shape)} and k/v {tuple(k.shape)}"
        )
    if min(q.shape) == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention: empty input")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k, v must be contiguous")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} exceeds the kernel's {MAX_HEAD_DIM}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale) v; q [B,N,H,D], k/v [B,M,H,D] -> [B,N,H,D].

    CPU tensors run the plain version; CUDA tensors launch the kernel or raise."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    lib = native.load_library()
    b, n, h, d = q.shape
    m = k.shape[1]
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides.extend((t.stride(0), t.stride(1), t.stride(2)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sd_flash_attention_forward(
            _DTYPE_CODES[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, n, m, d, *strides, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES.hit((b, n, m, h, d, str(q.dtype)))
    return out
