"""The int8 Adam leaf update (K9): its plain version, the quantization rules and
the wrapper around the CUDA kernel.

Replaces the Pallas TPU kernel ``stable_diffusion_pytorch_tpu/ops/adam8bit_update.py``
``_kernel`` and the XLA leaf path of ``trainers/adam8bit.py`` beside it (the
JAX package states the two are numerically the same). One call updates one
parameter leaf: dequantize the stored moments, run the f32 Adam recurrence
with the bias corrections passed in, write
``update = (mu / bc1) / (sqrt(nu / bc2) + eps)``, take the blockwise absmax of
the new moments and requantize them, ``nu`` in the sqrt domain. The CUDA C++
kernel is ``csrc/adam8bit_update.cu``, built by ``ops/native.py``.

The code (the JAX package's ``_quantize``/``_dequantize``)::

    q  = clip(round(127 * sign(x) * sqrt(|x| / absmax_block)), -127, 127)   int8
    x~ = sign(q) * (q/127)^2 * absmax_block

Layout. JAX blocks along each parameter's minor axis, its output channel:
conv ``[kh, kw, I, O]``, dense ``[I, O]``, 1-D ``[C]``. The port stores convs
as ``[O, I, kh, kw]`` and linears as ``[O, I]`` (``utils/convert.py``), so the
same blocks run along torch dim 0 (:data:`BLOCK_DIM`; a test derives it from
the converter's map). A leaf is viewed as ``[O, R]`` with ``R = numel / O``;
along dim 0 the blocks are ``block_size`` rows for each column ``r`` when
``O % block_size == 0 and O > block_size``, else one block of ``O`` rows
(``_blocked_view``'s rule). Codes keep the parameter's shape; scales are f32
``[nb, *shape[1:]]``, the JAX scale under the weight's own transpose.
In memory, the kernel needs dim 0 outermost and the columns of codes,
scales, gradient and update in one order: all contiguous, or (4-D conv
weights, which the port keeps ``channels_last``) all ``channels_last``
(:func:`zeros_state` makes the state in its parameter's format).

The JAX size gate, VMEM budget and row tiling are TPU mechanisms and are not
ported: on a CUDA tensor every leaf goes to the kernel, 1-D leaves included.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.ops import native

LAUNCHES = native.counter("adam8bit_update")
BLOCK_DIM = 0  # the torch dim that holds JAX's minor (output-channel) axis
_G_CODES = {torch.float32: 0, torch.bfloat16: 1}

QState = Tuple[torch.Tensor, torch.Tensor]  # (int8 codes, f32 scales)


def blocked_layout(shape, block_size: int) -> Tuple[int, int, int, int]:
    """-> (O, R, block, nb): rows along dim 0, columns, rows per block, blocks."""
    o = int(shape[0]) if len(shape) else 1
    numel = 1
    for d in shape:
        numel *= int(d)
    r = numel // o if o else 0
    block = block_size if (o % block_size == 0 and o > block_size) else o
    return o, r, block, (o // block if block else 0)


def scale_shape(shape, block_size: int) -> Tuple[int, ...]:
    """The f32 scales' shape of a leaf: ``[nb, *shape[1:]]``."""
    nb = blocked_layout(shape, block_size)[3]
    return (nb, *tuple(shape)[1:]) if len(shape) else (1,)


def memory_format(t: torch.Tensor) -> torch.memory_format:
    """``channels_last`` for a 4-D tensor laid out so (and not contiguous), else contiguous."""
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def zeros_state(p: torch.Tensor, block_size: int) -> QState:
    """All-zero (codes, scales) for parameter ``p``, in ``p``'s memory format."""
    fmt = memory_format(p)
    return (torch.zeros_like(p, dtype=torch.int8, memory_format=fmt),
            torch.zeros(scale_shape(p.shape, block_size), dtype=torch.float32, device=p.device)
            .contiguous(memory_format=fmt))


def quantize(x: torch.Tensor, block_size: int) -> QState:
    """f32 values -> (int8 codes in x's shape, f32 scales [nb, *shape[1:]])."""
    o, r, block, nb = blocked_layout(x.shape, block_size)
    xb = x.float().reshape(nb, block, r)
    absmax = xb.abs().amax(dim=1, keepdim=True)
    safe = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    y = xb / safe
    q = torch.clamp(torch.round(127.0 * torch.sign(y) * torch.sqrt(torch.abs(y))), -127, 127)
    return q.to(torch.int8).reshape(x.shape), absmax.reshape(scale_shape(x.shape, block_size))


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(codes, scales) -> f32 values in the codes' shape."""
    nb = scale.shape[0]
    o, r = (q.shape[0], q.numel() // q.shape[0]) if q.dim() else (1, 1)
    qf = q.float().reshape(nb, o // nb, r) * (1.0 / 127.0)
    x = torch.sign(qf) * qf * qf * scale.reshape(nb, 1, r)
    return x.reshape(q.shape)


def adam8bit_update_plain(
    g: torch.Tensor, mu: QState, nu: QState, bc1: float, bc2: float,
    b1: float, b2: float, eps: float, block_size: int,
) -> Tuple[torch.Tensor, QState, QState]:
    """-> (update in g's dtype, new mu codes and scales, new nu codes and
    scales); the op order of the JAX package's XLA leaf path. The bias
    corrections divide as 0-d tensors on g's device: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which is not IEEE
    division (JAX's and the kernel's)."""
    g32 = g.float()
    bc1, bc2 = (torch.tensor(b, dtype=torch.float32, device=g.device) for b in (bc1, bc2))
    m = b1 * dequantize(*mu) + (1.0 - b1) * g32
    v = b2 * dequantize(*nu) ** 2 + (1.0 - b2) * g32 * g32
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return upd.to(g.dtype), quantize(m, block_size), quantize(torch.sqrt(v), block_size)


def _check(g, mu, nu, block_size):
    want_scale = scale_shape(g.shape, block_size)
    if g.dtype not in _G_CODES:
        raise TypeError(f"adam8bit_update takes float32 or bfloat16 gradients (got {g.dtype})")
    for name, (q, s) in (("mu", mu), ("nu", nu)):
        if q.dtype != torch.int8 or q.shape != g.shape or s.dtype != torch.float32 or tuple(s.shape) != want_scale:
            raise ValueError(
                f"adam8bit_update: {name} must be int8 codes {tuple(g.shape)} and f32 scales {want_scale} "
                f"(got {q.dtype} {tuple(q.shape)}, {s.dtype} {tuple(s.shape)})"
            )
    fmt = memory_format(mu[0])
    for t in (g, *mu, *nu):
        if t.device != g.device or not t.is_contiguous(memory_format=fmt):
            raise ValueError(
                "adam8bit_update: gradient, codes and scales must lie on one CUDA device, all contiguous or "
                "all channels_last")


def adam8bit_update(
    g: torch.Tensor, mu: QState, nu: QState, bc1: float, bc2: float,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, block_size: int = 256,
) -> Tuple[torch.Tensor, QState, QState]:
    """One leaf's int8 Adam update: the kernel on a CUDA tensor, the plain
    version on a CPU tensor. Returns new tensors; the inputs are not changed."""
    if not g.is_cuda:
        return adam8bit_update_plain(g, mu, nu, bc1, bc2, b1, b2, eps, block_size)
    g = g.contiguous(memory_format=memory_format(mu[0]))  # the state's layout
    _check(g, mu, nu, block_size)
    lib = native.load_library()
    o, r, block, nb = blocked_layout(g.shape, block_size)
    upd = torch.empty_like(g)
    new_mu = (torch.empty_like(mu[0]), torch.empty_like(mu[1]))
    new_nu = (torch.empty_like(nu[0]), torch.empty_like(nu[1]))
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.sd_adam8bit_update(
            _G_CODES[g.dtype], g.data_ptr(), mu[0].data_ptr(), mu[1].data_ptr(), nu[0].data_ptr(),
            nu[1].data_ptr(), upd.data_ptr(), new_mu[0].data_ptr(), new_mu[1].data_ptr(),
            new_nu[0].data_ptr(), new_nu[1].data_ptr(), r, block, nb,
            f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2), f32(eps), f32(bc1), f32(bc2), stream,
        )
    if rc != 0:
        raise RuntimeError(f"adam8bit_update kernel launch failed: CUDA error {rc}")
    LAUNCHES.hit((o, r, block, str(g.dtype)))
    return upd, new_mu, new_nu
