"""AdamW with int8 block-quantized moments (port of trainers/adam8bit.py).

``--use-8bit-adam``: the JAX package's analog of bitsandbytes' AdamW8bit. The
first moment is stored as int8 codes of ``mu`` and the second as int8 codes of
``sqrt(nu)``, each with f32 absmax scales per block of ``block_size`` (256)
along the parameter's output channel; the update math is f32. The codes, the
blocked layout and the leaf update are in ``ops/adam8bit_update.py``
(:func:`quantize`, :func:`dequantize`, and K9, the CUDA kernel the update
launches for every leaf on the card).

:class:`AdamW8bit` composes as the JAX chain does (``trainers/optim.py``
``build_optimizer``): ``fused_accumulate(as_fused_apply(chain(
clip_by_global_norm(c), scale_by_adam_8bit, add_decayed_weights(wd),
scale_by_learning_rate(lr))), k, acc_dtype)``, and without accumulation the
chain alone. Per leaf, in this order:

- the clip, ``optax.clip_by_global_norm``'s own order (optax 0.2.6):
  ``g`` when ``||g|| < c``, else ``(g / ||g||) * c``, in the gradient's dtype
  (a bf16 accumulator is clipped in bf16; its norm is taken in f32, see
  ``trainers/optim.py:global_norm``);
- K9: the update ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` in the gradient's
  dtype and the requantized moments;
- ``u + wd * p``, times ``-lr``, added to ``p`` (``apply_updates``), in f32.

The parameter apply is not fused into K9 yet. The accumulation is shared with
:class:`~stable_diffusion_pytorch_tpu_torch.trainers.optim.AdamW`
(:class:`~stable_diffusion_pytorch_tpu_torch.trainers.optim.Accumulating`).
The ZeRO-sharded use of the kernel (per shard) is not ported.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import adam8bit_update, zeros_state
from stable_diffusion_pytorch_tpu_torch.trainers.optim import Accumulating


class AdamW8bit(Accumulating):
    """clip-by-global-norm + AdamW with int8 moments, optionally accumulated.

    State: ``count``, and per parameter ``mu`` and ``nu`` as (int8 codes in
    the parameter's shape, f32 scales ``[nb, *shape[1:]]``); ``nu`` holds
    ``sqrt(nu)``. ``step`` replaces the code and scale tensors of each leaf."""

    def __init__(self, params: List[torch.Tensor], schedule, block_size: int = 256, **kw):
        super().__init__(params, schedule, **kw)
        self.block_size = block_size
        self.mu = [zeros_state(p, block_size) for p in self.params]
        self.nu = [zeros_state(p, block_size) for p in self.params]

    def _update(self, grads: List[torch.Tensor], norm: torch.Tensor) -> None:
        count_inc, bc1, bc2, lr = self._scalars()
        if self.max_grad_norm is not None:
            c = torch.tensor(self.max_grad_norm, dtype=torch.float32, device=norm.device)
            keep = norm < c
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.max_grad_norm is not None:
                g = torch.where(keep, g, (g / norm.to(g.dtype)) * c.to(g.dtype))
            upd, self.mu[i], self.nu[i] = adam8bit_update(
                g, self.mu[i], self.nu[i], bc1, bc2, self.b1, self.b2, self.eps, self.block_size)
            t = p * self.weight_decay  # add_decayed_weights: u + wd * p, in f32
            t.add_(upd)
            t.mul_(-lr)  # scale_by_learning_rate
            p.add_(t)  # apply_updates
        self.count = count_inc

    def layout(self) -> Dict:
        return {**super().layout(), "use_8bit_adam": True}

    def state_tensors(self) -> List[torch.Tensor]:
        return [t for qs in self.mu + self.nu for t in qs] + super().state_tensors()

    def _moments_state(self) -> Dict:
        return {"mu_q": [q for q, _ in self.mu], "mu_scale": [s for _, s in self.mu],
                "nu_q": [q for q, _ in self.nu], "nu_scale": [s for _, s in self.nu]}

    def _load_moments(self, state: Dict) -> None:
        for name in ("mu", "nu"):
            for (q, s), q_in, s_in in zip(getattr(self, name), state[f"{name}_q"], state[f"{name}_scale"]):
                if q_in.shape != q.shape or s_in.shape != s.shape:
                    raise ValueError(
                        f"checkpoint int8 {name} codes {tuple(q_in.shape)} and scales {tuple(s_in.shape)} do not "
                        f"match this optimizer's {tuple(q.shape)} and {tuple(s.shape)} (block size {self.block_size})")
                q.copy_(q_in)
                s.copy_(s_in)
