"""AdamW with int8 block-quantized moments (port of trainers/adam8bit.py).

``--use-8bit-adam``: the JAX package's analog of bitsandbytes' AdamW8bit. The
first moment is stored as int8 codes of ``mu`` and the second as int8 codes of
``sqrt(nu)``, each with f32 absmax scales per block of ``block_size`` (256)
along the parameter's output channel; the update math is f32. The codes, the
blocked layout and the step are in ``ops/adam8bit_update.py``
(:func:`quantize`, :func:`dequantize`, and K9, the CUDA kernel that runs the
whole optimizer step on the card in one launch).

:class:`AdamW8bit` composes as the JAX chain does (``trainers/optim.py``
``build_optimizer``): ``fused_accumulate(as_fused_apply(chain(
clip_by_global_norm(c), scale_by_adam_8bit, add_decayed_weights(wd),
scale_by_learning_rate(lr))), k, acc_dtype)``, and without accumulation the
chain alone. Per leaf, in this order (on the card all of it inside K9, one
launch over every leaf, the state and the parameters updated in place):

- the clip, ``optax.clip_by_global_norm``'s own order (optax 0.2.6):
  ``g`` when ``||g|| < c``, else ``(g / ||g||) * c``, in the gradient's dtype
  (a bf16 accumulator is clipped in bf16; its norm is taken in f32, see
  ``trainers/optim.py:global_norm``);
- K9: the update ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` in the gradient's
  dtype and the requantized moments;
- ``u + wd * p``, times ``-lr``, added to ``p`` (``apply_updates``), in f32.

On the card the update itself never reaches device memory. The accumulation is shared with
:class:`~stable_diffusion_pytorch_tpu_torch.trainers.optim.AdamW`
(:class:`~stable_diffusion_pytorch_tpu_torch.trainers.optim.Accumulating`).

Under ZeRO (``--shard-optimizer-state``) the leaves are the rank's slices
(``parallel/data_parallel.py``), cut by the JAX package's per-shard rule
(``parallel/mesh.py:int8_shard_dim``, JAX ``shard_plan``): along a torch dim
other than 0, so every block (all of one column's rows along dim 0) lies
whole in one rank, or, where no such cut exists, the leaf stays whole on
every rank. K9 then runs once per rank per optimizer step, over the rank's
slices and its whole leaves, planned by ``adam8bit_plan`` on those shapes;
the blocks, and so the codes and scales, are the ones a one-device run
computes.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import Adam8bitStep, zeros_state
from stable_diffusion_pytorch_tpu_torch.trainers.optim import Accumulating


class AdamW8bit(Accumulating):
    """clip-by-global-norm + AdamW with int8 moments, optionally accumulated.

    State: ``count``, and per parameter ``mu`` and ``nu`` as (int8 codes in
    the parameter's shape, f32 scales ``[nb, *shape[1:]]``); ``nu`` holds
    ``sqrt(nu)``. ``step`` updates the code and scale tensors in place, so
    their pointers, and the kernel's leaf table (built here on CUDA
    parameters), stay as they are."""

    def __init__(self, params: List[torch.Tensor], schedule, block_size: int = 256, **kw):
        super().__init__(params, schedule, **kw)
        self.block_size = block_size
        self.mu = [zeros_state(p, block_size) for p in self.params]
        self.nu = [zeros_state(p, block_size) for p in self.params]
        self._step = Adam8bitStep(self.params, self.mu, self.nu, block_size)

    def _update_leaves(self, idx, grads, norm, bc1, bc2, lr) -> None:
        """One K9 launch over the leaves ``idx``: all of them through the step
        made at construction, a group (offload) through one made for it."""
        idx = list(idx)
        if len(idx) == len(self.params):
            step, grads = self._step, list(grads)
        else:
            step = Adam8bitStep([self.params[i] for i in idx], [self.mu[i] for i in idx],
                                [self.nu[i] for i in idx], self.block_size)
            grads = [grads[i] for i in idx]
        step(grads, norm, bc1, bc2, lr, self.b1, self.b2, self.eps, self.weight_decay, self.max_grad_norm)

    def layout(self) -> Dict:
        return {**super().layout(), "use_8bit_adam": True}

    def state_tensors(self) -> List[torch.Tensor]:
        return [t for qs in self.mu + self.nu for t in qs] + super().state_tensors()

    def _moment_lists(self) -> List[list]:
        return [self.mu, self.nu]

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
