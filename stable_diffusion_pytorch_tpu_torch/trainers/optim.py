"""Learning-rate schedules and the AdamW update (port of trainers/optim.py and
trainers/fused_adamw.py).

The schedules are the JAX package's optax schedules written out: linear warmup
from 0 over ``warmup_steps`` optimizer steps, then linear, cosine, constant or
polynomial (power 1) decay over the rest; ``constant`` has no warmup. As in
optax, the update at optimizer step ``count`` (0-based) uses the rate at
``count``, so the first update of a warmup schedule has rate 0.

:class:`AdamW` is the math of the JAX package's ``fused_adamw`` (its ``_leaf``)
on lists of tensors with ``torch._foreach_*`` (one multi-tensor launch per
operation on a CUDA device). Its gradient clip is ``optax.clip_by_global_norm``'s
rule: scale 1 when ``||g|| < c``, else ``c / ||g||``, with no epsilon
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and differs).
Gradient accumulation over ``k`` micro steps is ``fused_accumulate``'s: a
running mean ``acc += (g - acc) / (i + 1)`` of the micro gradients, and the
update from that mean on the k-th. The JAX package has no Pallas kernel here;
the scalars stay on the device, so a step does not wait on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

SCHEDULES = ("linear", "cosine", "constant_with_warmup", "constant", "polynomial")


def build_lr_schedule(scheduler_type: str, learning_rate: float, warmup_steps: int, total_steps: int):
    """``f(step) -> lr`` (optax ``join_schedules`` of warmup and decay)."""
    if scheduler_type not in SCHEDULES:
        raise ValueError(f"unknown scheduler_type {scheduler_type!r}")
    lr = float(learning_rate)
    warmup_len = max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)

    def warmup(step: int) -> float:
        frac = min(max(step, 0), warmup_len) / warmup_len
        return lr * frac

    def decay(step: int) -> float:
        frac = min(max(step, 0), decay_steps) / decay_steps
        if scheduler_type in ("linear", "polynomial"):
            return lr * (1.0 - frac)
        if scheduler_type == "cosine":
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr

    def schedule(step: int) -> float:
        if scheduler_type == "constant":
            return lr
        if step < warmup_steps:
            return warmup(step)
        return decay(step - warmup_steps)

    return schedule


def lr_at_step(optim_cfg, max_train_steps: int, opt_step: int) -> float:
    """The learning rate at optimizer step ``opt_step``, for logging."""
    return build_lr_schedule(
        optim_cfg.scheduler_type, optim_cfg.learning_rate, optim_cfg.lr_warmup_steps, max_train_steps
    )(opt_step)


class AdamW:
    """clip-by-global-norm + AdamW over ``params``, optionally accumulated over
    ``accum_steps`` micro steps.

    ``step(grads)`` takes the micro step's gradients (one per parameter) and
    returns the global norm of those gradients (a 0-d f32 tensor). It applies
    the update when the micro step completes an accumulation window and
    returns whether it did. State: ``count`` (updates applied), ``mu``, ``nu``
    (f32, like the parameters), and with accumulation ``mini_step`` and
    ``acc``."""

    def __init__(
        self,
        params: List[torch.Tensor],
        schedule,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        max_grad_norm: Optional[float] = None,
        accum_steps: int = 1,
    ):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.accum_steps = accum_steps
        self.count = 0
        self.mini_step = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            self.acc = (
                [torch.zeros_like(p, dtype=torch.float32) for p in self.params] if accum_steps > 1 else None
            )

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        """sqrt(sum of squares) over every element of every gradient, f32."""
        norms = torch._foreach_norm([g.float() for g in grads])
        return torch.linalg.vector_norm(torch.stack(norms))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        """-> (applied, global norm of ``grads``)."""
        grads = [g.float() for g in grads]
        norm = self.global_norm(grads)
        if self.acc is None:
            self._update(grads, norm)
            return True, norm
        # running mean of the micro gradients (fused_accumulate's formula)
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step < self.accum_steps - 1:
            self.mini_step += 1
            return False, norm
        self._update(self.acc, self.global_norm(self.acc))
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        return True, norm

    def _update(self, grads: List[torch.Tensor], norm: torch.Tensor) -> None:
        b1, b2 = self.b1, self.b2
        count_inc = self.count + 1
        # f32 scalars, as optax computes them
        bc1 = float(torch.tensor(1.0) - torch.tensor(b1) ** torch.tensor(float(count_inc)))
        bc2 = float(torch.tensor(1.0) - torch.tensor(b2) ** torch.tensor(float(count_inc)))
        lr = float(torch.tensor(self.schedule(self.count), dtype=torch.float32))
        if self.max_grad_norm is not None:
            c = torch.tensor(self.max_grad_norm, dtype=torch.float32, device=norm.device)
            scale = torch.where(norm < c, torch.ones_like(norm), c / norm)
            g = torch._foreach_mul(grads, scale)
        else:
            g = grads
        # mu = b1 mu + (1 - b1) g ; nu = b2 nu + (1 - b2) g^2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        # adam = (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        adam = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(adam, denom)
        # p = p - lr (adam + wd p)
        torch._foreach_add_(adam, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(adam, lr)
        torch._foreach_sub_(self.params, adam)
        self.count = count_inc

    def state_dict(self) -> Dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu,
                "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for name in ("mu", "nu", "acc"):
            dst, src = getattr(self, name), state[name]
            if (dst is None) != (src is None):
                raise ValueError(
                    f"checkpoint optimizer state {name!r} does not match this run's "
                    "--gradient-accumulation-steps"
                )
            for d, s in zip(dst or [], src or []):
                d.copy_(s)


def build_optimizer(params, optim_cfg, max_train_steps: int, gradient_accumulation_steps: int = 1) -> AdamW:
    """clip-by-global-norm -> AdamW(schedule, wd), accumulated over k micro
    steps: the JAX package's default (fused) optimizer. The 8-bit optimizer
    and the bf16 moment or accumulator storage are not ported."""
    if getattr(optim_cfg, "use_8bit_adam", False):
        raise NotImplementedError("--use-8bit-adam is not ported yet (ROADMAP queue 2, K9)")
    for flag in ("adam_mu_dtype", "adam_nu_dtype", "accum_dtype"):
        if getattr(optim_cfg, flag, "f32") != "f32":
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} bf16 is not ported yet (ROADMAP queue 1, slice 2 follow-ups)"
            )
    schedule = build_lr_schedule(
        optim_cfg.scheduler_type, optim_cfg.learning_rate, optim_cfg.lr_warmup_steps, max_train_steps
    )
    return AdamW(
        params, schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=optim_cfg.adam_weight_decay,
        max_grad_norm=optim_cfg.max_grad_norm, accum_steps=gradient_accumulation_steps,
    )
