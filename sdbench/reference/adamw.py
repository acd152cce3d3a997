"""AdamW (Loshchilov & Hutter 2019) after a clip of the global gradient norm,
in float32, on a list of parameters.

Update ``count`` (0-based): g <- g * min(1, c / ||g||) (no clip when the norm
is below c); mu = b1 mu + (1 - b1) g; nu = b2 nu + (1 - b2) g^2; p <- p - lr
((mu / (1 - b1^(count+1))) / (sqrt(nu / (1 - b2^(count+1))) + eps) + wd p),
with lr the schedule's rate at ``count``: a linear warmup from 0 over W
updates, then a linear decay to 0 at the last update (optax's
``join_schedules`` of the two).
"""

from __future__ import annotations

from typing import List

import torch


def linear_schedule(lr: float, warmup: int, total: int):
    w = max(warmup, 1)
    decay = max(total - warmup, 1)

    def at(count: int) -> float:
        if count < warmup:
            return lr * min(max(count, 0), w) / w
        return lr * (1.0 - min(max(count - warmup, 0), decay) / decay)

    return at


class AdamW:
    def __init__(self, params: List[torch.Tensor], optim: dict, total_steps: int):
        if optim["scheduler_type"] != "linear":
            raise ValueError(f"unsupported schedule {optim['scheduler_type']!r}")
        self.params = params
        self.lr = linear_schedule(optim["learning_rate"], optim["lr_warmup_steps"], total_steps)
        self.b1, self.b2, self.eps = optim["adam_beta1"], optim["adam_beta2"], optim["adam_epsilon"]
        self.wd, self.clip = optim["adam_weight_decay"], optim["max_grad_norm"]
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Apply one update -> the norm of each clipped gradient it used."""
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        c = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** c, 1.0 - self.b2 ** c
        lr = self.lr(self.count)
        used = []
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.float() * scale
            used.append(torch.linalg.vector_norm(g))
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            adam = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            p.sub_(lr * (adam + self.wd * p))
        self.count += 1
        return used
