"""Tensor parallelism of the UNet's transformer blocks (``--tensor-parallel T``;
port of the JAX package's ``tp_shardings`` and ``ops/attention.py:set_tp_mesh``).

Megatron's split, on the model group of ``T`` adjacent ranks
(``parallel/mesh.py:get_mesh``), for every attention layer and feed-forward
of the UNet:

- column-parallel ``to_q``/``to_k``/``to_v``: rank ``r`` keeps the rows of
  heads ``[r H/T, (r + 1) H/T)``, so the flash-attention kernel (K1 forward,
  the split backward) runs on the rank's ``H/T`` local heads;
- column-parallel GEGLU ``proj``: its output is ``[value | gate]`` (``chunk(2)``
  in ``models/blocks.py``), so rank ``r`` keeps its slice of *both* halves
  (rows ``[r F/T, (r + 1) F/T)`` and ``F`` plus those) and its bias rows,
  and its ``chunk(2)`` splits its own value and gate slices;
- row-parallel attention ``out.0`` and FFN ``net.2``: rank ``r`` keeps the
  input columns matching its heads (its FFN slice); the partial products are
  summed over the group, then the bias, kept whole, is added once.

The group's inputs pass :class:`_Enter` (identity forward, all-reduce of the
gradient backward) and the row-parallel outputs :class:`_Exit` (all-reduce
forward, identity backward), so every weight kept whole (convs, norms, the
rest) gets the same gradient on every rank of the group. The split weights
are the module's own parameters, cut in place: their gradients are
complete for each slice.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ModelGroup:
    """The model group a split module runs on: ``size`` ranks, this one ``rank``."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def enter(self, x):
        return None if x is None else _Enter.apply(x, self.group)

    def exit(self, x):
        return _Exit.apply(x, self.group)


Layout = Tuple[int, int]  # (the dim a leaf is split along, the blocks of that dim each split T ways)


def split(full: torch.Tensor, layout: Layout, t: int, r: int) -> torch.Tensor:
    """Rank ``r``'s piece of a whole leaf: along ``dim``, each of ``halves``
    equal blocks cut ``t`` ways (GEGLU's ``proj``: 2 blocks, value and gate)."""
    dim, halves = layout
    n = full.shape[dim] // (halves * t)
    return torch.cat([full.narrow(dim, (h * t + r) * n, n) for h in range(halves)], dim)


def join(pieces: Sequence[torch.Tensor], layout: Layout) -> torch.Tensor:
    """The whole leaf of the ranks' pieces (the inverse of :func:`split`)."""
    dim, halves = layout
    blocks = [p.chunk(halves, dim) for p in pieces]
    return torch.cat([b[h] for h in range(halves) for b in blocks], dim)


@torch.no_grad()
def shard_unet(unet: nn.Module, tp: ModelGroup) -> Dict[str, Layout]:
    """Cut the UNet's attention and feed-forward weights for ``tp`` in place
    -> {parameter name: its :data:`Layout`} (the rest stay whole)."""
    from stable_diffusion_pytorch_tpu_torch.models.blocks import CrossAttention, FeedForward

    t, r = tp.size, tp.rank
    dims: Dict[str, Layout] = {}

    def put(module: nn.Module, attr: str, layout: Layout, name: str) -> None:
        old = getattr(module, attr)
        setattr(module, attr, nn.Parameter(split(old.detach(), layout, t, r).contiguous(),
                                           requires_grad=old.requires_grad))
        dims[name] = layout

    for name, m in unet.named_modules():
        if isinstance(m, CrossAttention):
            if m.n_heads % t:
                raise ValueError(f"{name}: {m.n_heads} heads do not split --tensor-parallel {t} ways")
            for proj in ("to_q", "to_k", "to_v"):
                put(getattr(m, proj), "weight", (0, 1), f"{name}.{proj}.weight")
            put(m.out[0], "weight", (1, 1), f"{name}.out.0.weight")
            m.tp = tp
        elif isinstance(m, FeedForward):
            proj = m.net[0].proj
            if (proj.weight.shape[0] // 2) % t:
                raise ValueError(f"{name}: a feed-forward of {proj.weight.shape[0] // 2} does not split "
                                 f"--tensor-parallel {t} ways")
            put(proj, "weight", (0, 2), f"{name}.net.0.proj.weight")
            put(proj, "bias", (0, 2), f"{name}.net.0.proj.bias")
            put(m.net[2], "weight", (1, 1), f"{name}.net.2.weight")
            m.tp = tp
    return dims
