"""Parameter sharding over the data group (``--shard-params``; the JAX
package's FSDP analog, ``trainers/trainer.py:_place_state`` with
``zero_shardings`` on the parameters).

PyTorch's FSDP2 ``fully_shard`` wraps each ResBlock and SpatialTransformer of
the trainable module, then the module itself: between uses each parameter is
a DTensor holding this rank's shard, a block's parameters are all-gathered
just before it runs (again in a remat block's recompute) and freed after,
and their gradients are reduce-scattered (averaged over the group) in the
backward. The shard dim of each parameter is the JAX rule's
(``parallel/mesh.py:zero_dim``), not FSDP2's default dim 0, so the int8
blocks along dim 0 stay whole; a leaf that rule leaves replicated takes
FSDP2's uneven split along dim 0. The parameters stay f32 (no FSDP mixed
precision policy): the run's ``torch.autocast`` casts inside the ops as on
one device, and the kernels take the gathered, unsharded tensors.

FSDP2 takes only contiguous parameters, so the conv weights leave
``channels_last`` for the standard layout (cuDNN takes either).
"""

from __future__ import annotations

import torch
from torch import nn

from stable_diffusion_pytorch_tpu_torch.parallel.mesh import zero_dim


def shard_module(module: nn.Module, mesh) -> nn.Module:
    """``fully_shard`` ``module`` over the 1-D data ``mesh``, block by block, in place."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from stable_diffusion_pytorch_tpu_torch.models.blocks import ResBlock, SpatialTransformer

    n = mesh.size()

    def placement(p: torch.Tensor):
        d = zero_dim(p.shape, n)
        return Shard(0 if d is None else d)

    with torch.no_grad():
        for p in module.parameters():
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    for m in module.modules():
        if isinstance(m, (ResBlock, SpatialTransformer)):
            fully_shard(m, mesh=mesh, shard_placement_fn=placement)
    fully_shard(module, mesh=mesh, shard_placement_fn=placement)
    return module
