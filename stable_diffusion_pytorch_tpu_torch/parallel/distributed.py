"""Process-group start-up for multi-device training (port of parallel/distributed.py).

The reference relies on ``accelerate launch`` to spawn and wire the ranks
(the reference's ``train_unet.py:37,567``). The port runs one process per card,
started by ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N``),
which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. :func:`maybe_initialize` joins that group; with no launcher
and no explicit arguments it does nothing, and the run is one process on one
device, as before. The backend is NCCL for a CUDA device and gloo for
``--device cpu``; each rank takes ``cuda:LOCAL_RANK``. A barrier right after
the start makes every rank meet once before any model is built (the JAX
package warms its collective fabric at the same point).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import torch

logger = logging.getLogger(__name__)

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
TIMEOUT_S = 600  # of a collective that never completes: a hung rank fails the run


def maybe_initialize(
    device: str = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join the process group when a launcher's environment or explicit
    arguments say there is one -> True when a group is up (started here or
    before). ``init_method`` is a rendezvous address (``tcp://host:port``);
    without it the launcher's ``env://`` is used."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    if init_method is None and world_size is None and not all(k in os.environ for k in LAUNCHER_ENV):
        return False
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    world = int(world_size if world_size is not None else os.environ["WORLD_SIZE"])
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1))))
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", init_method=init_method or "env://", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    barrier()
    logger.info(f"torch.distributed initialized: rank {rank}/{world}, backend {dist.get_backend()}")
    return True


def host_shard_info() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Every rank meets here (nothing without a process group)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def main_first(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on rank 0 alone, then a barrier: for files
    that every rank reads after (class images, a latent cache), written once.
    -> rank 0's result, None on the other ranks."""
    out = fn(*args, **kwargs) if host_shard_info()[0] == 0 else None
    barrier()
    return out
