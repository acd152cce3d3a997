"""Placement rules and the device mesh (port of parallel/mesh.py).

The JAX package places arrays on a ``(data,)`` or ``(data, model)`` mesh and
lets XLA insert the collectives; the port runs one process per device and
issues them itself (``parallel/data_parallel.py``, ``parallel/fsdp.py``). What
carries over unchanged is *where* each leaf is cut, and this module holds
those rules as plain functions over shapes:

- :func:`largest_divisible_axis`, the JAX rule itself, on a JAX-layout shape:
  the largest non-minor axis whose size divides ``n``, else the minor axis,
  else none;
- :func:`zero_dim` (JAX ``zero_shardings``) and :func:`int8_shard_dim` (JAX
  ``trainers/adam8bit.py:shard_plan``): the same rules, answered in the
  port's torch dims (JAX ``tp_shardings`` is ``parallel/tensor_parallel.py``'s
  split);
- :func:`combined_zero_dim` (JAX ``combine_zero``): under tensor parallelism,
  the data axis's cut of the optimizer state on top of the model split.

The port stores a conv kernel ``[kh, kw, I, O]`` as ``[O, I, kh, kw]`` and a
dense kernel ``[I, O]`` as ``[O, I]`` (``utils/convert.py``); 1-D leaves keep
their shape, and every other 2-D leaf the optimizer sees (LoRA factors, the
textual-inversion vectors: ``trainers/steps.py:Trainables``) is the JAX
leaf's transpose. So JAX's minor axis, the output channel along which the
int8 blocks run, is torch dim 0, and JAX's choice of a non-minor axis lands
on a torch dim other than 0: every int8 block (all of one column's rows along
dim 0) stays whole inside one rank. :func:`jax_shape` and :func:`torch_dim`
are that map, and a test holds the port's dims equal to the JAX package's
axes over every SD-1.5 UNet leaf.

:func:`get_mesh` builds the ``DeviceMesh`` from the process group as
``get_mesh`` builds its grid: adjacent ranks form the model groups.
:func:`per_device_bytes` counts the bytes of tensors resident on a device.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

# torch dim d of a port leaf holds JAX axis _PERM[ndim][d]
_PERM = {1: (0,), 2: (1, 0), 4: (3, 2, 0, 1)}


def jax_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """The JAX package's shape of a port leaf of ``shape``."""
    shape = tuple(int(s) for s in shape)
    perm = _PERM.get(len(shape))
    if perm is None:
        return shape
    out = [0] * len(shape)
    for d, a in enumerate(perm):
        out[a] = shape[d]
    return tuple(out)


def torch_dim(jax_axis: Optional[int], ndim: int) -> Optional[int]:
    """The port's dim holding JAX axis ``jax_axis`` of an ``ndim``-d leaf."""
    if jax_axis is None:
        return None
    perm = _PERM.get(ndim)
    return jax_axis if perm is None else perm.index(jax_axis)


def largest_divisible_axis(shape: Sequence[int], n: int) -> Optional[int]:
    """JAX's rule on a JAX-layout ``shape``: the largest NON-MINOR axis whose
    size divides ``n`` evenly, falling back to the minor axis, else None.
    Preferring a leading axis keeps the int8 optimizer's minor-axis blocks
    whole within each shard."""
    best_axis, best_size = None, 0
    for axis, size in enumerate(shape[:-1]):
        if size > best_size and size % n == 0 and size > 0:
            best_axis, best_size = axis, size
    if best_axis is None and len(shape) >= 1:
        c = shape[-1]
        if c > 0 and c % n == 0:
            return len(shape) - 1
    return best_axis


def zero_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The torch dim a port leaf of ``shape`` shards over ``n`` data ranks
    under ZeRO (JAX ``zero_shardings``), or None (replicated)."""
    if n <= 1 or len(shape) == 0:
        return None
    return torch_dim(largest_divisible_axis(jax_shape(shape), n), len(shape))


def int8_shard_dim(shape: Sequence[int], n: int, block_size: int = 256) -> Optional[int]:
    """The torch dim of a ZeRO shard whose int8 blocks stay whole (JAX
    ``shard_plan``: rank >= 2, the :func:`zero_dim` choice, and on the minor
    axis only when the shard keeps whole blocks of ``block_size``), or None:
    the leaf's int8 state then stays replicated, as the JAX package keeps
    such a leaf on its unsharded XLA path."""
    if n <= 1 or len(shape) < 2:
        return None
    js = jax_shape(shape)
    axis = largest_divisible_axis(js, n)
    if axis is None:
        return None
    if axis == len(js) - 1:
        c = js[-1]
        if not (c % block_size == 0 and c > block_size) or (c // n) % block_size != 0:
            return None
    return torch_dim(axis, len(shape))


def combined_zero_dim(shape: Sequence[int], n: int, model_dim: Optional[int] = None) -> Optional[int]:
    """JAX ``combine_zero`` for a whole port leaf of ``shape`` split over the
    model group along torch dim ``model_dim`` (None: kept whole): the torch
    dim of the largest JAX axis, the minor one included, other than the
    model split's, whose size divides ``n`` data ranks (the first of equal
    sizes), or None (replicated over the data group)."""
    if n <= 1 or len(shape) == 0:
        return None
    js = jax_shape(shape)
    perm = _PERM.get(len(shape))
    skip = None if model_dim is None else (model_dim if perm is None else perm[model_dim])
    best_axis, best_size = None, 0
    for axis, size in enumerate(js):
        if axis != skip and size > best_size and size % n == 0:
            best_axis, best_size = axis, size
    return torch_dim(best_axis, len(shape))


def zero_dims(shapes: Iterable[Sequence[int]], n: int, int8_block: Optional[int] = None) -> List[Optional[int]]:
    """:func:`zero_dim` of each shape, or with ``int8_block`` :func:`int8_shard_dim`."""
    if int8_block:
        return [int8_shard_dim(s, n, int8_block) for s in shapes]
    return [zero_dim(s, n) for s in shapes]


def combined_zero_dims(shapes: Iterable[Sequence[int]], layouts: Sequence, t: int, n: int,
                       int8_block: Optional[int] = None) -> List[Optional[int]]:
    """Each leaf's ZeRO dim under tensor parallelism, from the rank's pieces'
    ``shapes`` split by ``layouts`` (``parallel/tensor_parallel.py``; None:
    whole) over ``t`` model ranks: :func:`combined_zero_dim` of the whole
    leaf; with ``int8_block`` (the int8 optimizer, which updates a split leaf
    whole) :func:`int8_shard_dim` of the whole leaf, so its blocks stay whole."""
    out = []
    for shape, layout in zip(shapes, layouts):
        whole = [int(x) for x in shape]
        if layout is not None:
            whole[layout[0]] *= t
        out.append(int8_shard_dim(whole, n, int8_block) if int8_block
                   else combined_zero_dim(whole, n, None if layout is None else layout[0]))
    return out


def local_shape(shape: Sequence[int], dim: Optional[int], n: int) -> Tuple[int, ...]:
    """A rank's shard of a leaf cut along ``dim`` into ``n`` equal parts."""
    out = [int(s) for s in shape]
    if dim is not None:
        out[dim] //= n
    return tuple(out)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The rank's own storage of ``t``: a DTensor's local shard, else ``t``."""
    to_local = getattr(t, "to_local", None)
    if to_local is None:
        return t
    with torch.no_grad():
        return to_local()


def per_device_bytes(tensors: Iterable[torch.Tensor], device) -> int:
    """Bytes of ``tensors`` resident on ``device`` (a DTensor counts its
    local shard; tensors elsewhere, such as offloaded state in host memory,
    count nothing)."""
    device = torch.device(device)
    total = 0
    for t in tensors:
        t = local_tensor(t)
        if t.device.type == device.type and (device.index is None or t.device.index == device.index):
            total += t.numel() * t.element_size()
    return total


def get_mesh(device_type: str, model_parallel: int = 1):
    """The ``DeviceMesh`` over every rank of the process group: ``(data,)``,
    or ``(data, model)`` with ``model_parallel`` adjacent ranks per model
    group; None without a process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if model_parallel > 1:
        if world % model_parallel:
            raise ValueError(f"{world} ranks are not divisible by --tensor-parallel {model_parallel}")
        return init_device_mesh(device_type, (world // model_parallel, model_parallel),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return init_device_mesh(device_type, (world,), mesh_dim_names=(DATA_AXIS,))
