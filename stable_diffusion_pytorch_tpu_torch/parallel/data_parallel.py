"""Gradient averaging and ZeRO optimizer-state sharding over the data group.

The JAX package states a sharding for each array and XLA inserts the
collectives at the jit boundary (``parallel/mesh.py``, ``trainers/trainer.py:
_place_state``). Here the optimizer calls them itself, through
:class:`DataParallel`, once per optimizer step:

- data parallelism (every leaf replicated): the gradients (or, under
  accumulation, the window's accumulated mean) are all-reduced in buckets and
  divided by the data size, and the clip's global norm is taken from them;
- ZeRO (``--shard-optimizer-state``): each leaf with a shard dim (the JAX
  rule, ``parallel/mesh.py:zero_dim``, or for int8 moments ``int8_shard_dim``)
  is reduce-scattered along that dim, the rank updates its slice of the
  parameter (a tensor of its own, the ``local`` leaf the optimizer holds) and
  keeps moments for that slice only, and the slices are all-gathered back into
  the full parameter; leaves without a shard dim are all-reduced and updated
  whole on every rank. The global norm is ``sqrt`` of the all-reduced sum of
  squares of the shards plus that of the replicated leaves, each counted once;
- FSDP (``--shard-params``, ``parallel/fsdp.py``): the parameters are
  DTensors whose gradients FSDP has already reduce-scattered; the optimizer
  updates their local shards in place and the norm is all-reduced;
- tensor parallelism (``--tensor-parallel``, ``parallel/tensor_parallel.py``):
  the attention and feed-forward weights are this rank's slices, complete
  gradients for them; the norm adds their squares over the model group.
  With ``whole_model_leaves`` (the int8 optimizer, whose blocks along dim 0
  a head split would cut) a split leaf's gradient is gathered over the model
  group and the update runs on the whole leaf, the moments kept whole on
  every rank of the group, so each block's absmax is the whole block's.
  With ZeRO on top (JAX ``combine_zero``) each leaf's update unit, the
  rank's piece or the gathered whole leaf, is cut again over the data group
  along its ZeRO dim, exactly as without tensor parallelism.

Without a process group every call is the identity and the norm is the
single-device one, so a one-process run is unchanged. With a group of one
rank the collectives still run (over NCCL on the card) and give the same
values. A collective the backend cannot do raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from stable_diffusion_pytorch_tpu_torch.parallel.mesh import local_tensor

BUCKET_BYTES = 64 << 20  # of one all-reduce of replicated gradients


def _is_dtensor(t) -> bool:
    return hasattr(t, "device_mesh") and hasattr(t, "placements")


def _sumsq(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The f32 sum over ``tensors`` of ``sum(x * x)`` (0-d, on ``device``)."""
    tensors = [t for t in tensors if t.numel()]
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=device)
    return (torch.stack(torch._foreach_norm(tensors, dtype=torch.float32)) ** 2).sum()


def _fsdp_chunk(full: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    """FSDP's shard of ``full`` along ``dim`` (``torch.chunk``; empty past the chunks)."""
    chunks = torch.chunk(full, world, dim=dim)
    if rank < len(chunks):
        return chunks[rank]
    return full.narrow(dim, 0, 0)


class DataParallel:
    """One optimizer's leaves over the data group ``group``.

    ``params``: the full parameters (module parameters or trainable leaves),
    or FSDP's DTensor parameters. ``dims``: each leaf's ZeRO shard dim (None:
    replicated; all None without ZeRO). ``local`` lists what the optimizer
    updates: a sharded leaf's slice (a tensor of its own), a replicated
    leaf's parameter itself, or a DTensor's local shard."""

    def __init__(self, params: Sequence[torch.Tensor], group=None, dims: Optional[Sequence[Optional[int]]] = None,
                 model=None, layouts: Optional[Sequence] = None, whole_model_leaves: bool = False):
        import torch.distributed as dist

        self.params = list(params)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.dims = list(dims) if dims is not None else [None] * len(self.params)
        self.model = model  # parallel/tensor_parallel.py:ModelGroup, or None
        self.layouts = list(layouts) if layouts is not None else [None] * len(self.params)
        self.whole_model_leaves = bool(whole_model_leaves and model is not None)
        if len(self.dims) != len(self.params) or len(self.layouts) != len(self.params):
            raise ValueError(f"{len(self.dims)} shard dims, {len(self.layouts)} layouts for {len(self.params)} leaves")
        self.fsdp = any(_is_dtensor(p) for p in self.params)
        if self.fsdp and any(d is not None for d in self.dims):
            raise ValueError("FSDP parameters carry their own placement: no ZeRO dims on top")
        with torch.no_grad():
            self.local = []
            for i, d in enumerate(self.dims):
                unit = self._unit(i)
                if d is not None and unit.shape[d] % self.world:
                    raise ValueError(f"a leaf of shape {tuple(unit.shape)} does not split {self.world} ways on dim {d}")
                self.local.append(unit if d is None else self._slice(unit, i).clone(memory_format=torch.contiguous_format))

    def _joined(self, i: int) -> bool:
        """Whether leaf ``i``'s update runs on the whole leaf gathered over
        the model group (``whole_model_leaves``)."""
        return self.whole_model_leaves and self.layouts[i] is not None

    def _unit(self, i: int) -> torch.Tensor:
        """What leaf ``i``'s update covers before a ZeRO cut: the whole leaf
        gathered over the model group, or the rank's own parameter."""
        p = self.params[i]
        return self.gather_param(i, p.detach()) if self._joined(i) else local_tensor(p)

    def _split(self) -> List[int]:
        """The leaves split over the model group."""
        return [i for i, lay in enumerate(self.layouts) if lay is not None]

    def _model_join(self, i: int, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        from stable_diffusion_pytorch_tpu_torch.parallel.tensor_parallel import join

        t = t.contiguous()
        pieces = [torch.empty_like(t) for _ in range(self.model.size)]
        dist.all_gather(pieces, t, group=self.model.group)
        return join(pieces, self.layouts[i])

    @property
    def active(self) -> bool:
        return self.group is not None

    def _slice(self, full: torch.Tensor, i: int) -> torch.Tensor:
        d = self.dims[i]
        s = full.shape[d] // self.world
        return full.narrow(d, self.rank * s, s)

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The data group's mean gradient of each ``local`` leaf, and the
        global norm of the whole mean gradient (f32, 0-d)."""
        from stable_diffusion_pytorch_tpu_torch.trainers.optim import global_norm

        if not self.active:
            return list(grads), global_norm(list(grads))
        import torch.distributed as dist

        if self.fsdp:  # FSDP reduce-scattered the gradients in the backward
            local = [local_tensor(g) for g in grads]
            sq = _sumsq(local, self.local[0].device)
            dist.all_reduce(sq, group=self.group)
            return local, sq.sqrt()
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        replicated = [i for i, d in enumerate(self.dims) if d is None]
        self.all_reduce([grads[i] for i in replicated])
        for i in replicated:
            out[i] = self._model_join(i, grads[i]) if self._joined(i) else grads[i]
        sharded = [i for i, d in enumerate(self.dims) if d is not None]
        for i in sharded:
            g = self._model_join(i, grads[i]) if self._joined(i) else grads[i]
            out[i] = self._reduce_scatter_mean(g, self.dims[i])
        split = [] if self.model is None or self.whole_model_leaves else self._split()
        if not sharded and not split:
            return out, global_norm(out)
        return out, self._norm(out, split)

    def _norm(self, out: Sequence[torch.Tensor], split: Sequence[int]) -> torch.Tensor:
        """sqrt of the whole mean gradient's sum of squares from the rank's
        pieces ``out``: a ZeRO slice's squares summed over the data group,
        a model-split leaf's (``split``) over the model group, every piece
        held alike by several ranks counted once."""
        import torch.distributed as dist

        device = out[0].device

        def part(idx):
            cut = [i for i in idx if self.dims[i] is not None]
            sq = _sumsq([out[i] for i in cut], device)
            if cut:
                dist.all_reduce(sq, group=self.group)
            return sq + _sumsq([out[i] for i in idx if self.dims[i] is None], device)

        mine = set(split)
        sq = part([i for i in range(len(out)) if i in mine])
        if mine:
            dist.all_reduce(sq, group=self.model.group)
        return (sq + part([i for i in range(len(out)) if i not in mine])).sqrt()

    def all_reduce(self, tensors: Sequence[torch.Tensor], mean: bool = True) -> None:
        """Every tensor replaced in place by its sum (``mean``: its mean) over
        the group, in buckets of :data:`BUCKET_BYTES` (one flat buffer of one
        dtype a bucket)."""
        import torch.distributed as dist
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        bucket: List[torch.Tensor] = []
        size = 0

        def flush():
            if not bucket:
                return
            flat = _flatten_dense_tensors(bucket)
            dist.all_reduce(flat, group=self.group)
            if mean:
                flat.div_(self.world)
            for t, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                t.copy_(r)
            bucket.clear()

        for t in tensors:
            if bucket and (t.dtype != bucket[0].dtype or size + t.numel() * t.element_size() > BUCKET_BYTES):
                flush()
                size = 0
            bucket.append(t)
            size += t.numel() * t.element_size()
        flush()

    def _reduce_scatter_mean(self, g: torch.Tensor, d: int) -> torch.Tensor:
        """This rank's slice along ``d`` of the group's mean of ``g`` (contiguous)."""
        import torch.distributed as dist

        moved = g.movedim(d, 0).contiguous()
        out = torch.empty((moved.shape[0] // self.world, *moved.shape[1:]), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, moved, group=self.group)
        out.div_(self.world)
        return out.movedim(0, d).contiguous()

    @torch.no_grad()
    def take_params(self) -> None:
        """Copy each sharded leaf's slice of its parameter (each whole
        model-split leaf, gathered) into its local leaf, after the parameters
        were written, as by a checkpoint restore."""
        for i, d in enumerate(self.dims):
            if d is not None or self._joined(i):
                unit = self._unit(i).detach()
                self.local[i].copy_(unit if d is None else self._slice(unit, i))

    @torch.no_grad()
    def after_update(self) -> None:
        """All-gather each sharded leaf's updated slices into its full
        parameter; a whole model-split leaf's update back into its slice."""
        for i, d in enumerate(self.dims):
            if d is None and not self._joined(i):
                continue
            unit = self.local[i] if d is None else self._gather_zero(i, self.local[i])
            self.params[i].copy_(self.shard_param(i, unit) if self._joined(i) else unit)

    # ------------------------------------------------------------------ #
    # the checkpoint layout
    # ------------------------------------------------------------------ #

    def gathers(self, i: int) -> bool:
        """Whether :meth:`gather` of leaf ``i`` runs a collective."""
        if self.fsdp or (self.active and self.dims[i] is not None):
            return self.active
        return self.model is not None and not self.whole_model_leaves and self.layouts[i] is not None

    def gather(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The whole-leaf tensor of leaf ``i``'s piece ``t`` of optimizer
        state (a collective: every rank calls it)."""
        if self.fsdp:
            return self.gather_param(i, t)
        t = self._gather_zero(i, t)
        if self.model is None or self.whole_model_leaves:
            return t
        return self.gather_param(i, t)

    def gather_param(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The whole-leaf tensor of this rank's piece ``t`` of parameter ``i``
        (or of a tensor laid out as it: its EMA, its gradient accumulator)."""
        if self.model is not None and self.layouts[i] is not None:
            return self._model_join(i, t)
        if not (self.active and self.fsdp):
            return t
        return self._gather_fsdp(i, t)

    def _gather_fsdp(self, i: int, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        d = self.params[i].placements[0].dim
        sizes = [0] * self.world  # FSDP2 cuts a dim that does not divide unevenly
        dist.all_gather_object(sizes, int(t.shape[d]), group=self.group)
        moved = t.movedim(d, 0).contiguous()
        parts = [torch.empty((s, *moved.shape[1:]), dtype=t.dtype, device=t.device) for s in sizes]
        dist.all_gather(parts, moved, group=self.group)
        return torch.cat(parts, 0).movedim(0, d).contiguous()

    def _gather_zero(self, i: int, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        d = self.dims[i]
        if d is None or not self.active:
            return t
        moved = t.movedim(d, 0).contiguous()
        out = torch.empty((self.world * moved.shape[0], *moved.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, moved, group=self.group)
        return out.movedim(0, d)

    def shard(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of optimizer state of leaf ``i`` from its
        whole-leaf tensor ``full``."""
        if self.fsdp:
            return self.shard_param(i, full)
        if self.model is not None and not self.whole_model_leaves:
            full = self.shard_param(i, full)
        if self.dims[i] is None or not self.active:
            return full
        return self._slice(full, i)

    def shard_param(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of parameter ``i`` (or of a tensor laid out as it)."""
        if self.model is not None and self.layouts[i] is not None:
            from stable_diffusion_pytorch_tpu_torch.parallel.tensor_parallel import split

            return split(full, self.layouts[i], self.model.size, self.model.rank)
        if self.active and self.fsdp:
            return _fsdp_chunk(full, self.params[i].placements[0].dim, self.rank, self.world)
        return full
