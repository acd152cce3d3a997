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

The step's scalars (the bias corrections and the learning rate) are
computed on the host in f32, as optax does (:meth:`Accumulating.scalar_rows`),
and every update reads them from one device buffer, ``scalars`` (f32
``[bc1, bc2, lr, 0]``), never as Python floats: a CUDA graph that captured a
step would replay the floats it saw at capture. The per-step path uploads
the update's row into that buffer; chained dispatch (``trainers/chain.py``)
uploads a chunk's rows at once and copies row i into it before step i
(``fed``). CUDA divides by a Python float through its reciprocal, by a
tensor exactly, so the buffer is also IEEE division, as in JAX.

Narrow storage (``--adam-mu-dtype``, ``--adam-nu-dtype``, ``--accum-dtype``
bf16) keeps the math of ``fused_adamw._leaf`` and ``fused_accumulate._accumulate``:
each leaf is computed in f32 and each store rounds once. The update then runs
leaf by leaf (``torch._foreach_*`` on bf16 lists would round after every
operation, and upcasting whole lists would undo the memory saved). The clip's
norm is taken in f32 for a bf16 accumulator too (:func:`global_norm` says
where that departs from the JAX package). :class:`~stable_diffusion_pytorch_tpu_torch.trainers.adam8bit.AdamW8bit`
(``--use-8bit-adam``) shares the accumulation (:class:`Accumulating`).
:class:`ChainAdamW` (``--no-fused-adamw``) is the unfused optax chain under
``optax.MultiSteps``, in optax's order of operations.

Over several devices (``parallel/data_parallel.py:DataParallel``) the
optimizer holds what its rank updates: the whole leaves under data
parallelism, a ZeRO rank's slices, or FSDP's local shards. The gradients are
averaged over the data group once per optimizer step (the micro gradients, or
under accumulation the window's mean), the moments are kept for the rank's
slices only, and the slices are gathered back into the parameters after the
update. ``state_dict`` gathers the state into the one-device layout and
``load_state_dict`` takes that layout at any world size. ``offload``
(``--offload-optimizer``) keeps the moments in pinned host memory between
steps; the update runs over groups of leaves whose moments fill at most
:data:`OFFLOAD_GROUP_BYTES`, each group's moments copied to the device, the
group updated (one foreach pass, or one K9 launch), and copied back, so the
device holds one group's moments at a time. Every leaf's math is the one of
the whole update, bit for bit. The accumulator stays on the device, where
every micro step adds to it.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.parallel.data_parallel import DataParallel
from stable_diffusion_pytorch_tpu_torch.parallel.mesh import local_tensor

SCHEDULES = ("linear", "cosine", "constant_with_warmup", "constant", "polynomial")
OFFLOAD_GROUP_BYTES = 512 << 20  # of offloaded moments on the device at once


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


_FLAGS = {
    "use_8bit_adam": "--use-8bit-adam",
    "adam_mu_dtype": "--adam-mu-dtype",
    "adam_nu_dtype": "--adam-nu-dtype",
    "gradient_accumulation": "--gradient-accumulation-steps",
    "accum_dtype": "--accum-dtype",
    "no_fused_adamw": "--no-fused-adamw",
}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def storage_dtype(name: str) -> torch.dtype:
    """``f32`` or ``bf16`` (the storage-dtype flags' values) -> torch dtype."""
    return {"f32": torch.float32, "bf16": torch.bfloat16}[name]


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def upload(host: np.ndarray, out: torch.Tensor) -> torch.Tensor:
    """Copy ``host`` into ``out``: on a CUDA device from pinned memory, queued on
    the current stream (the caching host allocator keeps the staging buffer
    until the copy has run), so the host does not wait. -> ``out``."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if out.is_cuda:
        return out.copy_(src.pin_memory(), non_blocking=True)
    return out.copy_(src)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of ``sum(x * x)``, in f32 (a 0-d tensor)
    whatever the leaves' dtype. For a bf16 accumulator this departs from the
    JAX package on purpose: there ``optax.global_norm`` sums the leaves in
    bf16, one by one in tree order, so its value depends on the leaf order
    and a leaf below 1/512 of the running total adds nothing."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors, dtype=torch.float32)))


def clip_limit(max_grad_norm: float, device) -> torch.Tensor:
    """The clip's limit as a 0-d f32 tensor on ``device``, made by a fill (a
    tensor built from a Python number would be a host-to-device copy, which
    a CUDA graph cannot capture)."""
    return torch.full((), max_grad_norm, dtype=torch.float32, device=device)


class Accumulating:
    """clip-by-global-norm + an Adam variant over ``params``, optionally
    accumulated over ``accum_steps`` micro steps (``fused_accumulate``).

    ``step(grads)`` takes the micro step's gradients (one per parameter) and
    returns ``(applied, norm)``: whether it applied an update (the micro step
    completed an accumulation window) and the global norm of those gradients
    (a 0-d f32 tensor; the data group's mean gradient's, or under
    accumulation the rank's own micro gradients'). Under FSDP with
    accumulation the gradients stay inside FSDP until a window's last micro
    step (``TrainState.defer_gradient_sync``): the earlier micro steps hand
    in None and get a NaN norm, the last hands in the window's sum of the
    data group's mean gradients, whose mean is applied and whose norm is
    returned; the accumulator then stays zero. State here: ``count``
    (updates applied), and with accumulation ``mini_step`` and ``acc``
    (``acc_dtype``, shaped as the gradients handed in). Subclasses hold the
    moments of ``self.params`` (the ``data_parallel.local`` leaves) and
    implement ``_update_leaves(idx, grads, norm, bc1, bc2, lr)`` (the update
    of the leaves ``idx``), ``_moments_state`` (lists aligned with the
    leaves), ``_load_moments`` and ``_moment_lists``."""

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
        acc_dtype: torch.dtype = torch.float32,
        data_parallel: Optional[DataParallel] = None,
    ):
        self.dp = data_parallel if data_parallel is not None else DataParallel(params)
        self.params = self.dp.local
        self.offload = False  # offload_moments() moves the moments to the host
        self.transfer_s = 0.0  # host <-> device seconds of the offloaded moments, all steps
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.accum_steps = accum_steps
        self.count = 0
        self.mini_step = 0
        self.deferred = 0  # micro steps of this window whose gradients FSDP holds
        device = self.params[0].device if self.params else torch.device("cpu")
        # f32 [bc1, bc2, lr, 0] of the next update, on the device; ``fed``: the
        # caller copies each update's row in (chained dispatch), else _apply uploads it
        self.scalars = torch.zeros(4, dtype=torch.float32, device=device)
        self.fed = False
        with torch.no_grad():
            self.acc = ([torch.zeros_like(local_tensor(p), dtype=acc_dtype) for p in self.dp.params]
                        if accum_steps > 1 else None)

    def applies_next(self) -> bool:
        """Whether the next :meth:`step` completes an accumulation window."""
        return self.acc is None or self.mini_step == self.accum_steps - 1

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]]):
        """-> (applied, global norm of ``grads``)."""
        if grads is None:
            if self.applies_next():
                raise ValueError("a window's last micro step must hand in its gradients")
            self.deferred += 1
            self.mini_step += 1
            return False, torch.full((), float("nan"), device=self.params[0].device)
        grads = [local_tensor(g).float() for g in grads]
        if self.acc is None or self.deferred:
            if self.deferred:  # FSDP summed the window's micro gradients into these
                torch._foreach_div_(grads, float(self.deferred + 1))
                self.deferred = self.mini_step = 0
            grads, norm = self.dp.reduce(grads)
            self._apply(grads, norm)
            return True, norm
        norm = global_norm(grads)
        # running mean of the micro gradients (fused_accumulate's formula),
        # in f32; the in-place add rounds once into the accumulator's dtype
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        del delta
        if self.mini_step < self.accum_steps - 1:
            self.mini_step += 1
            return False, norm
        self._apply(*self.dp.reduce(self.acc))
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        return True, norm

    def _apply(self, grads: List[torch.Tensor], norm: torch.Tensor) -> None:
        """The update (group by group, offloaded moments brought in for each),
        and the sharded leaves gathered after it."""
        if self.offload:
            bc1, bc2, lr = self._load_scalars()
            device = self.params[0].device
            for idx in self._offload_groups():
                host = self._move_moments(lambda t: t.to(device, non_blocking=True), idx)
                self._update_leaves(idx, grads, norm, bc1, bc2, lr)
                self._move_moments(None, idx, host)
            self.count += 1
        else:
            self._update(grads, norm)
        self.dp.after_update()

    def _update(self, grads: List[torch.Tensor], norm: torch.Tensor) -> None:
        """The update of every leaf in place (the moments where they lie)."""
        self._update_leaves(range(len(self.params)), grads, norm, *self._load_scalars())
        self.count += 1

    def _update_leaves(self, idx, grads: List[torch.Tensor], norm: torch.Tensor, bc1, bc2, lr) -> None:
        """The update of the leaves ``idx``; ``bc1``, ``bc2``, ``lr`` are 0-d f32
        tensors on the device (views of ``scalars``) or, equal in value, Python
        floats: on the CPU the two give the same bits."""
        raise NotImplementedError

    def _offload_groups(self) -> List[List[int]]:
        """Runs of neighbouring leaves whose moments fill at most
        :data:`OFFLOAD_GROUP_BYTES` (a larger leaf alone)."""
        groups, size = [[]], 0
        for i in range(len(self.params)):
            n = self.leaf_moment_bytes(i)
            if groups[-1] and size + n > OFFLOAD_GROUP_BYTES:
                groups.append([])
                size = 0
            groups[-1].append(i)
            size += n
        return [g for g in groups if g]

    def leaf_moment_bytes(self, i: int) -> int:
        """The bytes of leaf ``i``'s moments."""
        return sum(t.numel() * t.element_size() for lst in self._moment_lists()
                   for t in (lst[i] if isinstance(lst[i], tuple) else (lst[i],)))

    def _moment_lists(self) -> List[list]:
        """The lists holding the moments, one item per leaf (a tensor, or a
        tuple of tensors); replaced item by item, never rebound."""
        return []

    def offload_moments(self) -> None:
        """Move the moments into pinned host memory (``--offload-optimizer``),
        where they stay between steps."""
        def pinned(t):
            return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device="cpu", pin_memory=True).copy_(t)

        self._move_moments(pinned)
        self.offload = True

    def _move_moments(self, fn, idx=None, host: Optional[List[list]] = None) -> List[list]:
        """Replace each moment of the leaves ``idx`` (all by default) by
        ``fn(moment)`` (timed, waited for) -> the lists as they were; with
        ``host`` (those lists), copy the moments back into its tensors and put
        them in place again."""
        lists = self._moment_lists()
        before = [list(lst) for lst in lists]
        t0 = time.perf_counter()
        for k, lst in enumerate(lists):
            for i in range(len(lst)) if idx is None else idx:
                x = lst[i]
                if host is None:
                    lst[i] = tuple(fn(t) for t in x) if isinstance(x, tuple) else fn(x)
                else:
                    h = host[k][i]
                    for dst, src in zip(h if isinstance(h, tuple) else (h,), x if isinstance(x, tuple) else (x,)):
                        dst.copy_(src, non_blocking=True)
                    lst[i] = h
        if self.params and self.params[0].is_cuda:
            torch.cuda.synchronize(self.params[0].device)
        self.transfer_s += time.perf_counter() - t0
        return before

    def scalar_rows(self, n: int = 1) -> np.ndarray:
        """f32 ``[n, 4]``: ``[bc1, bc2, lr, 0]`` of the next ``n`` updates (from
        update ``count``), the bias corrections ``1 - b^(count + 1)`` computed in
        f32 on the host as optax does, the rate at ``count``."""
        rows = np.zeros((n, 4), np.float32)
        for i in range(n):
            count = self.count + i
            c = torch.tensor(float(count + 1))
            bc1, bc2 = (float(torch.tensor(1.0) - torch.tensor(b) ** c) for b in (self.b1, self.b2))
            rows[i, :3] = (bc1, bc2, f32(self.schedule(count)))
        return rows

    def _load_scalars(self):
        """Upload the next update's row into ``scalars`` unless the caller fed
        it -> (bc1, bc2, lr) as 0-d views of the buffer."""
        if not self.fed:
            upload(self.scalar_rows(1)[0], self.scalars)
        return self.scalars[0], self.scalars[1], self.scalars[2]

    def layout(self) -> Dict:
        """The state's layout, by the flags that set it."""
        return {"gradient_accumulation": self.acc is not None,
                "accum_dtype": None if self.acc is None else _DTYPE_NAMES[self.acc[0].dtype]}

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer state (moments and accumulator)."""
        return list(self.acc or [])

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.state_tensors())

    def state_dict(self) -> Dict:
        """The state in the one-device layout (the moments of sharded leaves
        gathered: a collective, every rank calls it). Offloaded moments stay
        on the host; one whose gather needs the device goes there alone and
        comes back at once, so at most one leaf's piece is on the card."""
        device = self.params[0].device if self.params else torch.device("cpu")

        def whole(i: int, t: torch.Tensor) -> torch.Tensor:
            if t.device == device or not self.dp.gathers(i):
                return self.dp.gather(i, t)
            return self.dp.gather(i, t.to(device)).cpu()

        moments = {k: [whole(i, t) for i, t in enumerate(v)] for k, v in self._moments_state().items()}
        acc = None if self.acc is None else [self.dp.gather_param(i, a) for i, a in enumerate(self.acc)]
        return {"layout": self.layout(), "count": self.count, "mini_step": self.mini_step, "acc": acc, **moments}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        saved = state.get("layout") or _legacy_layout(state)
        mine = self.layout()
        # the fused AdamW's layout names no path: a checkpoint without the key is the fused one
        value = lambda d, k: d.get(k, False) if k == "no_fused_adamw" else d.get(k)  # noqa: E731
        differ = [k for k in sorted(set(saved) | set(mine)) if value(saved, k) != value(mine, k)]
        # a dtype means nothing where the other side has no such state
        if "gradient_accumulation" in differ:
            differ = [k for k in differ if k != "accum_dtype"]
        if "use_8bit_adam" in differ:
            differ = [k for k in differ if k not in ("adam_mu_dtype", "adam_nu_dtype", "no_fused_adamw")]
        if differ:
            raise ValueError(
                "checkpoint optimizer state does not match this run's flags: "
                + ", ".join(f"{_FLAGS[k]} (checkpoint: {value(saved, k)}, this run: {value(mine, k)})"
                            for k in differ)
                + "; re-run with the saving run's flags"
            )
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for i, (d, s) in enumerate(zip(self.acc or [], state["acc"] or [])):
            d.copy_(self.dp.shard_param(i, s))
        self._load_moments({**state, **{k: [self.dp.shard(i, t) for i, t in enumerate(state[k])]
                                        for k in self._moments_state()}})


def _legacy_layout(state: Dict) -> Dict:
    """The layout of a checkpoint written before layouts were recorded: f32 AdamW."""
    return {"use_8bit_adam": False, "adam_mu_dtype": "f32", "adam_nu_dtype": "f32",
            "gradient_accumulation": state.get("acc") is not None,
            "accum_dtype": None if state.get("acc") is None else "f32"}


class AdamW(Accumulating):
    """clip-by-global-norm + AdamW (``fused_adamw``), optionally accumulated.
    Moments ``mu``, ``nu`` in ``mu_dtype`` and ``nu_dtype`` (f32 or bf16)."""

    def __init__(self, params: List[torch.Tensor], schedule, mu_dtype: torch.dtype = torch.float32,
                 nu_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(params, schedule, **kw)
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
            self.nu = [torch.zeros_like(p, dtype=nu_dtype) for p in self.params]

    def _clip_scale(self, norm: torch.Tensor) -> torch.Tensor:
        """1 when ``norm < c``, else ``c / norm`` (f32)."""
        c = clip_limit(self.max_grad_norm, norm.device)
        return torch.where(norm < c, torch.ones_like(norm), c / norm)

    def _update_leaves(self, idx, grads, norm, bc1, bc2, lr) -> None:
        b1, b2 = self.b1, self.b2
        params, grads = [self.params[i] for i in idx], [grads[i] for i in idx]
        mus, nus = [self.mu[i] for i in idx], [self.nu[i] for i in idx]
        scale = None if self.max_grad_norm is None else self._clip_scale(norm)
        if any(t.dtype != torch.float32 for t in (grads[0], mus[0], nus[0])):
            for p, g, mu, nu in zip(params, grads, mus, nus):
                self._leaf(p, g, mu, nu, bc1, bc2, lr, scale)
            return
        g = grads if scale is None else torch._foreach_mul(grads, scale)
        # mu = b1 mu + (1 - b1) g ; nu = b2 nu + (1 - b2) g^2
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        # adam = (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        adam = torch._foreach_div(mus, bc1)
        torch._foreach_div_(adam, denom)
        # p = p - lr (adam + wd p)
        torch._foreach_add_(adam, params, alpha=self.weight_decay)
        torch._foreach_mul_(adam, lr)
        torch._foreach_sub_(params, adam)

    def _leaf(self, p, g, mu, nu, bc1, bc2, lr, scale) -> None:
        """``fused_adamw._leaf``: the leaf in f32, each store rounded once."""
        b1, b2 = self.b1, self.b2
        g32 = g.float() if scale is None else g.float() * scale
        mu_n = b1 * mu.float() + (1.0 - b1) * g32
        nu_n = b2 * nu.float() + (1.0 - b2) * g32 * g32
        adam = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + self.eps)
        p.sub_(lr * (adam + self.weight_decay * p))
        mu.copy_(mu_n)
        nu.copy_(nu_n)

    def layout(self) -> Dict:
        return {**super().layout(), "use_8bit_adam": False, "adam_mu_dtype": _DTYPE_NAMES[self.mu[0].dtype],
                "adam_nu_dtype": _DTYPE_NAMES[self.nu[0].dtype]}

    def state_tensors(self) -> List[torch.Tensor]:
        return self.mu + self.nu + super().state_tensors()

    def _moment_lists(self) -> List[list]:
        return [self.mu, self.nu]

    def _moments_state(self) -> Dict:
        return {"mu": self.mu, "nu": self.nu}

    def _load_moments(self, state: Dict) -> None:
        for d, s in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            d.copy_(s)


class ChainAdamW(AdamW):
    """``--no-fused-adamw``: the JAX package's optax path, ``chain(
    clip_by_global_norm(c), adamw(mu_dtype))`` under ``optax.MultiSteps``,
    in optax 0.2.6's order of operations: the clip ``g / ||g|| * c`` where
    ``||g|| >= c``; ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2
    nu`` in f32 (for a bf16 mu, b1 rounded to bf16 first, as JAX's
    weak-typed scalar is), mu stored in ``mu_dtype`` after the update read it; ``u =
    (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p``, then ``p + u * -lr``.
    ``nu`` stays f32 (``optax.adamw`` has no nu storage dtype). Under
    accumulation ``MultiSteps`` keeps the same running mean as the fused
    path, in f32 whatever ``--accum-dtype`` says. Leaf by leaf. The layout
    names the path, so a checkpoint of either path refuses to resume under
    the other. Given the same gradients and f32 moments it differs from
    :class:`AdamW` only in rounding (the clip's ``g / ||g|| * c`` against
    ``g * (c / ||g||)``): after a few steps the parameters agree within 1e-3
    of the learning rate beyond 2^-22 of their size (an f32 parameter's last
    bits), as ``chip_smoke.py`` phase 9d and
    ``tests/test_torch_port_train_options.py`` hold them. With a bf16 mu the
    two differ as the JAX package's two paths do (optax takes b1 in bf16,
    ``fused_adamw`` in f32)."""

    def _update_leaves(self, idx, grads, norm, bc1, bc2, lr) -> None:
        b1, b2 = self.b1, self.b2
        if self.max_grad_norm is not None:
            c = clip_limit(self.max_grad_norm, norm.device)
            keep = norm < c
        for i in idx:
            p, g, mu, nu = self.params[i], grads[i], self.mu[i], self.nu[i]
            g = g.float()
            if self.max_grad_norm is not None:
                g = torch.where(keep, g, g / norm * c)
            # JAX's weak-typed b1 takes mu's dtype; XLA multiplies in f32
            mu_n = (1.0 - b1) * g + float(torch.tensor(b1, dtype=mu.dtype)) * mu.float()
            nu_n = (1.0 - b2) * (g * g) + b2 * nu
            u = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + self.eps) + self.weight_decay * p
            p.add_(u * -lr)
            mu.copy_(mu_n)
            nu.copy_(nu_n)

    def layout(self) -> Dict:
        return {**super().layout(), "no_fused_adamw": True}


def build_optimizer(params, optim_cfg, max_train_steps: int, gradient_accumulation_steps: int = 1,
                    data_parallel: Optional[DataParallel] = None) -> Accumulating:
    """clip-by-global-norm -> AdamW(schedule, wd), accumulated over k micro
    steps, as the JAX package's ``build_optimizer`` composes it: the fused
    AdamW with ``--adam-mu-dtype``/``--adam-nu-dtype`` storage, or under
    ``--use-8bit-adam`` the int8 optimizer (which ignores the moment dtype
    flags), both honouring ``--accum-dtype``; or under ``--no-fused-adamw``
    the optax chain (:class:`ChainAdamW`: ``--adam-mu-dtype`` only, an f32
    accumulator). ``--adam-nu-dtype bf16`` with ``--no-fused-adamw`` raises
    the JAX package's ``ValueError``. ``data_parallel`` places the leaves over
    the data group (its ``local`` leaves are what the optimizer updates)."""
    unfused = getattr(optim_cfg, "no_fused_adamw", False)
    if (unfused and not getattr(optim_cfg, "use_8bit_adam", False)
            and getattr(optim_cfg, "adam_nu_dtype", "f32") == "bf16"):
        raise ValueError(
            "--adam-nu-dtype bf16 requires the fused AdamW path "
            "(optax.adamw has no nu storage dtype); drop --no-fused-adamw"
        )
    schedule = build_lr_schedule(
        optim_cfg.scheduler_type, optim_cfg.learning_rate, optim_cfg.lr_warmup_steps, max_train_steps
    )
    common = dict(
        b1=0.9, b2=0.999, eps=1e-8, weight_decay=optim_cfg.adam_weight_decay,
        max_grad_norm=optim_cfg.max_grad_norm, accum_steps=gradient_accumulation_steps,
        acc_dtype=storage_dtype(getattr(optim_cfg, "accum_dtype", "f32")), data_parallel=data_parallel,
    )
    if getattr(optim_cfg, "use_8bit_adam", False):
        from stable_diffusion_pytorch_tpu_torch.trainers.adam8bit import AdamW8bit

        return AdamW8bit(params, schedule, **common)
    if unfused:
        return ChainAdamW(params, schedule, mu_dtype=storage_dtype(getattr(optim_cfg, "adam_mu_dtype", "f32")),
                          **{**common, "acc_dtype": torch.float32})
    return AdamW(
        params, schedule, mu_dtype=storage_dtype(getattr(optim_cfg, "adam_mu_dtype", "f32")),
        nu_dtype=storage_dtype(getattr(optim_cfg, "adam_nu_dtype", "f32")), **common,
    )
