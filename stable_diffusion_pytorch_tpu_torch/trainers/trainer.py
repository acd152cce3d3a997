"""Trainer core on one device and its trainers: the UNet trainer (with LoRA
and DreamBooth's prior preservation), the textual-inversion trainer, the
ControlNet trainer and the autoencoder (KL-VAE) trainer (port of
trainers/trainer.py).

The loop keeps the JAX package's semantics: ``train_batch_size`` per device,
``global_step`` counting optimizer steps (``gradient_accumulation_steps``
micro steps each), ``checkpoint-{step}`` saves every ``checkpointing_steps``
(or per epoch), ``latest`` resume with the reference's replay arithmetic
(skipping the micro batches already seen in the resumed epoch), evaluation
every ``log_interval`` optimizer steps before the termination check (the
autoencoder trainer one step earlier, at ``(step + 1) % log_interval``, as
the JAX package's does), and the JSONL metrics stream (train loss, lr,
samples/s, step timing).

Random draws: micro step ``m`` takes its draws from a ``torch.Generator``
seeded with ``SeedSequence([0, seed, m])`` (evaluation batch ``i``:
``[1, seed, i]``), so a resumed run replays the same draws, as the JAX
package's ``fold_in(seed, m)`` keys do. The streams differ from JAX's.

The JAX trainers' options: v-prediction and Min-SNR (``trainers/steps.py``),
the gradient noise scale (``--log-grad-noise-scale``: two half-batch
backward passes a micro step, the EMA-smoothed ratio ``grad_noise_scale`` in
the metrics from the 5th optimizer step, :class:`GradNoiseScale`), loss-spike
detection (``--spike-threshold``, :class:`LossSpikes`), ``--log-image``
(each trainer's ``log_images`` after an evaluation), wandb
(``--with-tracking``), the latent cache's rows (``has_text_cache``: the
cached empty-prompt embedding), on-device preprocessing and the
``synthetic_fallback`` stamp. Ported memory levers: ``--remat-policy``
(per-block remat, set on the UNet by ``build_models``), ``--use-8bit-adam``
(int8 moments, K9), ``--adam-mu-dtype``/``--adam-nu-dtype``/``--accum-dtype``
bf16; ``--no-fused-adamw`` runs the optax chain (``trainers/optim.py``).
``--use-pallas-attention`` changes nothing, as in the JAX package, which
declares it and never reads it: the kernels run either way.

Over several devices (one process per device, started by ``torchrun``;
``parallel/distributed.py``), as the JAX package (``trainer.py:86-128``):
``--train-batch-size`` is per device, so the global batch is that times the
data size; each rank's loader takes every ``world``-th row from its rank
(``shard_id``, ``num_shards``); each rank draws the global batch's draws from
the step's generator and keeps its rows (rank ``r`` holds global rows
``[r b, (r + 1) b)``, the JAX batch's device split), so a world of N at a
per-rank batch b takes the draws of one device at batch N b; the loss and
the metrics are the global batch's means; the gradients are averaged over
the data group once per optimizer step (``parallel/data_parallel.py``;
under FSDP with accumulation, FSDP's reduce-scatter runs on a window's last
micro step only: ``TrainState.defer_gradient_sync``);
logging, image logging, tracking and checkpoint writes happen on rank 0,
which gathers the one-device layout. ``--num-devices N`` must equal the
data size (a mismatch raises ``ValueError``; the JAX package takes the
first N devices). ``--shard-optimizer-state`` (and ``--use-deepspeed``, which
the UNet and VAE CLIs map to it) shards the optimizer state ZeRO-style,
``--offload-optimizer`` keeps it in pinned host memory between steps (a
no-op with a warning on the CPU, where the two memories are one), and
``--shard-params`` shards the trainable module with FSDP2
(``parallel/fsdp.py``; trainable tensors that are not a module, LoRA
factors and textual-inversion vectors, shard their optimizer state
instead). ``--tensor-parallel T`` splits the UNet trainer's attention and
feed-forward weights over groups of T adjacent ranks
(``parallel/tensor_parallel.py``), the data axis being the world over T.
With one process every option but ``--tensor-parallel`` is the one-device
run. The combinations :func:`check_parallel` names raise ``ValueError``.

One program per call, as the JAX package jits its steps (``trainers/chain.py``,
``utils/graphs.py``): on a CUDA device with one process each optimizer step
(its accumulation micro steps and the update) is one CUDA graph, captured at
the first step and replayed, at ``--steps-per-dispatch 1`` (the default, JAX's
``_jit_step``) as at N, and the evaluation step is one graph per batch
signature (JAX's ``_jit_eval``). The route is fixed when the trainer is built
(``capture=False`` builds the eager trainer, the graph route's control); a
window the graph cannot take (an epoch's remainder, a resume's partial
window, a batch of another shape) runs eagerly. The CPU, a process group and
``--offload-optimizer`` run each micro step eagerly, as before.

Chained dispatch, ``--steps-per-dispatch N``: where the JAX package's rule
allows (:func:`~stable_diffusion_pytorch_tpu_torch.trainers.chain.chunk_safe`),
N optimizer steps run as one chunk whose metrics reach the host in one pull
(N replays on the graph route; on the CPU and over a process group the steps
of a chunk run eagerly); checkpoint and evaluation boundaries run one
optimizer step at a time. Under ``--offload-optimizer`` every step is
dispatched alone, as in the JAX package. The loss stream is the per-step
path's, bit for bit on the CPU.

``SD_TRAIN_PROFILE=1`` (the JAX package's switch, read where it reads it):
each micro step's wall time split into host phases (:class:`~stable_diffusion_pytorch_tpu_torch.utils.profiling.PhaseTimer`):
``fetch`` (the loader), ``place`` (the batch to the device; on a dispatch,
the draws too), ``dispatch`` (the eager step's launches, or the replays) and
``sync`` (the loss pulled to the host, or a dispatch's one pull); their p50
and mean go into every logged record and the end-of-run summary line.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch import pipeline
from stable_diffusion_pytorch_tpu_torch.models import lora as lora_lib
from stable_diffusion_pytorch_tpu_torch.models.build import (
    cast_for_inference,
    require_device,
    resolve_dtype,
    sampling_model,
)
from stable_diffusion_pytorch_tpu_torch.models.controlnet import init_controlnet_from_unet
from stable_diffusion_pytorch_tpu_torch.parallel.data_parallel import DataParallel
from stable_diffusion_pytorch_tpu_torch.parallel.distributed import host_shard_info
from stable_diffusion_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, combined_zero_dims, get_mesh, zero_dims
from stable_diffusion_pytorch_tpu_torch.parallel.tensor_parallel import ModelGroup
from stable_diffusion_pytorch_tpu_torch.trainers import chain
from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_optimizer, lr_at_step, upload
from stable_diffusion_pytorch_tpu_torch.trainers.steps import (
    Trainables,
    TrainState,
    half_spans,
    make_controlnet_train_step,
    make_textual_inversion_train_step,
    make_unet_train_step,
    make_vae_train_step,
    sample_draws,
    take_rows,
)
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import CheckpointManager, resume_train_state_math
from stable_diffusion_pytorch_tpu_torch.utils.data import DataLoader, detransform, to_img
from stable_diffusion_pytorch_tpu_torch.utils.graphs import GraphPool, signature
from stable_diffusion_pytorch_tpu_torch.utils.profiling import PhaseTimer, StepTimer
from stable_diffusion_pytorch_tpu_torch.utils.tracking import Tracker, get_logger

LOG_IMAGE_PROMPT = "a white cat wearing a hat"  # the reference's eval prompt (train_unet.py:452-465)
LOG_IMAGE_STEPS = 50  # DDIM steps of a logged sample


class GradNoiseScale:
    """The gradient-noise-scale record (JAX ``trainers/trainer.py:585-599``):
    EMAs (decay 0.95, from 0) of the estimator's two halves, S and G^2, one
    update per optimizer step; from the 5th update, while the G^2 EMA is
    positive, ``update`` returns B_noise = EMA(S) / EMA(G^2) (the bias
    corrections cancel in the ratio), else None."""

    def __init__(self, decay: float = 0.95, warmup: int = 5):
        self.decay, self.warmup = decay, warmup
        self.s_ema, self.g2_ema, self.count = 0.0, 0.0, 0

    def update(self, gns_s: float, gns_g2: float) -> Optional[float]:
        d = self.decay
        self.count += 1
        self.s_ema = d * self.s_ema + (1 - d) * gns_s
        self.g2_ema = d * self.g2_ema + (1 - d) * gns_g2
        if self.count >= self.warmup and self.g2_ema > 0:
            return self.s_ema / self.g2_ema
        return None


class LossSpikes:
    """Running-statistics loss-spike detection (JAX ``trainers/trainer.py:
    600-625``): after step 10, a loss above mean + threshold * std of the
    running statistics (decay 0.98; the mean starts at the first loss) is a
    spike; ``update`` returns the spike count then, or None. The statistics
    take every loss, spikes included."""

    def __init__(self, threshold: float, decay: float = 0.98, after: int = 10):
        self.threshold, self.decay, self.after = threshold, decay, after
        self.mean: Optional[float] = None
        self.var, self.count = 0.0, 0

    def update(self, global_step: int, loss: float, logger=None) -> Optional[int]:
        spike = None
        if (self.mean is not None and global_step > self.after and self.var > 0
                and loss > self.mean + self.threshold * (self.var ** 0.5)):
            self.count += 1
            spike = self.count
            if logger is not None:
                logger.warning(
                    f"LOSS SPIKE at step {global_step}: loss={loss:.5f} vs running "
                    f"mean={self.mean:.5f} std={self.var ** 0.5:.5f} (threshold {self.threshold}x)"
                )
        if self.mean is None:
            self.mean = loss
        else:
            dm = self.decay
            delta = loss - self.mean
            self.mean += (1 - dm) * delta
            self.var = dm * (self.var + (1 - dm) * delta * delta)
        return spike


def check_parallel(cfg) -> None:
    """Raise ``ValueError`` for a combination of the multi-device options the
    port does not run: FSDP (``--shard-params``) with the int8 optimizer
    (FSDP2 splits 1-D leaves along their one dim, through int8 blocks);
    FSDP or tensor parallelism with ``--log-image`` (the sampler copies the
    whole module) or ``--log-grad-noise-scale`` (its norms would need the
    other ranks' pieces); tensor parallelism with FSDP (the JAX package
    ignores ``--shard-params`` under a model axis; the port refuses it)."""
    p, optim, log = cfg.parallel, cfg.optim, cfg.log
    tp = int(p.tensor_parallel or 1) > 1
    rules = [(p.shard_params, getattr(optim, "use_8bit_adam", False), "--shard-params", "--use-8bit-adam")]
    for on, name in ((p.shard_params, "--shard-params"), (tp, "--tensor-parallel")):
        rules += [(on, log.log_image, name, "--log-image"),
                  (on, log.log_grad_noise_scale, name, "--log-grad-noise-scale")]
    rules += [(tp, p.shard_params, "--tensor-parallel", "--shard-params")]
    for on, bad, flag, other in rules:
        if on and bad:
            raise ValueError(f"{flag} does not run with {other}")


def step_generator(device, *seeds: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(seeds)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


class Trainer:
    """Loop, checkpointing, resume replay, evaluation cadence and metrics.
    Subclasses build the state and steps in ``_build``."""

    run_name = "trainer"
    eval_cadence_offset = 0  # evaluate when (global_step + offset) % log_interval == 0
    tensor_parallel_ok = False  # whether --tensor-parallel applies (it splits the trained UNet's weights)

    def __init__(self, cfg, train_dataset, eval_dataset, logger=None, device="cuda", train_collate=None,
                 capture: bool = True):
        """``capture``: on a CUDA device with one process, run each optimizer
        step and evaluation step as a replayed CUDA graph (the route is fixed
        here); False runs them eagerly (the graph route's control)."""
        if train_dataset is None:
            raise ValueError("must specify a training dataset")
        if eval_dataset is None and cfg.train.log_interval > 0:
            raise ValueError("if passed log_interval > 0, you must specify an evaluation dataset")
        check_parallel(cfg)
        self.cfg = cfg
        self.logger = logger or get_logger(self.run_name)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.device = require_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.dtype = resolve_dtype(cfg.parallel.mixed_precision, self.device)
        rank, world = host_shard_info()
        self.is_main_process = rank == 0
        if not self.is_main_process:
            self.logger.setLevel(logging.WARNING)
        tp = int(cfg.parallel.tensor_parallel or 1)
        if tp > 1 and not self.tensor_parallel_ok:
            raise ValueError(f"--tensor-parallel splits the UNet's weights: {self.run_name} does not train them")
        if tp > 1 and world == 1:
            raise ValueError(f"--tensor-parallel {tp} needs {tp} processes: start them with torchrun "
                             f"--nproc_per_node {tp}")
        self.mesh = get_mesh(self.device.type, tp)
        # self.rank, self.world: this process's place on the data axis (the model group shares its rows)
        self.group, self.model_group, self.rank, self.world = None, None, 0, 1
        if self.mesh is not None:
            self.group = self.mesh.get_group(DATA_AXIS)
            self.rank, self.world = self.mesh.get_local_rank(DATA_AXIS), self.mesh.size(0)
            if tp > 1:
                self.model_group = ModelGroup(self.mesh.get_group(MODEL_AXIS), tp, self.mesh.get_local_rank(MODEL_AXIS))
        if cfg.parallel.num_devices is not None and cfg.parallel.num_devices != self.world:
            raise ValueError(
                f"--num-devices {cfg.parallel.num_devices} does not match the data axis of {self.world} "
                "process(es): start one process per device with torchrun --nproc_per_node "
                f"{cfg.parallel.num_devices}, or drop --num-devices")
        self.global_train_batch = cfg.train.train_batch_size * self.world
        self.global_eval_batch = cfg.train.eval_batch_size * self.world
        num_workers = int(getattr(cfg.dataset, "dataloader_num_workers", 0) or 0)
        self.train_loader = DataLoader(
            train_dataset, batch_size=cfg.train.train_batch_size, shuffle=True, seed=cfg.train.seed,
            collate=train_collate, num_workers=num_workers, shard_id=self.rank, num_shards=self.world,
        )
        self.eval_loader = (
            DataLoader(eval_dataset, batch_size=cfg.train.eval_batch_size, shuffle=False,
                       seed=cfg.train.seed, num_workers=num_workers, shard_id=self.rank, num_shards=self.world)
            if eval_dataset is not None else None
        )
        self.ckpt_manager = CheckpointManager(cfg.checkpoint)
        self.tracker = Tracker(cfg.log, self.run_name, config=cfg.to_dict() if cfg.log.with_tracking else None,
                               enabled=self.is_main_process)
        # a dataset standing in for one that failed to load marks every record
        if any(getattr(ds, "synthetic_fallback", False) for ds in (train_dataset, eval_dataset)):
            self.tracker.set_persistent(synthetic_fallback=True)
        self.random_flip = bool(cfg.dataset.random_flip and cfg.dataset.device_preprocess)
        # the captured step, the metrics' order; the trainer's graphs (the
        # step's and the evaluation's) share one pool and one side stream
        self._graph, self._metric_keys = None, []
        self._graphs = GraphPool("global")
        self._chunk_warm = self._single_warm = False
        self._last_dispatch: Dict[str, float] = {}
        self._build()
        self._route = chain.route(int(cfg.train.steps_per_dispatch or 1), self.device, self.state.optimizer.offload,
                                  self.group, capture)

    # subclass surface
    def _build(self) -> None:
        raise NotImplementedError

    def _train_draws(self, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        """Every random draw of one micro step on this rank's ``batch``."""
        raise NotImplementedError

    def _step(self, batch: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        """One micro step from its batch and draws -> its metrics (0-d tensors)."""
        raise NotImplementedError

    def _train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, Any]:
        return self._step(batch, self._train_draws(batch, generator))

    def _eval_draws(self, batch: Dict[str, torch.Tensor], generator: torch.Generator):
        """Every random draw of one evaluation step on this rank's ``batch``."""
        raise NotImplementedError

    def _eval_body(self, batch: Dict[str, torch.Tensor], draws) -> torch.Tensor:
        """One evaluation step from its batch and draws -> the loss (0-d)."""
        raise NotImplementedError

    def _eval_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        return self._eval_body(batch, self._eval_draws(batch, generator))

    def log_images(self, global_step: int):
        """Under ``--log-image``, after each evaluation: sample or reconstruct,
        write the PNG under ``output/``, hand it to the tracker; -> the image."""
        return None

    # shared machinery
    def _optimizer(self, params, module_sharded: bool = False, layouts=None):
        """The run's optimizer over ``params`` on the data group: ZeRO dims
        under ``--shard-optimizer-state`` or ``--shard-params``, unless FSDP
        sharded the module (``module_sharded``: its state is sharded with
        it), int8 blocks kept whole under ``--use-8bit-adam``; ``layouts``: each leaf's split
        over the model group (tensor parallelism: the ZeRO dims layered on
        it, JAX ``combine_zero``); the moments offloaded under
        ``--offload-optimizer`` on a CUDA device."""
        p, optim = self.cfg.parallel, self.cfg.optim
        eight = getattr(optim, "use_8bit_adam", False)
        dp = None
        if self.group is not None:
            dims = None
            if (p.shard_optimizer_state or p.shard_params) and not module_sharded:
                shapes, block = [q.shape for q in params], 256 if eight else None
                dims = (zero_dims(shapes, self.world, int8_block=block) if layouts is None
                        else combined_zero_dims(shapes, layouts, self.model_group.size, self.world, int8_block=block))
            dp = DataParallel(params, self.group, dims, model=self.model_group, layouts=layouts,
                              whole_model_leaves=eight)
        opt = build_optimizer(
            params, optim, max_train_steps=self.cfg.train.max_train_steps,
            gradient_accumulation_steps=self.cfg.train.gradient_accumulation_steps, data_parallel=dp,
        )
        if p.offload_optimizer:
            if self.device.type == "cpu":
                self.logger.warning("--offload-optimizer ignored on a CPU device (host and device memory coincide)")
            else:
                opt.offload_moments()
        return opt

    def _place(self, module) -> bool:
        """Under ``--shard-params`` on a data group, shard ``module`` with
        FSDP2 (``parallel/fsdp.py``) -> whether it was sharded."""
        if not (self.cfg.parallel.shard_params and self.group is not None):
            return False
        from stable_diffusion_pytorch_tpu_torch.parallel.fsdp import shard_module

        shard_module(module, self.mesh)
        return True

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over the data group (a 0-d f32 tensor)."""
        if self.group is None:
            return x
        import torch.distributed as dist

        x = x.detach().float().clone()
        dist.all_reduce(x, group=self.group)
        return x / self.world

    def _rows(self, draws, rows: int):
        """This rank's rows (``[rank * rows, (rank + 1) * rows)``) of a global batch's draws."""
        return take_rows(draws, self.rank * rows, (self.rank + 1) * rows)

    def _check_unet(self, unet, trainable: bool) -> None:
        """The UNet as ``build_models(..., for_training=True, remat=...)`` makes it:
        f32 parameters (trainable, or frozen here), the run's remat policy."""
        p = next(unet.parameters())
        if p.dtype != torch.float32 or (trainable and not p.requires_grad):
            raise ValueError("the UNet must hold f32 trainable parameters: build_models(..., for_training=True)")
        if unet.remat != self.cfg.parallel.remat_policy:
            raise ValueError(f"the UNet was built with remat {unet.remat!r}, the run asks for "
                             f"--remat-policy {self.cfg.parallel.remat_policy}: build_models(..., remat=...)")
        if not trainable:
            unet.requires_grad_(False)

    def _latent_shape(self, batch, rows: Optional[int] = None) -> tuple:
        """The latents' shape for a batch of pixels, uint8 images, cached
        moments or latents (with ``rows`` in place of the batch's)."""
        if "moments" in batch:
            m = batch["moments"].shape
            shape = (*m[:-1], m[-1] // 2)
        elif "latents" in batch:
            shape = tuple(batch["latents"].shape)
        else:
            image = batch["pixel_values"] if "pixel_values" in batch else batch["raw_images"]
            shape = tuple(self.model.latent_shape(image.shape[0], image.shape[1]))
        return shape if rows is None else (rows, *shape[1:])

    def _unet_draws(self, batch, generator, whole_batch_drop: bool = False, halves: bool = False):
        """Every draw of one UNet-loss step for this rank's batch (its rows,
        2B under prior preservation): the global batch's draws, this rank's
        rows kept; with ``halves`` a pair, one for each half of the global
        batch (the gradient-noise-scale split, :func:`half_spans`), drawn in
        that order."""
        rows = batch["input_ids"].shape[0]

        def draws(n):
            return sample_draws(
                generator, n, self._latent_shape(batch, n), self.model.noise_scheduler.noise_steps, self.device,
                noise_offset=float(self.cfg.train.noise_offset or 0.0),
                input_perturbation=float(self.cfg.train.input_perturbation or 0.0),
                whole_batch_drop=whole_batch_drop, random_flip=self.random_flip,
            )

        total = rows * self.world
        if halves:
            return [take_rows(draws(n), *span)
                    for n, span in zip((total // 2, total - total // 2), half_spans(rows, self.rank, self.world))]
        return self._rows(draws(total), rows)

    def _uncond_ids(self) -> torch.Tensor:
        """The empty prompt's token ids on the device."""
        return torch.as_tensor(np.asarray(self.model.text_encoder.tokenize([""]).input_ids[0]), dtype=torch.long,
                               device=self.device)

    def _place_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        non_blocking = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                if non_blocking:
                    t = t.pin_memory()
                out[k] = t.to(self.device, non_blocking=non_blocking)
        return out

    def _micro_steps(self, epoch_iter, *, skip_until: int, micro_step0: int, step_timer, max_train_steps: int,
                     ckpt_steps, phases: Optional[PhaseTimer] = None):
        """Yield (metrics as floats, step wall seconds incl. the batch fetch)
        for each micro step of one epoch: one micro step at a time, or under
        chained dispatch chunks of optimizer steps (:meth:`_dispatch`) where
        :func:`chain.chunk_safe` allows, and on the graph route every
        optimizer step whose window the epoch holds (JAX ``_micro_steps``).
        ``phases`` (``SD_TRAIN_PROFILE=1``) takes each micro step's
        ``place``, ``dispatch`` and ``sync`` seconds."""

        def phase(name):
            return phases.phase(name) if phases is not None else contextlib.nullcontext()

        cfg = self.cfg
        accum = cfg.train.gradient_accumulation_steps
        spd = int(cfg.train.steps_per_dispatch or 1)
        route = self._route
        micro = micro_step0
        buf: list = []
        it = enumerate(epoch_iter)
        exhausted = False
        while True:
            steps = 0
            if route is not None and chain.chunk_safe(micro, spd, accum, max_train_steps, ckpt_steps,
                                                      cfg.train.log_interval, self.eval_cadence_offset):
                steps = spd
            elif route == "graph" and micro % accum == 0:
                steps = 1
            want = steps * accum if steps else 1
            t_fetch0 = time.perf_counter()
            while len(buf) < want and not exhausted:
                try:
                    s, batch = next(it)
                except StopIteration:
                    exhausted = True
                    break
                if s >= skip_until:
                    buf.append(batch)
            fetch_dt = time.perf_counter() - t_fetch0
            if not buf:
                return
            if steps > 1 and len(buf) < want and route == "graph" and len(buf) >= accum:
                steps, want = 1, accum  # the epoch's rest: one replay at a time
            if steps and len(buf) >= want:
                window, buf = buf[:want], buf[want:]
                t0 = time.perf_counter()
                rows = self._dispatch(window, micro, steps)
                per_step = (time.perf_counter() - t0) / want
                warm, self._chunk_warm = self._chunk_warm, True
                for i in range(want):
                    if warm:  # the first dispatch captures: left out, as JAX leaves out its compile
                        step_timer.add(per_step)
                        if phases is not None:
                            for name, dt in self._last_dispatch.items():
                                phases.add(name, dt / want)
                    micro += 1
                    yield dict(zip(self._metric_keys, map(float, rows[i]))), per_step + fetch_dt / want
                continue
            batch = buf.pop(0)
            if route is not None and not self._single_warm:
                self._single_warm = True  # a chained run's first step alone builds what it builds
                step_timer.skip_next()
                if phases is not None:
                    phases.skip_next("dispatch")
            t0 = time.perf_counter()
            with phase("place"):
                placed = self._place_batch(batch)
            with step_timer:
                with phase("dispatch"):
                    metrics = self._train_step(placed, step_generator(self.device, 0, self.cfg.train.seed, micro))
                # reading the loss waits for the step's device work; the
                # other metrics stay on the device until the loop reads them
                with phase("sync"):
                    metrics["loss"] = float(self._mean(metrics["loss"]))
            micro += 1
            yield metrics, fetch_dt + (time.perf_counter() - t0)

    def _window_inputs(self, window, micro0: int) -> list:
        """The micro steps' (placed batch, draws) of one optimizer step, the
        draws from the per-step path's generators."""
        out = []
        for m, batch in enumerate(window):
            placed = self._place_batch(batch)
            out.append((placed, self._train_draws(placed, step_generator(self.device, 0, self.cfg.train.seed,
                                                                         micro0 + m))))
        return out

    def _window(self, inputs) -> torch.Tensor:
        """One optimizer step over its micro steps' inputs -> f32 [micro
        steps, K], the metrics in the order of ``_metric_keys``."""
        rows = []
        for batch, draws in inputs:
            metrics = self._step(batch, draws)
            metrics["loss"] = self._mean(metrics["loss"])
            self._metric_keys = sorted(metrics)
            rows.append(torch.stack([metrics[k].detach().float().reshape(()) for k in self._metric_keys]))
        return torch.stack(rows)

    def _save_counters(self):
        """The host's counts a step moves -> a function that puts them back."""
        state, opt = self.state, self.state.optimizer
        saved = (state.step, opt.count, opt.mini_step)

        def restore():
            state.step, opt.count, opt.mini_step = saved

        return restore

    def _graph_tensors(self) -> list:
        """What the captured step reads and writes in place: the parameters,
        the optimizer state, the EMA."""
        return [*self.state.local_params(), *self.state.optimizer.state_tensors(), *(self.state.ema_params or [])]

    def _dispatch(self, window, micro0: int, steps: int):
        """Run ``steps`` optimizer steps of ``window`` (their micro batches) ->
        the metrics of each micro step, f32 [micro steps, K] on the host, in
        one pull. The steps' batches and draws are placed first, and the
        optimizer's scalars of the chunk go up in one copy; row i reaches its
        buffer before step i. On the graph route a step replays the captured
        one (the first step captures it); a step whose inputs the graph
        cannot take runs eagerly. ``_last_dispatch``: the host seconds of
        ``place``, ``dispatch`` and the one pull (``sync``)."""
        accum = self.cfg.train.gradient_accumulation_steps
        opt = self.state.optimizer
        t0 = time.perf_counter()
        inputs = [self._window_inputs(window[i * accum:(i + 1) * accum], micro0 + i * accum) for i in range(steps)]
        rows = upload(opt.scalar_rows(steps), torch.empty((steps, 4), dtype=torch.float32, device=opt.scalars.device))
        t1 = time.perf_counter()
        outs = []
        opt.fed = True
        try:
            for i in range(steps):
                opt.scalars.copy_(rows[i])
                if self._route != "graph" or (self._graph is not None and not self._graph.takes(inputs[i])):
                    outs.append(self._window(inputs[i]))
                elif self._graph is None:
                    self._graph = self._graphs.capture(self._window, inputs[i], graph_cls=chain.StepGraph,
                                                       save_counters=self._save_counters, pinned=self._graph_tensors)
                    outs.append(self._graph.first)
                    self._graph.first = None
                else:
                    outs.append(self._graph.replay(inputs[i]).clone())
                    self.state.step += accum
                    opt.count += 1
        finally:
            opt.fed = False
        t2 = time.perf_counter()
        out = torch.cat(outs).cpu().numpy()
        self._last_dispatch = {"place": t1 - t0, "dispatch": t2 - t1, "sync": time.perf_counter() - t2}
        return out

    def _resume(self) -> dict:
        restored, resumed_step = self.ckpt_manager.restore(self.state)
        if restored:
            self.logger.info(f"Resuming from checkpoint at global step {resumed_step}")
        elif self.cfg.checkpoint.resume_from_checkpoint:
            self.logger.info(
                f"Checkpoint '{self.cfg.checkpoint.resume_from_checkpoint}' does "
                "not exist. Starting a new training run."
            )
        return resume_train_state_math(
            num_batches_per_epoch=len(self.train_loader),
            gradient_accumulation_steps=self.cfg.train.gradient_accumulation_steps,
            max_train_steps=self.cfg.train.max_train_steps,
            max_train_epochs=self.cfg.train.max_train_epochs,
            resumed_global_step=resumed_step,
        )

    def train(self) -> None:
        cfg = self.cfg
        replay = self._resume()
        max_train_steps = replay["max_train_steps"]
        max_train_epochs = replay["max_train_epochs"]
        global_step = replay["global_step"]
        start_epoch = replay["start_epoch"]
        resume_step = replay["resume_step"]
        accum = cfg.train.gradient_accumulation_steps
        resumed = global_step > 0

        ckpt_steps = cfg.checkpoint.checkpointing_steps
        if ckpt_steps is not None and str(ckpt_steps).isdigit():
            ckpt_steps = int(ckpt_steps)

        total_bs = self.global_train_batch * accum
        self.logger.info("****************Start Training******************")
        self.logger.info(f"Total training data: {len(self.train_dataset)}")
        if self.eval_dataset is not None:
            self.logger.info(f"Total eval data: {len(self.eval_dataset)}")
        self.logger.info(f"Total update steps: {max_train_steps}")
        self.logger.info(f"Total Epochs: {max_train_epochs}")
        self.logger.info(f"Total Batch size: {total_bs}")
        self.logger.info(f"Device: {self.device} (compute {self.dtype})")
        self.logger.info(f"Resume from epoch={start_epoch}, step={resume_step}")
        self.logger.info("**********************************************")

        spd = int(cfg.train.steps_per_dispatch or 1)
        self._chunk_warm = self._single_warm = False
        self.logger.info(self._route_line(spd))

        micro_step = global_step * accum
        window_losses = []
        window_wall = 0.0
        self.step_timer = step_timer = StepTimer(warmup=2)  # the first steps build and tune
        # SD_TRAIN_PROFILE=1: each micro step's wall time by host phase (JAX trainer.py:518-520)
        phases = PhaseTimer(warmup=2) if os.environ.get("SD_TRAIN_PROFILE", "") == "1" else None
        done = False
        gns = GradNoiseScale()
        spike_thr = float(cfg.log.spike_threshold or 0.0)
        spikes = LossSpikes(spike_thr)

        for epoch in range(start_epoch, max_train_epochs):
            if done:
                break
            self.train_loader.set_epoch(epoch)
            stepper = self._micro_steps(
                phases.timed_iter(self.train_loader, "fetch") if phases is not None else self.train_loader,
                skip_until=resume_step if (resumed and epoch == start_epoch) else -1,
                micro_step0=micro_step,
                step_timer=step_timer,
                max_train_steps=max_train_steps,
                ckpt_steps=ckpt_steps,
                phases=phases,
            )
            for metrics, step_wall in stepper:
                micro_step += 1
                window_losses.append(metrics["loss"])
                window_wall += step_wall
                sync = micro_step % accum == 0
                if sync:
                    global_step += 1
                    loss_val = float(np.mean(window_losses))
                    window_losses = []
                    lr = lr_at_step(cfg.optim, max_train_steps, global_step)
                    dt, window_wall = window_wall, 0.0
                    record = {
                        "train_loss": loss_val,
                        "lr": lr,
                        "samples_per_sec": total_bs / max(dt, 1e-9),
                        **step_timer.summary_ms(),
                        **(phases.summary_ms() if phases is not None else {}),
                    }
                    if "gns_s" in metrics:
                        # the sync micro step's estimator halves, read beside the loss
                        b_noise = gns.update(float(metrics["gns_s"]), float(metrics["gns_g2"]))
                        if b_noise is not None:
                            record["grad_noise_scale"] = b_noise
                    if spike_thr > 0:
                        spike = spikes.update(global_step, loss_val, self.logger)
                        if spike is not None:
                            record["loss_spike"] = spike
                    self.tracker.log(record, step=global_step)
                    if global_step % 10 == 0 or global_step <= 3:
                        self.logger.info(
                            f"step {global_step}/{max_train_steps} loss={loss_val:.5f} lr={lr:.2e} "
                            f"({total_bs / max(dt, 1e-9):.1f} samples/s)"
                        )
                    if isinstance(ckpt_steps, int) and ckpt_steps > 0 and global_step % ckpt_steps == 0:
                        path = self.ckpt_manager.save(global_step, self.state, write=self.is_main_process)
                        self.logger.info(f"Saved state to {path}")

                # evaluation runs before the termination check, so a last step
                # on the cadence is still evaluated
                if (sync and global_step > 0 and cfg.train.log_interval > 0
                        and (global_step + self.eval_cadence_offset) % cfg.train.log_interval == 0):
                    self.evaluate(global_step)
                    if cfg.log.log_image and self.is_main_process:
                        self.log_images(global_step)

                if global_step >= max_train_steps:
                    done = True
                    break

            if ckpt_steps == "epoch":
                path = self.ckpt_manager.save(global_step, self.state, epoch=epoch, write=self.is_main_process)
                self.logger.info(f"Saved state to {path}")

        if phases is not None:
            summary = {**step_timer.summary_ms(), **phases.summary_ms()}
            if summary:
                self.logger.info("SD_TRAIN_PROFILE phase breakdown (ms): "
                                 + ", ".join(f"{k}={v:.1f}" for k, v in summary.items()))
        self.tracker.finish()

    def _route_line(self, spd: int) -> str:
        """The log line that says how the optimizer steps run."""
        head = f"--steps-per-dispatch {spd}: "
        if self._route == "graph":
            return head + ("each optimizer step runs as one CUDA graph, captured at the first step and replayed, "
                           + (f"{spd} replays a chunk and one pull of the metrics" if spd > 1
                              else "one pull of the metrics a step"))
        why = ("the optimizer is offloaded" if self.state.optimizer.offload
               else "a process group" if self.group is not None
               else f"a {self.device.type} device" if self.device.type != "cuda" else "the trainer built with capture off")
        if self._route == "eager":
            return head + f"chunks of {spd} optimizer steps and one pull of the metrics, run without a CUDA graph ({why})"
        return head + f"one micro step at a time, each step dispatched alone without a CUDA graph ({why})"

    def evaluate(self, global_step: int) -> Optional[float]:
        """The mean evaluation loss over the evaluation loader (batch ``i``'s
        draws from ``step_generator(device, 1, seed, i)``). On the graph route
        each batch signature's evaluation step is one CUDA graph: the first
        batch of a signature runs it eagerly on a side stream and captures
        it, later ones replay it (the last batch may be shorter)."""
        if self.eval_loader is None:
            return None
        self.logger.info(f"Evaluate on eval dataset [len: {len(self.eval_dataset)}]")
        losses = []
        for i, batch in enumerate(self.eval_loader):
            placed = self._place_batch(batch)
            inputs = (placed, self._eval_draws(placed, step_generator(self.device, 1, self.cfg.train.seed, i)))
            if self._route == "graph":
                loss = self._graphs.run(("eval", *signature(inputs)), lambda x: self._eval_body(*x),
                                        inputs, what="the evaluation step", pinned=self.state.local_params)
            else:
                loss = self._eval_body(*inputs)
            losses.append(float(self._mean(loss)))
        if not losses:
            return None
        eval_loss = float(np.mean(losses))
        self.logger.info(f"global step {global_step}: eval_loss: {eval_loss}")
        self.tracker.log({"eval_loss": eval_loss}, step=global_step)
        return eval_loss


class UNetTrainer(Trainer):
    """Latent-diffusion training: frozen CLIP and VAE, trainable UNet, or with
    ``--lora-rank`` a frozen f32 UNet and trainable rank-r factors at the
    ``--lora-targets`` weights, merged into the loss with scale ``alpha /
    rank`` (``--lora-alpha``, the rank when unset). ``--with-prior-preservation``
    (DreamBooth, with ``train_collate=dreambooth_collate``) adds
    ``--prior-loss-weight`` times the class rows' MSE, in evaluation too."""

    run_name = "train_unet"
    tensor_parallel_ok = True

    def __init__(self, model, cfg, train_dataset, eval_dataset, logger=None, compat=None, device="cuda",
                 train_collate=None, capture: bool = True):
        self.model = model
        self.compat = compat
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device, train_collate=train_collate,
                         capture=capture)

    def _build(self) -> None:
        cfg, compat, model = self.cfg, self.compat, self.model
        if bool(model.noise_scheduler.alphas_cumprod[-1] <= 0.0) and cfg.train.prediction_type == "epsilon":
            raise ValueError(
                "--zero-terminal-snr trains a timestep with SNR 0, where the "
                "eps objective is degenerate (the target IS the input); use "
                "--prediction-type v_prediction (Lin et al. 2023 §3.1)"
            )
        unet = model.unet
        lora_rank = int(cfg.train.lora_rank or 0)
        self._check_unet(unet, trainable=lora_rank == 0)
        sharded, layouts = False, None
        if lora_rank > 0 and self.model_group is not None:
            raise ValueError("--tensor-parallel splits the UNet's weights: a LoRA run keeps them frozen")
        transform = None
        self._lora = None
        if lora_rank > 0:
            alpha = float(cfg.train.lora_alpha or 0.0) or lora_rank
            scale = alpha / lora_rank
            base = dict(unet.named_parameters())
            trainable = Trainables(lora_lib.init_lora(
                {n: p.detach() for n, p in base.items()}, lora_rank, cfg.train.lora_targets,
                generator=torch.Generator(device=self.device).manual_seed(cfg.train.seed)))

            def transform(params):
                return lora_lib.lora_weights(base, params, scale)

            self._lora = (base, scale)

            self.logger.info(f"LoRA rank {lora_rank} (alpha {alpha:g}, targets {cfg.train.lora_targets}): "
                             f"{lora_lib.lora_param_count(trainable.tensors()):,} trainable params; base UNet frozen")
            params = trainable.leaves
        else:
            trainable = unet
            sharded = self._place(unet)
            if self.model_group is not None:
                from stable_diffusion_pytorch_tpu_torch.parallel.tensor_parallel import shard_unet

                split = shard_unet(unet, self.model_group)
                layouts = [split.get(n) for n, p in unet.named_parameters() if p.requires_grad]
            params = [p for p in unet.parameters() if p.requires_grad]
        self.state = TrainState(trainable, self._optimizer(params, module_sharded=sharded, layouts=layouts),
                                with_ema=cfg.train.ema_decay > 0)
        self.whole_batch_drop = bool(compat and compat.reference_compat)
        self._train, self._eval = make_unet_train_step(
            unet, model.text_encoder.module, model.autoencoder, model.noise_scheduler,
            compute_dtype=self.dtype,
            guidance_scale=cfg.train.guidance_scale,
            train_with_cfg=bool(compat and compat.train_with_cfg),
            reference_cfg_formula=bool(compat and compat.cfg_formula),
            cfg_dropout_prob=float(cfg.train.cfg_dropout_prob),
            whole_batch_cfg_dropout=self.whole_batch_drop,
            ema_decay=cfg.train.ema_decay,
            noise_offset=float(cfg.train.noise_offset or 0.0),
            input_perturbation=float(cfg.train.input_perturbation or 0.0),
            param_transform=transform,
            prior_loss_weight=float(cfg.train.prior_loss_weight or 0.0) if cfg.train.with_prior_preservation else 0.0,
            prediction_type=cfg.train.prediction_type,
            snr_gamma=float(cfg.train.snr_gamma or 0.0),
            grad_noise_scale=bool(cfg.log.log_grad_noise_scale),
            random_flip=self.random_flip,
        )
        self.gns = bool(cfg.log.log_grad_noise_scale)
        self.uncond_ids = self._uncond_ids()
        # the latent cache's rows hold the text embedding: the train step
        # drops prompts to the cached empty-prompt embedding (evaluation
        # batches are pixels and tokens, and keep the token path)
        self.uncond_train = (
            torch.as_tensor(np.asarray(self.train_dataset.uncond_emb, np.float32), device=self.device)
            if getattr(self.train_dataset, "has_text_cache", False) else self.uncond_ids
        )

    def _draws(self, batch, generator, halves: bool = False):
        return self._unet_draws(batch, generator, self.whole_batch_drop, halves=halves)

    def _train_draws(self, batch, generator):
        return self._draws(batch, generator, halves=self.gns)

    def _step(self, batch, draws):
        return self._train(self.state, batch, self.uncond_train, draws)

    def _eval_draws(self, batch, generator):
        return self._draws(batch, generator)

    def _eval_body(self, batch, draws):
        return self._eval(batch, self.uncond_ids, draws, params=self.state.tensors())

    @torch.no_grad()
    def log_images(self, global_step: int):
        """A sample at the reference's eval prompt, 50 DDIM steps (the
        reference's full loop runs 1000), from the trained weights (a LoRA
        merged into the base), written as ``output/unet_sample.png``. The
        sampler reads the UNet's output as the run trains it
        (``--prediction-type``), where the JAX package's reads it as epsilon."""
        weights = None
        if self._lora is not None:
            base, scale = self._lora
            weights = lora_lib.lora_weights(base, self.state.tensors(), scale)
        outs = pipeline.sample(
            sampling_model(self.model, weights=weights), image_size=self.cfg.dataset.resolution,
            prompt=LOG_IMAGE_PROMPT, time_steps=LOG_IMAGE_STEPS, guidance_scale=self.cfg.train.guidance_scale,
            save_dir="output", sampler="ddim", seed=self.cfg.train.seed, name="unet_sample",
            prediction_type=self.cfg.train.prediction_type,
        )
        self.tracker.log_images({"sampled image": outs[0]}, step=global_step)
        return outs[0]


class TextualInversionTrainer(Trainer):
    """Textual inversion (Gal et al. 2022): everything frozen but K embedding
    vectors for a placeholder token. ``model.text_encoder.add_textual_inversion``
    must have registered the placeholder and its initial vectors first (the
    datasets tokenize through it). At build the trainer writes the
    ``textual_inversion.json`` sidecar (placeholder, vector count) into the
    checkpoint directory, which sampling reads (``CLIPModel.load_textual_inversion``)."""

    run_name = "train_textual_inversion"

    def __init__(self, model, cfg, train_dataset, eval_dataset, logger=None, device="cuda", capture: bool = True):
        self.model = model
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device, capture=capture)

    def _build(self) -> None:
        cfg, model = self.cfg, self.model
        te = model.text_encoder
        if te._ti is None:
            raise ValueError("call model.text_encoder.add_textual_inversion(...) before building the "
                             "TextualInversionTrainer")
        self._check_unet(model.unet, trainable=False)
        self.placeholder, pids, vectors = te._ti
        trainable = Trainables({"ti": torch.as_tensor(vectors, dtype=torch.float32, device=self.device)})
        self.state = TrainState(trainable, self._optimizer(trainable.leaves), with_ema=cfg.train.ema_decay > 0)
        self._train, self._eval = make_textual_inversion_train_step(
            model.unet, te.module, model.autoencoder, model.noise_scheduler, [int(i) for i in pids],
            compute_dtype=self.dtype, ema_decay=cfg.train.ema_decay,
        )
        if self.is_main_process:
            os.makedirs(cfg.checkpoint.ckpt_dir, exist_ok=True)
            with open(os.path.join(cfg.checkpoint.ckpt_dir, "textual_inversion.json"), "w") as f:
                json.dump({"placeholder_token": self.placeholder, "num_vectors": int(len(pids))}, f)

    def _train_draws(self, batch, generator):
        return self._unet_draws(batch, generator)

    def _step(self, batch, draws):
        return self._train(self.state, batch, draws)

    def _eval_draws(self, batch, generator):
        return self._unet_draws(batch, generator)

    def _eval_body(self, batch, draws):
        return self._eval(batch, draws, self.state.tensors())

    @torch.no_grad()
    def log_images(self, global_step: int):
        """A 50-step DDIM sample of "a photo of a <placeholder>" with the
        trained vectors, written as ``output/ti_sample.png``."""
        self.model.text_encoder.set_textual_inversion_vectors(self.state.tensors()["ti"].detach().float().cpu().numpy())
        outs = pipeline.sample(
            sampling_model(self.model), image_size=self.cfg.dataset.resolution,
            prompt=f"a photo of a {self.placeholder}", time_steps=LOG_IMAGE_STEPS,
            guidance_scale=self.cfg.train.guidance_scale, save_dir="output", sampler="ddim",
            seed=self.cfg.train.seed, name="ti_sample",
        )
        self.tracker.log_images({"sampled image": outs[0]}, step=global_step)
        return outs[0]


class ControlNetTrainer(Trainer):
    """ControlNet training (Zhang et al. 2023): frozen UNet, VAE and CLIP; the
    control branch ``controlnet`` (f32 trainable parameters, zero convs at
    zero: ``models/build.py:build_controlnet(..., for_training=True)``) starts
    as a copy of the UNet's encoder. Each row's prompt drops with
    ``--cfg-dropout-prob`` (default 0.1, the field's; the paper's 0.5 must be
    asked for)."""

    run_name = "train_controlnet"

    def __init__(self, model, controlnet, cfg, train_dataset, eval_dataset, logger=None, device="cuda",
                 train_collate=None, capture: bool = True):
        self.model = model
        self.controlnet = controlnet
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device, train_collate=train_collate,
                         capture=capture)

    def _build(self) -> None:
        cfg, model, net = self.cfg, self.model, self.controlnet
        self._check_unet(model.unet, trainable=False)
        p = next(net.parameters())
        if p.dtype != torch.float32 or not p.requires_grad:
            raise ValueError("the ControlNet must hold f32 trainable parameters: "
                             "build_controlnet(..., for_training=True)")
        init_controlnet_from_unet(model.unet, net)
        sharded = self._place(net)
        self.state = TrainState(net, self._optimizer([q for q in net.parameters() if q.requires_grad], sharded),
                                with_ema=cfg.train.ema_decay > 0)
        self._train, self._eval = make_controlnet_train_step(
            model.unet, net, model.text_encoder.module, model.autoencoder, model.noise_scheduler,
            compute_dtype=self.dtype, cfg_dropout_prob=float(getattr(cfg.train, "cfg_dropout_prob", 0.5)),
            ema_decay=cfg.train.ema_decay,
        )
        self.uncond_ids = self._uncond_ids()

    def _train_draws(self, batch, generator):
        return self._unet_draws(batch, generator)

    def _step(self, batch, draws):
        return self._train(self.state, batch, self.uncond_ids, draws)

    def _eval_draws(self, batch, generator):
        return self._unet_draws(batch, generator)

    def _eval_body(self, batch, draws):
        return self._eval(batch, self.uncond_ids, draws)

    @torch.no_grad()
    def log_images(self, global_step: int):
        """A 50-step DDIM sample at the first evaluation row's caption,
        steered by its hint through a copy of the trained ControlNet cast for
        inference, written as ``output/controlnet_sample.png``."""
        sampler = sampling_model(self.model)
        sampler.attach_controlnet(cast_for_inference(copy.deepcopy(self.controlnet), self.model.dtype))
        row = self.eval_dataset[0]
        outs = pipeline.sample(
            sampler, image_size=self.cfg.dataset.resolution, prompt=row.get("text", ""),
            time_steps=LOG_IMAGE_STEPS, guidance_scale=self.cfg.train.guidance_scale, save_dir="output",
            sampler="ddim", seed=self.cfg.train.seed, name="controlnet_sample", control_image=row["hint"],
        )
        self.tracker.log_images({"sampled image": outs[0]}, step=global_step)
        return outs[0]


class AutoencoderTrainer(Trainer):
    """KL-VAE training: the whole VAE trainable, loss MSE + ``kl_weight`` * KL,
    with the reference's loss fixed by default (the batch-mean KL; example
    0's under ``CompatConfig.kl_per_example0``). The VAE must hold f32
    trainable parameters (``models/build.py:build_autoencoder``); it
    computes in the run's dtype under autocast. ``--remat-policy`` is a UNet
    option and does not apply here."""

    run_name = "train_autoencoder"
    eval_cadence_offset = 1  # (global_step + 1) % log_interval, as the JAX package's VAE trainer

    def __init__(self, vae, cfg, train_dataset, eval_dataset, test_images=None, logger=None, compat=None,
                 device="cuda", capture: bool = True):
        self.vae = vae
        self.compat = compat
        self.test_images = list(test_images or [])
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device, capture=capture)

    def _build(self) -> None:
        cfg, vae = self.cfg, self.vae
        if next(vae.parameters()).dtype != torch.float32 or not next(vae.parameters()).requires_grad:
            raise ValueError("the VAE must hold f32 trainable parameters: build_autoencoder(..., device)")
        sharded = self._place(vae)
        self.state = TrainState(vae, self._optimizer([p for p in vae.parameters() if p.requires_grad], sharded),
                                with_ema=cfg.train.ema_decay > 0)
        self.gns = bool(cfg.log.log_grad_noise_scale)
        self._train, self._eval = make_vae_train_step(
            vae, compute_dtype=self.dtype, kl_weight=float(cfg.model.autoencoder.kl_weight),
            kl_per_example0=bool(self.compat and self.compat.kl_per_example0), ema_decay=cfg.train.ema_decay,
            grad_noise_scale=self.gns, random_flip=self.random_flip,
        )

    def _eps(self, batch, generator, rows: Optional[int] = None) -> torch.Tensor:
        """The posterior noise of one step, [B, H/f, W/f, latent_channels] f32
        (``rows`` rows in place of the batch's)."""
        b, h, w, _ = (batch["pixel_values"] if "pixel_values" in batch else batch["raw_images"]).shape
        f = self.vae.downsample_factor
        return torch.randn((b if rows is None else rows, h // f, w // f, self.vae.latent_channels),
                           generator=generator, device=self.device)

    def _draws(self, batch, generator, halves: bool = False):
        """(posterior noise, flips or None) of one step for this rank's rows
        of the global batch's draws; with ``halves`` each a pair, one for
        each half of the global batch (drawn half by half)."""
        rows = next(iter(batch.values())).shape[0]

        def draws(n):
            eps = self._eps(batch, generator, n)
            flip = torch.rand((n,), generator=generator, device=self.device) < 0.5 if self.random_flip else None
            return eps, flip

        def take(pair, start, stop):
            return tuple(None if t is None else t[start:stop] for t in pair)

        total = rows * self.world
        if halves:
            eps, flip = zip(*(take(draws(n), *span) for n, span in
                              zip((total // 2, total - total // 2), half_spans(rows, self.rank, self.world))))
            return eps, flip if self.random_flip else None
        return take(draws(total), self.rank * rows, (self.rank + 1) * rows)

    def _train_draws(self, batch, generator):
        return self._draws(batch, generator, halves=self.gns)

    def _step(self, batch, draws):
        return self._train(self.state, batch, *draws)

    def _eval_draws(self, batch, generator):
        return self._draws(batch, generator)

    def _eval_body(self, batch, draws):
        return self._eval(batch, *draws)

    @torch.no_grad()
    def recon(self, image: np.ndarray) -> np.ndarray:
        """Reconstruct one [-1, 1] HWC image (a posterior sample from a
        generator seeded 0) -> HWC uint8."""
        batch = {"pixel_values": torch.as_tensor(np.asarray(image, np.float32), device=self.device)[None]}
        autocast = self.device.type == "cuda" and self.dtype != torch.float32
        with torch.autocast(self.device.type, dtype=self.dtype, enabled=autocast):
            recon, _ = self.vae(batch["pixel_values"], eps=self._eps(batch, step_generator(self.device, 0)))
        return detransform(recon.float().cpu().numpy())

    def log_images(self, global_step: int):
        """Reconstructions of the test images; the first written as
        ``output/autoencoder.png``."""
        if not self.test_images:
            return None
        recons = [self.recon(img) for img in self.test_images]
        to_img(recons[0], output_path="output", name="autoencoder")
        self.tracker.log_images({"original_imgs": [detransform(i) for i in self.test_images], "recon_imgs": recons},
                                step=global_step)
        return recons[0]
