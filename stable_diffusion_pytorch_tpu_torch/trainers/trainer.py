"""Trainer core on one device and the UNet trainer (port of trainers/trainer.py).

The loop keeps the JAX package's semantics: ``train_batch_size`` per device,
``global_step`` counting optimizer steps (``gradient_accumulation_steps``
micro steps each), ``checkpoint-{step}`` saves every ``checkpointing_steps``
(or per epoch), ``latest`` resume with the reference's replay arithmetic
(skipping the micro batches already seen in the resumed epoch), evaluation
every ``log_interval`` optimizer steps before the termination check, and the
JSONL metrics stream (train loss, lr, samples/s, step timing).

Random draws: micro step ``m`` takes its draws from a ``torch.Generator``
seeded with ``SeedSequence([0, seed, m])`` (evaluation batch ``i``:
``[1, seed, i]``), so a resumed run replays the same draws, as the JAX
package's ``fold_in(seed, m)`` keys do. The streams differ from JAX's.

Not ported, and refused with ``NotImplementedError`` naming the ROADMAP item
(:func:`check_supported`): multi-device and sharded training, remat, chained
dispatch, v-prediction, Min-SNR, gradient-noise-scale, LoRA, prior
preservation, the latent cache, on-device preprocessing, image logging, wandb
tracking, loss-spike detection, the 8-bit optimizer and bf16 optimizer
storage.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.models.build import require_device, resolve_dtype
from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_optimizer, lr_at_step
from stable_diffusion_pytorch_tpu_torch.trainers.steps import (
    TrainState,
    make_unet_train_step,
    sample_draws,
)
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import CheckpointManager, resume_train_state_math
from stable_diffusion_pytorch_tpu_torch.utils.data import DataLoader
from stable_diffusion_pytorch_tpu_torch.utils.profiling import StepTimer
from stable_diffusion_pytorch_tpu_torch.utils.tracking import Tracker, get_logger

SLICE2_REST = "ROADMAP queue 1, item 13a"


def _unsupported(cfg):
    """(flag, ROADMAP item) of every option set away from a default whose
    feature the port does not have."""
    p, t, lg, d, o = cfg.parallel, cfg.train, cfg.log, cfg.dataset, cfg.optim
    checks = [
        (p.num_devices not in (None, 1), "--num-devices", "ROADMAP queue 1, item 17"),
        (p.shard_optimizer_state, "--shard-optimizer-state", "ROADMAP queue 1, item 17"),
        (t.use_deepspeed, "--use-deepspeed", "ROADMAP queue 1, item 17"),
        (p.offload_optimizer, "--offload-optimizer", "ROADMAP queue 1, item 17"),
        (p.shard_params, "--shard-params", "ROADMAP queue 1, item 17"),
        ((p.tensor_parallel or 1) > 1, "--tensor-parallel", "ROADMAP queue 1, item 17"),
        (p.remat_policy != "none", f"--remat-policy {p.remat_policy}", SLICE2_REST),
        (not p.use_pallas_attention, "--use-pallas-attention off", SLICE2_REST),
        ((t.steps_per_dispatch or 1) > 1, "--steps-per-dispatch", SLICE2_REST),
        (t.prediction_type != "epsilon", f"--prediction-type {t.prediction_type}", SLICE2_REST),
        ((t.snr_gamma or 0.0) > 0.0, "--snr-gamma", SLICE2_REST),
        (lg.log_grad_noise_scale, "--log-grad-noise-scale", SLICE2_REST),
        ((t.lora_rank or 0) > 0, "--lora-rank", "ROADMAP queue 1, item 16"),
        (t.with_prior_preservation, "--with-prior-preservation", "ROADMAP queue 1, item 16"),
        (lg.log_image, "--log-image", SLICE2_REST),
        (lg.with_tracking, "--with-tracking", SLICE2_REST),
        ((lg.spike_threshold or 0.0) > 0.0, "--spike-threshold", SLICE2_REST),
        (d.latent_cache is not None, "--latent-cache", SLICE2_REST),
        (d.device_preprocess, "--device-preprocess", SLICE2_REST),
        (o.use_8bit_adam, "--use-8bit-adam", "ROADMAP queue 1, item 18"),
        (o.no_fused_adamw, "--no-fused-adamw", SLICE2_REST),
        (o.adam_mu_dtype != "f32", "--adam-mu-dtype", SLICE2_REST),
        (o.adam_nu_dtype != "f32", "--adam-nu-dtype", SLICE2_REST),
        (o.accum_dtype != "f32", "--accum-dtype", SLICE2_REST),
    ]
    return [(flag, item) for bad, flag, item in checks if bad]


def check_supported(cfg) -> None:
    """Raise NotImplementedError for the first option the port cannot honour."""
    for flag, item in _unsupported(cfg):
        raise NotImplementedError(f"{flag} is not ported to the PyTorch trainer yet ({item})")


def step_generator(device, *seeds: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(seeds)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


class Trainer:
    """Loop, checkpointing, resume replay, evaluation cadence and metrics.
    Subclasses build the state and steps in ``_build``."""

    run_name = "trainer"

    def __init__(self, cfg, train_dataset, eval_dataset, logger=None, device="cuda"):
        if train_dataset is None:
            raise ValueError("must specify a training dataset")
        if eval_dataset is None and cfg.train.log_interval > 0:
            raise ValueError("if passed log_interval > 0, you must specify an evaluation dataset")
        check_supported(cfg)
        self.cfg = cfg
        self.logger = logger or get_logger(self.run_name)
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.device = require_device(device)
        self.dtype = resolve_dtype(cfg.parallel.mixed_precision, self.device)
        self.global_train_batch = cfg.train.train_batch_size
        self.global_eval_batch = cfg.train.eval_batch_size
        num_workers = int(getattr(cfg.dataset, "dataloader_num_workers", 0) or 0)
        self.train_loader = DataLoader(
            train_dataset, batch_size=self.global_train_batch, shuffle=True, seed=cfg.train.seed,
            num_workers=num_workers,
        )
        self.eval_loader = (
            DataLoader(eval_dataset, batch_size=self.global_eval_batch, shuffle=False,
                       seed=cfg.train.seed, num_workers=num_workers)
            if eval_dataset is not None else None
        )
        self.ckpt_manager = CheckpointManager(cfg.checkpoint)
        self.tracker = Tracker(cfg.log, self.run_name)
        self._build()

    # subclass surface
    def _build(self) -> None:
        raise NotImplementedError

    def _train_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, Any]:
        raise NotImplementedError

    def _eval_step(self, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    # shared machinery
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

    def _micro_steps(self, epoch_iter, *, skip_until: int, micro_step0: int, step_timer):
        """Yield (metrics as floats, step wall seconds incl. the batch fetch)
        for each micro step of one epoch."""
        micro = micro_step0
        it = enumerate(epoch_iter)
        while True:
            t_fetch0 = time.perf_counter()
            try:
                s, batch = next(it)
                while s < skip_until:
                    s, batch = next(it)
            except StopIteration:
                return
            fetch_dt = time.perf_counter() - t_fetch0
            t0 = time.perf_counter()
            placed = self._place_batch(batch)
            with step_timer:
                metrics = self._train_step(placed, step_generator(self.device, 0, self.cfg.train.seed, micro))
                # reading the loss waits for the step's device work
                metrics = {k: float(v) for k, v in metrics.items()}
            micro += 1
            yield metrics, fetch_dt + (time.perf_counter() - t0)

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

        micro_step = global_step * accum
        window_losses = []
        window_wall = 0.0
        self.step_timer = step_timer = StepTimer(warmup=2)  # the first steps build and tune
        done = False

        for epoch in range(start_epoch, max_train_epochs):
            if done:
                break
            self.train_loader.set_epoch(epoch)
            stepper = self._micro_steps(
                self.train_loader,
                skip_until=resume_step if (resumed and epoch == start_epoch) else -1,
                micro_step0=micro_step,
                step_timer=step_timer,
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
                    }
                    self.tracker.log(record, step=global_step)
                    if global_step % 10 == 0 or global_step <= 3:
                        self.logger.info(
                            f"step {global_step}/{max_train_steps} loss={loss_val:.5f} lr={lr:.2e} "
                            f"({total_bs / max(dt, 1e-9):.1f} samples/s)"
                        )
                    if isinstance(ckpt_steps, int) and ckpt_steps > 0 and global_step % ckpt_steps == 0:
                        path = self.ckpt_manager.save(global_step, self.state)
                        self.logger.info(f"Saved state to {path}")

                # evaluation runs before the termination check, so a last step
                # on the cadence is still evaluated
                if sync and global_step > 0 and cfg.train.log_interval > 0 and global_step % cfg.train.log_interval == 0:
                    self.evaluate(global_step)

                if global_step >= max_train_steps:
                    done = True
                    break

            if ckpt_steps == "epoch":
                path = self.ckpt_manager.save(global_step, self.state, epoch=epoch)
                self.logger.info(f"Saved state to {path}")

        self.tracker.finish()

    def evaluate(self, global_step: int) -> Optional[float]:
        if self.eval_loader is None:
            return None
        self.logger.info(f"Evaluate on eval dataset [len: {len(self.eval_dataset)}]")
        losses = [
            float(self._eval_step(self._place_batch(batch), step_generator(self.device, 1, self.cfg.train.seed, i)))
            for i, batch in enumerate(self.eval_loader)
        ]
        if not losses:
            return None
        eval_loss = float(np.mean(losses))
        self.logger.info(f"global step {global_step}: eval_loss: {eval_loss}")
        self.tracker.log({"eval_loss": eval_loss}, step=global_step)
        return eval_loss


class UNetTrainer(Trainer):
    """Latent-diffusion training: frozen CLIP and VAE, trainable UNet."""

    run_name = "train_unet"

    def __init__(self, model, cfg, train_dataset, eval_dataset, logger=None, compat=None, device="cuda"):
        self.model = model
        self.compat = compat
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device)

    def _build(self) -> None:
        cfg, compat, model = self.cfg, self.compat, self.model
        unet = model.unet
        if next(unet.parameters()).dtype != torch.float32 or not next(unet.parameters()).requires_grad:
            raise ValueError("the UNet must hold f32 trainable parameters: build_models(..., for_training=True)")
        optimizer = build_optimizer(
            [p for p in unet.parameters() if p.requires_grad], cfg.optim,
            max_train_steps=cfg.train.max_train_steps,
            gradient_accumulation_steps=cfg.train.gradient_accumulation_steps,
        )
        self.state = TrainState(unet, optimizer, with_ema=cfg.train.ema_decay > 0)
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
        )
        self.uncond_ids = torch.as_tensor(
            np.asarray(model.text_encoder.tokenize([""]).input_ids[0]), dtype=torch.long, device=self.device
        )

    def _draws(self, batch, generator):
        bsz = batch["input_ids"].shape[0]
        return sample_draws(
            generator, bsz, self.model.latent_shape(bsz, batch["pixel_values"].shape[1]),
            self.model.noise_scheduler.noise_steps, self.device,
            noise_offset=float(self.cfg.train.noise_offset or 0.0),
            input_perturbation=float(self.cfg.train.input_perturbation or 0.0),
            whole_batch_drop=self.whole_batch_drop,
        )

    def _train_step(self, batch, generator):
        return self._train(self.state, batch, self.uncond_ids, self._draws(batch, generator))

    def _eval_step(self, batch, generator):
        return self._eval(batch, self.uncond_ids, self._draws(batch, generator))
