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

Not ported, and refused with ``NotImplementedError`` naming the ROADMAP item
(:func:`check_supported`): multi-device and sharded training, chained
dispatch, v-prediction, Min-SNR, gradient-noise-scale, the latent cache,
on-device preprocessing, image logging (so no trainer here has
``log_images``), wandb tracking, loss-spike detection and the unfused optax
optimizer (``--no-fused-adamw``). Ported memory levers: ``--remat-policy`` (per-block
remat, set on the UNet by ``build_models``), ``--use-8bit-adam`` (int8
moments, K9), ``--adam-mu-dtype``/``--adam-nu-dtype``/``--accum-dtype`` bf16.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.models import lora as lora_lib
from stable_diffusion_pytorch_tpu_torch.models.build import require_device, resolve_dtype
from stable_diffusion_pytorch_tpu_torch.models.controlnet import init_controlnet_from_unet
from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_optimizer, lr_at_step
from stable_diffusion_pytorch_tpu_torch.trainers.steps import (
    Trainables,
    TrainState,
    make_controlnet_train_step,
    make_textual_inversion_train_step,
    make_unet_train_step,
    make_vae_train_step,
    sample_draws,
)
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import CheckpointManager, resume_train_state_math
from stable_diffusion_pytorch_tpu_torch.utils.data import DataLoader, detransform
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
        (not p.use_pallas_attention, "--use-pallas-attention off", SLICE2_REST),
        ((t.steps_per_dispatch or 1) > 1, "--steps-per-dispatch", SLICE2_REST),
        (t.prediction_type != "epsilon", f"--prediction-type {t.prediction_type}", SLICE2_REST),
        ((t.snr_gamma or 0.0) > 0.0, "--snr-gamma", SLICE2_REST),
        (lg.log_grad_noise_scale, "--log-grad-noise-scale", SLICE2_REST),
        (lg.log_image, "--log-image", SLICE2_REST),
        (lg.with_tracking, "--with-tracking", SLICE2_REST),
        ((lg.spike_threshold or 0.0) > 0.0, "--spike-threshold", SLICE2_REST),
        (d.latent_cache is not None, "--latent-cache", SLICE2_REST),
        (d.device_preprocess, "--device-preprocess", SLICE2_REST),
        (o.no_fused_adamw, "--no-fused-adamw", SLICE2_REST),
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
    eval_cadence_offset = 0  # evaluate when (global_step + offset) % log_interval == 0

    def __init__(self, cfg, train_dataset, eval_dataset, logger=None, device="cuda", train_collate=None):
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
            collate=train_collate, num_workers=num_workers,
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
    def _optimizer(self, params):
        return build_optimizer(
            params, self.cfg.optim, max_train_steps=self.cfg.train.max_train_steps,
            gradient_accumulation_steps=self.cfg.train.gradient_accumulation_steps,
        )

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

    def _unet_draws(self, batch, generator, whole_batch_drop: bool = False):
        """Every draw of one UNet-loss step for this batch (its rows, 2B under prior preservation)."""
        bsz = batch["input_ids"].shape[0]
        return sample_draws(
            generator, bsz, self.model.latent_shape(bsz, batch["pixel_values"].shape[1]),
            self.model.noise_scheduler.noise_steps, self.device,
            noise_offset=float(self.cfg.train.noise_offset or 0.0),
            input_perturbation=float(self.cfg.train.input_perturbation or 0.0),
            whole_batch_drop=whole_batch_drop,
        )

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
                if (sync and global_step > 0 and cfg.train.log_interval > 0
                        and (global_step + self.eval_cadence_offset) % cfg.train.log_interval == 0):
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
    """Latent-diffusion training: frozen CLIP and VAE, trainable UNet, or with
    ``--lora-rank`` a frozen f32 UNet and trainable rank-r factors at the
    ``--lora-targets`` weights, merged into the loss with scale ``alpha /
    rank`` (``--lora-alpha``, the rank when unset). ``--with-prior-preservation``
    (DreamBooth, with ``train_collate=dreambooth_collate``) adds
    ``--prior-loss-weight`` times the class rows' MSE, in evaluation too."""

    run_name = "train_unet"

    def __init__(self, model, cfg, train_dataset, eval_dataset, logger=None, compat=None, device="cuda",
                 train_collate=None):
        self.model = model
        self.compat = compat
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device, train_collate=train_collate)

    def _build(self) -> None:
        cfg, compat, model = self.cfg, self.compat, self.model
        unet = model.unet
        lora_rank = int(cfg.train.lora_rank or 0)
        self._check_unet(unet, trainable=lora_rank == 0)
        transform = None
        if lora_rank > 0:
            alpha = float(cfg.train.lora_alpha or 0.0) or lora_rank
            scale = alpha / lora_rank
            base = dict(unet.named_parameters())
            trainable = Trainables(lora_lib.init_lora(
                {n: p.detach() for n, p in base.items()}, lora_rank, cfg.train.lora_targets,
                generator=torch.Generator(device=self.device).manual_seed(cfg.train.seed)))

            def transform(params):
                return lora_lib.lora_weights(base, params, scale)

            self.logger.info(f"LoRA rank {lora_rank} (alpha {alpha:g}, targets {cfg.train.lora_targets}): "
                             f"{lora_lib.lora_param_count(trainable.tensors()):,} trainable params; base UNet frozen")
            params = trainable.leaves
        else:
            trainable = unet
            params = [p for p in unet.parameters() if p.requires_grad]
        self.state = TrainState(trainable, self._optimizer(params), with_ema=cfg.train.ema_decay > 0)
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
        )
        self.uncond_ids = self._uncond_ids()

    def _draws(self, batch, generator):
        return self._unet_draws(batch, generator, self.whole_batch_drop)

    def _train_step(self, batch, generator):
        return self._train(self.state, batch, self.uncond_ids, self._draws(batch, generator))

    def _eval_step(self, batch, generator):
        return self._eval(batch, self.uncond_ids, self._draws(batch, generator), params=self.state.tensors())


class TextualInversionTrainer(Trainer):
    """Textual inversion (Gal et al. 2022): everything frozen but K embedding
    vectors for a placeholder token. ``model.text_encoder.add_textual_inversion``
    must have registered the placeholder and its initial vectors first (the
    datasets tokenize through it). At build the trainer writes the
    ``textual_inversion.json`` sidecar (placeholder, vector count) into the
    checkpoint directory, which sampling reads (``CLIPModel.load_textual_inversion``)."""

    run_name = "train_textual_inversion"

    def __init__(self, model, cfg, train_dataset, eval_dataset, logger=None, device="cuda"):
        self.model = model
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device)

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
        os.makedirs(cfg.checkpoint.ckpt_dir, exist_ok=True)
        with open(os.path.join(cfg.checkpoint.ckpt_dir, "textual_inversion.json"), "w") as f:
            json.dump({"placeholder_token": self.placeholder, "num_vectors": int(len(pids))}, f)

    def _train_step(self, batch, generator):
        return self._train(self.state, batch, self._unet_draws(batch, generator))

    def _eval_step(self, batch, generator):
        return self._eval(batch, self._unet_draws(batch, generator), self.state.tensors())


class ControlNetTrainer(Trainer):
    """ControlNet training (Zhang et al. 2023): frozen UNet, VAE and CLIP; the
    control branch ``controlnet`` (f32 trainable parameters, zero convs at
    zero: ``models/build.py:build_controlnet(..., for_training=True)``) starts
    as a copy of the UNet's encoder. Each row's prompt drops with
    ``--cfg-dropout-prob`` (default 0.1, the field's; the paper's 0.5 must be
    asked for)."""

    run_name = "train_controlnet"

    def __init__(self, model, controlnet, cfg, train_dataset, eval_dataset, logger=None, device="cuda",
                 train_collate=None):
        self.model = model
        self.controlnet = controlnet
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device, train_collate=train_collate)

    def _build(self) -> None:
        cfg, model, net = self.cfg, self.model, self.controlnet
        self._check_unet(model.unet, trainable=False)
        p = next(net.parameters())
        if p.dtype != torch.float32 or not p.requires_grad:
            raise ValueError("the ControlNet must hold f32 trainable parameters: "
                             "build_controlnet(..., for_training=True)")
        init_controlnet_from_unet(model.unet, net)
        self.state = TrainState(net, self._optimizer([q for q in net.parameters() if q.requires_grad]),
                                with_ema=cfg.train.ema_decay > 0)
        self._train, self._eval = make_controlnet_train_step(
            model.unet, net, model.text_encoder.module, model.autoencoder, model.noise_scheduler,
            compute_dtype=self.dtype, cfg_dropout_prob=float(getattr(cfg.train, "cfg_dropout_prob", 0.5)),
            ema_decay=cfg.train.ema_decay,
        )
        self.uncond_ids = self._uncond_ids()

    def _train_step(self, batch, generator):
        return self._train(self.state, batch, self.uncond_ids, self._unet_draws(batch, generator))

    def _eval_step(self, batch, generator):
        return self._eval(batch, self.uncond_ids, self._unet_draws(batch, generator))


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
                 device="cuda"):
        self.vae = vae
        self.compat = compat
        self.test_images = list(test_images or [])
        super().__init__(cfg, train_dataset, eval_dataset, logger, device=device)

    def _build(self) -> None:
        cfg, vae = self.cfg, self.vae
        if next(vae.parameters()).dtype != torch.float32 or not next(vae.parameters()).requires_grad:
            raise ValueError("the VAE must hold f32 trainable parameters: build_autoencoder(..., device)")
        self.state = TrainState(vae, self._optimizer([p for p in vae.parameters() if p.requires_grad]),
                                with_ema=cfg.train.ema_decay > 0)
        self._train, self._eval = make_vae_train_step(
            vae, compute_dtype=self.dtype, kl_weight=float(cfg.model.autoencoder.kl_weight),
            kl_per_example0=bool(self.compat and self.compat.kl_per_example0), ema_decay=cfg.train.ema_decay,
        )

    def _eps(self, batch, generator) -> torch.Tensor:
        """The posterior noise of one step, [B, H/f, W/f, latent_channels] f32."""
        b, h, w, _ = batch["pixel_values"].shape
        f = self.vae.downsample_factor
        return torch.randn((b, h // f, w // f, self.vae.latent_channels), generator=generator, device=self.device)

    def _train_step(self, batch, generator):
        return self._train(self.state, batch, self._eps(batch, generator))

    def _eval_step(self, batch, generator):
        return self._eval(batch, self._eps(batch, generator))

    @torch.no_grad()
    def recon(self, image: np.ndarray) -> np.ndarray:
        """Reconstruct one [-1, 1] HWC image (a posterior sample from a
        generator seeded 0) -> HWC uint8."""
        batch = {"pixel_values": torch.as_tensor(np.asarray(image, np.float32), device=self.device)[None]}
        autocast = self.device.type == "cuda" and self.dtype != torch.float32
        with torch.autocast(self.device.type, dtype=self.dtype, enabled=autocast):
            recon, _ = self.vae(batch["pixel_values"], eps=self._eps(batch, step_generator(self.device, 0)))
        return detransform(recon.float().cpu().numpy())
