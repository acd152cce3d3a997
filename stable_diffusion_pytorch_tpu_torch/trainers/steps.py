"""The train and eval steps of the UNet and of the KL-VAE (port of
trainers/steps.py: ``make_unet_train_step``, ``make_vae_train_step``).

One UNet step: frozen VAE encode and posterior sample, q-sample, frozen CLIP encode
with empty-prompt dropout, the UNet forward and backward, the f32 MSE to the
noise, clip-by-global-norm and AdamW (``trainers/optim.py``), and the EMA
shadow update. The UNet keeps f32 parameters; on a CUDA device with a bf16
compute dtype its forward runs under ``torch.autocast`` (matmuls and convs in
bf16, the counterpart of Flax's ``dtype=bf16`` over ``param_dtype=f32``). The
attention and GroupNorm layers reach the kernels through their autograd
Functions (``ops/flash_attention.py``, ``ops/fused_groupnorm.py``), forward and
backward.

Every random draw of a step comes from :func:`sample_draws`: the posterior
noise, the diffusion noise, the timesteps, the dropout uniforms, the offset
noise and the input perturbation. ``jax.random`` cannot be reproduced, so a
parity test draws them in JAX (``steps.py`` splits the step key seven ways)
and hands them in.

One VAE step: the whole VAE (encode, posterior sample, decode) forward and
backward on trainable f32 parameters under the same autocast, the f32 MSE of
the reconstruction plus ``kl_weight`` times the KL, then the same optimizer
and EMA update. Its one draw, the posterior noise, is handed in as ``eps``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from stable_diffusion_pytorch_tpu_torch.models import schedule as sched_lib
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import make_pred_noise_fn
from stable_diffusion_pytorch_tpu_torch.models.schedule import DiffusionSchedule


class TrainState:
    """The trainable module's parameters (held by the module: the UNet, or
    the VAE of the autoencoder trainer), the optimizer state, the micro-step
    count and the optional EMA shadow parameters."""

    def __init__(self, module: torch.nn.Module, optimizer, with_ema: bool = False):
        self.step = 0
        self.module = module
        self.names = [n for n, p in module.named_parameters() if p.requires_grad]
        self.params: List[torch.Tensor] = [p for p in module.parameters() if p.requires_grad]
        self.optimizer = optimizer
        with torch.no_grad():
            self.ema_params = [p.detach().clone() for p in self.params] if with_ema else None

    def state_dict(self) -> Dict:
        return {
            "step": self.step,
            "params": dict(zip(self.names, self.params)),
            "opt_state": self.optimizer.state_dict(),
            "ema_params": None if self.ema_params is None else dict(zip(self.names, self.ema_params)),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if (state["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint EMA parameters do not match this run's --ema-decay")
        if sorted(state["params"]) != sorted(self.names):
            raise ValueError("checkpoint parameters do not match this module's parameters")
        self.step = int(state["step"])
        for i, name in enumerate(self.names):
            self.params[i].copy_(state["params"][name])
            if self.ema_params is not None:
                self.ema_params[i].copy_(state["ema_params"][name])
        self.optimizer.load_state_dict(state["opt_state"])


def sample_draws(
    generator: torch.Generator,
    batch_size: int,
    latent_shape: Tuple[int, ...],
    noise_steps: int,
    device,
    noise_offset: float = 0.0,
    input_perturbation: float = 0.0,
    whole_batch_drop: bool = False,
) -> Dict[str, torch.Tensor]:
    """Every random draw of one step, f32 (timesteps int64) on ``device``:
    ``posterior_eps`` and ``noise`` [B, h, w, c], ``timesteps`` [B] in
    [0, noise_steps), ``drop_u`` uniforms ([B], or [] for whole-batch
    dropout), and when enabled ``offset`` [B, 1, 1, c] and ``perturb``."""
    kw = dict(generator=generator, device=device)
    draws = {
        "posterior_eps": torch.randn(latent_shape, **kw),
        "noise": torch.randn(latent_shape, **kw),
        "timesteps": torch.randint(0, noise_steps, (batch_size,), **kw),
        "drop_u": torch.rand(() if whole_batch_drop else (batch_size,), **kw),
    }
    if noise_offset > 0.0:
        draws["offset"] = torch.randn((batch_size, 1, 1, latent_shape[-1]), **kw)
    if input_perturbation > 0.0:
        draws["perturb"] = torch.randn(latent_shape, **kw)
    return draws


def _ema_update(ema_params, params, decay: float) -> None:
    if ema_params is None or decay == 1.0:
        return
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)


def _apply_gradients(state: TrainState, loss: torch.Tensor, ema_decay: float) -> torch.Tensor:
    """Backward from ``loss``, hand the gradients to ``state.optimizer.step``,
    move the EMA when that applied an update, count the micro step -> the
    gradients' global norm."""
    for p in state.params:
        p.grad = None
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
    applied, grad_norm = state.optimizer.step(grads)
    for p in state.params:
        p.grad = None
    with torch.no_grad():
        # the EMA moves only when the optimizer applied an update
        _ema_update(state.ema_params, state.params, ema_decay if applied else 1.0)
    state.step += 1
    return grad_norm


def make_unet_train_step(
    unet: torch.nn.Module,
    text_encoder: torch.nn.Module,
    vae,
    schedule: DiffusionSchedule,
    compute_dtype: torch.dtype = torch.float32,
    guidance_scale: float = 7.5,
    train_with_cfg: bool = False,
    reference_cfg_formula: bool = False,
    cfg_dropout_prob: float = 0.1,
    whole_batch_cfg_dropout: bool = False,
    ema_decay: float = 0.0,
    noise_offset: float = 0.0,
    input_perturbation: float = 0.0,
) -> Tuple[Callable, Callable]:
    """Build (train_step, eval_step) for latent-diffusion training.

    train_step(state, batch, uncond_ids, draws) -> {"loss", "grad_norm"}
    eval_step(batch, uncond_ids, draws) -> loss

    ``train_step`` hands the gradients to ``state.optimizer.step`` and moves
    the EMA when that applied an update.

    ``batch``: {"pixel_values": [B, H, W, 3] in [-1, 1], "input_ids": [B, S]}
    on the model's device; ``uncond_ids`` [S], the empty prompt's tokens;
    ``draws`` from :func:`sample_draws`. The target is the noise (epsilon);
    the loss is the f32 MSE. ``whole_batch_cfg_dropout`` swaps the whole batch
    for the empty prompt at once (the reference), otherwise each example is
    dropped on its own; ``train_with_cfg`` regresses the CFG-combined doubled
    forward at ``guidance_scale`` (the reference's quirk)."""
    device = next(unet.parameters()).device
    sched = sched_lib.schedule_on(schedule, device)
    pred_noise = make_pred_noise_fn(unet, guidance_scale if train_with_cfg else 1.0, reference_cfg_formula)
    autocast = device.type == "cuda" and compute_dtype != torch.float32

    @torch.no_grad()
    def prepare_inputs(batch, uncond_ids, draws):
        """Frozen encoders + q-sample -> (x_t, t, context, uncond_emb, noise)."""
        posterior = vae.encode(batch["pixel_values"])
        latents = posterior.sample(eps=draws["posterior_eps"])
        noise = draws["noise"].to(latents.dtype)
        if noise_offset > 0.0:
            noise = noise + noise_offset * draws["offset"].to(latents.dtype)
        t = draws["timesteps"]
        if input_perturbation > 0.0:
            noisy = noise + input_perturbation * draws["perturb"].to(latents.dtype)
            x_t = sched_lib.add_noise(sched, latents, noisy, t)
        else:
            x_t = sched_lib.add_noise(sched, latents, noise, t)

        input_ids = batch["input_ids"].long()
        uncond_batch = uncond_ids.long()[None].expand_as(input_ids)
        drop = draws["drop_u"] < cfg_dropout_prob
        if drop.dim():
            drop = drop[:, None]
        input_ids = torch.where(drop, uncond_batch, input_ids)
        context = text_encoder(input_ids)
        uncond_emb = text_encoder(uncond_batch) if train_with_cfg else None
        return x_t, t, context, uncond_emb, noise

    def loss_fn(batch, uncond_ids, draws):
        x_t, t, ctx, uncond_emb, noise = prepare_inputs(batch, uncond_ids, draws)
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            pred = pred_noise(x_t, t, ctx, uncond_emb)
        return torch.mean((pred.float() - noise.float()) ** 2)

    def train_step(state: TrainState, batch, uncond_ids, draws):
        loss = loss_fn(batch, uncond_ids, draws)
        grad_norm = _apply_gradients(state, loss, ema_decay)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(batch, uncond_ids, draws):
        return loss_fn(batch, uncond_ids, draws)

    return train_step, eval_step


def make_vae_train_step(
    vae: torch.nn.Module,
    compute_dtype: torch.dtype = torch.float32,
    kl_weight: float = 1.0,
    kl_per_example0: bool = False,
    ema_decay: float = 0.0,
) -> Tuple[Callable, Callable]:
    """Build (train_step, eval_step) for KL-VAE training.

    train_step(state, batch, eps) -> {"loss", "grad_norm", "recon_loss", "kl_loss"}
    eval_step(batch, eps) -> loss

    ``batch``: {"pixel_values": [B, H, W, 3] in [-1, 1]} on the VAE's device;
    ``eps``: the posterior noise, [B, H/f, W/f, latent_channels]. The loss is
    the f32 MSE(img, recon) + ``kl_weight`` * KL, the KL the batch mean of the
    per-example sums, or example 0's under ``kl_per_example0`` (the
    reference's bug, ``CompatConfig.kl_per_example0``)."""
    device = next(vae.parameters()).device
    autocast = device.type == "cuda" and compute_dtype != torch.float32

    def loss_fn(batch, eps):
        img = batch["pixel_values"]
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            recon, posterior = vae(img, eps=eps)
        recon_loss = torch.mean((img.float() - recon.float()) ** 2)
        kl = posterior.kl()
        kl_loss = kl[0] if kl_per_example0 else kl.mean()
        return recon_loss + kl_weight * kl_loss, recon_loss, kl_loss

    def train_step(state: TrainState, batch, eps):
        loss, recon_loss, kl_loss = loss_fn(batch, eps)
        grad_norm = _apply_gradients(state, loss, ema_decay)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "recon_loss": recon_loss.detach(),
                "kl_loss": kl_loss.detach()}

    @torch.no_grad()
    def eval_step(batch, eps):
        return loss_fn(batch, eps)[0]

    return train_step, eval_step
