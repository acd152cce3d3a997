"""The train and eval steps of the UNet, of the KL-VAE, of textual inversion and
of ControlNet (port of trainers/steps.py: ``make_unet_train_step``,
``make_vae_train_step``, ``make_textual_inversion_train_step``,
``make_controlnet_train_step``).

One UNet step: frozen VAE encode and posterior sample (or the latent cache's
moments sampled, or uint8 rows normalized on the device first), q-sample,
frozen CLIP encode with empty-prompt dropout (or the cached embeddings), the
UNet forward and backward, the f32 MSE to the noise or to v, optionally
weighted per example by Min-SNR, clip-by-global-norm and AdamW
(``trainers/optim.py``), and the EMA shadow update. Under the gradient noise
scale the backward runs once per half batch (:func:`_gns_grads`). The UNet
keeps f32 parameters; on a CUDA device with a bf16 compute dtype its forward
runs under ``torch.autocast`` (matmuls and convs in bf16, the counterpart of
Flax's ``dtype=bf16`` over ``param_dtype=f32``). The
attention and GroupNorm layers reach the kernels through their autograd
Functions (``ops/flash_attention.py``, ``ops/fused_groupnorm.py``), forward and
backward.

Every random draw of a step comes from :func:`sample_draws`: the posterior
noise, the diffusion noise, the timesteps, the dropout uniforms, the offset
noise, the input perturbation and the flips. ``jax.random`` cannot be reproduced, so a
parity test draws them in JAX (``steps.py`` splits the step key seven ways)
and hands them in.

One VAE step: the whole VAE (encode, posterior sample, decode) forward and
backward on trainable f32 parameters under the same autocast, the f32 MSE of
the reconstruction plus ``kl_weight`` times the KL, then the same optimizer
and EMA update. Its draws, the posterior noise and under on-device
preprocessing the flips, are handed in as ``eps`` and ``flip``.

The personalization steps. DreamBooth is the UNet step with
``prior_loss_weight`` (instance rows at the even indices, class rows at the
odd ones: ``mean(instance MSE) + w * mean(class MSE)``) and, for LoRA, a
``param_transform`` that forms the factored UNet weights from the frozen base
and the trainable factors (``models/lora.py:lora_weights``), put in place of
the UNet's parameters through the forward and the backward. Textual inversion
trains only ``{"ti": [K, 768]}``, injected where the placeholder's sentinel
ids stand in the prompt; its gradient reaches the vectors only through the
frozen UNet's cross-attention keys and values. ControlNet trains the control
branch, whose residuals the frozen UNet adds to its skips and bottleneck, and
drops each row's prompt on its own. The trainable tensors of LoRA and textual
inversion are not a module's parameters: :class:`Trainables` holds them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from stable_diffusion_pytorch_tpu_torch.models import schedule as sched_lib
from stable_diffusion_pytorch_tpu_torch.models.blocks import GaussianDistribution
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import make_pred_noise_fn
from stable_diffusion_pytorch_tpu_torch.models.lora import substituted
from stable_diffusion_pytorch_tpu_torch.models.schedule import DiffusionSchedule
from stable_diffusion_pytorch_tpu_torch.parallel.mesh import local_tensor
from stable_diffusion_pytorch_tpu_torch.trainers.optim import global_norm
from stable_diffusion_pytorch_tpu_torch.utils.preprocess import device_preprocess


class Trainables:
    """Named tensors that are not a module's parameters: LoRA factors
    (``<module>.lora_a`` [in, r], ``<module>.lora_b`` [r, out]) or the
    textual-inversion vectors (``{"ti": [K, 768]}``), each in the JAX
    package's orientation. The optimizer updates their transposes (``leaves``,
    f32, contiguous; a 1-D tensor is its own): dim 0 of a leaf is then the
    JAX minor axis, as it is for the port's module weights, so the int8
    optimizer's blocks along dim 0 (``ops/adam8bit_update.py``) are the JAX
    package's."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.names = list(tensors)
        with torch.no_grad():
            self.leaves = [t.detach().float().t().contiguous().requires_grad_(True) for t in tensors.values()]

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The named tensors in their own orientation, differentiable views of the leaves."""
        return {n: leaf.t() for n, leaf in zip(self.names, self.leaves)}


class TrainState:
    """The trainable parameters, the optimizer state, the micro-step count and
    the optional EMA shadow parameters.

    ``trainable`` is a module (its parameters that require grad: the UNet, the
    VAE, a ControlNet) or a :class:`Trainables`. ``params`` are what the
    optimizer updates (a :class:`Trainables`' transposed leaves);
    ``state_dict`` keys them by name in the checkpoint layout, a
    :class:`Trainables`' in their own orientation. Under FSDP the parameters
    are DTensors, under tensor parallelism some are this rank's slices: the
    EMA shadows are laid out as the parameters, ``state_dict`` gathers both
    into whole tensors (every rank calls it), and ``load_state_dict`` cuts
    whole tensors into this rank's pieces."""

    def __init__(self, trainable: Union[torch.nn.Module, Trainables], optimizer, with_ema: bool = False):
        self.step = 0
        if isinstance(trainable, Trainables):
            self.module, self.trainables = None, trainable
            self.names, self.params = list(trainable.names), trainable.leaves
        else:
            self.module, self.trainables = trainable, None
            self.names = [n for n, p in trainable.named_parameters() if p.requires_grad]
            self.params = [p for p in trainable.parameters() if p.requires_grad]
        self.optimizer = optimizer
        self._dp = getattr(optimizer, "dp", None)
        with torch.no_grad():
            self.ema_params = [local_tensor(p).detach().clone() for p in self.params] if with_ema else None

    def defer_gradient_sync(self) -> bool:
        """Under FSDP with gradient accumulation, turn FSDP's reduce-scatter
        off for the backward of every micro step but a window's last, so the
        data group reduces once per optimizer step (FSDP sums the window's
        micro gradients, unsharded, until then) -> whether it is off."""
        if self.module is None or self._dp is None or not (self._dp.fsdp and self._dp.active):
            return False
        defer = not self.optimizer.applies_next()
        self.module.set_requires_gradient_sync(not defer)
        return defer

    def local_params(self) -> List[torch.Tensor]:
        """Each parameter's storage on this rank (a DTensor's local shard)."""
        return [local_tensor(p) for p in self.params]

    def _whole(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        if self._dp is None:
            return tensors
        return [self._dp.gather_param(i, t) for i, t in enumerate(tensors)]

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The trainable tensors by name, as the model takes them."""
        if self.trainables is not None:
            return self.trainables.tensors()
        return dict(zip(self.names, self.params))

    def _saved(self, tensors: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.trainables is None:
            return dict(zip(self.names, tensors))
        return {n: t.detach().t().contiguous() for n, t in zip(self.names, tensors)}

    def state_dict(self) -> Dict:
        return {
            "step": self.step,
            "params": self._saved(self._whole(self.local_params())),
            "opt_state": self.optimizer.state_dict(),
            "ema_params": None if self.ema_params is None else self._saved(self._whole(self.ema_params)),
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if (state["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint EMA parameters do not match this run's --ema-decay")
        if sorted(state["params"]) != sorted(self.names):
            raise ValueError("checkpoint parameters do not match this run's trainable tensors")

        def put(i: int, dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
            src = src if self.trainables is None else src.t()
            if self._dp is not None:
                src = self._dp.shard_param(i, src)
            if src.shape != dst.shape:
                raise ValueError(f"checkpoint tensor {name!r} is {tuple(src.shape)}, this run's {tuple(dst.shape)}")
            dst.copy_(src)

        self.step = int(state["step"])
        local = self.local_params()
        for i, name in enumerate(self.names):
            put(i, local[i], state["params"][name], name)
            if self.ema_params is not None:
                put(i, self.ema_params[i], state["ema_params"][name], name)
        if self._dp is not None:
            self._dp.take_params()
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
    random_flip: bool = False,
) -> Dict[str, torch.Tensor]:
    """Every random draw of one step, f32 (timesteps int64) on ``device``:
    ``posterior_eps`` and ``noise`` [B, h, w, c], ``timesteps`` [B] in
    [0, noise_steps), ``drop_u`` uniforms ([B], or [] for whole-batch
    dropout), and when enabled ``offset`` [B, 1, 1, c], ``perturb`` and
    ``flip`` [B] bool (the on-device preprocessing's flips, p = 0.5)."""
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
    if random_flip:
        draws["flip"] = torch.rand((batch_size,), **kw) < 0.5
    return draws


def batch_rows(batch: Dict[str, torch.Tensor]) -> int:
    return next(iter(batch.values())).shape[0]


def split_batch(batch: Dict[str, torch.Tensor]):
    """The two halves of a batch along dim 0 (the first ``B // 2`` rows, the rest)."""
    half = batch_rows(batch) // 2
    return {k: v[:half] for k, v in batch.items()}, {k: v[half:] for k, v in batch.items()}


def take_rows(draws, start: int, stop: int):
    """Rows ``[start, stop)`` of every draw with a batch dim (a 0-d draw,
    whole-batch dropout's uniform, is kept whole)."""
    return {k: (v if v.dim() == 0 else v[start:stop]) for k, v in draws.items()}


def half_spans(rows: int, rank: int, world: int):
    """The gradient-noise-scale halves of a global batch of ``rows * world``
    rows, rank ``r`` holding global rows ``[r * rows, (r + 1) * rows)``:
    -> ((start, stop) of this rank's rows inside half 1, and inside half 2),
    each in that half's own row numbering (half 1 is the first
    ``rows * world // 2`` global rows, as the JAX package splits the batch)."""
    total = rows * world
    h1 = total // 2
    lo, hi = rank * rows, (rank + 1) * rows
    return (min(lo, h1), min(hi, h1)), (max(lo, h1) - h1, max(hi, h1) - h1)


def _ema_update(ema_params, params, decay: float) -> None:
    if ema_params is None or decay == 1.0:
        return
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)


def _backward(state: TrainState, loss: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """Backward from ``loss`` -> the gradient of each of ``state.params``
    (zeros where none reached it), or None where FSDP keeps the micro step's
    gradients unreduced (:meth:`TrainState.defer_gradient_sync`)."""
    for p in state.params:
        p.grad = None
    deferred = state.defer_gradient_sync()
    loss.backward()
    if deferred:
        return None
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
    for p in state.params:
        p.grad = None
    return grads


def _apply(state: TrainState, grads: List[torch.Tensor], ema_decay: float) -> torch.Tensor:
    """Hand ``grads`` to ``state.optimizer.step``, move the EMA when that
    applied an update, count the micro step -> the gradients' global norm."""
    applied, grad_norm = state.optimizer.step(grads)
    with torch.no_grad():
        # the EMA moves only when the optimizer applied an update
        _ema_update(state.ema_params, state.local_params(), ema_decay if applied else 1.0)
    state.step += 1
    return grad_norm


def _apply_gradients(state: TrainState, loss: torch.Tensor, ema_decay: float) -> torch.Tensor:
    return _apply(state, _backward(state, loss), ema_decay)


def _mse(pred: torch.Tensor, target: torch.Tensor, prior_loss_weight: float = 0.0,
         weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The f32 MSE. With per-example weights ``weight`` [B] (Min-SNR) or
    ``prior_loss_weight`` > 0 the loss is taken over the per-example MSEs:
    each times its weight, then their mean, or with the prior term
    ``mean(even rows) + w * mean(odd rows)`` (instance rows, class rows)."""
    sq = (pred.float() - target.float()) ** 2
    if weight is None and prior_loss_weight <= 0.0:
        return sq.mean()
    per_example = sq.reshape(sq.shape[0], -1).mean(dim=1)
    if weight is not None:
        per_example = weight * per_example
    if prior_loss_weight > 0.0:
        return per_example[0::2].mean() + prior_loss_weight * per_example[1::2].mean()
    return per_example.mean()


def _gns_grads(grad_fn: Callable, batch: Dict[str, torch.Tensor], draws: Sequence, dp=None):
    """The gradient-noise-scale split (McCandlish et al. 2018): the gradient
    of each half of the batch, ``grad_fn(half, its draws) -> (loss, grads)``
    with ``draws`` one per half, averaged into the full batch's; with
    B_small = B // 2 and B_big = 2 B_small, the estimator's two halves
    S = 2 B_small (|g_small|^2 - |g_big|^2) and G^2 = 2 |g_big|^2 - |g_small|^2,
    |g_small|^2 the mean of the halves' squared norms. The trainer smooths
    both and reports S / G^2. -> (loss, grads, {"gns_s", "gns_g2"}).

    Over a data group (``dp``) the halves are those of the global batch
    (:func:`half_spans`; at world 2 half 1 is rank 0's rows): each rank takes
    the gradient of its rows in each half (``draws`` are its rows of each
    half's draws), the halves' gradients are all-reduced, and the loss and
    the gradient returned are the global batch's on every rank."""
    if dp is not None and dp.active:
        return _gns_grads_group(grad_fn, batch, draws, dp)
    b1, b2 = split_batch(batch)
    half = batch_rows(b1)
    l1, g1 = grad_fn(b1, draws[0])
    l2, g2 = grad_fn(b2, draws[1])
    small2 = (global_norm(g1) ** 2 + global_norm(g2) ** 2) * 0.5
    torch._foreach_add_(g1, g2)
    del g2
    torch._foreach_mul_(g1, 0.5)
    big2 = global_norm(g1) ** 2
    return (l1 + l2) * 0.5, g1, {"gns_s": 2.0 * half * (small2 - big2), "gns_g2": 2.0 * big2 - small2}


def _gns_grads_group(grad_fn: Callable, batch: Dict[str, torch.Tensor], draws: Sequence, dp):
    import torch.distributed as dist

    rows = batch_rows(batch)
    total = rows * dp.world
    sizes = (total // 2, total - total // 2)
    (s1, e1), _ = half_spans(rows, dp.rank, dp.world)
    n1 = e1 - s1
    parts = ({k: v[:n1] for k, v in batch.items()}, {k: v[n1:] for k, v in batch.items()})
    halves, loss = [None, None], None
    for k, (part, d, size) in enumerate(zip(parts, draws, sizes)):
        n = batch_rows(part)
        if n == 0:
            continue
        l, g = grad_fn(part, d)
        torch._foreach_mul_(g, n / size)  # this rank's share of the half's mean gradient
        halves[k] = g
        loss = l * (n / size) if loss is None else loss + l * (n / size)
    like = halves[0] if halves[0] is not None else halves[1]
    halves = [h if h is not None else [torch.zeros_like(t) for t in like] for h in halves]
    for h in halves:
        dp.all_reduce(h, mean=False)
    dist.all_reduce(loss, group=dp.group)
    small2 = (global_norm(halves[0]) ** 2 + global_norm(halves[1]) ** 2) * 0.5
    g = halves[0]
    torch._foreach_add_(g, halves[1])
    torch._foreach_mul_(g, 0.5)
    big2 = global_norm(g) ** 2
    return loss * 0.5, g, {"gns_s": 2.0 * sizes[0] * (small2 - big2), "gns_g2": 2.0 * big2 - small2}


def _latents_and_x_t(vae, sched, batch, draws):
    """Frozen VAE encode, posterior sample and q-sample -> (x_t, t, noise)."""
    latents = vae.encode(batch["pixel_values"]).sample(eps=draws["posterior_eps"])
    noise = draws["noise"].to(latents.dtype)
    t = draws["timesteps"]
    return sched_lib.add_noise(sched, latents, noise, t), t, noise


def _drop_prompts(input_ids: torch.Tensor, uncond_ids: torch.Tensor, drop_u: torch.Tensor, p: float):
    """Rows (or, for a 0-d ``drop_u``, the whole batch) whose uniform is below
    ``p`` take the empty prompt -> (token ids, the empty prompt's batch)."""
    input_ids = input_ids.long()
    uncond_batch = uncond_ids.long()[None].expand_as(input_ids)
    drop = drop_u < p
    if drop.dim():
        drop = drop[:, None]
    return torch.where(drop, uncond_batch, input_ids), uncond_batch


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
    param_transform: Optional[Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]] = None,
    prior_loss_weight: float = 0.0,
    prediction_type: str = "epsilon",
    snr_gamma: float = 0.0,
    grad_noise_scale: bool = False,
    random_flip: bool = False,
) -> Tuple[Callable, Callable]:
    """Build (train_step, eval_step) for latent-diffusion training.

    train_step(state, batch, uncond_ids, draws) -> {"loss", "grad_norm"}
    (and "gns_s", "gns_g2" under ``grad_noise_scale``)
    eval_step(batch, uncond_ids, draws, params=None) -> loss

    ``param_transform(trainable tensors) -> {UNet parameter name: tensor}``
    (LoRA: ``models/lora.py:lora_weights`` over the frozen base): the step
    runs the UNet with those tensors in place of its parameters, forward and
    backward, so the gradient lands on ``state.tensors()``; ``eval_step``
    then needs ``params``, the trainable tensors to evaluate.
    ``prior_loss_weight`` > 0 is DreamBooth's prior preservation: the batch
    interleaves instance rows (even) and class rows (odd), and the loss is
    ``mean(instance MSE) + w * mean(class MSE)``, in evaluation too.

    The objective: ``prediction_type`` "epsilon" regresses the noise,
    "v_prediction" the f32 v = alpha eps - sigma x0 (Salimans & Ho 2022);
    ``snr_gamma`` > 0 weighs each example's MSE by its Min-SNR-gamma weight
    (Hang et al. 2023), before the prior term splits the rows. The loss is
    f32. ``grad_noise_scale`` takes the gradient as the mean of the two
    half batches' (:func:`_gns_grads`); ``draws`` is then a pair, one
    :func:`sample_draws` for each half.

    ``train_step`` hands the gradients to ``state.optimizer.step`` and moves
    the EMA when that applied an update.

    ``batch`` on the model's device: "input_ids" [B, S] and the image as
    "pixel_values" [B, H, W, 3] in [-1, 1], "raw_images" [B, H, W, 3] uint8
    (normalized here, flipped where ``draws["flip"]`` is set under
    ``random_flip``), "moments" [B, h, w, 2c] (the latent cache's posterior,
    sampled with ``draws["posterior_eps"]``) or "latents"; with
    "context_emb" [B, S, D] (the cached text) CLIP does not run and
    ``uncond_ids`` is the cached empty prompt's embedding [S, D], else the
    empty prompt's tokens [S]. ``draws`` from :func:`sample_draws`.
    ``whole_batch_cfg_dropout`` swaps the whole batch for the empty prompt at
    once (the reference), otherwise each example is dropped on its own;
    ``train_with_cfg`` regresses the CFG-combined doubled forward at
    ``guidance_scale`` (the reference's quirk)."""
    device = next(unet.parameters()).device
    sched = sched_lib.schedule_on(schedule, device)
    pred_noise = make_pred_noise_fn(unet, guidance_scale if train_with_cfg else 1.0, reference_cfg_formula)
    autocast = device.type == "cuda" and compute_dtype != torch.float32

    @torch.no_grad()
    def encode_latents(batch, draws):
        if "moments" in batch:
            return GaussianDistribution.from_moments(batch["moments"]).sample(eps=draws["posterior_eps"])
        if "latents" in batch:
            return batch["latents"]
        if "raw_images" in batch:
            raw = batch["raw_images"]
            pixels = device_preprocess(raw, raw.shape[1], center_crop=True, random_flip=random_flip,
                                       flip=draws.get("flip"))
        else:
            pixels = batch["pixel_values"]
        return vae.encode(pixels).sample(eps=draws["posterior_eps"])

    @torch.no_grad()
    def prepare_inputs(batch, uncond_ids, draws):
        """Frozen encoders + q-sample -> (x_t, t, context, uncond_emb, noise, latents)."""
        latents = encode_latents(batch, draws)
        noise = draws["noise"].to(latents.dtype)
        if noise_offset > 0.0:
            noise = noise + noise_offset * draws["offset"].to(latents.dtype)
        t = draws["timesteps"]
        if input_perturbation > 0.0:
            noisy = noise + input_perturbation * draws["perturb"].to(latents.dtype)
            x_t = sched_lib.add_noise(sched, latents, noisy, t)
        else:
            x_t = sched_lib.add_noise(sched, latents, noise, t)

        if "context_emb" in batch:
            context = batch["context_emb"]
            uncond_batch = uncond_ids.to(context.dtype)[None].expand_as(context)
            drop = draws["drop_u"] < cfg_dropout_prob
            if drop.dim():
                drop = drop[:, None, None]
            context = torch.where(drop, uncond_batch, context)
            return x_t, t, context, uncond_batch if train_with_cfg else None, noise, latents
        input_ids, uncond_batch = _drop_prompts(batch["input_ids"], uncond_ids, draws["drop_u"], cfg_dropout_prob)
        context = text_encoder(input_ids)
        uncond_emb = text_encoder(uncond_batch) if train_with_cfg else None
        return x_t, t, context, uncond_emb, noise, latents

    def weights(params):
        """The UNet's parameters, or the transform's tensors in their place."""
        if param_transform is None:
            return contextlib.nullcontext()
        if params is None:
            raise ValueError("a step with param_transform evaluates given params: the trainable tensors")
        return substituted(unet, param_transform(params))

    def loss_fn(batch, uncond_ids, draws):
        x_t, t, ctx, uncond_emb, noise, latents = prepare_inputs(batch, uncond_ids, draws)
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            pred = pred_noise(x_t, t, ctx, uncond_emb)
        if prediction_type == "v_prediction":
            alpha, sigma_vp = (c.reshape(-1, 1, 1, 1).float() for c in sched_lib.alpha_sigma_at(sched, t))
            target = sched_lib.v_from_eps_x0(latents.float(), noise.float(), alpha, sigma_vp)
        else:
            target = noise
        weight = sched_lib.min_snr_weight(sched, t, snr_gamma, prediction_type) if snr_gamma > 0.0 else None
        return _mse(pred, target, prior_loss_weight, weight)

    def grad_fn(state, uncond_ids):
        def fn(batch, draws):
            with weights(state.tensors()):
                loss = loss_fn(batch, uncond_ids, draws)
                return loss.detach(), _backward(state, loss)

        return fn

    def train_step(state: TrainState, batch, uncond_ids, draws):
        if grad_noise_scale:
            loss, grads, extras = _gns_grads(grad_fn(state, uncond_ids), batch, draws,
                                             getattr(state.optimizer, "dp", None))
        else:
            (loss, grads), extras = grad_fn(state, uncond_ids)(batch, draws), {}
        grad_norm = _apply(state, grads, ema_decay)
        return {"loss": loss, "grad_norm": grad_norm, **extras}

    @torch.no_grad()
    def eval_step(batch, uncond_ids, draws, params=None):
        with weights(params):
            return loss_fn(batch, uncond_ids, draws)

    return train_step, eval_step


def make_textual_inversion_train_step(
    unet: torch.nn.Module,
    text_encoder: torch.nn.Module,
    vae,
    schedule: DiffusionSchedule,
    placeholder_ids: Sequence[int],
    compute_dtype: torch.dtype = torch.float32,
    ema_decay: float = 0.0,
) -> Tuple[Callable, Callable]:
    """Build (train_step, eval_step) for textual inversion (Gal et al. 2022).

    train_step(state, batch, draws) -> {"loss", "grad_norm"}
    eval_step(batch, draws, params) -> loss

    Everything is frozen but the state's ``{"ti": [K, D]}``, which the text
    encoder injects wherever ``placeholder_ids[j]`` stands in the prompt
    (``CLIPTextTransformer.forward(token_overrides=)``); the UNet regresses
    the noise under the run's autocast, the f32 MSE. No prompt dropout, so
    of ``draws`` only the posterior noise, the noise and the timesteps are
    used; ``params`` of ``eval_step`` is ``{"ti": ...}``."""
    device = next(unet.parameters()).device
    sched = sched_lib.schedule_on(schedule, device)
    pids = torch.as_tensor(list(placeholder_ids), dtype=torch.long, device=device)
    autocast = device.type == "cuda" and compute_dtype != torch.float32

    def loss_fn(params, batch, draws):
        with torch.no_grad():
            x_t, t, noise = _latents_and_x_t(vae, sched, batch, draws)
        context = text_encoder(batch["input_ids"].long(), token_overrides=(pids, params["ti"]))
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            eps = unet(x_t, t, context)
        return _mse(eps, noise)

    def train_step(state: TrainState, batch, draws):
        loss = loss_fn(state.tensors(), batch, draws)
        grad_norm = _apply_gradients(state, loss, ema_decay)
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(batch, draws, params):
        return loss_fn(params, batch, draws)

    return train_step, eval_step


def make_controlnet_train_step(
    unet: torch.nn.Module,
    controlnet: torch.nn.Module,
    text_encoder: torch.nn.Module,
    vae,
    schedule: DiffusionSchedule,
    compute_dtype: torch.dtype = torch.float32,
    cfg_dropout_prob: float = 0.5,
    ema_decay: float = 0.0,
) -> Tuple[Callable, Callable]:
    """Build (train_step, eval_step) for ControlNet training (Zhang et al. 2023).

    train_step(state, batch, uncond_ids, draws) -> {"loss", "grad_norm"}
    eval_step(batch, uncond_ids, draws) -> loss

    The UNet, VAE and text encoder are frozen; the state's module is the
    ControlNet, whose residuals of ``batch["hint"]`` [B, H, W, C] (pixel
    space, [-1, 1]) the UNet adds to its skips and bottleneck, under the
    run's autocast. Each row's prompt is dropped on its own when its uniform
    is below ``cfg_dropout_prob``; the loss is the f32 MSE to the noise."""
    device = next(unet.parameters()).device
    sched = sched_lib.schedule_on(schedule, device)
    autocast = device.type == "cuda" and compute_dtype != torch.float32

    def loss_fn(batch, uncond_ids, draws):
        with torch.no_grad():
            x_t, t, noise = _latents_and_x_t(vae, sched, batch, draws)
            input_ids, _ = _drop_prompts(batch["input_ids"], uncond_ids, draws["drop_u"], cfg_dropout_prob)
            context = text_encoder(input_ids)
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            control = controlnet(x_t, t, context, batch["hint"].to(x_t.dtype))
            eps = unet(x_t, t, context, control=control)
        return _mse(eps, noise)

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
    grad_noise_scale: bool = False,
    random_flip: bool = False,
) -> Tuple[Callable, Callable]:
    """Build (train_step, eval_step) for KL-VAE training.

    train_step(state, batch, eps, flip=None) -> {"loss", "grad_norm", "recon_loss", "kl_loss"}
    eval_step(batch, eps, flip=None) -> loss

    ``batch``: {"pixel_values": [B, H, W, 3] in [-1, 1]} or {"raw_images":
    [B, H, W, 3] uint8} (normalized here, row i flipped where ``flip[i]``
    under ``random_flip``) on the VAE's device; ``eps``: the posterior noise,
    [B, H/f, W/f, latent_channels]. The loss is the f32 MSE(img, recon) +
    ``kl_weight`` * KL, the KL the batch mean of the per-example sums, or
    example 0's under ``kl_per_example0`` (the reference's bug,
    ``CompatConfig.kl_per_example0``). Under ``grad_noise_scale`` the
    gradient is the mean of the half batches' (:func:`_gns_grads`): ``eps``
    and ``flip`` are then pairs, one for each half, and the metrics hold
    "gns_s" and "gns_g2" in place of the loss parts, as in the JAX package."""
    device = next(vae.parameters()).device
    autocast = device.type == "cuda" and compute_dtype != torch.float32

    def loss_fn(batch, eps, flip):
        if "raw_images" in batch:
            raw = batch["raw_images"]
            img = device_preprocess(raw, raw.shape[1], center_crop=True, random_flip=random_flip, flip=flip)
        else:
            img = batch["pixel_values"]
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            recon, posterior = vae(img, eps=eps)
        recon_loss = torch.mean((img.float() - recon.float()) ** 2)
        kl = posterior.kl()
        kl_loss = kl[0] if kl_per_example0 else kl.mean()
        return recon_loss + kl_weight * kl_loss, recon_loss, kl_loss

    def train_step(state: TrainState, batch, eps, flip=None):
        if grad_noise_scale:
            def grad_fn(half, draws):
                loss = loss_fn(half, *draws)[0]
                return loss.detach(), _backward(state, loss)

            flips = flip if flip is not None else (None, None)
            loss, grads, extras = _gns_grads(grad_fn, batch, list(zip(eps, flips)),
                                             getattr(state.optimizer, "dp", None))
        else:
            loss, recon_loss, kl_loss = loss_fn(batch, eps, flip)
            grads = _backward(state, loss)
            loss = loss.detach()
            extras = {"recon_loss": recon_loss.detach(), "kl_loss": kl_loss.detach()}
        grad_norm = _apply(state, grads, ema_decay)
        return {"loss": loss, "grad_norm": grad_norm, **extras}

    @torch.no_grad()
    def eval_step(batch, eps, flip=None):
        return loss_fn(batch, eps, flip)[0]

    return train_step, eval_step
