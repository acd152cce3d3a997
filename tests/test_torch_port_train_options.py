"""The trainers' options, port vs the JAX package, at a tiny size on the CPU (f32).

- One jitted JAX UNet train step of one configuration: v-prediction, Min-SNR
  5, the gradient-noise-scale split, the CFG-combined doubled forward and
  per-example prompt dropout at 0.5, offset noise, on a latent-cache batch
  (posterior ``moments`` and cached ``context_emb``, the cached empty-prompt
  embedding broadcast in the uncond slot), through a stand-in UNet (a channel
  mix, a time embedding and a context gate: the tiny UNet's two half-batch
  passes took 36 s to trace and compile, and its gradients are held in
  ``test_torch_port_train_step.py``). It compiles once for the module; its
  optimizer keeps the step's gradients. The port's step gets the same
  weights, batch and draws (the step key split in two, each half's key seven
  ways, as the JAX step splits them). Bars of ``test_torch_port_train_step.py``:
  loss 1e-5 relative; gradients per leaf within 1e-4 of the leaf's largest
  (+1e-7); the estimator's halves S and G^2 within 1e-4 of
  2 B_small |g_small|^2, the size of the terms whose difference they are.
- ``snr_at`` and ``min_snr_weight`` at every t, both prediction types, on the
  default and the zero-terminal-SNR schedules: 1e-6 relative.
- One jitted JAX VAE step with the gradient-noise-scale split on uint8 rows
  (on-device preprocessing: the center crop, the random flip), through a
  stand-in VAE (per-pixel moments, a posterior sample, a per-pixel decode;
  the VAE's gradients are held in ``test_torch_port_vae_train.py``): loss,
  S, G^2 and gradients at the same bars.
- The gradient-noise-scale and loss-spike recurrences against the JAX
  trainer's arithmetic (``trainers/trainer.py:585-625``), on a fixed loss
  sequence with a spike after step 10: exact.
- ``--no-fused-adamw`` (``ChainAdamW``) against ``optax.chain(
  clip_by_global_norm, adamw)`` under ``optax.MultiSteps``: 1e-6 absolute;
  against the port's fused ``AdamW`` on the same gradients, f32 moments:
  within 1e-3 of the learning rate beyond 2^-22 of the parameter (rounding
  only).
- The repairs: zero-terminal SNR with the epsilon objective raises JAX's
  ``ValueError``; ``--use-pallas-attention`` is accepted and changes nothing;
  ``--steps-per-dispatch 2`` trains (chained dispatch, ``trainers/chain.py``).
- The training CLIs with every new option on, in this process (jax not used
  by the port): the metrics stream, the cache, the logged images (also the
  textual-inversion and ControlNet trainers'), the crash report.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import flax.linen as flax_nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models import blocks as jax_blocks  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import args as jax_args  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import optim as jax_optim  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import steps as jax_steps  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig, load_config  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import schedule as port_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.blocks import GaussianDistribution  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.scripts import train_autoencoder, train_unet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import args as port_args  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import optim as port_optim  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import trainer as trainer_mod  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState, make_unet_train_step  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.steps import make_vae_train_step  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.trainer import GradNoiseScale, LossSpikes  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.latent_cache import LatentCacheDataset  # noqa: E402
from test_torch_port_train_step import OPTIM, _KeepGrads, random_params  # noqa: E402
from test_torch_port_vae_train import _Record  # noqa: E402

torch.set_num_threads(2)

STEP_KW = dict(cfg_dropout_prob=0.5, train_with_cfg=True, noise_offset=0.1, prediction_type="v_prediction",
               snr_gamma=5.0)
BATCH = 4  # halves of 2
LATENT = (BATCH // 2, 8, 8, 4)


def _grads_close(names, got, ref):
    for name, g in zip(names, got):
        want = ref[name]
        err = (g - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-7, (name, err, want.abs().max().item())


def _gns_close(metrics, jm):
    """S and G^2 within 1e-4 of 2 B_small |g_small|^2 (|g_small|^2 = S / B_small + G^2)."""
    half = BATCH // 2
    scale = 2 * half * abs(float(jm["gns_s"]) / half + float(jm["gns_g2"]))
    for k in ("gns_s", "gns_g2"):
        assert abs(metrics[k].item() - float(jm[k])) <= 1e-4 * scale, (k, metrics[k].item(), float(jm[k]), scale)


class StandInUNet(flax_nn.Module):
    """A stand-in UNet (the JAX ``UNetModel`` call form): a channel mix of x,
    a time embedding and a context gate, so that the loss depends on x, t and
    the context and every weight gets a gradient. It traces and compiles in a
    fraction of the tiny UNet's time; the UNet's own gradients are held in
    ``test_torch_port_train_step.py``."""

    @flax_nn.compact
    def __call__(self, x, t, ctx):
        h = flax_nn.Dense(4, name="mix")(x)
        temb = jnp.sin(t.astype(jnp.float32)[:, None] * 0.01 * (1.0 + jnp.arange(4, dtype=jnp.float32)))
        h = h + flax_nn.Dense(4, name="time")(temb)[:, None, None, :]
        gate = flax_nn.Dense(4, name="ctx")(jnp.mean(ctx, axis=1))
        return h * (1.0 + gate[:, None, None, :])


class PortStandIn(torch.nn.Module):
    """The port's counterpart of :class:`StandInUNet`, on its weights."""

    def __init__(self, params):
        super().__init__()
        self.mix, self.time, self.ctx = (_linear(params["params"][n]) for n in ("mix", "time", "ctx"))

    def forward(self, x, t, ctx):
        h = self.mix(x)
        temb = torch.sin(t.float()[:, None] * 0.01 * (1.0 + torch.arange(4, dtype=torch.float32)))
        h = h + self.time(temb)[:, None, None, :]
        gate = self.ctx(ctx.mean(dim=1))
        return h * (1.0 + gate[:, None, None, :])


def cache_batch(seed):
    rng = np.random.default_rng(seed)
    batch = {"moments": rng.standard_normal((BATCH, 8, 8, 8)).astype(np.float32),
             "input_ids": rng.integers(0, 49408, (BATCH, 77)).astype(np.int32),
             "context_emb": rng.standard_normal((BATCH, 77, 16)).astype(np.float32)}
    batch["moments"][..., 4:] = -1.0 + 0.3 * batch["moments"][..., 4:]  # log-variances around -1
    return batch, rng.standard_normal((77, 16)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_unet_run():
    """One jitted JAX train step (STEP_KW + the GNS split) of the stand-in on
    cache batch 5 with key 9 -> (batch, uncond, each half's draws, params,
    state after, metrics)."""
    module = StandInUNet()
    params = random_params(module, 3, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 16)))
    sched = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
    tx = _KeepGrads(jax_optim.build_optimizer(jax_args.OptimConfig(**OPTIM), max_train_steps=10))
    train_step, _ = jax_steps.make_unet_train_step(module, None, None, sched, tx, grad_noise_scale=True, **STEP_KW)
    batch, uncond = cache_batch(5)
    key = jax.random.PRNGKey(9)
    state, metrics, draws = jax.jit(lambda *a: (*train_step(*a), _half_draws(a[-1])))(
        jax_steps.TrainState.create(params, tx), None, None, {k: jnp.asarray(a) for k, a in batch.items()},
        jnp.asarray(uncond), key)
    return batch, uncond, draws, params, state, metrics


def _half_draws(key):
    """``test_torch_port_train_step.py:jax_draws`` of each half batch, as the
    JAX GNS step takes them from its key (traced into the step's own jit)."""
    out = []
    for half in jax.random.split(key):
        k_sample, k_noise, k_t, k_drop, _, k_off, k_ip = jax.random.split(half, 7)
        out.append({"posterior_eps": jax.random.normal(k_sample, LATENT, jnp.float32),
                    "noise": jax.random.normal(k_noise, LATENT, jnp.float32),
                    "timesteps": jax.random.randint(k_t, (BATCH // 2,), 0, 1000),
                    "drop_u": jax.random.uniform(k_drop, (BATCH // 2, 1))[:, 0],
                    "offset": jax.random.normal(k_off, (BATCH // 2, 1, 1, LATENT[-1]), jnp.float32),
                    "perturb": jax.random.normal(k_ip, LATENT, jnp.float32)})
    return out


@functools.lru_cache(maxsize=None)
def port_unet_run():
    """The port's step on the same weights, batch and draws -> (state with the kept gradients, metrics)."""
    batch, uncond, jdraws, params, _, _ = jax_unet_run()
    unet = PortStandIn(params)
    train, _ = make_unet_train_step(unet, None, None, port_schedule.make_schedule(DDPMConfig()),
                                    grad_noise_scale=True, **STEP_KW)
    state = TrainState(unet, _Record())
    draws = [{k: torch.from_numpy(np.array(v)) for k, v in d.items()} for d in jdraws]
    metrics = train(state, {k: torch.from_numpy(a) for k, a in batch.items()}, torch.from_numpy(uncond), draws)
    return state, metrics


def test_v_prediction_min_snr_gns_step_loss_and_estimator_match_jax():
    *_, jm = jax_unet_run()
    _, metrics = port_unet_run()
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    _gns_close(metrics, jm)


def test_v_prediction_min_snr_gns_step_gradients_match_jax():
    *_, jstate, _ = jax_unet_run()
    state, _ = port_unet_run()
    want = _linear_grads(jstate.opt_state[1], ("mix", "time", "ctx"))
    assert sorted(want) == sorted(state.names)
    _grads_close(state.names, state.optimizer.grads, want)


@pytest.mark.parametrize("zero_terminal_snr", [False, True], ids=["default", "zero_terminal_snr"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_snr_and_min_snr_weight_match_jax(prediction_type, zero_terminal_snr):
    jsched = jax_schedule.make_schedule(jax_schedule.DDPMConfig(zero_terminal_snr=zero_terminal_snr))
    # the JAX table, so that the functions alone are compared (the tables' own
    # parity, cumulative products in another order, is not this test's)
    psched = dataclasses.replace(port_schedule.make_schedule(DDPMConfig(zero_terminal_snr=zero_terminal_snr)),
                                 alphas_cumprod=torch.from_numpy(np.array(jsched.alphas_cumprod)))
    t = np.arange(1000)
    np.testing.assert_allclose(port_schedule.snr_at(psched, torch.from_numpy(t)).numpy(),
                               np.asarray(jax_schedule.snr_at(jsched, jnp.asarray(t))), rtol=1e-6)
    got = port_schedule.min_snr_weight(psched, torch.from_numpy(t), 5.0, prediction_type).numpy()
    want = np.asarray(jax_schedule.min_snr_weight(jsched, jnp.asarray(t), 5.0, prediction_type))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    assert np.isfinite(got).all()


class StandInVAE(flax_nn.Module):
    """A stand-in VAE (the JAX ``AutoEncoderKL`` call form): per-pixel moments
    of the image, a posterior sample, a per-pixel decode, f = 1. It compiles
    in a fraction of the tiny VAE's time; the VAE's own gradients are held in
    ``test_torch_port_vae_train.py``."""

    @flax_nn.compact
    def __call__(self, img, sample_key=None):
        posterior = jax_vae.AutoEncoderKLOutput(
            latent_dist=jax_blocks.GaussianDistribution.from_moments(flax_nn.Dense(8, name="enc")(img)))
        z = posterior.latent_dist.sample(sample_key)
        return flax_nn.Dense(3, name="dec")(jnp.tanh(z)), posterior


class PortStandInVAE(torch.nn.Module):
    """The port's counterpart of :class:`StandInVAE`, on its weights."""

    def __init__(self, params):
        super().__init__()
        self.enc, self.dec = (_linear(params["params"][n]) for n in ("enc", "dec"))

    def forward(self, img, eps=None):
        posterior = GaussianDistribution.from_moments(self.enc(img))
        return self.dec(torch.tanh(posterior.sample(eps=eps))), posterior


def _linear(p):
    kernel = np.array(p["kernel"])
    layer = torch.nn.Linear(*kernel.shape)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(kernel.T))
        layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    return layer


def _linear_grads(tree, names):
    """A JAX Dense gradient tree -> {"<name>.weight", "<name>.bias"} in torch's orientation."""
    p = tree["params"]
    return {f"{n}.{k}": torch.from_numpy(np.array(p[n][kk]).T.copy() if kk == "kernel" else np.array(p[n][kk]))
            for n in names for k, kk in (("weight", "kernel"), ("bias", "bias"))}


RAW = (BATCH, 8, 12, 3)  # uint8 rows, center-cropped to 8x8 in the step
KL_WEIGHT = 0.5


@functools.lru_cache(maxsize=None)
def jax_vae_run():
    """One jitted JAX VAE train step (the stand-in) with the GNS split on
    uint8 rows, random flip, key 11 -> (params, rows, each half's (flips,
    posterior noise), state after, metrics)."""
    module = StandInVAE()
    params = random_params(module, 1, jnp.zeros((1, 8, 8, 3)), jax.random.PRNGKey(0))
    tx = _KeepGrads(jax_optim.build_optimizer(jax_args.OptimConfig(**OPTIM), max_train_steps=10))
    train_step, _ = jax_steps.make_vae_train_step(module, tx, kl_weight=KL_WEIGHT, random_flip=True,
                                                  grad_noise_scale=True)
    raw = np.random.default_rng(4).integers(0, 256, RAW).astype(np.uint8)

    def draws(key):
        """Each half's flips and posterior noise, as the GNS step splits its key."""
        out = []
        for k in jax.random.split(key):
            k, k_pre = jax.random.split(k)
            out.append((jax.random.bernoulli(k_pre, 0.5, (BATCH // 2, 1, 1, 1)).reshape(-1),
                        jax.random.normal(k, (BATCH // 2, 8, 8, 4), jnp.float32)))
        return out

    state, metrics, halves = jax.jit(lambda *a: (*train_step(*a), draws(a[-1])))(
        jax_steps.TrainState.create(params, tx), {"raw_images": jnp.asarray(raw)}, jax.random.PRNGKey(11))
    return params, raw, halves, state, metrics


def test_vae_gns_step_on_device_preprocessed_rows_matches_jax():
    params, raw, halves, jstate, jm = jax_vae_run()
    flips = [torch.from_numpy(np.array(f)) for f, _ in halves]
    eps = [torch.from_numpy(np.array(e)) for _, e in halves]
    assert any(f.any() for f in flips) and not all(f.all() for f in flips)
    vae = PortStandInVAE(params)
    train, _ = make_vae_train_step(vae, kl_weight=KL_WEIGHT, grad_noise_scale=True, random_flip=True)
    state = TrainState(vae, _Record())
    metrics = train(state, {"raw_images": torch.from_numpy(raw)}, eps, flips)
    assert sorted(metrics) == ["gns_g2", "gns_s", "grad_norm", "loss"]  # no loss parts on this path, as in JAX
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-5)
    _gns_close(metrics, jm)
    want = _linear_grads(jstate.opt_state[1], ("enc", "dec"))
    assert sorted(want) == sorted(state.names)
    _grads_close(state.names, state.optimizer.grads, want)


def _jax_recurrences(losses, gns_pairs, spike_thr):
    """The JAX trainer's lines (trainers/trainer.py:585-625), per optimizer step."""
    gns_s_ema, gns_g2_ema, gns_count = 0.0, 0.0, 0
    loss_mean, loss_var, spike_count = None, 0.0, 0
    out = []
    for global_step, (loss_val, (s, g2)) in enumerate(zip(losses, gns_pairs), start=1):
        record = {}
        d = 0.95
        gns_count += 1
        gns_s_ema = d * gns_s_ema + (1 - d) * s
        gns_g2_ema = d * gns_g2_ema + (1 - d) * g2
        if gns_count >= 5 and gns_g2_ema > 0:
            record["grad_noise_scale"] = gns_s_ema / gns_g2_ema
        if loss_mean is not None and global_step > 10 and loss_var > 0 and loss_val > loss_mean + spike_thr * (
                loss_var ** 0.5):
            spike_count += 1
            record["loss_spike"] = spike_count
        if loss_mean is None:
            loss_mean = loss_val
        else:
            dm = 0.98
            delta = loss_val - loss_mean
            loss_mean += (1 - dm) * delta
            loss_var = dm * (loss_var + (1 - dm) * delta * delta)
        out.append(record)
    return out


def test_gns_and_spike_recurrences_match_jax_arithmetic():
    rng = np.random.default_rng(2)
    losses = list(0.1 + 0.01 * rng.standard_normal(30))
    losses[3] = 0.5  # before step 10: no spike
    losses[14] = 0.4  # step 15: a spike
    losses[15] = 0.45  # step 16: another
    gns_pairs = [(float(s), float(g)) for s, g in zip(rng.uniform(-1, 4, 30), rng.uniform(-0.2, 1, 30))]
    want = _jax_recurrences(losses, gns_pairs, 3.0)
    gns, spikes = GradNoiseScale(), LossSpikes(3.0)
    got = []
    for step, (loss, (s, g2)) in enumerate(zip(losses, gns_pairs), start=1):
        record = {}
        b = gns.update(s, g2)
        if b is not None:
            record["grad_noise_scale"] = b
        spike = spikes.update(step, loss)
        if spike is not None:
            record["loss_spike"] = spike
        got.append(record)
    assert got == want
    assert [r.get("loss_spike") for r in got if "loss_spike" in r] == [1, 2]
    assert "grad_noise_scale" not in got[3] and "grad_noise_scale" in got[4]


@pytest.mark.parametrize("accum,mu_dtype", [(1, "f32"), (2, "f32"), (2, "bf16")],
                         ids=["plain", "accumulate2", "accumulate2_bf16_mu"])
def test_no_fused_adamw_matches_the_optax_chain_under_multisteps(accum, mu_dtype):
    """Four micro steps on a small tree, the clip active (global norm above 0.5),
    ``--accum-dtype bf16`` given and ignored: 1e-6 absolute."""
    rng = np.random.default_rng(accum)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32), "b": rng.standard_normal(11).astype(np.float32)}
    grads = [{k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()} for _ in range(4)]
    cfg = dict(learning_rate=1e-2, adam_weight_decay=0.1, max_grad_norm=0.5, scheduler_type="linear",
               lr_warmup_steps=1, no_fused_adamw=True, adam_mu_dtype=mu_dtype, accum_dtype="bf16")
    tx = jax_optim.build_optimizer(jax_args.OptimConfig(**cfg), max_train_steps=10,
                                   gradient_accumulation_steps=accum)
    assert isinstance(tx, optax.MultiSteps) == (accum > 1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)

    @jax.jit
    def jax_step(g, st, jp):
        updates, st = tx.update(g, st, jp)
        return optax.apply_updates(jp, updates), st

    ours = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = port_optim.build_optimizer(ours, port_args.OptimConfig(**cfg), max_train_steps=10,
                                     gradient_accumulation_steps=accum)
    assert isinstance(opt, port_optim.ChainAdamW) and opt.layout()["no_fused_adamw"]
    assert opt.acc is None or opt.acc[0].dtype == torch.float32
    for g in grads:
        jp, st = jax_step({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
    for k, got in zip(("a", "b"), ours):
        np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert opt.count == 4 // accum
    if mu_dtype == "bf16":
        assert opt.mu[0].dtype == torch.bfloat16 and opt.nu[0].dtype == torch.float32
        return  # the JAX package's two paths round b1 * mu apart there (trainers/optim.py:ChainAdamW)
    # the fused AdamW on the same gradients: rounding apart
    fused_params = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    fused = port_optim.build_optimizer(fused_params, port_args.OptimConfig(**{**cfg, "no_fused_adamw": False,
                                                                                "accum_dtype": "f32"}),
                                       max_train_steps=10, gradient_accumulation_steps=accum)
    assert type(fused) is port_optim.AdamW
    for g in grads:
        fused.step([torch.from_numpy(g[k]) for k in ("a", "b")])
    for a, b in zip(ours, fused_params):
        assert ((a - b).abs() - 2.0 ** -22 * b.abs()).max().item() <= 1e-3 * cfg["learning_rate"]


def test_no_fused_adamw_refuses_bf16_nu_and_a_fused_checkpoint():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="--adam-nu-dtype bf16 requires the fused AdamW path"):
        port_optim.build_optimizer(p, port_args.OptimConfig(no_fused_adamw=True, adam_nu_dtype="bf16"), 10)
    fused = port_optim.build_optimizer(p, port_args.OptimConfig(), 10)
    chain = port_optim.build_optimizer(p, port_args.OptimConfig(no_fused_adamw=True), 10)
    with pytest.raises(ValueError, match=r"--no-fused-adamw \(checkpoint: False, this run: True\)"):
        chain.load_state_dict(fused.state_dict())
    with pytest.raises(ValueError, match=r"--no-fused-adamw \(checkpoint: True, this run: False\)"):
        fused.load_state_dict(chain.state_dict())
    legacy = fused.state_dict()
    legacy.pop("layout")  # a checkpoint written before layouts were recorded: the fused path
    fused.load_state_dict(legacy)


TINY = (
    "--device cpu --dataset synthetic --resolution 32 --train-batch-size 2 --eval-batch-size 2 "
    "--max-train-samples 8 --max-val-samples 2 --dataloader-num-workers 0 --lr-warmup-steps 0 "
    "--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 --autoencoder-channels-list 16,32 --groups 8"
).split()


def test_zero_terminal_snr_with_epsilon_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=r"--zero-terminal-snr trains a timestep with SNR 0, where the eps "
                                         r"objective is degenerate \(the target IS the input\); use "
                                         r"--prediction-type v_prediction"):
        train_unet.main([*TINY, "--max-train-steps", "1", "--ckpt-dir", "ckpt", "--zero-terminal-snr"])


def test_use_pallas_attention_flag_is_accepted_and_changes_nothing():
    _, cfg = load_config(["--use-pallas-attention"])
    assert cfg.parallel.use_pallas_attention is False
    # as the JAX package, which declares the field and never reads it: the
    # entry point's flag check takes it
    got, _ = train_unet.parse_training_flags(["--use-pallas-attention", "--device", "cpu"], "t",
                                             trainer_mod.get_logger("t"))
    assert got.parallel.use_pallas_attention is False


@pytest.mark.parametrize("flags,item", [(["--steps-per-dispatch", "2"], None),
                                        (["--tensor-parallel", "2"], None)],
                         ids=["steps_per_dispatch", "tensor_parallel"])
def test_still_refused_options_name_their_item(tmp_path, monkeypatch, flags, item):
    """No option is refused any longer. Chained dispatch trains: two
    optimizer steps in one chunk (one dispatch). Tensor parallelism passes
    the flag check, and one process, which has no model group to split the
    weights over, raises naming the processes it needs."""
    monkeypatch.chdir(tmp_path)
    argv = [*TINY, "--max-train-steps", "2", "--gradient-accumulation-steps", "1", "--log-interval", "0",
            "--ckpt-dir", "ckpt", *flags]
    if flags[0] == "--steps-per-dispatch":
        trainer = train_unet.build_trainer(argv)
        chunks = []
        inner = trainer._dispatch
        trainer._dispatch = lambda window, micro0, steps: chunks.append(steps) or inner(window, micro0, steps)
        trainer.train()
        assert chunks == [2] and trainer.state.optimizer.count == 2
        assert len([r for r in _records("logs/train_unet_metrics.jsonl") if "train_loss" in r]) == 2
        return
    with pytest.raises(ValueError, match="--tensor-parallel 2 needs 2 processes"):
        train_unet.main(argv)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_unet_cli_runs_every_new_option(tmp_path, monkeypatch):
    """v-prediction on the zero-terminal-SNR schedule, Min-SNR, the GNS split,
    spike detection, the latent cache (built, then trained from), on-device
    preprocessing with flips, the unfused optimizer and ``--log-image`` (its
    sample in 2 steps here)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer_mod, "LOG_IMAGE_STEPS", 2)
    trainer = train_unet.main([
        *TINY, "--max-train-steps", "5", "--gradient-accumulation-steps", "1", "--log-interval", "5",
        "--checkpointing-steps", "5", "--ckpt-dir", "ckpt", "--zero-terminal-snr", "--prediction-type",
        "v_prediction", "--snr-gamma", "5", "--log-grad-noise-scale", "--spike-threshold", "3", "--log-image",
        "--latent-cache", "cache/latents.npz", "--device-preprocess", "--random-flip", "--no-fused-adamw"])
    cache = LatentCacheDataset("cache/latents.npz")
    assert cache.moments.shape == (8, 16, 16, 8) and cache.context_emb.shape == (8, 77, 768)
    assert cache.context_emb.dtype == np.float16 and cache.uncond_emb.shape == (77, 768)
    assert trainer.train_dataset.has_text_cache and trainer.uncond_train.shape == (77, 768)
    assert isinstance(trainer.state.optimizer, port_optim.ChainAdamW)
    records = _records("logs/train_unet_metrics.jsonl")
    train = [r for r in records if "train_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["train_loss"]) for r in train)
    assert ["grad_noise_scale" in r for r in train] == [False] * 4 + [True]
    assert not any("synthetic_fallback" in r for r in records)
    assert os.path.exists("output/unet_sample.png")
    ckpt = torch.load("ckpt/checkpoint-5/train_state.pt", map_location="cpu", weights_only=False)
    assert ckpt["opt_state"]["layout"]["no_fused_adamw"] is True


@pytest.mark.parametrize("kind", ["textual_inversion", "controlnet"])
def test_personalization_log_images(tmp_path, monkeypatch, kind):
    """``log_images`` of the textual-inversion trainer (its placeholder's
    prompt) and of the ControlNet trainer (the first evaluation row's hint),
    at 16x16: a sample written under ``output/`` (2 steps here; the 50 of
    ``LOG_IMAGE_STEPS`` run on the card, ``chip_smoke.py`` phase 9d)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(trainer_mod, "LOG_IMAGE_STEPS", 2)
    flags = [*TINY, "--resolution", "16", "--max-train-steps", "1", "--ckpt-dir", "ckpt", "--log-image"]
    if kind == "textual_inversion":
        from stable_diffusion_pytorch_tpu_torch.scripts.train_textual_inversion import build_trainer

        flags += ["--placeholder-token", "<c>", "--num-vectors", "2", "--initializer-token", "toy"]
        name = "ti_sample"
    else:
        from stable_diffusion_pytorch_tpu_torch.scripts.train_controlnet import build_trainer

        name = "controlnet_sample"
    image = build_trainer(flags).log_images(1)
    assert image.shape == (16, 16, 3) and image.dtype == np.uint8
    assert os.path.exists(f"output/{name}.png")


def test_vae_cli_gns_device_preprocess_log_image_and_crash_report(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    vae_flags = [*TINY, "--max-test-samples", "2", "--ckpt-dir", "ckpt", "--gradient-accumulation-steps", "1"]
    trainer = train_autoencoder.main([*vae_flags, "--max-train-steps", "5", "--log-interval", "4",
                                      "--log-grad-noise-scale", "--device-preprocess", "--random-flip",
                                      "--log-image"])
    assert trainer.random_flip and trainer.gns
    train = [r for r in _records("logs/train_autoencoder_metrics.jsonl") if "train_loss" in r]
    assert len(train) == 5 and "grad_noise_scale" in train[-1]
    assert os.path.exists("output/autoencoder.png")
    with pytest.raises(ValueError, match="--num-devices 4 does not match"):
        train_autoencoder.main([*vae_flags, "--num-devices", "4"])
    reports = os.listdir("logs/crashes")
    assert len(reports) == 1
    with open(os.path.join("logs/crashes", reports[0])) as f:
        report = json.load(f)
    assert report["host"] == 0 and report["fn"] == "_main"
    assert report["exception"].startswith("ValueError: --num-devices 4 does not match")
