"""The UNet training step, port vs the JAX package, at a tiny size on the CPU (f32).

The JAX ``make_unet_train_step`` and the port's get the same weights (JAX
trees converted by ``utils/convert.py``), the same batch and the same random
draws: JAX's step key is split seven ways inside the step, and the test draws
the posterior noise, the noise, the timesteps, the dropout uniforms, the
offset noise and the input perturbation from those keys and hands them to the
port. One step configuration serves both step tests: the reference-compat
switches (the CFG-combined doubled forward, the reference's CFG formula,
whole-batch prompt dropout), offset noise, input perturbation and an EMA of
0.9 (the per-example dropout of the default step is held in
``test_torch_port_personalize.py``). One jitted JAX train step, whose
optimizer keeps each step's gradients in its state, runs two steps once for
the module; the tests read its losses, gradients, parameters and EMA.
Tolerances, f32 on both sides with sums in another order:

- loss: 1e-5 relative;
- gradients: per leaf, max-abs error within 1e-4 of the leaf's largest
  gradient (+1e-7), f32 through the UNet, VAE and CLIP;
- parameters and EMA after two AdamW steps (clip 0.1, weight decay 0.1,
  learning rate 1e-4): 1e-5 absolute, a tenth of one update. AdamW divides
  each gradient element by its own magnitude, so an element whose gradient is
  within the f32 gradient error of zero (about 1e-4 of its leaf's largest)
  may move by a different fraction of the learning rate on the two sides;
  the worst seen is 7e-6 (0.07 of an update). The optimizer alone is held to
  1e-6 below, on gradients away from zero.

Also the optimizer alone (``fused_adamw`` and ``fused_accumulate``), the five
learning-rate schedules, ``add_noise`` and ``GaussianDistribution``.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models import blocks as jax_blocks  # noqa: E402
from stable_diffusion_pytorch_tpu.models import clip as jax_clip  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import args as jax_args  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import fused_adamw as jax_fused  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import optim as jax_optim  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import steps as jax_steps  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, DDPMConfig, UnetConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.blocks import GaussianDistribution  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPTextTransformer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.schedule import add_noise, make_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import args as port_args  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import optim as port_optim  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState, make_unet_train_step  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)

# up-path concats 16+16, 16+8 and 8+8 with 4 groups: in 24 channels the group
# of channels 12-17 straddles the boundary at 16
UNET_KW = dict(num_res_blocks=1, n_heads=2, attention_resolutions=[2], channels_list=[8, 16],
               time_emb_dim=16, dropout=0.0, n_layers=1, context_dim=16)
VAE_KW = dict(in_channels=3, latent_channels=4, out_channels=3, autoencoder_channels_list=[8, 16],
              autoencoder_num_res_blocks=1, groups=4, kl_weight=1.0)
CLIP_KW = dict(d_model=16, n_layers=1, n_heads=2, intermediate=32, max_positions=77)
STEP_KW = dict(cfg_dropout_prob=0.5, train_with_cfg=True, reference_cfg_formula=True, whole_batch_cfg_dropout=True,
               noise_offset=0.1, input_perturbation=0.1, ema_decay=0.9)
OPTIM = dict(learning_rate=1e-4, adam_weight_decay=0.1, max_grad_norm=0.1, scheduler_type="linear",
             lr_warmup_steps=0)


def random_params(module, seed, *args):
    """Seeded random parameters of a flax module (shapes from ``eval_shape``)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "bias":
            return 0.1 * n
        return n / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def jax_models():
    """The tiny JAX UNet, VAE and CLIP and their seeded random weights, shared by every variant."""
    unet_cfg, vae_cfg = jax_unet.UnetConfig(**UNET_KW), jax_vae.AutoencoderConfig(**VAE_KW)
    j_unet = jax_unet.UNetModel.from_config(4, 4, unet_cfg)
    j_vae = jax_vae.AutoEncoderKL.from_config(vae_cfg)
    j_clip = jax_clip.CLIPTextTransformer(**CLIP_KW)
    u = random_params(j_unet, 0, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 16)))
    v = random_params(j_vae, 1, jnp.zeros((1, 16, 16, 3)))
    c = random_params(j_clip, 2, jnp.zeros((1, 77), jnp.int32))
    return unet_cfg, vae_cfg, (j_unet, j_vae, j_clip), (u, v, c)


class _KeepGrads:
    """A JAX fused transform: ``inner``'s update, with each step's gradients
    kept in the state, so that one jitted train step hands them out."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def apply(self, grads, state, params):
        new_params, inner = self.inner.apply(grads, state[0], params)
        return new_params, (inner, grads)


@functools.lru_cache(maxsize=None)
def jax_run():
    """Two JAX train steps on batches 10 and 11 with keys 20 and 21 -> (the
    batches, the keys, the state after each step, the metrics of each step)."""
    unet_cfg, vae_cfg, (j_unet, j_vae, j_clip), (u, v, c) = jax_models()
    sched = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
    tx = _KeepGrads(jax_optim.build_optimizer(jax_args.OptimConfig(**OPTIM), max_train_steps=10))
    train_step, _ = jax_steps.make_unet_train_step(j_unet, j_clip, j_vae, sched, tx, **STEP_KW)
    train_step = jax.jit(train_step)
    jstate = jax_steps.TrainState.create(u, tx, with_ema=True)
    batches, keys, states, metrics = [], [], [], []
    for i in range(2):
        batch, uncond = batch_and_uncond(10 + i)
        key = jax.random.PRNGKey(20 + i)
        jstate, m = train_step(jstate, c, v, {k: jnp.asarray(a) for k, a in batch.items()}, jnp.asarray(uncond), key)
        batches.append((batch, uncond))
        keys.append(key)
        states.append(jstate)
        metrics.append(m)
    return batches, keys, states, metrics


def port_setup():
    unet_cfg, vae_cfg, _, (u, v, c) = jax_models()
    unet = UNetModel(4, 4, UnetConfig(**UNET_KW))
    unet.load_state_dict(convert.to_torch(convert.unet_state_dict(u, unet_cfg)), strict=True)
    vae = AutoEncoderKL(AutoencoderConfig(**VAE_KW))
    vae.load_state_dict(convert.to_torch(convert.autoencoder_state_dict(v, vae_cfg)), strict=True)
    clip = CLIPTextTransformer(**CLIP_KW)
    clip.load_state_dict(convert.to_torch(convert.clip_state_dict(c)), strict=True)
    steps = make_unet_train_step(unet, clip.eval().requires_grad_(False), vae.eval().requires_grad_(False),
                                 make_schedule(DDPMConfig()), **STEP_KW)
    return unet, steps


def batch_and_uncond(seed):
    rng = np.random.default_rng(seed)
    batch = {"pixel_values": rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32),
             "input_ids": rng.integers(0, 49408, (2, 77)).astype(np.int32)}
    uncond = np.full((77,), 49407, np.int32)
    uncond[0] = 49406
    return batch, uncond


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draws(key, whole_batch_drop, bsz, latent, steps):
    k_sample, k_noise, k_t, k_drop, _, k_off, k_ip = jax.random.split(key, 7)
    return {
        "posterior_eps": jax.random.normal(k_sample, latent, jnp.float32),
        "noise": jax.random.normal(k_noise, latent, jnp.float32),
        "timesteps": jax.random.randint(k_t, (bsz,), 0, steps),
        "drop_u": jax.random.uniform(k_drop, ()) if whole_batch_drop else jax.random.uniform(k_drop, (bsz, 1))[:, 0],
        "offset": jax.random.normal(k_off, (bsz, 1, 1, latent[-1]), jnp.float32),
        "perturb": jax.random.normal(k_ip, latent, jnp.float32),
    }


def jax_draws(key, whole_batch_drop=False, bsz=2, latent=(2, 8, 8, 4), steps=1000):
    """The draws ``make_unet_train_step`` takes from its step key (one jitted
    program a signature: ``jax.random`` gives the same bits under jit)."""
    draws = _jax_draws(key, bool(whole_batch_drop), int(bsz), tuple(latent), int(steps))
    return {k: torch.from_numpy(np.array(a)) for k, a in draws.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


class _Record:
    """An optimizer that keeps the gradients it is handed."""

    def step(self, grads):
        self.grads = [g.clone() for g in grads]
        return True, torch.tensor(0.0)


def test_train_step_loss_and_gradients_match_jax():
    batches, keys, states, metrics = jax_run()
    (batch, uncond), key = batches[0], keys[0]
    draws = jax_draws(key, whole_batch_drop=True)
    unet_cfg = jax_models()[0]

    unet, (train_step, port_eval) = port_setup()
    state = TrainState(unet, _Record())
    out = train_step(state, _torch_batch(batch), torch.from_numpy(uncond), draws)
    loss = float(metrics[0]["loss"])
    np.testing.assert_allclose(out["loss"].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(port_eval(_torch_batch(batch), torch.from_numpy(uncond), draws).item(), loss,
                               rtol=1e-5)
    ref = convert.to_torch(convert.unet_state_dict(states[0].opt_state[1], unet_cfg))
    for name, got in zip(state.names, state.optimizer.grads):
        want = ref[name]
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-7, (name, err, want.abs().max().item())


def test_two_train_steps_params_and_ema_match_jax():
    batches, keys, states, metrics = jax_run()
    unet_cfg = jax_models()[0]
    unet, (port_step, _) = port_setup()
    optimizer = port_optim.build_optimizer(
        [p for p in unet.parameters()], port_args.OptimConfig(**OPTIM), max_train_steps=10,
    )
    state = TrainState(unet, optimizer, with_ema=True)
    for (batch, uncond), key, jm in zip(batches, keys, metrics):
        pm = port_step(state, _torch_batch(batch), torch.from_numpy(uncond), jax_draws(key, whole_batch_drop=True))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    jstate = states[-1]
    assert state.step == int(jstate.step) == 2
    for tree, ours in ((jstate.params, state.params), (jstate.ema_params, state.ema_params)):
        ref = convert.to_torch(convert.unet_state_dict(tree, unet_cfg))
        for name, got in zip(state.names, ours):
            torch.testing.assert_close(got.detach(), ref[name], rtol=1e-6, atol=0.1 * OPTIM["learning_rate"],
                                       msg=name)


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "accumulate2"])
def test_adamw_matches_fused_adamw(accum):
    """Three micro steps of clip + AdamW (+ running-mean accumulation) on a
    small tree; the clip is active (global norm above 0.5). 1e-6 absolute."""
    rng = np.random.default_rng(accum)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32), "b": rng.standard_normal(11).astype(np.float32)}
    grads = [{k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()} for _ in range(3)]
    sched = jax_optim.build_lr_schedule("linear", 1e-2, 1, 10)
    ftx = jax_fused.fused_adamw(sched, weight_decay=0.1, max_grad_norm=0.5)
    tx = jax_fused.fused_accumulate(ftx, accum) if accum > 1 else ftx
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    ours = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = port_optim.AdamW(ours, port_optim.build_lr_schedule("linear", 1e-2, 1, 10),
                           weight_decay=0.1, max_grad_norm=0.5, accum_steps=accum)
    for g in grads:
        jp, st = tx.apply({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        applied, norm = opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        np.testing.assert_allclose(norm.item(), float(np.sqrt(sum((v ** 2).sum() for v in g.values()))), rtol=1e-5)
        for k, t in zip(("a", "b"), ours):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    assert opt.count == (3 if accum == 1 else 1)


@pytest.mark.parametrize("kind", port_optim.SCHEDULES)
def test_lr_schedules_match_optax(kind):
    cfg = port_args.OptimConfig(learning_rate=3e-4, lr_warmup_steps=5, scheduler_type=kind)
    jcfg = jax_args.OptimConfig(learning_rate=3e-4, lr_warmup_steps=5, scheduler_type=kind)
    for step in (0, 1, 4, 5, 6, 11, 19, 20, 25):
        np.testing.assert_allclose(port_optim.lr_at_step(cfg, 20, step), jax_optim.lr_at_step(jcfg, 20, step),
                                   rtol=1e-6, atol=1e-12)


def test_add_noise_and_posterior_match_jax():
    rng = np.random.default_rng(5)
    x0, noise = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 999], np.int32)
    ref = jax_schedule.add_noise(jax_schedule.make_schedule(jax_schedule.DDPMConfig()), jnp.asarray(x0),
                                 jnp.asarray(noise), jnp.asarray(t))
    out = add_noise(make_schedule(DDPMConfig()), torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)

    moments = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    jpost = jax_blocks.GaussianDistribution.from_moments(jnp.asarray(moments))
    post = GaussianDistribution.from_moments(torch.from_numpy(moments))
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (2, 4, 4, 4), jnp.float32))
    np.testing.assert_allclose(post.sample(eps=torch.from_numpy(eps)).numpy(), np.asarray(jpost.sample(key)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(post.mode().numpy(), np.asarray(jpost.mode()))
    np.testing.assert_allclose(post.kl().numpy(), np.asarray(jpost.kl()), rtol=1e-5)
    drawn = post.sample(torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 4, 4, 4) and not torch.equal(drawn, post.mean)
