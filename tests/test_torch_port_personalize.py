"""The personalization trainers' steps and datasets, port vs the JAX package, at
a tiny size on the CPU (f32): the models and tolerances of
``test_torch_port_train_step.py`` (JAX weights carried by ``utils/convert.py``,
every leaf random, so LoRA's B and ControlNet's zero convs are filled; JAX's
step keys split as its steps split them and the draws handed to the port).

Each step runs twice on both sides from the same start, with the same
batches, under the f32 AdamW (clip 0.1, weight decay 0.1, learning rate
1e-4) and an EMA of 0.9: the loss of each step at 1e-5 relative and its
gradient norm at 1e-4; each step's gradients per leaf within 1e-4 of the
leaf's largest (+1e-7); the trainable tensors and their EMA after the two
steps at 1e-5 absolute. One jitted JAX train step yields all of it: its
optimizer is the JAX AdamW wrapped to keep each step's gradients in its state.

- DreamBooth with LoRA: ``make_unet_train_step(param_transform=merge_lora,
  prior_loss_weight=0.7)`` on an interleaved batch (instance rows even, class
  rows odd), rank 3 at ``attn``; the port's frozen UNet runs with the merged
  weights in place of its own. The eval step keeps the prior term, as the
  JAX trainer's does (its eval set is the instance set).
- Textual inversion: ``make_textual_inversion_train_step``, two vectors whose
  sentinel ids stand in the prompts; the port's UNet under per-block remat.
- ControlNet: ``make_controlnet_train_step`` with the prompt dropped per row
  (keys whose draws drop one row and keep the other, in both steps); the
  port's UNet under the conv-save remat.
- The int8 optimizer over LoRA factors and textual-inversion vectors (their
  transposes, ``Trainables``): one step of the port's ``AdamW8bit`` against
  the JAX chain run eagerly, codes equal and parameters and dequantized
  moments at rtol 1e-6: the port's blocks are the JAX package's.
- The datasets: ``FolderPromptDataset`` rows from PNG files the test writes,
  ``DreamBoothDataset`` and ``dreambooth_collate`` over two epochs,
  ``TextualInversionDataset``, ``edge_hint`` and ``ControlNetDataset``,
  equal to the JAX package's; ``init_concept_vectors`` equal to the JAX
  script's, from an initializer token and from noise.
"""

import functools
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models import clip as jax_clip  # noqa: E402
from stable_diffusion_pytorch_tpu.models import controlnet as jax_cn  # noqa: E402
from stable_diffusion_pytorch_tpu.models import lora as jax_lora  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu.models.bpe import CLIPBPETokenizer as JaxBPE  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import adam8bit as jax_a8  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import args as jax_args  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import optim as jax_optim  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import steps as jax_steps  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import data as jax_data  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, ClipConfig, DDPMConfig, UnetConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models import lora as port_lora  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.clip import VOCAB_SIZE, CLIPModel, CLIPTextTransformer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops import adam8bit_update as k9  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.scripts.train_textual_inversion import init_concept_vectors  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import args as port_args  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import optim as port_optim  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.adam8bit import AdamW8bit  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.steps import (  # noqa: E402
    Trainables,
    TrainState,
    make_controlnet_train_step,
    make_textual_inversion_train_step,
    make_unet_train_step,
)
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import data as port_data  # noqa: E402
from test_torch_port_train_step import CLIP_KW, OPTIM, UNET_KW, VAE_KW, random_params  # noqa: E402
from test_torch_port_train_step import jax_models as train_step_models  # noqa: E402

torch.set_num_threads(2)

EMA = 0.9
PRIOR = 0.7
LORA_RANK, LORA_SCALE = 3, 0.75
PIDS = (VOCAB_SIZE, VOCAB_SIZE + 1)  # the textual-inversion sentinels of two vectors
DROP_MIXED_SEEDS = (62, 63)  # ControlNet step keys whose per-row dropout drops one row of two and keeps one
J_CFG = jax_unet.UnetConfig(**UNET_KW)


@pytest.fixture(scope="module")
def jax_models():
    """The tiny JAX UNet, VAE and CLIP with seeded random weights (those of
    ``test_torch_port_train_step.py``), and the schedule."""
    _, _, (j_unet, j_vae, j_clip), (u, v, c) = train_step_models()
    return types.SimpleNamespace(unet=j_unet, vae=j_vae, clip=j_clip, u=u, v=v, c=c,
                                 sched=jax_schedule.make_schedule(jax_schedule.DDPMConfig()))


def port_models(jm, remat="none"):
    """The port's frozen UNet (f32, ``remat``), VAE and CLIP with the JAX weights."""
    unet = UNetModel(4, 4, UnetConfig(**UNET_KW), remat=remat)
    unet.load_state_dict(convert.to_torch(convert.unet_state_dict(jm.u, J_CFG)), strict=True)
    vae = AutoEncoderKL(AutoencoderConfig(**VAE_KW))
    vae.load_state_dict(convert.to_torch(convert.autoencoder_state_dict(jm.v, jax_vae.AutoencoderConfig(**VAE_KW))),
                        strict=True)
    clip = CLIPTextTransformer(**CLIP_KW)
    clip.load_state_dict(convert.to_torch(convert.clip_state_dict(jm.c)), strict=True)
    return tuple(m.eval().requires_grad_(False) for m in (unet, vae, clip))


class _KeepGrads:
    """A JAX fused transform: ``inner``'s update, with each step's gradients
    kept in the state (so a jitted train step hands them out)."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def apply(self, grads, state, params):
        new_params, inner = self.inner.apply(grads, state[0], params)
        return new_params, (inner, grads)


class _Recording:
    """The port's optimizer, keeping each step's gradients."""

    def __init__(self, inner):
        self.inner, self.grads = inner, []

    def step(self, grads):
        self.grads.append([g.clone() for g in grads])
        return self.inner.step(grads)

    def state_dict(self):
        return self.inner.state_dict()


def jax_tx():
    return _KeepGrads(jax_optim.build_optimizer(jax_args.OptimConfig(**OPTIM), max_train_steps=10))


def port_optimizer(params):
    return _Recording(port_optim.build_optimizer(params, port_args.OptimConfig(**OPTIM), max_train_steps=10))


def batch(seed, rows, pids=()):
    """Pixels and token ids of ``rows`` rows; ``pids`` are put in every row's prompt."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB_SIZE, (rows, 77)).astype(np.int32)
    for j, p in enumerate(pids):
        ids[:, 3 + j] = p
        ids[::2, 9 + j] = p
    return {"pixel_values": rng.uniform(-1, 1, (rows, 16, 16, 3)).astype(np.float32), "input_ids": ids}


def uncond():
    ids = np.full((77,), 49407, np.int32)
    ids[0] = 49406
    return ids


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, splits, rows, drop_index):
    keys = jax.random.split(key, splits)
    latent = (rows, 8, 8, 4)
    out = {"posterior_eps": jax.random.normal(keys[0], latent, jnp.float32),
           "noise": jax.random.normal(keys[1], latent, jnp.float32),
           "timesteps": jax.random.randint(keys[2], (rows,), 0, 1000)}
    out["drop_u"] = (jax.random.uniform(keys[drop_index], (rows, 1))[:, 0] if drop_index is not None
                     else jnp.ones((rows,)))
    return out


def draws(key, splits, rows, drop_index=None):
    """The draws a JAX step takes from its key: the posterior noise, the
    noise and the timesteps from the first three of ``splits`` keys, the
    per-row dropout uniforms from ``drop_index`` (one jitted program a
    signature: ``jax.random`` gives the same bits under jit)."""
    return {k: torch.from_numpy(np.array(a)) for k, a in _jax_draws(key, splits, rows, drop_index).items()}


def _t(b):
    return {k: torch.from_numpy(a) for k, a in b.items()}


def _j(b):
    return {k: jnp.asarray(a) for k, a in b.items()}


def check_two_steps(jstates, metrics, state, to_port):
    """Each step's loss, gradient norm and gradients; then the trainable
    tensors and their EMA (``to_port(tree) -> {name: tensor}``)."""
    for i, (jstate, jm, pm) in enumerate(zip(jstates, *metrics)):
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        ref = to_port(jstate.opt_state[1])
        for name, got in zip(state.names, state.optimizer.grads[i]):
            got = got if state.trainables is None else got.t()
            want = ref[name]
            err = (got - want).abs().max().item()
            assert err <= 1e-4 * want.abs().max().item() + 1e-7, (i, name, err, want.abs().max().item())
    saved = state.state_dict()
    assert saved["step"] == int(jstates[-1].step) == 2
    for part, tree in (("params", jstates[-1].params), ("ema_params", jstates[-1].ema_params)):
        ref = to_port(tree)
        assert sorted(saved[part]) == sorted(ref)
        for name, got in saved[part].items():
            torch.testing.assert_close(got.detach(), ref[name], rtol=1e-6, atol=0.1 * OPTIM["learning_rate"],
                                       msg=f"{part}.{name}")


# --------------------------------------------------------------------------- #
# DreamBooth: LoRA and prior preservation
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def lora_run(jax_models):
    """The JAX step with ``merge_lora`` and the prior term, two steps on
    interleaved batches of 2 instance and 2 class rows: (models, the LoRA at
    the start, the batches, the keys, the states and metrics after each step)."""
    jm = jax_models
    lora = jax_lora.init_lora(jax.random.PRNGKey(1), jm.u, rank=LORA_RANK, targets="attn")
    leaves, tree = jax.tree_util.tree_flatten(lora)
    rng = np.random.default_rng(4)
    # a trained B (init_lora's is zero, which would leave A without gradient)
    lora = jax.tree_util.tree_unflatten(tree, [np.asarray(x) if np.asarray(x).any()
                                               else (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
                                               for x in leaves])
    tx = jax_tx()
    train_step, _ = jax_steps.make_unet_train_step(
        jm.unet, jm.clip, jm.vae, jm.sched, tx, cfg_dropout_prob=0.5, ema_decay=EMA,
        param_transform=lambda lp: jax_lora.merge_lora(jm.u, lp, LORA_SCALE), prior_loss_weight=PRIOR)
    train_step = jax.jit(train_step)
    jstate = jax_steps.TrainState.create(lora, tx, with_ema=True)
    batches, keys, jstates, jms = [batch(10 + i, 4) for i in range(2)], [jax.random.PRNGKey(20 + i) for i in range(2)], [], []
    for b, key in zip(batches, keys):
        jstate, m = train_step(jstate, jm.c, jm.v, _j(b), jnp.asarray(uncond()), key)
        jstates.append(jstate)
        jms.append(m)
    return jm, lora, batches, keys, jstates, jms


def port_lora_step(jm, lora, optimizer=True):
    unet, vae, clip = port_models(jm)
    base = dict(unet.named_parameters())
    trainable = Trainables(convert.to_torch(convert.lora_state_dict(lora, J_CFG)))
    steps = make_unet_train_step(
        unet, clip, vae, make_schedule(DDPMConfig()), cfg_dropout_prob=0.5, ema_decay=EMA,
        param_transform=lambda p: port_lora.lora_weights(base, p, LORA_SCALE), prior_loss_weight=PRIOR)
    opt = port_optimizer(trainable.leaves) if optimizer else None
    return unet, trainable, TrainState(trainable, opt, with_ema=True), steps


def test_lora_prior_step_matches_jax(lora_run):
    jm, lora, batches, keys, jstates, jms = lora_run
    unet, _, state, (port_step, _) = port_lora_step(jm, lora)
    base_before = {n: p.clone() for n, p in unet.state_dict().items()}
    pms = [port_step(state, _t(b), torch.from_numpy(uncond()), draws(key, 7, 4, drop_index=3))
           for b, key in zip(batches, keys)]
    check_two_steps(jstates, (jms, pms), state, lambda tree: convert.to_torch(convert.lora_state_dict(tree, J_CFG)))
    # the base UNet is frozen and untouched: the merged weights were only lent to it
    assert all(torch.equal(p, base_before[n]) for n, p in unet.state_dict().items())
    assert not any(p.requires_grad for p in unet.parameters())


def test_prior_loss_in_the_eval_step_matches_jax(lora_run):
    """The eval step keeps the prior term (even rows against odd rows,
    whatever the rows hold: the eval set is the instance set) and evaluates
    the factors it is given: JAX's first-step loss, from the same factors,
    batch and draws."""
    jm, lora, batches, keys, _, jms = lora_run
    _, trainable, _, (_, port_eval) = port_lora_step(jm, lora, optimizer=False)
    args = (_t(batches[0]), torch.from_numpy(uncond()), draws(keys[0], 7, 4, drop_index=3))
    np.testing.assert_allclose(port_eval(*args, params=trainable.tensors()).item(), float(jms[0]["loss"]), rtol=1e-5)
    with pytest.raises(ValueError, match="params"):
        port_eval(*args)


# --------------------------------------------------------------------------- #
# textual inversion and ControlNet
# --------------------------------------------------------------------------- #


def test_textual_inversion_step_matches_jax(jax_models):
    """Only ``ti`` trains; its gradient reaches it only through cross-attention
    keys and values of a frozen UNet under per-block remat."""
    jm = jax_models
    vectors = (0.1 * np.random.default_rng(5).standard_normal((2, CLIP_KW["d_model"]))).astype(np.float32)
    tx = jax_tx()
    train_step, _ = jax_steps.make_textual_inversion_train_step(
        jm.unet, jm.clip, jm.vae, jm.sched, tx, placeholder_ids=PIDS, ema_decay=EMA)
    jstate = jax_steps.TrainState.create({"ti": jnp.asarray(vectors)}, tx, with_ema=True)
    train_step = jax.jit(train_step)

    unet, vae, clip = port_models(jm, remat="full")
    trainable = Trainables({"ti": torch.from_numpy(vectors)})
    state = TrainState(trainable, port_optimizer(trainable.leaves), with_ema=True)
    port_step, _ = make_textual_inversion_train_step(unet, clip, vae, make_schedule(DDPMConfig()), PIDS,
                                                     ema_decay=EMA)
    jstates, jms, pms = [], [], []
    for i in range(2):
        b, key = batch(40 + i, 2, pids=PIDS), jax.random.PRNGKey(50 + i)
        jstate, m = train_step(jstate, jm.u, jm.c, jm.v, _j(b), key)
        jstates.append(jstate)
        jms.append(m)
        pms.append(port_step(state, _t(b), draws(key, 3, 2)))
    check_two_steps(jstates, (jms, pms), state, lambda tree: {"ti": torch.from_numpy(np.array(tree["ti"]))})
    assert state.names == ["ti"] and not any(p.requires_grad for m in (unet, vae, clip) for p in m.parameters())


def test_controlnet_step_matches_jax(jax_models):
    """The control branch trains (its zero convs filled), the UNet frozen under
    the conv-save remat; each row's prompt drops on its own."""
    jm = jax_models
    j_cn = jax_cn.ControlNet.from_unet_config(4, 4, J_CFG, hint_downsamples=1)
    cn = random_params(j_cn, 6, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 16)),
                       jnp.zeros((1, 16, 16, 3)))
    tx = jax_tx()
    train_step, _ = jax_steps.make_controlnet_train_step(
        jax_cn.ControlledUNetModel(unet=jm.unet, controlnet=j_cn), jm.clip, jm.vae, jm.sched, tx,
        cfg_dropout_prob=0.5, ema_decay=EMA)
    jstate = jax_steps.TrainState.create(cn, tx, with_ema=True)
    train_step = jax.jit(train_step)

    unet, vae, clip = port_models(jm, remat="conv-save")
    net = ControlNet(4, 4, UnetConfig(**UNET_KW), hint_downsamples=1)
    net.load_state_dict(convert.to_torch(convert.controlnet_state_dict(cn, J_CFG)), strict=True)
    net.eval().requires_grad_(True)
    state = TrainState(net, port_optimizer(list(net.parameters())), with_ema=True)
    port_step, _ = make_controlnet_train_step(unet, net, clip, vae, make_schedule(DDPMConfig()), cfg_dropout_prob=0.5,
                                              ema_decay=EMA)
    jstates, jms, pms = [], [], []
    for i, seed in enumerate(DROP_MIXED_SEEDS):
        key = jax.random.PRNGKey(seed)
        b = batch(70 + i, 2)
        b["hint"] = port_data.edge_hint(b["pixel_values"][0])[None].repeat(2, 0)
        b["hint"][1] = -b["hint"][1]
        step_draws = draws(key, 4, 2, drop_index=3)
        assert (step_draws["drop_u"] < 0.5).tolist() in ([True, False], [False, True]), step_draws["drop_u"]
        jstate, m = train_step(jstate, jm.u, jm.c, jm.v, _j(b), jnp.asarray(uncond()), key)
        jstates.append(jstate)
        jms.append(m)
        pms.append(port_step(state, _t(b), torch.from_numpy(uncond()), step_draws))
    check_two_steps(jstates, (jms, pms), state,
                    lambda tree: convert.to_torch(convert.controlnet_state_dict(tree, J_CFG)))


# --------------------------------------------------------------------------- #
# the int8 optimizer over named tensors
# --------------------------------------------------------------------------- #


def test_adamw8bit_over_lora_and_ti_leaves_blocks_as_jax():
    """Blocks of 4: ``lora_b`` [3, 16] and ``ti`` [3, 16] split their minor
    axis into 4 blocks, ``lora_a`` [16, 3] is one block per row, in JAX as in
    the port (whose leaves are the transposes). Two steps, eagerly in JAX: the
    second reads back the moments the first stored."""
    rng = np.random.default_rng(8)
    shapes = {"m.lora_a": (16, LORA_RANK), "m.lora_b": (LORA_RANK, 16), "ti": (3, 16)}
    tensors = {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for n, shape in shapes.items()}
    grads = [{n: rng.standard_normal(t.shape).astype(np.float32) for n, t in tensors.items()} for _ in range(2)]
    sched = jax_optim.build_lr_schedule("constant", 1e-2, 0, 10)
    tx = optax.chain(optax.clip_by_global_norm(1.0), jax_a8.adamw_8bit(sched, weight_decay=0.1, block_size=4))
    params = {n: jnp.asarray(t.numpy()) for n, t in tensors.items()}
    jstate = tx.init(params)
    trainable = Trainables(tensors)
    opt = AdamW8bit(trainable.leaves, port_optim.build_lr_schedule("constant", 1e-2, 0, 10), block_size=4,
                    weight_decay=0.1, max_grad_norm=1.0)
    for g in grads:
        updates, jstate = tx.update({n: jnp.asarray(a) for n, a in g.items()}, jstate, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(g[n]).t().contiguous() for n in trainable.names])
    adam = jstate[1][0]
    # ti's leaf is [16, 3]: codes in its shape, 4 blocks of 4 rows a column
    assert [tuple(t.shape) for t in opt.mu[trainable.names.index("ti")]] == [(16, 3), (4, 3)]
    for i, name in enumerate(trainable.names):
        np.testing.assert_allclose(trainable.tensors()[name].detach().numpy(), np.asarray(params[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        for ours, theirs in ((opt.mu[i], adam.mu[name]), (opt.nu[i], adam.nu[name])):
            np.testing.assert_array_equal(ours[0].t().numpy(), np.asarray(theirs.q), err_msg=name)
            np.testing.assert_allclose(k9.dequantize(*ours).t().numpy(),
                                       np.asarray(jax_a8._dequantize(theirs, tensors[name].shape)),
                                       rtol=1e-6, atol=1e-8, err_msg=name)


# --------------------------------------------------------------------------- #
# the datasets
# --------------------------------------------------------------------------- #


def _write_pngs(folder, n, h, w, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        port_data.to_img((rng.random((h, w, 3)) * 255).astype(np.uint8), str(folder), f"img_{i}.png")


def _rows_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        if isinstance(v, str):
            assert ours[k] == v, k
        else:
            np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(v), err_msg=k)


def _cfgs(**kw):
    return port_data.DatasetConfig(**kw), jax_data.DatasetConfig(**kw)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Instance and class PNGs, 20x24 (a center crop to 20 on the long side)."""
    root = tmp_path_factory.mktemp("dreambooth")
    _write_pngs(root / "inst", 2, 20, 24, 0)
    _write_pngs(root / "cls", 3, 24, 20, 1)
    return root


def test_folder_and_dreambooth_datasets_match_jax(folders):
    pc, jc = _cfgs(resolution=20, random_flip=True)
    ours_tok, jax_tok = CLIPBPETokenizer(), JaxBPE()
    ours = [port_data.FolderPromptDataset(str(folders / d), p, pc, ours_tok)
            for d, p in (("inst", "a photo of sks blob"), ("cls", "a photo of a blob"))]
    theirs = [jax_data.FolderPromptDataset(str(folders / d), p, jc, jax_tok)
              for d, p in (("inst", "a photo of sks blob"), ("cls", "a photo of a blob"))]
    ours_db, theirs_db = port_data.DreamBoothDataset(*ours), jax_data.DreamBoothDataset(*theirs)
    assert len(ours_db) == len(theirs_db) == 3
    for epoch in (0, 1):
        ours_db.set_epoch(epoch)
        theirs_db.set_epoch(epoch)
        for i in range(2):
            _rows_equal(ours[0][i], theirs[0][i])
        rows = [(ours_db[i], theirs_db[i]) for i in range(3)]
        for a, b in rows:
            _rows_equal(a, b)
        _rows_equal(port_data.dreambooth_collate([a for a, _ in rows[:2]]),
                    jax_data.dreambooth_collate([b for _, b in rows[:2]]))
    with pytest.raises(ValueError, match="no images"):
        port_data.FolderPromptDataset(str(folders), "x", pc, ours_tok)


def test_textual_inversion_dataset_matches_jax():
    pc, jc = _cfgs(resolution=16)
    ours_base = port_data.SyntheticTextImageDataset(pc, "train", CLIPBPETokenizer(), 4)
    theirs_base = jax_data.SyntheticTextImageDataset(jc, "train", JaxBPE(), 4)
    port_clip = CLIPModel(ClipConfig(model_dir=None), CLIPTextTransformer(**CLIP_KW))
    port_clip.add_textual_inversion("<concept>", np.zeros((2, CLIP_KW["d_model"]), np.float32))
    jax_model = _tiny_jax_clip_model(None)
    jax_model.add_textual_inversion("<concept>", np.zeros((2, CLIP_KW["d_model"]), np.float32))
    ours = port_data.TextualInversionDataset(ours_base, "<concept>", port_clip.tokenize)
    theirs = jax_data.TextualInversionDataset(theirs_base, "<concept>", jax_model.tokenize)
    texts = set()
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(4):
            _rows_equal(ours[i], theirs[i])
            texts.add(ours[i]["text"])
            assert set(PIDS) <= set(ours[i]["input_ids"].tolist())
    assert len(texts) > 1


def test_edge_hint_and_controlnet_dataset_match_jax():
    pc, jc = _cfgs(resolution=24)
    ours = port_data.ControlNetDataset(port_data.SyntheticTextImageDataset(pc, "validation", CLIPBPETokenizer(), 3))
    theirs = jax_data.ControlNetDataset(jax_data.SyntheticTextImageDataset(jc, "validation", JaxBPE(), 3))
    for i in range(3):
        _rows_equal(ours[i], theirs[i])
        assert set(np.unique(ours[i]["hint"])) == {-1.0, 1.0}
    batch_ = port_data.collate_fn([ours[0], ours[1]])
    assert batch_["hint"].shape == (2, 24, 24, 3) and batch_["hint"].dtype == np.float32
    _rows_equal(batch_, jax_data.collate_fn([theirs[0], theirs[1]]))


def _tiny_jax_clip_model(params):
    """The JAX ``CLIPModel`` facade over the tiny CLIP tower and ``params``."""
    model = jax_clip.CLIPModel.__new__(jax_clip.CLIPModel)
    model.cfg = jax_clip.ClipConfig(model_dir=None)
    model.max_seq_len = 77
    model.module = jax_clip.CLIPTextTransformer(**CLIP_KW)
    model.tokenizer = JaxBPE()
    model.params = params
    model._ti = None
    return model


@pytest.mark.parametrize("initializer", ["toy", "red circle", ""], ids=["token", "two_tokens", "noise"])
def test_init_concept_vectors_match_the_jax_script(jax_models, initializer):
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    from train_textual_inversion import init_concept_vectors as jax_init

    cfg = types.SimpleNamespace(num_vectors=3, initializer_token=initializer)
    clip = CLIPTextTransformer(**CLIP_KW)
    clip.load_state_dict(convert.to_torch(convert.clip_state_dict(jax_models.c)), strict=True)
    ours = init_concept_vectors(CLIPModel(ClipConfig(model_dir=None), clip), cfg, seed=4)
    theirs = jax_init(_tiny_jax_clip_model(jax_models.c), cfg, seed=4)
    assert ours.shape == (3, CLIP_KW["d_model"]) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)
