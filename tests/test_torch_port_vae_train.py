"""The KL-VAE training path, port vs the JAX package, at a tiny size on the CPU (f32).

- ``make_vae_train_step``: the JAX step's loss, its parts and its gradients
  (kept by the optimizer of a jitted step; both KL variants in one compile)
  against the port's step on the same weights (JAX trees converted by
  ``utils/convert.py:autoencoder_state_dict``), the same batch and the JAX
  posterior draw ``jax.random.normal(key, std.shape)`` handed in as ``eps``;
  with the batch-mean KL and with ``kl_per_example0``. Tolerances, f32 on both
  sides with sums in another order: loss, its parts and the eval loss 1e-5
  relative; gradients per leaf within 1e-4 of the leaf's largest gradient
  (+1e-7), their global norm 1e-4 relative.
- The plain attention backward at the VAE's single 512-wide head against the
  JAX ``flash_attention`` VJP with its Pallas kernels in interpret mode:
  within 1e-4 of each gradient's largest magnitude (f32 sums over 64 kv rows
  and 512 columns in another order). Past 512 the kernel wrappers refuse the
  head dim on any device.
- The training CLI with ``--device cpu`` and jax blocked, in one process: 3 optimizer steps
  (accumulation 2, EMA on) save ``checkpoint-{1,2,3}`` and evaluate at
  ``(step + 1) % log_interval``; a run resumed from ``latest`` with only
  ``checkpoint-2`` present ends in exactly the unbroken run's state (bitwise
  on the CPU); ``--use-8bit-adam --accum-dtype bf16`` trains the VAE's
  leaves. The test images are the JAX package's rows, and the trainer
  reconstructs one; the multi-device options (ROADMAP item 17) raise naming it.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from stable_diffusion_pytorch_tpu.models import autoencoder as jax_vae  # noqa: E402
from stable_diffusion_pytorch_tpu.models.bpe import CLIPBPETokenizer as JaxBPE  # noqa: E402
from stable_diffusion_pytorch_tpu.ops.flash_attention import flash_attention as jax_flash  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import args as jax_args  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import optim as jax_optim  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import steps as jax_steps  # noqa: E402
from stable_diffusion_pytorch_tpu.utils import data as jax_data  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (  # noqa: E402
    MAX_BWD_HEAD_DIM,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_bwd_split,
)
from stable_diffusion_pytorch_tpu_torch.scripts import train_autoencoder  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.optim import global_norm  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState, make_vae_train_step  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import data as port_data  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from test_torch_port_train_step import random_params  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
VAE_KW = dict(in_channels=3, latent_channels=4, out_channels=3, autoencoder_channels_list=[16, 32],
              autoencoder_num_res_blocks=1, groups=8, kl_weight=0.5)
OPTIM = dict(learning_rate=1e-4, adam_weight_decay=0.1, max_grad_norm=0.1, scheduler_type="linear",
             lr_warmup_steps=0)
LATENT = (2, 16, 16, 4)  # the posterior of a batch of two 32x32 images, f = 2


@functools.lru_cache(maxsize=None)
def vae_params():
    vae_cfg = jax_vae.AutoencoderConfig(**VAE_KW)
    j_vae = jax_vae.AutoEncoderKL.from_config(vae_cfg)
    return vae_cfg, j_vae, random_params(j_vae, 1, jnp.zeros((1, 32, 32, 3)))


@functools.lru_cache(maxsize=None)
def jax_steps_run():
    """One jitted JAX train step of each KL variant on batch 3 with key 7, in
    one compile (the variants share the VAE's forward and most of its
    backward) -> (batch, key, {kl_per_example0: (state after, metrics)})."""
    vae_cfg, j_vae, params = vae_params()
    rng = np.random.default_rng(3)
    batch = {"pixel_values": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(7)
    steps = {}
    for variant in (False, True):
        tx = _KeepGrads(jax_optim.build_optimizer(jax_args.OptimConfig(**OPTIM), max_train_steps=10))
        train_step, _ = jax_steps.make_vae_train_step(j_vae, tx, kl_weight=VAE_KW["kl_weight"],
                                                      kl_per_example0=variant)
        steps[variant] = (tx, train_step)

    def both(p, jbatch, k):
        return {v: step(jax_steps.TrainState.create(p, tx), jbatch, k) for v, (tx, step) in steps.items()}

    return batch, key, jax.jit(both)(params, {k: jnp.asarray(a) for k, a in batch.items()}, key)


class _KeepGrads:
    """A JAX fused transform: ``inner``'s update, with the step's gradients
    kept in the state, so that one jitted train step hands them out."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def apply(self, grads, state, params):
        new_params, inner = self.inner.apply(grads, state[0], params)
        return new_params, (inner, grads)


class _Record:
    """An optimizer that keeps the gradients it is handed and reports their norm."""

    def step(self, grads):
        self.grads = [g.clone() for g in grads]
        return True, global_norm(grads)


@pytest.mark.parametrize("kl_per_example0", [False, True], ids=["batch_mean_kl", "kl_per_example0"])
def test_vae_train_step_loss_and_gradients_match_jax(kl_per_example0):
    vae_cfg, _, params = vae_params()
    batch, key, results = jax_steps_run()
    # the jitted step's metrics, and the gradients ``jax.value_and_grad`` took
    # inside it, kept by the optimizer in its state
    jstate, jm = results[kl_per_example0]
    loss, grads = jm["loss"], jstate.opt_state[1]
    eps = torch.from_numpy(np.array(jax.random.normal(key, LATENT, jnp.float32)))

    vae = AutoEncoderKL(AutoencoderConfig(**VAE_KW))
    vae.load_state_dict(convert.to_torch(convert.autoencoder_state_dict(params, vae_cfg)), strict=True)
    train, evaluate = make_vae_train_step(vae.requires_grad_(True), kl_weight=VAE_KW["kl_weight"],
                                          kl_per_example0=kl_per_example0)
    state = TrainState(vae, _Record())
    tbatch = {k: torch.from_numpy(a) for k, a in batch.items()}
    metrics = train(state, tbatch, eps)
    for name in ("loss", "recon_loss", "kl_loss"):
        np.testing.assert_allclose(metrics[name].item(), float(jm[name]), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(evaluate(tbatch, eps).item(), float(loss), rtol=1e-5)
    assert state.step == 1
    ref = convert.to_torch(convert.autoencoder_state_dict(grads, vae_cfg))
    assert sorted(ref) == sorted(state.names)
    for name, got in zip(state.names, state.optimizer.grads):
        want = ref[name]
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-7, (name, err, want.abs().max().item())


def test_d512_plain_backward_matches_jax_vjp_interpret():
    """One head of 512 at [1, 64, 64, 1, 512], the VAE bottleneck of a 64x64 image."""
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((1, 64, 1, 512)).astype(np.float32) for _ in range(4))
    scale = 512 ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, scale, interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    refs = vjp(jnp.asarray(do))
    ours = flash_attention_bwd_plain(*(torch.from_numpy(a) for a in (q, k, v, do)), scale)
    for got, ref in zip(ours, refs):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_backward_wrappers_refuse_head_dims_past_512():
    assert MAX_BWD_HEAD_DIM == 512
    q = torch.zeros(1, 8, 1, 520)
    lse = torch.zeros(1, 1, 8)
    for bwd in (flash_attention_bwd_split, flash_attention_bwd):
        with pytest.raises(ValueError, match="head dim 520 exceeds the kernel's 512"):
            bwd(q, q, q, q, q, lse, 0.1)


def test_test_images_are_the_jax_rows():
    kw = dict(dataset="synthetic", resolution=32, max_test_samples=7)
    ours = port_data.sample_test_image(port_data.DatasetConfig(**kw), "test", CLIPBPETokenizer(max_seq_len=77),
                                       num=4)
    ref = jax_data.sample_test_image(jax_data.DatasetConfig(**kw), "test", JaxBPE(max_seq_len=77), num=4)
    assert len(ours) == 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


TRAIN = (
    "--device cpu --dataset synthetic --resolution 32 --max-train-steps 3 --train-batch-size 2 "
    "--eval-batch-size 2 --gradient-accumulation-steps 2 --max-train-samples 8 --max-val-samples 4 "
    "--max-test-samples 2 --log-interval 2 --checkpointing-steps 1 --lr-warmup-steps 1 --ema-decay 0.9 "
    "--dataloader-num-workers 0 --autoencoder-channels-list 16,32 --groups 8"
).split()

# one process, jax blocked: the unbroken run in ./unbroken; a run in ./resumed
# that holds only its checkpoint-2 and resumes `latest`; the lean run in ./lean
_NO_JAX = """
import os, shutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import torch
torch.set_num_threads(2)
from stable_diffusion_pytorch_tpu_torch.scripts.train_autoencoder import main
argv = sys.argv[1:] + ["--ckpt-dir", "ckpt"]
os.makedirs("unbroken")
os.chdir("unbroken")
main(argv)
os.makedirs("../resumed/ckpt")
shutil.copytree("ckpt/checkpoint-2", "../resumed/ckpt/checkpoint-2")
os.chdir("../resumed")
print("RESUMED RUN", file=sys.stderr, flush=True)
main(argv + ["--resume-from-checkpoint", "latest"])
print("LEAN RUN", file=sys.stderr, flush=True)
os.makedirs("../lean")
os.chdir("../lean")
main(argv + ["--use-8bit-adam", "--accum-dtype", "bf16", "--max-train-steps", "2"])
assert not any(m.split(".")[0] in ("jax", "flax", "optax") for m in sys.modules if sys.modules[m] is not None)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(unbroken dir, resumed dir, the resumed run's log, lean dir)."""
    cwd = tmp_path_factory.mktemp("vae_cli")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, *TRAIN], capture_output=True, text=True,
                          timeout=300, env=env, cwd=cwd)
    assert proc.returncode == 0, proc.stderr[-3000:]
    resumed_log = proc.stderr.split("RESUMED RUN")[-1].split("LEAN RUN")[0]
    return cwd / "unbroken", cwd / "resumed", resumed_log, cwd / "lean"


def test_vae_cli_runs_without_jax_checkpoints_and_resumes_latest(runs):
    unbroken, resumed, resumed_log, _ = runs
    assert sorted(os.listdir(unbroken / "ckpt")) == ["checkpoint-1", "checkpoint-2", "checkpoint-3"]
    lines = (unbroken / "logs" / "train_autoencoder_metrics.jsonl").read_text().splitlines()
    assert len([line for line in lines if "train_loss" in line]) == 3
    # the VAE trainer evaluates at (step + 1) % log_interval == 0: steps 1 and 3
    assert [line.split(",")[0] for line in lines if "eval_loss" in line] == ['{"step": 1', '{"step": 3']

    assert "Resuming from checkpoint at global step 2" in resumed_log
    want = load_checkpoint(str(unbroken / "ckpt" / "checkpoint-3"))
    got = load_checkpoint(str(resumed / "ckpt" / "checkpoint-3"))
    assert got["step"] == want["step"] == 6 and got["opt_state"]["count"] == 3
    assert any(name.startswith("encoder.bottleneck.1.") for name in want["params"])
    for part in ("params", "ema_params"):
        for name, t in want[part].items():
            assert torch.equal(got[part][name], t), (part, name)
    for name in ("mu", "nu", "acc"):
        assert all(torch.equal(a, b) for a, b in zip(got["opt_state"][name], want["opt_state"][name])), name


def test_vae_trainer_reconstructs_a_test_image(tmp_path):
    trainer = train_autoencoder.build_trainer([*TRAIN, "--ckpt-dir", str(tmp_path / "ckpt"),
                                               "--logging-dir", str(tmp_path / "logs")])
    assert len(trainer.test_images) == 10 and trainer.test_images[0].shape == (32, 32, 3)
    out = trainer.recon(trainer.test_images[0])
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8


def test_vae_cli_takes_the_lean_optimizer(runs):
    """``--use-8bit-adam --accum-dtype bf16`` on the VAE's leaves (K9's plain
    version on the CPU): the checkpoint holds int8 codes and a bf16 accumulator."""
    state = load_checkpoint(str(runs[3] / "ckpt" / "checkpoint-2"))
    opt = state["opt_state"]
    assert opt["layout"] == {"gradient_accumulation": True, "accum_dtype": "bf16", "use_8bit_adam": True}
    assert opt["count"] == 2 and len(opt["mu_q"]) == len(state["params"])
    assert all(q.dtype == torch.int8 for q in opt["mu_q"] + opt["nu_q"])
    assert all(a.dtype == torch.bfloat16 for a in opt["acc"])
    assert all(torch.isfinite(p).all() for p in state["params"].values())


@pytest.mark.parametrize("flags", [["--num-devices", "4"], ["--shard-params"], ["--offload-optimizer"]],
                         ids=["num_devices", "shard_params", "offload_optimizer"])
def test_unported_vae_options_raise(tmp_path, monkeypatch, capfd, flags):
    """The multi-device options on one CPU process: ``--num-devices 4`` raises
    naming 4 and the data size 1; ``--shard-params`` (nothing to shard over
    one process) and ``--offload-optimizer`` (a no-op with the JAX package's
    warning on the CPU, where host and device memory are one) build and step."""
    monkeypatch.chdir(tmp_path)
    argv = [*TRAIN, "--ckpt-dir", "ckpt", "--max-train-steps", "1", "--log-interval", "0", *flags]
    if flags[0] == "--num-devices":
        with pytest.raises(ValueError, match="--num-devices 4 does not match the data axis of 1 process"):
            train_autoencoder.main(argv)
        return
    trainer = train_autoencoder.main(argv)
    assert trainer.state.optimizer.count == 1 and trainer.world == 1
    assert all(t.device.type == "cpu" for t in trainer.state.optimizer.state_tensors())
    warned = "--offload-optimizer ignored on a CPU device (host and device memory coincide)" in capfd.readouterr().err
    assert warned == (flags[0] == "--offload-optimizer")
