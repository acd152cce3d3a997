"""Chained dispatch (``--steps-per-dispatch``) of the port's trainers on the CPU,
against the port's per-step path and the JAX package's rule.

- Each of the four trainers (UNet, textual inversion, ControlNet, VAE),
  built by its entry point's ``build_trainer`` at a tiny size: the loss
  stream with ``--steps-per-dispatch 2`` equals the one with 1, bit for bit,
  under accumulation 2, ``--checkpointing-steps 2`` and ``--log-interval 2``
  over 5 steps (the VAE at ``--log-interval 4``: with its evaluation one
  step early, log 2 and checkpoint 2 leave no room for a chunk of 2), with
  the same evaluation and checkpoint steps and at least one chunk run; a
  resume from ``latest`` under chaining reproduces the last step's loss. The
  second and third trainers reuse the first one's models (its trainable
  module's starting state put back), and the text encoder is built with one
  layer: a stand-in, the same in every run, that keeps the runs short.
- ``train_unet.main`` on both sides with the same flags: the port's
  evaluation and checkpoint steps are the JAX package's. The JAX side runs
  its entry point, loop, chunk rule, tracker and checkpoint manager, with
  its models, datasets and steps stood in (nothing of it is compiled but
  its loop's own calls).
- The chunk plan of the port's ``Trainer._micro_steps`` (its dispatches:
  chunks of optimizer steps, single micro steps) equals the JAX package's
  ``Trainer._micro_steps`` over a grid of N, accumulation, checkpoint step,
  log interval, evaluation offset, maximum steps and resume point, both
  driven through stand-in trainers.
- The optimizer's scalars read from its device buffer give the same bits
  as the Python floats of the host path, for the fused AdamW (f32 and bf16
  moments), ``ChainAdamW`` and the int8 Adam (its plain version here).
- The route: a CUDA device with one process captures a graph, at
  ``--steps-per-dispatch 1`` too; the CPU, a process group and a trainer
  built with ``capture=False`` run chunks without one (at 1: micro step by
  micro step); the offloaded optimizer dispatches step by step. The 2-rank gloo group's chained runs are in
  ``tests/test_torch_port_parallel.py`` (its spawned group).
"""

import copy
import functools
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stable_diffusion_pytorch_tpu_torch.models import build as port_build  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.scripts import (  # noqa: E402
    train_autoencoder,
    train_controlnet,
    train_textual_inversion,
    train_unet,
)
from stable_diffusion_pytorch_tpu_torch.trainers import chain  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import trainer as trainer_mod  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.adam8bit import AdamW8bit  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.optim import AdamW, ChainAdamW, build_lr_schedule, global_norm  # noqa: E402

TINY = ("--device cpu --dataset synthetic --resolution 16 --train-batch-size 1 --eval-batch-size 1 "
        "--max-train-samples 6 --max-val-samples 1 --dataloader-num-workers 0 --lr-warmup-steps 1 "
        "--channels-list 16,32 --n-heads 2 --time-emb-dim 32 --n-layers 1 --num-res-blocks 1 "
        "--autoencoder-channels-list 8,16 --groups 8 --noise-steps 50 --ema-decay 0.9").split()
RUN = ["--max-train-steps", "5", "--gradient-accumulation-steps", "2", "--checkpointing-steps", "2",
       "--log-interval", "2"]
KINDS = {
    "unet": (train_unet, []),
    "textual_inversion": (train_textual_inversion, ["--placeholder-token", "<c>", "--num-vectors", "2",
                                                    "--initializer-token", "toy"]),
    "controlnet": (train_controlnet, []),
    "vae": (train_autoencoder, ["--max-test-samples", "1", "--log-interval", "4"]),
}


@pytest.fixture
def one_layer_text_encoder(monkeypatch):
    """The entry points' text encoder built with one layer (a stand-in)."""
    monkeypatch.setattr(port_build, "CLIPTextTransformer",
                        functools.partial(port_build.CLIPTextTransformer, n_layers=1))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _remake(first, spd: int, ckpt: str, logs: str, resume=None):
    """Another trainer of ``first``'s kind over its models and datasets."""
    cfg = copy.deepcopy(first.cfg)
    cfg.train.steps_per_dispatch = spd
    cfg.checkpoint.ckpt_dir, cfg.log.logging_dir = ckpt, logs
    cfg.checkpoint.resume_from_checkpoint = resume
    data = (first.train_dataset, first.eval_dataset)
    if isinstance(first, trainer_mod.AutoencoderTrainer):
        return trainer_mod.AutoencoderTrainer(first.vae, cfg, *data, test_images=first.test_images,
                                              compat=first.compat, device="cpu")
    if isinstance(first, trainer_mod.ControlNetTrainer):
        return trainer_mod.ControlNetTrainer(first.model, first.controlnet, cfg, *data, device="cpu")
    if isinstance(first, trainer_mod.TextualInversionTrainer):
        return trainer_mod.TextualInversionTrainer(first.model, cfg, *data, device="cpu")
    return trainer_mod.UNetTrainer(first.model, cfg, *data, compat=first.compat, device="cpu")


def _train(trainer):
    """Train, recording each dispatch's optimizer steps -> (train losses by
    step, evaluation steps, the dispatches)."""
    dispatches = []
    inner = trainer._dispatch

    def recorded(window, micro0, steps):
        dispatches.append(steps)
        return inner(window, micro0, steps)

    trainer._dispatch = recorded
    trainer.train()
    records = _records(trainer.tracker.jsonl_path)
    return ([(r["step"], r["train_loss"]) for r in records if "train_loss" in r],
            [r["step"] for r in records if "eval_loss" in r], dispatches)


@pytest.mark.parametrize("kind", list(KINDS))
def test_chained_loss_stream_equals_per_step_and_resumes(tmp_path, monkeypatch, one_layer_text_encoder, kind):
    monkeypatch.chdir(tmp_path)
    script, extra = KINDS[kind]
    first = script.build_trainer([*TINY, *RUN, *extra, "--ckpt-dir", "a/ckpt", "--logging-dir", "a/logs"])
    module = first.state.module
    start = None if module is None else copy.deepcopy(module.state_dict())
    per_step, evals, dispatches = _train(first)
    assert dispatches == [] and len(per_step) == 5
    if start is not None:
        module.load_state_dict(start)
    chained = _remake(first, 2, "b/ckpt", "b/logs")
    got, got_evals, dispatches = _train(chained)
    assert got == per_step
    assert got_evals == evals and evals == ([3] if kind == "vae" else [2, 4])
    assert 2 in dispatches  # a chunk of two optimizer steps ran
    saved = [sorted(n for n in os.listdir(d) if n.startswith("checkpoint-")) for d in ("a/ckpt", "b/ckpt")]
    assert saved[0] == saved[1] == ["checkpoint-2", "checkpoint-4"]
    resumed = _remake(first, 2, "b/ckpt", "c/logs", resume="latest")
    got, _, _ = _train(resumed)
    assert got[-1] == per_step[-1] and [s for s, _ in got] == [5]


# --------------------------------------------------------------------------- #
# train_unet.main on both sides: evaluation and checkpoint steps
# --------------------------------------------------------------------------- #

MAIN_FLAGS = ["--dataset", "synthetic", "--resolution", "16", "--train-batch-size", "1", "--eval-batch-size", "1",
              "--max-train-samples", "6", "--max-val-samples", "1", "--num-devices", "1", "--steps-per-dispatch", "2",
              *RUN]


def _jax_loop_only(monkeypatch):
    """Stand-ins for the JAX entry point's models, datasets and steps: its
    loop, chunk rule, tracker and checkpoint manager run as they are."""
    import jax.numpy as jnp

    from stable_diffusion_pytorch_tpu.models import build as jax_build
    from stable_diffusion_pytorch_tpu.trainers import trainer as jax_trainer
    from stable_diffusion_pytorch_tpu.utils import data as jax_data

    rows = [{"pixel_values": np.zeros((16, 16, 3), np.float32), "input_ids": np.zeros((77,), np.int32)}] * 6

    class LoopOnly(jax_trainer.UNetTrainer):
        def _build(self):
            self._jit_train_chain = True
            self.state = self._place_state(jax_trainer.TrainState.create({"w": jnp.zeros((2,))}, self.tx))

        def _train_step(self, batch, key):
            return {"loss": jnp.float32(1.0)}

        def _train_chunk(self, batches, base_key, m0):
            return {"loss": jnp.ones(len(batches["input_ids"]))}

        def _eval_step(self, batch, key):
            return jnp.float32(0.5)

    monkeypatch.setattr(jax_build, "build_models",
                        lambda *a, **k: types.SimpleNamespace(text_encoder=types.SimpleNamespace(tokenizer=None)))
    monkeypatch.setattr(jax_data, "get_dataset", lambda *a, split="train", **k: rows[:6 if split == "train" else 1])
    monkeypatch.setattr(jax_trainer, "UNetTrainer", LoopOnly)


def test_eval_and_checkpoint_steps_equal_jax_train_unet_main(tmp_path, monkeypatch, one_layer_text_encoder):
    import train_unet as jax_train_unet

    def steps(work):
        records = _records(os.path.join(work, "logs", "train_unet_metrics.jsonl"))
        return ([r["step"] for r in records if "train_loss" in r], [r["step"] for r in records if "eval_loss" in r],
                sorted(os.listdir(os.path.join(work, "ckpt"))))

    monkeypatch.chdir(tmp_path)
    flags = [*TINY, *MAIN_FLAGS, "--ckpt-dir", "port/ckpt", "--logging-dir", "port/logs"]
    train_unet.main(flags)
    _jax_loop_only(monkeypatch)
    jax_train_unet.main([*MAIN_FLAGS, "--ckpt-dir", "jax/ckpt", "--logging-dir", "jax/logs"])
    assert steps("port") == steps("jax") == ([1, 2, 3, 4, 5], [2, 4], ["checkpoint-2", "checkpoint-4"])


# --------------------------------------------------------------------------- #
# the chunk plan against the JAX package's _micro_steps
# --------------------------------------------------------------------------- #


def _consume(stepper, accum: int, max_steps: int, micro0: int) -> None:
    """Take micro steps as the train loop does, stopping after the last optimizer step."""
    micro = micro0
    for _ in stepper:
        micro += 1
        if micro % accum == 0 and micro // accum >= max_steps:
            return


def _jax_plan(spd, accum, max_steps, ckpt, log, offset, batches, skip, micro0):
    import jax

    from stable_diffusion_pytorch_tpu.trainers import trainer as jax_trainer
    from stable_diffusion_pytorch_tpu.utils.profiling import StepTimer as JaxStepTimer

    plan = []

    class Stub:
        cfg = types.SimpleNamespace(train=types.SimpleNamespace(steps_per_dispatch=spd, log_interval=log))
        _jit_train_chain, eval_cadence_offset, mesh = True, offset, None

        def _train_chunk(self, placed, base_key, m0):
            n = len(placed["x"])
            plan.append(("chunk", m0, n // accum))
            return {"loss": np.zeros(n, np.float32)}

        def _train_step(self, placed, key):
            plan.append(("micro", int(placed["m"][0])))
            return {"loss": np.float32(0.0)}

        def _place_batch(self, batch):
            return batch

    stepper = jax_trainer.Trainer._micro_steps(
        Stub(), iter(batches), skip_until=skip, micro_step0=micro0, accum=accum, ckpt_steps=ckpt,
        max_train_steps=max_steps, base_key=jax.random.PRNGKey(0), step_timer=JaxStepTimer(), phases=None)
    _consume(stepper, accum, max_steps, micro0)
    return plan


def _port_plan(spd, accum, max_steps, ckpt, log, offset, batches, skip, micro0):
    plan = []

    class Stub:
        cfg = types.SimpleNamespace(train=types.SimpleNamespace(
            steps_per_dispatch=spd, log_interval=log, gradient_accumulation_steps=accum, seed=0))
        _route, _metric_keys, eval_cadence_offset, device = "eager", ["loss"], offset, torch.device("cpu")
        _chunk_warm = _single_warm = False

        def _dispatch(self, window, m0, steps):
            plan.append(("chunk", m0, steps))
            return np.zeros((steps * accum, 1), np.float32)

        def _train_step(self, placed, generator):
            plan.append(("micro", int(placed["m"][0])))
            return {"loss": torch.zeros(())}

        def _place_batch(self, batch):
            return batch

        def _mean(self, x):
            return x

    stepper = trainer_mod.Trainer._micro_steps(
        Stub(), iter(batches), skip_until=skip, micro_step0=micro0, step_timer=trainer_mod.StepTimer(),
        max_train_steps=max_steps, ckpt_steps=ckpt)
    _consume(stepper, accum, max_steps, micro0)
    return plan


def test_chunk_plan_follows_the_jax_rule(monkeypatch):
    """Over the grid, one epoch of 9 micro batches (``m``: each one's index
    in the epoch; a resume skips the first ``skip``). The JAX loop stacks a
    chunk's batches and hands them to its stand-in as they are."""
    from stable_diffusion_pytorch_tpu.trainers import trainer as jax_trainer

    monkeypatch.setattr(jax_trainer, "mesh_lib", types.SimpleNamespace(put_batch_chunk=lambda mesh, x: x))
    cases = 0
    for spd in (2, 3):
        for accum in (1, 2):
            for ckpt in (None, 2, 3, "epoch"):
                for log in (0, 2, 3):
                    for offset in (0, 1):
                        for max_steps in (4, 7):
                            for skip in (-1, 2 * accum):
                                micro0 = max(skip, 0)
                                batches = [{"x": np.zeros(1), "m": np.array([s])} for s in range(9)]
                                args = (spd, accum, max_steps, ckpt, log, offset, batches, skip, micro0)
                                want = _jax_plan(*args)
                                assert _port_plan(*args) == want, args
                                cases += any(p[0] == "chunk" for p in want)
    assert cases > 50  # most cases hold a chunk


# --------------------------------------------------------------------------- #
# the optimizer's scalars: a device buffer, the host path's bits
# --------------------------------------------------------------------------- #


def _leaves(seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [(256, 3), (8, 4, 3, 3), (7,)]
    params = [torch.randn(s, generator=g) * 0.1 for s in shapes]
    grads = [[torch.randn(s, generator=g) * 1e-2 for s in shapes] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("make", [
    lambda p, s: AdamW(p, s, weight_decay=0.1, max_grad_norm=0.02),
    lambda p, s: AdamW(p, s, mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16, weight_decay=0.1,
                       max_grad_norm=0.02),
    lambda p, s: ChainAdamW(p, s, weight_decay=0.1, max_grad_norm=0.02),
    lambda p, s: AdamW8bit(p, s, weight_decay=0.1, max_grad_norm=0.02),
], ids=["adamw", "adamw_bf16", "chain_adamw", "adamw8bit"])
def test_scalars_buffer_gives_the_host_floats_bits(make):
    params, grads = _leaves(0)
    sched = build_lr_schedule("cosine", 1e-3, 1, 5)
    fed, host = make([p.clone() for p in params], sched), make([p.clone() for p in params], sched)
    for g in grads:
        norm = global_norm(g)
        fed._update(g, norm)  # the buffer's 0-d views
        bc1, bc2, lr = (float(x) for x in host.scalar_rows(1)[0, :3])  # the old host floats
        host._update_leaves(range(len(params)), g, norm, bc1, bc2, lr)
        host.count += 1
        assert torch.equal(fed.scalars[:3], torch.tensor([bc1, bc2, lr]))
    for a, b in zip(fed.params + fed.state_tensors(), host.params + host.state_tensors()):
        assert torch.equal(a, b)


def test_chunk_rows_are_the_per_step_rows():
    params, _ = _leaves(1)
    opt = AdamW(params, build_lr_schedule("linear", 1e-3, 2, 6))
    rows = opt.scalar_rows(4)
    for i in range(4):
        np.testing.assert_array_equal(opt.scalar_rows(1)[0], rows[i])
        opt.count += 1


# --------------------------------------------------------------------------- #
# the route
# --------------------------------------------------------------------------- #


def test_route_table():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for spd in (1, 2):  # one CUDA process replays each optimizer step, at spd 1 too (JAX's _jit_step)
        assert chain.route(spd, cuda, False, None) == "graph"
        assert chain.route(spd, cuda, True, None) is None  # the optimizer offloaded: step by step, as JAX
    assert chain.route(1, cuda, False, object()) is None  # a process group: no collective is captured
    assert chain.route(2, cuda, False, object()) == "eager"
    assert chain.route(1, cpu, False, None) is None
    assert chain.route(2, cpu, False, None) == "eager"
    assert chain.route(1, cuda, False, None, capture=False) is None  # the eager trainer, the graph's control
    assert chain.route(2, cuda, False, None, capture=False) == "eager"


# --------------------------------------------------------------------------- #
# SD_TRAIN_PROFILE=1: PhaseTimer and the records' phase keys
# --------------------------------------------------------------------------- #


def test_phase_timer_equals_jax():
    """The same samples through the port's and JAX's ``PhaseTimer``: the
    warm-up per name, ``skip_next``, ``phase``, ``timed_iter`` (its samples
    replaced by fixed ones) and the summary's keys and values."""
    from stable_diffusion_pytorch_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
    from stable_diffusion_pytorch_tpu_torch.utils.profiling import PhaseTimer

    rng = np.random.default_rng(0)
    script = [("add", name, float(x)) for name, x in zip(rng.choice(["fetch", "place", "dispatch", "sync"], 60),
                                                          rng.random(60))]
    script[10:10] = [("skip", "dispatch", 2)]
    script[25:25] = [("skip", "sync", 1)]
    timers = [PhaseTimer(warmup=2), JaxPhaseTimer(warmup=2)]
    for t in timers:
        assert t.summary_ms() == {}
        for op, name, x in script:
            t.add(name, x) if op == "add" else t.skip_next(name, x)
        with t.phase("phase"):
            pass
        assert list(t.timed_iter(range(4), "iter")) == [0, 1, 2, 3]
        t.samples["phase"], t.samples["iter"] = [0.5], [0.25, 0.75]  # the clock's samples, made equal
    got, want = (t.summary_ms() for t in timers)
    assert got == want and set(got) == {f"{n}_ms_{s}" for n in ("fetch", "place", "dispatch", "sync", "phase", "iter")
                                        for s in ("p50", "mean")}


def test_profile_records_carry_the_jax_trainers_phase_keys(tmp_path, monkeypatch, one_layer_text_encoder):
    """``SD_TRAIN_PROFILE=1``: ``train_unet.main`` on both sides (the JAX
    side's models, datasets and steps stood in) logs records with the same
    keys, step by step: the phases' p50 and mean once each has passed its
    warm-up."""
    import train_unet as jax_train_unet

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SD_TRAIN_PROFILE", "1")
    flags = [*MAIN_FLAGS, "--steps-per-dispatch", "1", "--gradient-accumulation-steps", "1"]
    train_unet.main([*TINY, *flags, "--ckpt-dir", "port/ckpt", "--logging-dir", "port/logs"])
    _jax_loop_only(monkeypatch)
    jax_train_unet.main([*flags, "--ckpt-dir", "jax/ckpt", "--logging-dir", "jax/logs"])
    keys = [[sorted(r) for r in _records(os.path.join(w, "logs", "train_unet_metrics.jsonl")) if "train_loss" in r]
            for w in ("port", "jax")]
    assert keys[0] == keys[1] and len(keys[0]) == 5
    assert {f"{p}_ms_{s}" for p in ("fetch", "place", "dispatch", "sync") for s in ("p50", "mean")} <= set(keys[0][-1])


def test_graph_route_replays_every_whole_window_and_steps_the_rest():
    """On the graph route at ``--steps-per-dispatch 1`` each optimizer step
    whose window the epoch holds is one dispatch; a resume's partial window
    and the epoch's remainder run micro step by micro step."""
    accum = 3
    plan = []

    class Stub:
        cfg = types.SimpleNamespace(train=types.SimpleNamespace(
            steps_per_dispatch=1, log_interval=2, gradient_accumulation_steps=accum, seed=0))
        _route, _metric_keys, eval_cadence_offset, device = "graph", ["loss"], 0, torch.device("cpu")
        _chunk_warm = _single_warm = False

        def _dispatch(self, window, m0, steps):
            plan.append(("step", m0, [int(b["m"][0]) for b in window]))
            return np.zeros((steps * accum, 1), np.float32)

        def _train_step(self, placed, generator):
            plan.append(("micro", int(placed["m"][0])))
            return {"loss": torch.zeros(())}

        def _place_batch(self, batch):
            return batch

        def _mean(self, x):
            return x

    batches = [{"x": np.zeros(1), "m": np.array([s])} for s in range(11)]
    stepper = trainer_mod.Trainer._micro_steps(Stub(), iter(batches), skip_until=1, micro_step0=1,
                                               step_timer=trainer_mod.StepTimer(), max_train_steps=9, ckpt_steps=2)
    list(stepper)
    assert plan == [("micro", 1), ("micro", 2), ("step", 3, [3, 4, 5]), ("step", 6, [6, 7, 8]), ("micro", 9),
                    ("micro", 10)]
