"""Multi-device training of the port, against the JAX package, on the CPU.

- The placement rules (no process group): for every leaf of the SD-1.5
  UNet and 2, 4 and 8 ranks, the torch dim the port shards is the JAX axis
  of ``zero_shardings``, of ``trainers/adam8bit.py:shard_plan`` and of
  ``tp_shardings`` (the port's ``shard_unet`` split, on a meta-device UNet)
  under ``utils/convert.py``'s transposes (read through the
  converter itself: each JAX leaf is a broadcast view numbered along its
  sharded axis, and the port's dim is the one along which the converted view
  varies); and ``adam8bit_plan`` over the 2-, 4- and 8-rank shard shapes
  keeps each quantization block in one work item.
- One spawned group of 2 gloo ranks (``tests/torch_parallel_worker.py``;
  each rank one thread, a free port, a join timeout, and a hard wait here
  that kills both and fails on a hang) runs the tiny UNet of
  ``tests/test_torch_port_train_step.py`` from the JAX package's weights
  under data parallelism, ZeRO (f32 AdamW and int8 Adam), FSDP and the
  gradient noise scale, a checkpoint round trip across world sizes and
  ``train_unet.main``. The JAX side runs in this process, while the ranks
  run, on a 2-device mesh (``tests/conftest.py`` forces 8 host devices): the
  global batch of 2 rows sharded over it, the parameters replicated, the
  same draws; its train step is compiled once as the gradient function
  (:class:`_GradsOut`) and the package's optimizer (f32 AdamW, int8 Adam)
  and EMA update follow it.

Limits (f32 on both sides, those of ``tests/test_torch_port_train_step.py``):
the loss 1e-5 relative, the parameters and EMA after two steps 1e-5
absolute (a tenth of one update at learning rate 1e-4), port against port
too (ZeRO, FSDP, world 1 and world 2, where only the order of the sums
differs: AdamW divides each gradient element by its own magnitude, so an
element within rounding of zero moves by another fraction of the learning
rate); the moments within 1e-4 of their leaf's largest (the gradient limit
of that test); int8 codes at most one apart; ZeRO's optimizer bytes per rank
at most 0.6 of the replicated run's.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_port_train_step as ts  # noqa: E402

from stable_diffusion_pytorch_tpu.models import presets as jax_presets  # noqa: E402
from stable_diffusion_pytorch_tpu.models import schedule as jax_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu.models import unet as jax_unet  # noqa: E402
from stable_diffusion_pytorch_tpu.parallel import mesh as jax_mesh  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import adam8bit as jax_adam8bit  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import args as jax_args  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import optim as jax_optim  # noqa: E402
from stable_diffusion_pytorch_tpu.trainers import steps as jax_steps  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig, load_config  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.ops.adam8bit_update import adam8bit_plan  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.parallel.tensor_parallel import ModelGroup, shard_unet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import args as port_args  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_optimizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState, make_unet_train_step  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils import convert  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 2
GROUP_TIMEOUT_S = 240  # the whole spawned group, then both ranks are killed
LR_TOL = 0.1 * ts.OPTIM["learning_rate"]
TINY_RUN = ["--dataset", "synthetic", "--resolution", "32", "--max-train-steps", "2", "--train-batch-size", "1",
            "--eval-batch-size", "1", "--max-train-samples", "8", "--max-val-samples", "2", "--log-interval", "2",
            "--checkpointing-steps", "2", "--ckpt-dir", "ckpt", "--channels-list", "32,64", "--n-heads", "4",
            "--time-emb-dim", "64", "--n-layers", "1", "--autoencoder-channels-list", "16,32", "--groups", "8"]
MAIN_ARGV = [*TINY_RUN, "--num-devices", str(WORLD), "--shard-optimizer-state"]
TPZERO_WORLD = 4  # a (data 2, model 2) group: ZeRO on top of tensor parallelism
TPZERO_ARGV = [*TINY_RUN, "--tensor-parallel", "2", "--shard-optimizer-state"]
VAE_BASE = ["--dataset", "synthetic", "--resolution", "32", "--max-train-steps", "2", "--train-batch-size", "1",
            "--eval-batch-size", "1", "--max-train-samples", "8", "--max-val-samples", "2", "--max-test-samples", "1",
            "--log-interval", "0", "--gradient-accumulation-steps", "1", "--autoencoder-channels-list", "16,32",
            "--groups", "8", "--num-devices", str(WORLD)]
VAE_ARGV = [*VAE_BASE, "--use-deepspeed", "--steps-per-dispatch", "2"]  # ZeRO, chained
VAE_DDP_ARGV = [*VAE_BASE, "--max-train-steps", "4"]  # data parallelism
# per-row prompt dropout, so that each rank keeps its rows' uniforms, and an EMA
STEP_KW = dict(cfg_dropout_prob=0.5, ema_decay=0.9)


# --------------------------------------------------------------------------- #
# the placement rules over the SD-1.5 UNet's leaves
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def sd15_shapes():
    cfg = jax_presets.sd15_unet_config()
    unet = jax_unet.UNetModel.from_config(4, 4, cfg)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 77, 768)))
    return cfg, shapes


def _marked(shapes, axes):
    """Each JAX leaf as a read-only view numbered along its axis (zeros where None)."""
    def leaf(s, a):
        if a is None:
            return np.broadcast_to(np.zeros((), np.int16), s.shape)
        line = np.arange(s.shape[a], dtype=np.int16).reshape([-1 if i == a else 1 for i in range(len(s.shape))])
        return np.broadcast_to(line, s.shape)

    return jax.tree_util.tree_map(leaf, shapes, axes)


def _varying_dim(arr):
    """The one dim along which ``arr`` varies, or None."""
    origin = arr[(0,) * arr.ndim]
    dims = [d for d in range(arr.ndim) if arr.shape[d] > 1
            and arr[tuple(1 if i == d else 0 for i in range(arr.ndim))] != origin]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


def _spec_axis(spec, axis_name):
    hits = [i for i, s in enumerate(spec) if s == axis_name]
    return hits[0] if hits else None


def _jax_axes(kind, n, shapes):
    if kind == "zero":
        mesh = jax_mesh.get_mesh(n)
        return jax.tree_util.tree_map(lambda s: _spec_axis(s.spec, jax_mesh.DATA_AXIS),
                                      jax_mesh.zero_shardings(mesh, shapes))
    if kind == "int8":
        mesh = jax_mesh.get_mesh(n)

        def axis(s):
            plan = jax_adam8bit.shard_plan(s.shape, 256, mesh)
            return None if plan is None else _spec_axis(plan[0], jax_mesh.DATA_AXIS)

        return jax.tree_util.tree_map(axis, shapes)
    mesh = jax_mesh.get_mesh(8, model_parallel=n)
    return jax.tree_util.tree_map(lambda s: _spec_axis(s.spec, jax_mesh.MODEL_AXIS),
                                  jax_mesh.tp_shardings(mesh, shapes))


def tensor_parallel_dims(t):
    """{name: the dim the port splits it along, or None} of the SD-1.5 UNet
    over ``t`` model ranks (``shard_unet`` on a meta-device UNet)."""
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel

    with torch.device("meta"):
        unet = UNetModel(4, 4, presets.sd15_unet_config())
    layouts = shard_unet(unet, ModelGroup(None, t, 0))
    return {name: (layouts[name][0] if name in layouts else None) for name, _ in unet.named_parameters()}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["zero", "int8", "tp"])
def test_shard_dims_match_jax_axes_under_the_converter(kind, n):
    cfg, shapes = sd15_shapes()
    axes = _jax_axes(kind, n, shapes)
    marked = convert.unet_state_dict(_marked(shapes, axes), cfg)
    if kind == "tp":
        ours = tensor_parallel_dims(n)
    else:
        ours = {name: (port_mesh.zero_dim(a.shape, n) if kind == "zero" else port_mesh.int8_shard_dim(a.shape, n))
                for name, a in marked.items()}
    assert len(marked) == 686
    want = {name: _varying_dim(a) for name, a in marked.items()}
    if kind == "tp":  # the GEGLU bias, whole in JAX, splits with its weight's rows: each rank adds its slice
        assert all(ours.pop(k) == 0 and want.pop(k) is None for k in list(ours) if k.endswith("net.0.proj.bias"))
    assert ours == want
    # the cut leaves hold nearly every parameter (ZeRO), or the attention and FFN weights (TP)
    numel = {name: int(np.prod(a.shape)) for name, a in marked.items()}
    share = sum(numel[k] for k, d in want.items() if d is not None) / sum(numel.values())
    assert share > (0.99 if kind != "tp" else 0.2), share
    if kind == "int8":  # the int8 rule never cuts along dim 0, where the blocks run, at the SD-1.5 widths
        assert all(d != 0 for d in ours.values())


@pytest.mark.parametrize("n,t", [(2, 2), (2, 4), (4, 2)])
def test_combined_zero_dims_match_jax_combine_zero(n, t):
    """ZeRO on top of tensor parallelism: over ``n`` data ranks and ``t``
    model ranks, the port's dim for every SD-1.5 leaf (``combined_zero_dim``
    of the whole leaf beside its model split) is the data axis of JAX
    ``combine_zero`` over ``tp_shardings``, under the converter's transposes;
    the GEGLU bias, which the port splits over the model group and JAX keeps
    whole, stays whole over the data group in the port."""
    cfg, shapes = sd15_shapes()
    mesh = jax_mesh.get_mesh(n * t, model_parallel=t)
    axes = jax.tree_util.tree_map(lambda s: _spec_axis(s.spec, jax_mesh.DATA_AXIS),
                                  jax_mesh.combine_zero(mesh, shapes, jax_mesh.tp_shardings(mesh, shapes)))
    marked = convert.unet_state_dict(_marked(shapes, axes), cfg)
    split = tensor_parallel_dims(t)
    ours = {name: port_mesh.combined_zero_dim(a.shape, n, split[name]) for name, a in marked.items()}
    want = {name: _varying_dim(a) for name, a in marked.items()}
    bias = [k for k in ours if k.endswith("net.0.proj.bias")]
    assert bias and all(ours.pop(k) is None and want.pop(k) == 0 for k in bias)
    assert ours == want
    assert all(ours[k] != split[k] for k in ours if split[k] is not None and ours[k] is not None)
    # the pieces a rank holds: combined_zero_dims from the split shapes gives the same dims
    names = list(marked)
    layouts = [None if split[k] is None else (split[k], 1) for k in names]
    pieces = [port_mesh.local_shape(marked[k].shape, split[k], t) for k in names]
    got = port_mesh.combined_zero_dims(pieces, layouts, t, n)
    assert {k: d for k, d in zip(names, got) if k not in bias} == ours
    assert sum(d is not None for d in ours.values()) > 600


@pytest.mark.parametrize("n", [2, 4, 8])
def test_k9_plan_keeps_blocks_whole_over_zero_shards(n):
    """``adam8bit_plan`` over a rank's shard shapes: each leaf's blocks are
    those of the whole leaf restricted to the rank's columns (same rows per
    block, same block count), so K9 needs no other plan per shard."""
    cfg, shapes = sd15_shapes()
    port = [a.shape for a in convert.unet_state_dict(_marked(shapes, jax.tree_util.tree_map(lambda s: None, shapes)),
                                                      cfg).values()]
    dims = port_mesh.zero_dims(port, n, int8_block=256)
    local = [port_mesh.local_shape(s, d, n) for s, d in zip(port, dims)]
    whole, shard = adam8bit_plan(port), adam8bit_plan(local)
    for s, d, a, b in zip(port, dims, whole.leaves, shard.leaves):
        assert (a.o, a.block, a.nb) == (b.o, b.block, b.nb)
        assert b.r * (n if d is not None else 1) == a.r
    assert sum(d is not None for d in dims) > 250


# --------------------------------------------------------------------------- #
# the 2-rank group against the JAX package on 2 devices
# --------------------------------------------------------------------------- #


def _steps(n):
    """(global batch, uncond, draws) of ``n`` steps, the JAX test's batches and keys."""
    out = []
    for i in range(n):
        batch, uncond = ts.batch_and_uncond(10 + i)
        out.append((batch, uncond, jax.random.PRNGKey(20 + i)))
    return out


class _GradsOut:
    """A JAX fused transform that applies nothing and hands the step's
    gradients out as its state: the JAX train step as a gradient function."""

    def init(self, params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def apply(self, grads, state, params):
        return params, grads


@functools.lru_cache(maxsize=None)
def jax_gradient_step():
    """The JAX package's UNet train step, jitted once over the 2-device mesh
    (the global batch sharded, the weights replicated), giving the gradients."""
    unet_cfg, vae_cfg, (j_unet, j_vae, j_clip), (u, v, c) = ts.jax_models()
    sched = jax_schedule.make_schedule(jax_schedule.DDPMConfig())
    train_step, _ = jax_steps.make_unet_train_step(j_unet, j_clip, j_vae, sched, _GradsOut(), **STEP_KW)
    mesh = jax_mesh.get_mesh(WORLD)
    return jax.jit(train_step), mesh, jax_mesh.put_replicated(mesh, c), jax_mesh.put_replicated(mesh, v)


_jax_ema_update = jax.jit(jax_steps._ema_update)  # as the package's jitted train step runs it


def jax_gradient_compiled() -> None:
    """Compile the gradient step: its first call, on the first step's inputs."""
    step, mesh, c, v = jax_gradient_step()
    batch, uncond, key = _steps(1)[0]
    params = jax_mesh.put_replicated(mesh, ts.jax_models()[3][0])
    jax.block_until_ready(step(jax_steps.TrainState.create(params, _GradsOut()), c, v,
                               jax_mesh.put_batch(mesh, {k: jnp.asarray(a) for k, a in batch.items()}),
                               jnp.asarray(uncond), key))


@functools.lru_cache(maxsize=None)
def jax_update(use_8bit: bool):
    """The package's optimizer (``build_optimizer``'s transform) and its update
    (``_optimizer_step``) compiled ahead of time for replicated leaves on the
    2-device mesh -> (transform, compiled update). Compiling runs nothing on
    the devices, so it may overlap the other JAX work."""
    _, mesh, _, _ = jax_gradient_step()
    tx = jax_optim.build_optimizer(jax_args.OptimConfig(**ts.OPTIM, use_8bit_adam=use_8bit), max_train_steps=10)
    rep = jax_mesh.replicated(mesh)

    def spec(tree):
        return jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(np.shape(a), a.dtype, sharding=rep), tree)

    params = spec(ts.jax_models()[3][0])
    update = jax.jit(functools.partial(jax_steps._optimizer_step, tx))
    return tx, update.lower(params, spec(jax.eval_shape(tx.init, params)), params).compile()


@functools.lru_cache(maxsize=None)
def jax_on_two_devices(use_8bit: bool):
    """Two JAX steps on the 2-device mesh -> (metrics, params, EMA): the
    package's gradient (one compile for both optimizers), then its optimizer
    (``build_optimizer``'s transform, ``_optimizer_step``) and EMA update.
    Its device work runs on the calling thread alone: two threads running
    programs on the CPU mesh at once have deadlocked (their eager EMA
    updates)."""
    step, mesh, c, v = jax_gradient_step()
    u = ts.jax_models()[3][0]
    tx, update = jax_update(use_8bit)
    rep = jax_mesh.replicated(mesh)
    params = ema = jax_mesh.put_replicated(mesh, u)
    opt_state = jax.device_put(tx.init(params), rep)
    metrics = []
    for batch, uncond, key in _steps(2):
        grads_state, m = step(jax_steps.TrainState.create(params, _GradsOut()), c, v,
                              jax_mesh.put_batch(mesh, {k: jnp.asarray(a) for k, a in batch.items()}),
                              jnp.asarray(uncond), key)
        params, opt_state = update(jax.device_put(grads_state.opt_state, rep), opt_state, params)
        ema = _jax_ema_update(ema, params, STEP_KW["ema_decay"])
        metrics.append(m)
    return metrics, params, ema


def _port_inputs(work):
    unet_cfg, vae_cfg, _, (u, v, c) = ts.jax_models()
    torch_steps = [(ts._torch_batch(b), torch.from_numpy(un), ts.jax_draws(k)) for b, un, k in _steps(3)]
    batch, uncond = ts.batch_and_uncond(30)
    halves = tuple(ts.jax_draws(jax.random.PRNGKey(40 + h), bsz=1, latent=(1, 8, 8, 4)) for h in range(2))
    return {
        "unet_kw": ts.UNET_KW, "vae_kw": ts.VAE_KW, "clip_kw": ts.CLIP_KW, "step_kw": STEP_KW, "optim": ts.OPTIM,
        "unet_sd": convert.to_torch(convert.unet_state_dict(u, unet_cfg)),
        "vae_sd": convert.to_torch(convert.autoencoder_state_dict(v, vae_cfg)),
        "clip_sd": convert.to_torch(convert.clip_state_dict(c)),
        "steps": torch_steps, "gns_step": (ts._torch_batch(batch), torch.from_numpy(uncond), halves),
        "forward": tuple(torch.from_numpy(np.asarray(a)) for a in forward_inputs()),
        "ckpt_w1": str(work / "ckpt_w1"), "main_argv": MAIN_ARGV, "vae_argv": VAE_ARGV, "tpzero_argv": TPZERO_ARGV,
        "vae_ddp_argv": VAE_DDP_ARGV,
    }


def forward_inputs():
    """(x_t, timesteps, context) of the tensor-parallel forward."""
    rng = np.random.default_rng(50)
    return (rng.standard_normal((2, 8, 8, 4)).astype(np.float32), np.array([3, 700], np.int32),
            rng.standard_normal((2, 77, 16)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_tensor_parallel_forward():
    """The JAX UNet forward with ``tp_shardings`` on a (data 1, model 2) mesh."""
    unet_cfg, _, (j_unet, _, _), (u, _, _) = ts.jax_models()
    mesh = jax_mesh.get_mesh(2, model_parallel=2)
    params = jax.device_put(u, jax_mesh.tp_shardings(mesh, u))
    x, t, ctx = (jax_mesh.put_replicated(mesh, jnp.asarray(a)) for a in forward_inputs())
    with mesh:
        return np.asarray(jax.jit(j_unet.apply)(params, x, t, ctx))


def _one_process(inp, gns=False, steps=(), accum=1):
    """The port on one process (no group) from the inputs' weights -> (state, step)."""
    import torch_parallel_worker as worker

    unet, vae, clip = worker.models(inp)
    params = list(unet.parameters())
    opt = build_optimizer(params, port_args.OptimConfig(**inp["optim"]), max_train_steps=10,
                          gradient_accumulation_steps=accum)
    state = TrainState(unet, opt, with_ema=True)
    step, _ = make_unet_train_step(unet, clip, vae, make_schedule(DDPMConfig()), grad_noise_scale=gns, **inp["step_kw"])
    for batch, uncond, draws in steps:
        step(state, batch, uncond, draws)
    return state, step


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Run the 2-rank group and, beside it, the 4-rank tensor-parallel ZeRO
    group once -> (inputs, rank 0's results, rank 1's, work dir); the 4-rank
    group's records are ``work / tpzero_rank{r}.pt``."""
    work = tmp_path_factory.mktemp("parallel")
    inp = _port_inputs(work)
    state, _ = _one_process(inp, steps=inp["steps"][:2])
    save_checkpoint(inp["ckpt_w1"], state.state_dict())
    torch.save(inp, work / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    ranks = [(WORLD, r) for r in range(WORLD)] + [(TPZERO_WORLD, r) for r in range(TPZERO_WORLD)]
    ports = {WORLD: _free_port(), TPZERO_WORLD: _free_port()}
    logs = [open(work / f"world{w}_rank{r}.log", "w") for w, r in ranks]
    procs = [subprocess.Popen([sys.executable, WORKER, str(work / "inputs.pt"), str(r), str(w), str(ports[w]),
                               str(work)], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(work))
             for (w, r), log in zip(ranks, logs)]
    try:
        # the JAX side, while the ranks run: both optimizer updates compile on
        # other threads (XLA compiles without the GIL) while this one runs
        # every program on the devices, one at a time
        jax_gradient_step()
        with ThreadPoolExecutor(2) as pool:
            compiles = [pool.submit(jax_update, use_8bit) for use_8bit in (True, False)]
            jax_tensor_parallel_forward()
            jax_gradient_compiled()
            for c in compiles:
                c.result()
        jax_on_two_devices(False)
        jax_on_two_devices(True)
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = "\n".join((work / f"world{w}_rank{r}.log").read_text()[-3000:] for w, r in ranks)
    assert all(p.returncode == 0 for p in procs), f"rank exit codes {[p.returncode for p in procs]}:\n{tails}"
    return inp, *(torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)), work


def _close(got: dict, want: dict, atol: float) -> None:
    assert sorted(got) == sorted(want)
    for name in want:
        torch.testing.assert_close(got[name].float(), want[name].float(), rtol=0, atol=atol, msg=name)


@pytest.mark.parametrize("mode", ["dp", "zero", "dp8", "zero8", "fsdp", "tp", "tp8"])
def test_two_ranks_match_jax_on_two_devices(group, mode):
    _, r0, r1, _ = group
    metrics, params, ema = jax_on_two_devices(mode.endswith("8"))
    unet_cfg = ts.jax_models()[0]
    for got, jm in zip(r0[mode]["losses"], metrics):
        np.testing.assert_allclose(got, float(jm["loss"]), rtol=1e-5)
    assert r0[mode]["losses"] == r1[mode]["losses"]
    _close(r0[mode]["params"], convert.to_torch(convert.unet_state_dict(params, unet_cfg)), LR_TOL)
    _close(r0[mode]["ema"], convert.to_torch(convert.unet_state_dict(ema, unet_cfg)), LR_TOL)


@pytest.mark.parametrize("mode,ref", [("zero", "dp"), ("zero8", "dp8"), ("fsdp", "dp")])
def test_sharded_modes_equal_data_parallel(group, mode, ref):
    _, r0, r1, _ = group
    _close(r0[mode]["params"], r0[ref]["params"], LR_TOL)
    _close(r1[mode]["params"], r0[mode]["params"], 0.0)  # every rank gathers the same whole tensors
    for key in ("mu", "nu") if mode != "zero8" else ("mu_q", "nu_q"):
        for a, b in zip(r0[mode]["opt_state"][key], r0[ref]["opt_state"][key]):
            assert a.shape == b.shape
            if mode == "zero8":
                assert (a.int() - b.int()).abs().max() <= 1
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))


def test_tensor_parallel_forward_matches_jax_and_splits_the_geglu_halves(group):
    """The forward over the model group of 2 equals the JAX package's with
    ``tp_shardings`` (the limits of JAX ``test_tensor_parallel_forward_matches_replicated``;
    a GEGLU split that gave one rank the value half and the other the gate
    half would not); each rank keeps half the heads' rows of ``to_q``/
    ``to_k``/``to_v``, half of ``proj``'s rows and bias, the matching half of
    the columns of the output projections, and the rest whole."""
    inp, r0, r1, _ = group
    want = jax_tensor_parallel_forward()
    full = inp["unet_sd"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["tp"]["forward"].numpy(), want, rtol=2e-4, atol=2e-4)
        for name, shape in r["tp"]["local_shapes"].items():
            whole = tuple(full[name].shape)
            if name.endswith(("to_q.weight", "to_k.weight", "to_v.weight", "net.0.proj.weight", "net.0.proj.bias")):
                assert (shape[0] * WORLD, *shape[1:]) == whole, name
            elif name.endswith(("attn.out.0.weight", "ffn.net.2.weight")):
                assert (shape[0], shape[1] * WORLD) == whole, name
            else:
                assert shape == whole, name


@pytest.mark.parametrize("mode,ref", [("zero", "dp"), ("zero8", "dp8")])
def test_zero_cuts_optimizer_bytes_per_rank(group, mode, ref):
    _, r0, r1, _ = group
    for r in (r0, r1):
        assert r[mode]["state_bytes"] <= 0.6 * r[ref]["state_bytes"], (r[mode]["state_bytes"], r[ref]["state_bytes"])


@pytest.mark.parametrize("mode", ["tp", "tp8"])
def test_tensor_parallel_state_resumes_from_the_whole_layout(group, mode):
    """The split state's checkpoint layout is whole tensors; a new split state
    loaded from it takes the unbroken run's third step (int8: the whole
    leaves each rank keeps for the update taken up from the loaded weights)."""
    _, r0, _, _ = group
    unbroken, resumed = r0[mode]["step3"]
    _close(resumed, unbroken, 0.0)


def test_world_two_equals_world_one_at_the_same_global_batch(group):
    inp, r0, _, _ = group
    state, _ = _one_process(inp, steps=inp["steps"][:2])
    _close(r0["dp"]["params"], state.state_dict()["params"], LR_TOL)


def test_fsdp_reduces_once_per_optimizer_step_under_accumulation(group):
    """FSDP at accumulation 2: the window's first micro step reduce-scatters
    nothing and leaves no gradient (FSDP holds it; the norm it reports is
    NaN), the last reduce-scatters once per FSDP block and applies the
    window's mean; the result equals one process at the same global batch
    and accumulation."""
    inp, r0, r1, _ = group
    for r in (r0, r1):
        first, last = r["fsdp_accum"]["micro"]
        assert first["reduce_scatters"] == 0 and first["grads_left"] == 0 and np.isnan(first["grad_norm"])
        assert last["reduce_scatters"] > 0 and np.isfinite(last["grad_norm"])
        assert r["fsdp_accum"]["count"] == 1
    state, _ = _one_process(inp, steps=inp["steps"][:2], accum=2)
    assert state.optimizer.count == 1
    _close(r0["fsdp_accum"]["params"], state.state_dict()["params"], LR_TOL)
    _close(r1["fsdp_accum"]["params"], r0["fsdp_accum"]["params"], 0.0)


@pytest.mark.parametrize("mode,ref", [("tpzero", "tp"), ("tpzero8", "tp8")])
def test_tensor_parallel_with_zero_matches_jax_and_tensor_parallel(group, mode, ref):
    """ZeRO on top of tensor parallelism (JAX ``combine_zero``), world 4 as
    (data 2, model 2): two steps on each data rank's row equal the JAX
    package on 2 devices and the model-split run without ZeRO, every rank
    gathers the same whole tensors, each rank keeps at most 0.6 of that
    run's optimizer bytes, and the whole-layout state resumes into a new
    split state at the unbroken run's third step."""
    _, r0, _, work = group
    ranks = [torch.load(work / f"tpzero_rank{r}.pt", weights_only=False) for r in range(TPZERO_WORLD)]
    metrics, params, ema = jax_on_two_devices(mode.endswith("8"))
    unet_cfg = ts.jax_models()[0]
    for got, jm in zip(ranks[0][mode]["losses"], metrics):
        np.testing.assert_allclose(got, float(jm["loss"]), rtol=1e-5)
    _close(ranks[0][mode]["params"], convert.to_torch(convert.unet_state_dict(params, unet_cfg)), LR_TOL)
    _close(ranks[0][mode]["ema"], convert.to_torch(convert.unet_state_dict(ema, unet_cfg)), LR_TOL)
    _close(ranks[0][mode]["params"], r0[ref]["params"], LR_TOL)
    for r in ranks[1:]:
        assert r[mode]["losses"] == ranks[0][mode]["losses"]
        _close(r[mode]["params"], ranks[0][mode]["params"], 0.0)
    for r in ranks:
        assert r[mode]["cut_leaves"] > 10
        assert r[mode]["state_bytes"] <= 0.6 * r0[ref]["state_bytes"], (r[mode]["state_bytes"], r0[ref]["state_bytes"])
        unbroken, resumed = r[mode]["step3"]
        _close(resumed, unbroken, 0.0)
    for key in ("mu", "nu") if mode == "tpzero" else ("mu_q", "nu_q"):
        for a, b in zip(ranks[0][mode]["opt_state"][key], ranks[1][mode]["opt_state"][key]):
            assert a.shape == b.shape and torch.equal(a, b)


def test_train_unet_main_runs_tensor_parallel_with_zero(group):
    """``train_unet.main`` with ``--tensor-parallel 2 --shard-optimizer-state``
    under 4 gloo ranks: the data axis of 2, the model groups of 2, leaves
    both split and cut, two optimizer steps."""
    _, _, _, work = group
    for r in range(TPZERO_WORLD):
        main = torch.load(work / f"tpzero_rank{r}.pt", weights_only=False)["main"]
        assert main["count"] == 2 and main["global_batch"] == 2 and main["model_size"] == 2
        assert main["cut_leaves"] > 10 and main["split_leaves"] > 4


def test_grad_noise_scale_halves_are_the_global_batch_halves(group):
    """At world 2 half 1 is rank 0's row, half 2 rank 1's: the estimator, the
    loss and the step equal one process's over the global batch."""
    inp, r0, r1, _ = group
    state, step = _one_process(inp, gns=True)
    batch, uncond, halves = inp["gns_step"]
    out = step(state, batch, uncond, list(halves))
    for key in ("loss", "gns_s", "gns_g2"):
        np.testing.assert_allclose(r0["gns"][key], float(out[key]), rtol=1e-5, err_msg=key)
        assert r0["gns"][key] == r1["gns"][key]
    _close(r0["gns"]["params"], state.state_dict()["params"], LR_TOL)


def test_zero_checkpoint_resumes_across_world_sizes(group):
    """A checkpoint of world 2 (ZeRO: its moments gathered) resumed on one
    process takes the unbroken run's third step; one of a single process
    resumed at world 2 does the same."""
    inp, r0, _, work = group
    saved = load_checkpoint(str(work / "ckpt_w2"))
    assert saved["opt_state"]["mu"][0].shape == saved["params"][next(iter(saved["params"]))].shape
    state, step = _one_process(inp)
    state.load_state_dict(saved)
    batch, uncond, draws = inp["steps"][2]
    step(state, batch, uncond, draws)
    _close(state.state_dict()["params"], r0["unbroken_step3"], LR_TOL)
    state, _ = _one_process(inp, steps=inp["steps"][:3])
    _close(r0["resumed_w1_step3"], state.state_dict()["params"], LR_TOL)


def test_train_unet_main_under_two_gloo_ranks(group):
    """``train_unet.main`` under the group: two optimizer steps (of the
    default 4 micro steps) at a global batch of 2 (one row per rank), rank 0
    writing the metrics and the checkpoint."""
    _, r0, r1, work = group
    for r, res in enumerate((r0, r1)):
        assert res["main"] == {"step": 8, "count": 2, "global_batch": 2, "loader_batches": 4, "is_main": r == 0}
    with open(work / "main" / "logs" / "train_unet_metrics.jsonl") as f:
        records = [line for line in f if "train_loss" in line]
    assert len(records) == 2
    assert os.path.isdir(work / "main" / "ckpt" / "checkpoint-2")


def test_chained_dispatch_under_two_ranks_takes_the_chunk_rule_with_one_pull(group):
    """``--steps-per-dispatch 2`` under the group runs chunks without a CUDA
    graph (no collective is captured), by the JAX rule, one device-to-host
    pull each, through the VAE entry point: under ZeRO its 2 steps in one
    chunk; under data parallelism its 4 steps in two chunks, the losses
    those of the per-step run, bit for bit."""
    _, r0, r1, _ = group
    for res in (r0, r1):
        assert res["vae_main"]["chained"] == {"route": "eager", "dispatches": [(0, 2, 1)]}
        per_step, chained = res["vae_ddp"][1], res["vae_ddp"][2]
        assert per_step["route"] is None and per_step["dispatches"] == [] and not per_step["zero"]
        assert chained["route"] == "eager" and chained["dispatches"] == [(0, 2, 1), (2, 2, 1)]
    assert r0["vae_ddp"][2]["losses"] == r0["vae_ddp"][1]["losses"] and len(r0["vae_ddp"][1]["losses"]) == 4
    assert r1["vae_ddp"][2]["losses"] == r1["vae_ddp"][1]["losses"] == []  # rank 1 logs nothing


def test_train_autoencoder_main_maps_use_deepspeed_to_zero_under_two_ranks(group):
    _, r0, r1, _ = group
    for res in (r0, r1):
        assert res["vae_main"]["count"] == 2 and res["vae_main"]["zero"]
        assert res["vae_main"]["cut_leaves"] > 10


# --------------------------------------------------------------------------- #
# one process: the flags
# --------------------------------------------------------------------------- #


def test_use_deepspeed_maps_to_zero_in_the_unet_and_vae_clis(tmp_path, monkeypatch, caplog):
    from stable_diffusion_pytorch_tpu_torch.scripts import train_unet
    from stable_diffusion_pytorch_tpu_torch.utils.tracking import get_logger

    _, cfg = load_config(["--use-deepspeed"])
    assert cfg.train.use_deepspeed and not cfg.parallel.shard_optimizer_state
    logger = get_logger("t")
    for mapped in (True, False):
        got, _ = train_unet.parse_training_flags(["--use-deepspeed", "--device", "cpu"], "t", logger, mapped)
        assert got.parallel.shard_optimizer_state is mapped
    monkeypatch.chdir(tmp_path)
    trainer = train_unet.build_trainer(["--device", "cpu", "--use-deepspeed", *TINY_RUN])
    assert trainer.cfg.parallel.shard_optimizer_state and trainer.world == 1
