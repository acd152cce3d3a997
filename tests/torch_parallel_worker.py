"""One rank of the CPU process group of ``tests/test_torch_port_parallel.py`` (no jax).

    python tests/torch_parallel_worker.py INPUTS.pt RANK WORLD PORT OUT_DIR

Joins a gloo group at ``tcp://127.0.0.1:PORT`` (with a timeout, so that a
lost peer fails the run instead of hanging it) and runs every mode of the
test in turn on the tiny UNet the inputs describe, each from the same
weights: two optimizer steps of the port's UNet train step on this rank's
rows of the explicit global batches and draws, under data parallelism
(f32 AdamW and int8 Adam), ZeRO (both optimizers), FSDP, FSDP at
accumulation 2 (its reduce-scatters counted) and the gradient noise scale; tensor parallelism over both ranks (a forward, then two steps
on the whole batch, both optimizers); a ZeRO checkpoint written after two
steps and the unbroken run's third step; a resume at this world size from a
one-process checkpoint; ``train_unet.main`` and ``train_autoencoder.main``
(``--use-deepspeed``) for two steps each. Writes ``OUT_DIR/rank{RANK}.pt``.
With WORLD 4 it runs tensor parallelism with ZeRO instead
(:func:`tensor_parallel_with_zero`).
"""

from __future__ import annotations

import copy
import datetime
import json
import os
import sys
import time

import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, DDPMConfig, UnetConfig  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPTextTransformer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.parallel.data_parallel import DataParallel  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.parallel.fsdp import shard_module  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.parallel.mesh import combined_zero_dims, get_mesh, zero_dims  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.parallel.tensor_parallel import ModelGroup, shard_unet  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers import args as port_args  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.optim import build_optimizer  # noqa: E402
from stable_diffusion_pytorch_tpu_torch.trainers.steps import (  # noqa: E402
    TrainState,
    half_spans,
    make_unet_train_step,
    take_rows,
)
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

JOIN_TIMEOUT_S = 60


def models(inp):
    unet = UNetModel(4, 4, UnetConfig(**inp["unet_kw"]))
    unet.load_state_dict(inp["unet_sd"], strict=True)
    vae = AutoEncoderKL(AutoencoderConfig(**inp["vae_kw"]))
    vae.load_state_dict(inp["vae_sd"], strict=True)
    clip = CLIPTextTransformer(**inp["clip_kw"])
    clip.load_state_dict(inp["clip_sd"], strict=True)
    return unet, vae.eval().requires_grad_(False), clip.eval().requires_grad_(False)


def local_rows(batch, rank, rows):
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def build(inp, mode, group, mesh, world, gns=False, model=None, accum=1):
    """The tiny trainer state for ``mode``: dp, zero, fsdp, tp or tpzero
    (ZeRO on top of the model split; both with model group ``model``), a
    trailing 8 for int8 Adam; ``accum`` micro steps an optimizer step."""
    unet, vae, clip = models(inp)
    eight = mode.endswith("8")
    if mode == "fsdp":
        shard_module(unet, mesh)
    layouts = None
    if mode.startswith("tp"):
        split = shard_unet(unet, model)
        layouts = [split.get(n) for n, _ in unet.named_parameters()]
    params = [p for p in unet.parameters()]
    dims = None
    if mode.startswith("zero"):
        dims = zero_dims([p.shape for p in params], world, int8_block=256 if eight else None)
    elif mode.startswith("tpzero"):
        dims = combined_zero_dims([p.shape for p in params], layouts, model.size, world,
                                  int8_block=256 if eight else None)
    optim = port_args.OptimConfig(**inp["optim"], use_8bit_adam=eight)
    dp = DataParallel(params, group, dims, model=model, layouts=layouts, whole_model_leaves=eight)
    opt = build_optimizer(params, optim, max_train_steps=10, gradient_accumulation_steps=accum, data_parallel=dp)
    state = TrainState(unet, opt, with_ema=True)
    step, _ = make_unet_train_step(unet, clip, vae, make_schedule(DDPMConfig()), grad_noise_scale=gns,
                                   **inp["step_kw"])
    return state, step


def train(state, step, steps, rank, world, group):
    """Each step on this rank's rows; -> the global mean losses."""
    losses = []
    for batch, uncond, draws in steps:
        rows = next(iter(batch.values())).shape[0] // world
        out = step(state, local_rows(batch, rank, rows), uncond, take_rows(draws, rank * rows, (rank + 1) * rows))
        loss = out["loss"].detach().clone()
        dist.all_reduce(loss, group=group)
        losses.append(float(loss) / world)
    return losses


def tensor_parallel_with_zero(inp, rank, out_dir):
    """World 4, a (data 2, model 2) mesh: ZeRO on top of the model split
    (f32 AdamW and int8 Adam), two steps on this data rank's rows, the
    whole-layout state, the third step unbroken and from that state in a new
    split state; then ``train_unet.main`` with ``--tensor-parallel 2
    --shard-optimizer-state``. Writes ``OUT_DIR/tpzero_rank{RANK}.pt``."""
    mesh = get_mesh("cpu", 2)
    group = mesh.get_group("data")
    model = ModelGroup(mesh.get_group("model"), 2, mesh.get_local_rank("model"))
    d_rank, d_world = mesh.get_local_rank("data"), mesh.size(0)
    res = {"seconds": {}}
    for mode in ("tpzero", "tpzero8"):
        t0 = time.perf_counter()
        state, step = build(inp, mode, group, mesh, d_world, model=model)
        losses = train(state, step, inp["steps"][:2], d_rank, d_world, group)
        sd = copy.deepcopy(state.state_dict())
        res[mode] = {"losses": losses, "params": sd["params"], "ema": sd["ema_params"], "opt_state": sd["opt_state"],
                     "state_bytes": state.optimizer.state_bytes(),
                     "cut_leaves": sum(d is not None for d in state.optimizer.dp.dims)}
        train(state, step, inp["steps"][2:3], d_rank, d_world, group)
        resumed, step = build(inp, mode, group, mesh, d_world, model=model)
        resumed.load_state_dict(sd)
        train(resumed, step, inp["steps"][2:3], d_rank, d_world, group)
        res[mode]["step3"] = (state.state_dict()["params"], resumed.state_dict()["params"])
        res["seconds"][mode] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from stable_diffusion_pytorch_tpu_torch.scripts import train_unet

    work = os.path.join(out_dir, "main_tpzero")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    trainer = train_unet.main(["--device", "cpu", *inp["tpzero_argv"]])
    opt = trainer.state.optimizer
    res["main"] = {"count": opt.count, "global_batch": trainer.global_train_batch,
                   "model_size": trainer.model_group.size, "cut_leaves": sum(d is not None for d in opt.dp.dims),
                   "split_leaves": sum(lay is not None for lay in opt.dp.layouts)}
    res["seconds"]["main"] = time.perf_counter() - t0
    torch.save(res, os.path.join(out_dir, f"tpzero_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def record_dispatches() -> list:
    """Record each chained dispatch of the trainers: (first micro step,
    optimizer steps, device-to-host pulls) -> the list they land in."""
    from stable_diffusion_pytorch_tpu_torch.trainers import trainer as trainer_mod

    out, inner, pull = [], trainer_mod.Trainer._dispatch, torch.Tensor.cpu
    pulls = [0]

    def counted(self, *a, **k):
        pulls[0] += 1
        return pull(self, *a, **k)

    def recorded(self, window, micro0, steps):
        pulls[0] = 0
        torch.Tensor.cpu = counted
        try:
            return inner(self, window, micro0, steps)
        finally:
            torch.Tensor.cpu = pull
            out.append((micro0, steps, pulls[0]))

    trainer_mod.Trainer._dispatch = recorded
    return out


def main():
    inputs, rank, world, port, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    inp = torch.load(inputs, weights_only=False)
    if world == 4:
        return tensor_parallel_with_zero(inp, rank, out_dir)
    mesh = get_mesh("cpu")
    group = mesh.get_group("data")
    res = {"seconds": {}}

    for mode in ("dp", "zero", "dp8", "zero8", "fsdp"):
        t0 = time.perf_counter()
        state, step = build(inp, mode, group, mesh, world)
        losses = train(state, step, inp["steps"][:2], rank, world, group)
        sd = state.state_dict()
        res[mode] = {"losses": losses, "params": sd["params"], "ema": sd["ema_params"],
                     "state_bytes": state.optimizer.state_bytes(), "opt_state": sd["opt_state"]}
        res["seconds"][mode] = time.perf_counter() - t0

    # FSDP at accumulation 2: one window of the first two batches, the
    # reduce-scatters counted each micro step
    t0 = time.perf_counter()
    state, step = build(inp, "fsdp", group, mesh, world, accum=2)
    calls = {"n": 0}
    patched = {}
    for name in ("reduce_scatter_tensor", "reduce_scatter_single"):
        if hasattr(dist, name):
            def counted(*a, _f=getattr(dist, name), **k):
                calls["n"] += 1
                return _f(*a, **k)

            patched[name] = getattr(dist, name)
            setattr(dist, name, counted)
    micro = []
    try:
        for batch, uncond, draws in inp["steps"][:2]:
            rows = next(iter(batch.values())).shape[0] // world
            calls["n"] = 0
            out = step(state, local_rows(batch, rank, rows), uncond, take_rows(draws, rank * rows, (rank + 1) * rows))
            micro.append({"reduce_scatters": calls["n"], "grad_norm": float(out["grad_norm"]),
                          "grads_left": sum(p.grad is not None for p in state.params)})
    finally:
        for name, f in patched.items():
            setattr(dist, name, f)
    res["fsdp_accum"] = {"micro": micro, "count": state.optimizer.count, "params": state.state_dict()["params"]}
    res["seconds"]["fsdp_accum"] = time.perf_counter() - t0

    # tensor parallelism over both ranks (data 1, model 2): the forward, then the steps
    tp_mesh = get_mesh("cpu", world)
    model = ModelGroup(tp_mesh.get_group("model"), world, tp_mesh.get_local_rank("model"))
    for mode in ("tp", "tp8"):
        t0 = time.perf_counter()
        state, step = build(inp, mode, tp_mesh.get_group("data"), tp_mesh, 1, model=model)
        with torch.no_grad():
            forward = state.module(*inp["forward"])
        losses = train(state, step, inp["steps"][:2], 0, 1, tp_mesh.get_group("data"))
        sd = copy.deepcopy(state.state_dict())  # the whole tensors, kept apart from the ones step 3 moves
        res[mode] = {"forward": forward, "losses": losses, "params": sd["params"], "ema": sd["ema_params"],
                     "state_bytes": state.optimizer.state_bytes(),
                     "local_shapes": {n: tuple(p.shape) for n, p in state.module.named_parameters()}}
        # the third step, unbroken and from the whole-tensor state dict in a new split state
        train(state, step, inp["steps"][2:3], 0, 1, tp_mesh.get_group("data"))
        resumed, step = build(inp, mode, tp_mesh.get_group("data"), tp_mesh, 1, model=model)
        resumed.load_state_dict(sd)
        train(resumed, step, inp["steps"][2:3], 0, 1, tp_mesh.get_group("data"))
        res[mode]["step3"] = (state.state_dict()["params"], resumed.state_dict()["params"])
        res["seconds"][mode] = time.perf_counter() - t0

    # the gradient noise scale: the halves of the global batch, by rank
    t0 = time.perf_counter()
    state, step = build(inp, "dp", group, mesh, world, gns=True)
    batch, uncond, halves = inp["gns_step"]
    rows = next(iter(batch.values())).shape[0] // world
    spans = half_spans(rows, rank, world)
    out = step(state, local_rows(batch, rank, rows), uncond, [take_rows(d, *s) for d, s in zip(halves, spans)])
    res["gns"] = {"loss": float(out["loss"]), "gns_s": float(out["gns_s"]), "gns_g2": float(out["gns_g2"]),
                  "params": state.state_dict()["params"]}
    res["seconds"]["gns"] = time.perf_counter() - t0

    # a ZeRO checkpoint after two steps, then the unbroken run's third step
    t0 = time.perf_counter()
    state, step = build(inp, "zero", group, mesh, world)
    train(state, step, inp["steps"][:2], rank, world, group)
    sd = state.state_dict()
    if rank == 0:
        save_checkpoint(os.path.join(out_dir, "ckpt_w2"), sd)
    dist.barrier(group=group)
    train(state, step, inp["steps"][2:3], rank, world, group)
    res["unbroken_step3"] = state.state_dict()["params"]
    # the one-process checkpoint resumed here, and its third step
    state, step = build(inp, "zero", group, mesh, world)
    state.load_state_dict(load_checkpoint(inp["ckpt_w1"]))
    train(state, step, inp["steps"][2:3], rank, world, group)
    res["resumed_w1_step3"] = state.state_dict()["params"]
    res["seconds"]["checkpoint"] = time.perf_counter() - t0

    # the entry point a user calls, under this group
    t0 = time.perf_counter()
    from stable_diffusion_pytorch_tpu_torch.scripts import train_unet

    work = os.path.join(out_dir, "main")
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    trainer = train_unet.main(["--device", "cpu", *inp["main_argv"]])
    res["main"] = {"step": trainer.state.step, "count": trainer.state.optimizer.count,
                   "global_batch": trainer.global_train_batch, "loader_batches": len(trainer.train_loader),
                   "is_main": trainer.is_main_process}
    # the VAE entry point under the group, --use-deepspeed mapped to ZeRO, chained
    # dispatch on: each dispatch recorded with the device-to-host pulls it made
    from stable_diffusion_pytorch_tpu_torch.scripts import train_autoencoder

    dispatches = record_dispatches()
    os.makedirs(os.path.join(out_dir, "vae"), exist_ok=True)
    os.chdir(os.path.join(out_dir, "vae"))
    vae = train_autoencoder.main(["--device", "cpu", *inp["vae_argv"]])
    res["vae_main"] = {"count": vae.state.optimizer.count, "zero": vae.cfg.parallel.shard_optimizer_state,
                       "cut_leaves": sum(d is not None for d in vae.state.optimizer.dp.dims),
                       "chained": {"route": vae._route, "dispatches": list(dispatches)}}
    # the VAE entry point under data parallelism, per step and chained
    res["vae_ddp"] = {}
    for spd in (1, 2):
        dispatches.clear()
        os.makedirs(os.path.join(out_dir, f"vae_ddp{spd}"), exist_ok=True)
        os.chdir(os.path.join(out_dir, f"vae_ddp{spd}"))
        vae = train_autoencoder.main(["--device", "cpu", *inp["vae_ddp_argv"], "--steps-per-dispatch", str(spd)])
        losses = []
        if vae.is_main_process:  # rank 0 alone writes the metrics
            with open(vae.tracker.jsonl_path) as f:
                losses = [json.loads(line)["train_loss"] for line in f if "train_loss" in line]
        res["vae_ddp"][spd] = {"route": vae._route, "dispatches": list(dispatches), "losses": losses,
                               "zero": any(d is not None for d in vae.state.optimizer.dp.dims)}
    res["seconds"]["main"] = time.perf_counter() - t0
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier(group=group)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
