"""Sampler error against steps on a quickly trained tiny model (counterpart of tools/fid_samplers.py).

    FS_N=256 python -m stable_diffusion_pytorch_tpu_torch.scripts.fid_samplers [--device cuda]

The JAX tool's protocol, at its tiny configuration (UNet channels [16, 32],
4 heads, context 24; 1000 noise steps; sampled in latent space, no VAE):

1. QUICK-TRAIN the UNet from seeded random weights: ``FS_TRAIN_STEPS``
   (400) steps of eps matching in float32, Adam at 2e-3, batches of 16
   from synthetic context-conditioned data (x0 = w @ basis + 0.05 noise, the
   context tokens carry w), the context dropped for 10 % of the rows so the
   unconditional branch is trained too. An untrained net predicts eps ~ 0
   and its first step blows x0 up by 1 / sqrt(abar_T); ``FS_TRAIN_STEPS=0``
   perturbs the weights instead (``FS_PERTURB``, 0.02).
2. The TARGET: DDIM at ``FS_TARGET_STEPS`` (200) from the same contexts and
   initial noise as every grid entry; its floor, DDIM at the target's steps
   from independent initial noise.
3. For each (sampler, steps) of ``FS_GRID``
   ("ddim:10,20,25,50;dpmpp:10,15,20,25,50;ddpm:25,50"): the latent FID to
   the target (latents average-pooled ``FS_POOL`` x ``FS_POOL``, 8) and the
   paired latent RMSE (the deterministic samplers share x_T; DDPM's RMSE is
   its own noise, read its FID).

``FS_N`` (256) samples at ``FS_RES`` (32), CFG ``FS_GUIDANCE`` (2.0). The
initial noise of each batch comes from a torch generator seeded ``seed +
batch index``, DDPM's step noise from one seeded ``STEP_SEED`` further
(``sample_set`` takes both, so the tests can pass the JAX package's in).
On the card the quick-train's step is one CUDA graph (its draws made
first, a capturable Adam), and the loops run through the loop cache of a
``LatentDiffusion`` over the UNet (one graph per signature), unless
``capture=False`` is asked for; draws handed in run the eager loop.
Prints ONE JSON line, with the quick-train's first and last losses.
``--device`` (default ``cuda``; without a card the run stops unless given
``--device cpu``) is the port's own.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.config import DDPMConfig, UnetConfig
from stable_diffusion_pytorch_tpu_torch.models.build import init_weights, require_device, without_default_init
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import LatentDiffusion, make_sample_fn
from stable_diffusion_pytorch_tpu_torch.models.schedule import add_noise, make_schedule, schedule_on
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
from stable_diffusion_pytorch_tpu_torch.utils.fid import fid_from_features
from stable_diffusion_pytorch_tpu_torch.utils.graphs import GraphPool, module_tensors, replayed

UNET_KW = dict(num_res_blocks=1, n_heads=4, attention_resolutions=[1], channels_list=[16, 32], time_emb_dim=32,
               dropout=0.0, n_layers=1, context_dim=24)
CTX_DIM = UNET_KW["context_dim"]
CTX_TOKENS = 7
BATCH = 16
LR = 2e-3
DROP = 0.1  # the context dropout of the quick-train
SEEDS = {"target": 42, "floor": 4242}
STEP_SEED = 1_000_003  # DDPM's step-noise generators, apart from the initial noise's
DEFAULT_GRID = "ddim:10,20,25,50;dpmpp:10,15,20,25,50;ddpm:25,50"


def parse_grid(spec: str) -> List[tuple]:
    """"ddim:10,20;ddpm:25" -> [("ddim", 10), ("ddim", 20), ("ddpm", 25)]."""
    grid = []
    for part in spec.split(";"):
        name, _, steps = part.partition(":")
        grid += [(name.strip(), int(tok)) for tok in steps.split(",") if tok.strip()]
    return grid


def build_unet(seed: int, device="cpu") -> UNetModel:
    gen = torch.Generator().manual_seed(seed)
    with without_default_init():
        unet = UNetModel(4, 4, UnetConfig(**UNET_KW))
    with torch.no_grad():
        init_weights(unet, gen)
    return unet.float().to(device)


def make_basis(res: int) -> torch.Tensor:
    """The data's basis [ctx_dim, res, res, 4], each row at RMS 1 / sqrt(ctx_dim)."""
    basis = np.random.default_rng(0).standard_normal((CTX_DIM, res, res, 4)).astype(np.float32)
    basis /= np.sqrt((basis ** 2).mean(axis=(1, 2, 3), keepdims=True)) * np.sqrt(CTX_DIM)
    return torch.from_numpy(basis)


def make_batch(basis: torch.Tensor, gen: torch.Generator, n: int):
    """(x0 [n, res, res, 4], context tokens [n, 7, ctx_dim]) on the CPU."""
    w = torch.randn(n, CTX_DIM, generator=gen)
    x0 = torch.einsum("nc,chwd->nhwd", w, basis)
    x0 = x0 + 0.05 * torch.randn(x0.shape, generator=gen)
    return x0, w[:, None, :] + 0.1 * torch.randn(n, CTX_TOKENS, CTX_DIM, generator=gen)


def quick_train(unet: UNetModel, schedule, basis: torch.Tensor, steps: int, seed: int = 7,
                capture: bool = True) -> List[float]:
    """``steps`` of eps matching on ``unet``'s device, in float32 -> the
    losses. Each step's draws are made first on the CPU; on a CUDA device
    the step (forward, backward and a capturable Adam's update) is one CUDA
    graph, captured at the first step and replayed, unless ``capture`` is
    False (the same capturable Adam, eagerly); the losses stay on the
    device until the end."""
    device = next(unet.parameters()).device
    sched = schedule_on(schedule, device)
    opt = torch.optim.Adam(unet.parameters(), lr=LR, capturable=device.type == "cuda")
    gen = torch.Generator().manual_seed(seed)
    graphs = GraphPool("global")
    unet.train().requires_grad_(True)

    def step(batch):
        x0, tok, t, eps, keep = batch
        pred = unet(add_noise(sched, x0, eps, t), t, tok * keep)
        loss = ((pred.float() - eps) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = []
    for _ in range(steps):
        x0, tok = make_batch(basis, gen, BATCH)
        t = torch.randint(0, schedule.noise_steps, (BATCH,), generator=gen)
        eps = torch.randn(x0.shape, generator=gen)
        keep = (torch.rand(BATCH, generator=gen) >= DROP).float()[:, None, None]
        batch = tuple(a.to(device) for a in (x0, tok, t, eps, keep))
        losses.append(replayed(graphs, step, batch, what="the quick-train step", capture=capture,
                               pinned=lambda: [*module_tensors(unet)(), *(s for st in opt.state.values()
                                                                           for s in st.values())]))
    unet.eval().requires_grad_(False)
    return torch.stack(losses).cpu().tolist() if losses else []


def perturb(unet: UNetModel, scale: float, seed: int = 99) -> None:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen).to(p.device))


def initial_noise(seed: int, n: int, res: int) -> List[torch.Tensor]:
    """Each batch's x_T ~ N(0, 1), from a generator seeded ``seed + i`` (i the batch's first row)."""
    return [torch.randn((min(BATCH, n - i), res, res, 4), generator=torch.Generator().manual_seed(seed + i))
            for i in range(0, n, BATCH)]


def loop_model(unet: UNetModel, schedule, capture: bool = True) -> LatentDiffusion:
    """The latent-space model whose loop cache runs the tool's loops."""
    return LatentDiffusion(unet, None, None, schedule, capture=capture)


@torch.no_grad()
def sample_set(unet, schedule, sampler: str, steps: int, ctx_bank: np.ndarray, x_Ts: Sequence[torch.Tensor],
               guidance: float, step_noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
               seed: int = 0) -> np.ndarray:
    """Latents [N, res, res, 4] float32 from ``x_Ts`` over ``ctx_bank`` batch
    by batch, the unconditional context all zeros; DDPM's step noise is
    ``step_noise[j]`` where given (the eager loop), else from a CPU
    generator seeded ``seed + STEP_SEED + 16 j`` (through the loop cache of
    ``unet``, a :func:`loop_model`, or of a model made over it)."""
    model = unet if isinstance(unet, LatentDiffusion) else loop_model(unet, schedule)
    device = model.device
    fn = make_sample_fn(model.unet, schedule, num_steps=steps, sampler=sampler, guidance_scale=guidance)
    out = []
    for j, x_T in enumerate(x_Ts):
        ctx = torch.from_numpy(ctx_bank[j * BATCH: j * BATCH + len(x_T)]).to(device)
        generator = torch.Generator().manual_seed(seed + STEP_SEED + j * BATCH)
        x_T = x_T.to(device)
        if step_noise is None:
            x0 = model.sample_loop(x_T, ctx, steps, sampler=sampler, guidance_scale=guidance)(
                x_T, ctx, torch.zeros_like(ctx), generator)
        else:
            x0 = fn(x_T, ctx, torch.zeros_like(ctx), noise=[n.to(device) for n in step_noise[j]], generator=generator)
        out.append(x0.float().cpu().numpy())
    return np.concatenate(out)


def latent_features(z: np.ndarray, pool: int = 8) -> np.ndarray:
    """Latents [N, h, w, c] average-pooled over ``pool`` x ``pool`` cells, flattened."""
    z = np.asarray(z, np.float64)
    n, hh, ww, cc = z.shape
    ph, pw = hh // pool, ww // pool
    z = z[:, : ph * pool, : pw * pool]
    return z.reshape(n, ph, pool, pw, pool, cc).mean(axis=(2, 4)).reshape(n, -1)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))


def curve(unet, schedule, grid, ctx_bank, n: int, res: int, target_steps: int, guidance: float, pool: int) -> dict:
    """The target, its floor and each grid entry's latent FID and RMSE to the target."""
    target = sample_set(unet, schedule, "ddim", target_steps, ctx_bank, initial_noise(SEEDS["target"], n, res),
                        guidance)
    target_feat = latent_features(target, pool)
    floor = sample_set(unet, schedule, "ddim", target_steps, ctx_bank, initial_noise(SEEDS["floor"], n, res), guidance)
    rows = []
    for sampler, steps in grid:
        s = sample_set(unet, schedule, sampler, steps, ctx_bank, initial_noise(SEEDS["target"], n, res), guidance,
                       seed=SEEDS["target"])
        rows.append({"sampler": sampler, "steps": steps,
                     "fid_latent_vs_target": round(fid_from_features(target_feat, latent_features(s, pool)), 4),
                     "rmse_latent_vs_target": round(rmse(s, target), 4)})
    return {"target": f"ddim@{target_steps}",
            "fid_floor_target_vs_target": round(fid_from_features(target_feat, latent_features(floor, pool)), 4),
            "latent_rms": round(float(np.sqrt(np.mean(np.square(target.astype(np.float64))))), 4), "curve": rows}


def main(argv=None) -> dict:
    """Train, sample the grid and print the JSON line -> its dict."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")
    parser.add_argument("--seed", type=int, default=0, help="of the random weights")
    ns = parser.parse_args(argv)
    try:
        device = require_device(ns.device)
    except RuntimeError as exc:
        raise SystemExit(f"fid_samplers: {exc}") from None
    env = os.environ.get
    n, res = int(env("FS_N", "256")), int(env("FS_RES", "32"))
    train_steps = int(env("FS_TRAIN_STEPS", "400"))
    schedule = make_schedule(DDPMConfig(noise_steps=1000))
    basis = make_basis(res)
    unet = build_unet(ns.seed, device)
    losses = []
    if train_steps:
        losses = quick_train(unet, schedule, basis, train_steps)
    else:
        perturb(unet, float(env("FS_PERTURB", "0.02")))
    unet.eval().requires_grad_(False)
    model = loop_model(unet, schedule)
    ctx_bank = make_batch(basis, torch.Generator().manual_seed(1234), n)[1].numpy()
    result = {"metric": "sampler_quality_vs_steps_latent_fid", "n_images": n,
              "train_steps": train_steps, "train_loss_first": losses[0] if losses else None,
              "train_loss_last": losses[-1] if losses else None,
              **curve(model, schedule, parse_grid(env("FS_GRID", DEFAULT_GRID)), ctx_bank, n, res,
                      int(env("FS_TARGET_STEPS", "200")), float(env("FS_GUIDANCE", "2.0")), int(env("FS_POOL", "8")))}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
