#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stable_diffusion_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line; any failure exits nonzero:

1. env: the card (``nvidia-smi`` name and power limit), torch/CUDA/Triton
   versions, and the time to build the CUDA kernels from ``csrc/``.
2. kernels: every ported kernel against its plain PyTorch version on the card,
   at every distinct shape the main paths launch, recorded from a one-step run
   of each (the 512x512 txt2img slice; 1024x1024 txt2img; the hires fix's
   refine; one micro step of SD-1.5 training at 512x512, batch 4, and at
   1024x1024, batch 1, taken with an optimizer that applies nothing): flash
   attention forward (K1, also at the kv > 9216 shapes of the TPU's K2),
   its fused backward (K3) and its split backward (K4/K5, at its own shapes
   and at every K3 shape, K4's domain; launched twice, and the two results
   must agree bit for bit), CUDA C++; GroupNorm (K6), its backward (K7, which
   also serves the concat form's backward) and GroupNorm-concat (K8), Triton.
   In float32 (TF32 off) and bfloat16: max-abs error with its tolerance; the
   kernel's, the plain version's and the library call's times (CUDA events,
   median of 5 runs of 5 launches); and the bound: the larger of bytes / 3.35
   TB/s and FLOPs / peak (989 TFLOP/s bf16, 67 TFLOP/s f32; H100 SXM data
   sheet). The plain attention versions hold f32 [B, H, N, M] scores; past
   2^30 elements they run one (batch, head) at a time (``plain_per_head`` in
   the record), the same per-row math.
3. unet_parity: one SD-1.5-size UNet forward (full widths, 64x64 latent) in
   float32 on the card with the kernels, against the same weights and inputs
   on the CPU through the plain path (a deliberate CPU reference).
4. train_parity: one SD-1.5-size UNet forward and backward (32x32 latent,
   batch 1) in float32, card with the kernels vs CPU through the plain path:
   the relative gradient error overall and of the worst tensor; then the
   training step's precision (bf16 autocast over the same f32 weights) vs
   f32 on the card: output drift and gradient drift.
5. slice: ``pipeline.sample`` at 512x512, DDIM with CFG 7.5, bf16, seeded
   random weights; checks the decoded image is [B, 512, 512, 3] and finite and
   that each forward kernel was launched by this run; seconds per step and
   images/s.
6. hires: (a) ``pipeline.sample`` at 1024x1024, DDIM with CFG 7.5, bf16,
   whole decode: the image is [1, 1024, 1024, 3] and finite and K1 ran at kv
   16384; seconds per step, images/s, peak memory. (b) the hires fix: 512x512
   base, ``hires_scale=2``, ``hires_strength=0.6``, ``vae_tile=64``, a
   1024x1024 image from finite tiles; then its stages timed one by one (base
   loop, refine, tiled and whole decode of the refined latent) and the max
   difference between the tiled and the whole decode (no limit: the JAX
   package calls tiled decode an approximation); ``torch.profiler`` over two
   1024x1024 DDIM steps: device ms per step by kernel category.
7. train: the UNet trainer in process at SD-1.5 width, 512x512, batch 4,
   synthetic data, bf16 compute over f32 parameters, gradient accumulation 4
   (the default), two optimizer steps and one evaluation; checks a finite
   loss, changed parameters and that its five kernels (all but the split
   backward) were launched by this run; samples/s, step ms p50, peak memory.
   Then ``torch.profiler`` over one more accumulation window: device ms per
   micro step by kernel category and the device's idle share (the
   profiler's own cost included).
8. hires_train: the same at 1024x1024, batch 1: the 16384-token
   self-attention's backward runs the split kernels, the rest K3; all six
   kernels must be launched by this run.
9. checkpoint: a small-width run on the card saves ``checkpoint-2``; a second
   trainer resumed from ``latest`` holds exactly the saved state.

Then, each on its own line: the ``nvidia-smi`` name/power-limit line, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}`` last. In
the summary, ``launches`` counts phases 5 to 8 (each run with the counts set
to 0 just before it; the split is in the JSON record); ``max_abs_err``,
``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` are phase 2's bfloat16
numbers summed over the kernel's distinct shapes (one launch of each).
Without a CUDA device, or outside a checkout of the repository, it exits
nonzero and prints no result. Weights are random from a seed, with the
zero-initialized layers (each ResBlock's last conv, each transformer's
proj_out) filled too, so every path contributes to the outputs and gradients.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0          # of the random weights
STEPS = 10        # DDIM steps of the slice and hires runs
NUM_IMAGES = 1    # per slice run; CFG doubles the UNet batch
HIRES = 1024      # image side of the hires runs: a 128x128 latent, 16384 tokens
HIRES_BASE = HIRES // 2  # the hires fix's first stage, upscaled x2
HIRES_TILE = 64   # latent tile of the hires fix's tiled decode
TRAIN_BATCH = 4
HIRES_TRAIN_BATCH = 1
TRAIN_STEPS = 2   # optimizer steps of each train phase (x4 micro steps)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TPU_KERNELS = {
    "flash_attention": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/flash_attention.cu",
                        "stable_diffusion_pytorch_tpu/ops/flash_attention.py:45 _fa_kernel (K1), "
                        ":113 _fa_kernel_stream (K2)"),
    "flash_attention_bwd": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/flash_attention_bwd.cu",
                            "stable_diffusion_pytorch_tpu/ops/flash_attention_bwd.py:102"),
    "flash_attention_bwd_split": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/flash_attention_bwd_split.cu",
                                  "stable_diffusion_pytorch_tpu/ops/flash_attention_bwd.py:51 _dq_kernel, "
                                  ":61 _dkv_kernel (K4); :355 _sbwd_stats_kernel, :406 _sbwd_dq_kernel, "
                                  ":443 _sbwd_dkv_kernel (K5)"),
    "group_norm": ("triton", "stable_diffusion_pytorch_tpu_torch/ops/groupnorm_triton.py",
                   "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:44"),
    "group_norm_bwd": ("triton", "stable_diffusion_pytorch_tpu_torch/ops/groupnorm_triton.py",
                       "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:71"),
    "group_norm_cat": ("triton", "stable_diffusion_pytorch_tpu_torch/ops/groupnorm_triton.py",
                       "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:187"),
}
SLICE_KERNELS = ("flash_attention", "group_norm", "group_norm_cat")
TRAIN_KERNELS = tuple(k for k in TPU_KERNELS if k != "flash_attention_bwd_split")  # at 512px
# the SD-1.5 stack (models/presets.py) as training-CLI flags
SD15_FLAGS = (
    "--channels-list 320,640,1280,1280 --n-heads 8 --attention-resolutions 1,2,4 --num-res-blocks 2 "
    "--time-emb-dim 1280 --context-dim 768 --n-layers 1 --dropout 0 "
    "--autoencoder-channels-list 128,256,512,512 --autoencoder-num-res-blocks 2 --groups 32"
).split()
TINY_FLAGS = (
    "--channels-list 32,64 --n-heads 4 --time-emb-dim 64 --n-layers 1 "
    "--autoencoder-channels-list 16,32 --groups 8"
).split()


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def launch_counts() -> dict:
    """Each kernel's launches since the counts were last set to 0, and those
    of K1 at kv > 9216 (the shapes the TPU's streaming forward, K2, took)."""
    from stable_diffusion_pytorch_tpu_torch.ops import native

    counts = {name: native.COUNTERS[name].count for name in TPU_KERNELS}
    counts["flash_attention_kv_past_9216"] = sum(
        n for key, n in native.COUNTERS["flash_attention"].shapes.items() if key[2] > 9216)
    return counts


def cuda_ms(fn, iters: int = 5, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean CUDA-event time of ``iters`` launches,
    after 3 warm-up calls (the median keeps one host stall out of the number)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def fill_zero_weights(module, generator) -> None:
    """Seeded values for the weights the JAX-style init leaves at zero."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            if p.dim() > 1 and not p.any():
                p.normal_(0.0, 0.5 * p[0].numel() ** -0.5, generator=generator)


def build_sd15(device, dtype, seed: int):
    import torch

    from stable_diffusion_pytorch_tpu_torch.config import ClipConfig
    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import build_models

    model = build_models(
        presets.sd15_unet_config(), presets.sd15_autoencoder_config(), ClipConfig(model_dir=None),
        presets.sd15_ddpm_config(), dtype=dtype, device=device, seed=seed,
    )
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for m in (model.unet, model.autoencoder):
        fill_zero_weights(m, gen)
    return model


def train_argv(work: str, *flags: str):
    return ["--device", "cuda", "--dataset", "synthetic", "--seed", str(SEED),
            "--logging-dir", os.path.join(work, "logs"), "--ckpt-dir", os.path.join(work, "ckpt"), *flags]


def build_sd15_trainer(work: str, resolution: int, batch: int):
    """The training entry point's trainer at SD-1.5 width."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer

    shutil.rmtree(work, ignore_errors=True)
    trainer = build_trainer(train_argv(
        work, *SD15_FLAGS, "--resolution", str(resolution), "--train-batch-size", str(batch),
        "--eval-batch-size", str(batch), "--max-train-steps", str(TRAIN_STEPS), "--lr-warmup-steps", "0",
        "--learning-rate", "1e-4", "--max-train-samples", str(16 * batch), "--max-val-samples", str(batch),
        "--log-interval", str(TRAIN_STEPS), "--dataloader-num-workers", "4",
    ))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    fill_zero_weights(trainer.model.unet, gen)
    fill_zero_weights(trainer.model.autoencoder, gen)
    return trainer


def phase_env() -> dict:
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    triton = native.import_triton()
    t0 = time.perf_counter()
    native.load_library()
    build_s = time.perf_counter() - t0
    info = {
        "phase": "env", "gpu": gpu_line(), "device": torch.cuda.get_device_name(0),
        "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "triton": triton.__version__, "cuda_build_s": build_s,
    }
    emit(info)
    return info


# --------------------------------------------------------------------------- #
# phase 2: each kernel against its plain version, its library call and its bound
# --------------------------------------------------------------------------- #


def _elem(dtype) -> int:
    return 4 if dtype == "float32" else 2


# The plain attention versions hold f32 [B, H, N, M] scores (the backward about
# three such); past this many elements they run one (batch, head) at a time
# (one head's scores at 16384 tokens: 2^28 elements, 1 GiB).
PLAIN_SCORES_MAX = 2 ** 30


def _per_head(plain, *tensors, scale):
    """``plain`` on one (batch, head) slice of [B, L, H, D] tensors at a time,
    written into whole outputs: the same math, row by row."""
    b, h = tensors[0].shape[0], tensors[0].shape[2]
    outs = None
    for i in range(b):
        for j in range(h):
            parts = plain(*(t[i:i + 1, :, j:j + 1] for t in tensors), scale)
            parts = parts if isinstance(parts, tuple) else (parts,)
            if outs is None:
                outs = [p.new_empty((b, p.shape[1], h, p.shape[3])) for p in parts]
            for o, p in zip(outs, parts):
                o[i:i + 1, :, j:j + 1] = p
    return outs[0] if len(outs) == 1 else tuple(outs)


def _plain_attn(plain, key, *tensors, scale):
    """(the plain version as a callable, whether it runs per (batch, head))."""
    b, n, m, h, _ = key
    if b * h * n * m > PLAIN_SCORES_MAX:
        return (lambda: _per_head(plain, *tensors, scale=scale)), True
    return (lambda: plain(*tensors, scale)), False


def _attn_case(key, dtype, gen):
    """K1 at [B, N, M, H, D]: (kernel, plain, library, flops, bytes, record)."""
    import torch
    import torch.nn.functional as F

    from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    b, n, m, h, d = key
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(getattr(torch, dtype)) for s in (n, m, m))
    scale = d ** -0.5
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    plain, per_head = _plain_attn(flash_attention_plain, key, q, k, v, scale=scale)
    return (
        lambda: flash_attention(q, k, v, scale),
        plain,
        lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
        4 * b * h * n * m * d,
        _elem(dtype) * (2 * b * n * h * d + 2 * b * m * h * d),
        {"plain_per_head": per_head},
    )


def _attn_bwd_case(key, dtype, gen, split: bool = False):
    """K3 (or, with ``split``, K4/K5) at [B, N, M, H, D], given the K1
    forward's output and lse. Both bounds count the 10 B H N M D FLOPs of
    the five products the gradient needs, so the two rows compare."""
    import torch
    import torch.nn.functional as F

    from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import (
        _forward_kernel,
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_bwd_split,
    )

    b, n, m, h, d = key
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt) for s in (n, m, m, n))
    scale = d ** -0.5
    out, lse = _forward_kernel(q, k, v, scale, with_lse=True)
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    do_h = do.transpose(1, 2)
    kernel = flash_attention_bwd_split if split else flash_attention_bwd
    plain, per_head = _plain_attn(flash_attention_bwd_plain, key, q, k, v, do, scale=scale)
    return (
        lambda: kernel(q, k, v, out, do, lse, scale),
        plain,
        lambda: torch.autograd.grad(lib_out, leaves, do_h, retain_graph=True),
        10 * b * h * n * m * d,
        _elem(dtype) * 4 * (b * n * h * d + b * m * h * d),
        {"plain_per_head": per_head},
    )



def _gn_inputs(shape, c, gen, offset=0.5):
    import torch

    x = torch.randn(*shape, device="cuda", generator=gen) * 2.0 + offset
    w = 1.0 + 0.3 * torch.randn(c, device="cuda", generator=gen)
    b = 0.3 * torch.randn(c, device="cuda", generator=gen)
    return x, w, b


def _torch_gn(x, w, b, g, silu):
    """F.group_norm (+ F.silu) on a channel-last [B, S, C] map."""
    import torch.nn.functional as F

    y = F.group_norm(x.transpose(1, 2), g, w.to(x.dtype), b.to(x.dtype), 1e-5)
    return F.silu(y) if silu else y


def _gn_case(key, dtype, gen):
    """K6 at [B, S, C, groups, silu]."""
    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import xla_group_norm

    import torch

    b, s, c, g, silu = key
    x, w, bias = _gn_inputs((b, s, c), c, gen)
    x = x.to(getattr(torch, dtype))
    return (
        lambda: fused_group_norm(x, w, bias, g, 1e-5, silu),
        lambda: xla_group_norm(x, w, bias, g, 1e-5, silu),
        lambda: _torch_gn(x, w, bias, g, silu),
        (12 if silu else 8) * x.numel(),
        _elem(dtype) * 2 * x.numel(),
    )


def _gn_cat_case(key, dtype, gen):
    """K8 at [B, S, C1, C2, groups, silu]."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm_cat
    from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import xla_group_norm_cat

    b, s, c1, c2, g, silu = key
    x, w, bias = _gn_inputs((b, s, c1), c1 + c2, gen)
    skip = (_gn_inputs((b, s, c2), c2, gen, offset=-1.0)[0] * 1.5).to(getattr(torch, dtype))
    x = x.to(getattr(torch, dtype))
    n = x.numel() + skip.numel()
    return (
        lambda: fused_group_norm_cat(x, skip, w, bias, g, 1e-5, silu),
        lambda: xla_group_norm_cat(x, skip, w, bias, g, 1e-5, silu),
        lambda: _torch_gn(torch.cat([x, skip], dim=-1), w, bias, g, silu),
        (12 if silu else 8) * n,
        _elem(dtype) * 2 * n,
    )


def _gn_bwd_case(key, dtype, gen):
    """K7 at [B, S, C1, C2, groups, silu] (C2 > 0: the concat form's
    backward), given the K6/K8 forward's statistics."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import (
        _forward,
        group_norm_bwd,
        group_norm_bwd_plain,
    )

    b, s, c1, c2, g, silu = key
    dt = getattr(torch, dtype)
    x, w, bias = _gn_inputs((b, s, c1), c1 + c2, gen)
    parts = [x.to(dt)]
    if c2:
        parts.append((_gn_inputs((b, s, c2), c2, gen, offset=-1.0)[0] * 1.5).to(dt))
    dy = torch.randn(b, s, c1 + c2, device="cuda", generator=gen).to(dt)
    _, mean, rstd = _forward(parts[0], parts[1] if c2 else None, w, bias, g, 1e-5, silu)
    leaves = [t.detach().requires_grad_(True) for t in (*parts, w, bias)]
    whole = torch.cat(leaves[:len(parts)], dim=-1) if c2 else leaves[0]
    lib_out = _torch_gn(whole, leaves[-2], leaves[-1], g, silu)
    dy_t = dy.transpose(1, 2)
    n = b * s * (c1 + c2)
    return (
        lambda: group_norm_bwd(parts, dy, w, bias, mean, rstd, g, 1e-5, silu),
        lambda: group_norm_bwd_plain(parts, dy, w, bias, g, 1e-5, silu),
        lambda: torch.autograd.grad(lib_out, leaves, dy_t, retain_graph=True),
        (24 if silu else 16) * n,
        _elem(dtype) * 3 * n,
    )


# Tolerances on max|kernel - plain| of each output, relative to max(1, max|plain|)
# of that output:
# float32 -- another summation order over at most a few thousand terms (the
# backward: sums over up to 4096 kv or 40960 map rows, and K3's dq is summed
# with atomics in an order that changes between runs);
# bfloat16 -- both sides round outputs (and attention's P) to bf16, whose
# spacing is 2^-7 of the magnitude, so a few ulps; K3's delta = rowsum(dO * O)
# reads the bf16-rounded O where the plain version sums dP * P in f32. The
# split backward (K4/K5) sums over up to 16384 rows without atomics; the same
# limits as K3.
TOLERANCE = {
    "flash_attention": {"float32": 1e-5, "bfloat16": 2e-2},
    "flash_attention_bwd": {"float32": 1e-4, "bfloat16": 2e-2},
    "flash_attention_bwd_split": {"float32": 1e-4, "bfloat16": 2e-2},
    "group_norm": {"float32": 5e-5, "bfloat16": 2e-2},
    "group_norm_bwd": {"float32": 1e-4, "bfloat16": 2e-2},
    "group_norm_cat": {"float32": 5e-5, "bfloat16": 2e-2},
}
CASES = {"flash_attention": _attn_case, "flash_attention_bwd": _attn_bwd_case,
         "flash_attention_bwd_split": functools.partial(_attn_bwd_case, split=True),
         "group_norm": _gn_case, "group_norm_bwd": _gn_bwd_case, "group_norm_cat": _gn_cat_case}


class _NoUpdate:
    """An optimizer for the shape probe: takes the gradients, applies nothing."""

    def step(self, grads):
        import torch

        return False, torch.zeros(())


def record_shapes(model, trainers) -> dict:
    """The distinct launch shapes of each kernel: one-step runs of txt2img at
    512x512 and at 1024x1024 and of the hires fix (a one-step base and a
    one-step refine), and one training micro step of each trainer (parameters
    untouched). The split backward is also held at every K3 shape (K4's
    domain: ``SD_FLASH_BWD=split`` sends every length to it)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native
    from stable_diffusion_pytorch_tpu_torch.trainers.steps import TrainState
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    shapes = {name: set() for name in TPU_KERNELS}

    def collect():
        torch.cuda.synchronize()
        for name in TPU_KERNELS:
            shapes[name] |= {k[:-1] for k in native.COUNTERS[name].shapes}
        native.reset_counters()

    native.reset_counters()
    with torch.inference_mode():
        for size, hires in ((512, {}), (HIRES, {}),
                            (HIRES_BASE, {"hires_scale": 2.0, "hires_strength": 0.6, "vae_tile": HIRES_TILE})):
            pipeline.sample(model, image_size=size, prompt="a photo of a cat", time_steps=1,
                            guidance_scale=7.5, save_dir=None, num_images=NUM_IMAGES, seed=0, **hires)
            collect()
    for trainer in trainers:
        batch = trainer._place_batch(next(iter(trainer.train_loader)))
        probe = TrainState(trainer.model.unet, _NoUpdate())
        trainer._train(probe, batch, trainer.uncond_ids, trainer._draws(batch, step_generator("cuda", 9)))
        collect()
    shapes["flash_attention_bwd_split"] |= shapes["flash_attention_bwd"]
    return {name: sorted(v) for name, v in shapes.items()}


def _bound(flops: float, nbytes: float, dtype: str):
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _max_err(out, ref):
    """(max-abs error, max over outputs of error / max(1, max|plain output|))."""
    pairs = list(zip(_flat(out), _flat(ref))) if isinstance(out, (list, tuple)) else [(out, ref)]
    errs = [((o.float() - r.float()).abs().max().item(), max(1.0, r.float().abs().max().item())) for o, r in pairs]
    return max(e for e, _ in errs), max(e / s for e, s in errs)


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flat(x)
        else:
            yield x


def phase_kernels(shapes: dict) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows, failures = [], []
    summary = {name: {"max_rel_err": {}, "ms_bf16": 0.0, "plain_ms_bf16": 0.0, "library_ms_bf16": 0.0,
                      "bound_ms_bf16": 0.0, "ops_bound_ms_bf16": 0.0, "bytes_bound_ms_bf16": 0.0,
                      "max_abs_err_bf16": 0.0}
               for name in TPU_KERNELS}
    for name, keys in shapes.items():
        for key in keys:
            for dname in ("float32", "bfloat16"):
                kernel, plain, library, flops, nbytes, *record = CASES[name](key, dname, gen)
                out, ref = kernel(), plain()
                # the split backward has no atomics: a second launch must agree bit for bit
                again = kernel() if name == "flash_attention_bwd_split" else out
                torch.cuda.synchronize()
                err, rel = _max_err(out, ref)
                identical = again is out or all(torch.equal(a, b) for a, b in zip(again, out))
                tol = TOLERANCE[name][dname]
                del out, ref, again
                ms, plain_ms, library_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
                bound_ms, bound_by = _bound(flops, nbytes, dname)
                row = {"k": name, "shape": list(key), "dtype": dname, "err": err, "rel_err": rel, "tol": tol, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "flops": flops, "bytes": nbytes, "repeat_identical": identical, **(record[0] if record else {})}
                rows.append(row)
                s = summary[name]
                s["max_rel_err"][dname] = max(s["max_rel_err"].get(dname, 0.0), rel)
                if dname == "bfloat16":
                    s["ms_bf16"] += ms
                    s["plain_ms_bf16"] += plain_ms
                    s["library_ms_bf16"] += library_ms
                    s["bound_ms_bf16"] += bound_ms
                    s["ops_bound_ms_bf16" if bound_by == "operations" else "bytes_bound_ms_bf16"] += bound_ms
                    s["max_abs_err_bf16"] = max(s["max_abs_err_bf16"], err)
                if not (rel <= tol and identical):
                    failures.append(row)
                del kernel, plain, library
            torch.cuda.empty_cache()
    result = {"phase": "kernels", "ok": not failures, "n_shapes": {k: len(v) for k, v in shapes.items()},
              "summary": summary, "failures": failures, "shapes": rows}
    emit({k: v for k, v in result.items() if k != "shapes"})
    check(all(shapes.get(name) for name in TPU_KERNELS), f"a kernel recorded no shape in the probe runs: "
          f"{ {k: len(shapes.get(k, [])) for k in TPU_KERNELS} }")
    check(not failures, f"kernel disagrees with its plain version: {failures}")
    return result


# --------------------------------------------------------------------------- #
# phases 3-4: the SD-1.5 UNet in f32, card (kernels) vs CPU (plain path)
# --------------------------------------------------------------------------- #


def _sd15_unet_pair(seed: int):
    import copy

    import torch

    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import cast_for_inference, init_weights
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("cuda"):
        unet = UNetModel(4, 32, presets.sd15_unet_config())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init_weights(unet, gen)
    fill_zero_weights(unet, gen)
    cast_for_inference(unet, torch.float32)
    return unet, copy.deepcopy(unet).cpu()


def phase_unet_parity(seed: int) -> dict:
    """SD-1.5 UNet in float32: CUDA (kernels, TF32 off) vs CPU (plain path)."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    unet, cpu_unet = _sd15_unet_pair(seed)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, 64, 64, 4, generator=g)
    t = torch.tensor([601], dtype=torch.int32)
    ctx = torch.randn(1, 77, 768, generator=g)
    native.reset_counters()
    with torch.inference_mode():
        out = unet(x.cuda(), t.cuda(), ctx.cuda()).cpu()
        torch.cuda.synchronize()
        launches = {k: native.COUNTERS[k].count for k in SLICE_KERNELS}
        t0 = time.perf_counter()
        ref = cpu_unet(x, t, ctx)
        cpu_s = time.perf_counter() - t0
    err = (out - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    # f32 on both sides; sums over up to 11520 terms per conv output taken in
    # another order, through ~60 normalized layers: 1e-3 of the output scale
    tol = 1e-3 * scale
    res = {"phase": "unet_parity", "cpu_reference": True, "shape": list(out.shape), "max_abs_err": err,
           "max_abs_ref": ref.abs().max().item(), "tol": tol, "cuda_launches": launches,
           "cpu_forward_s": cpu_s, "ok": err <= tol and all(launches.values())}
    emit(res)
    check(bool(torch.isfinite(out).all()), "non-finite UNet output on CUDA")
    check(all(launches.values()), f"a kernel was not launched by the CUDA UNet forward: {launches}")
    check(err <= tol, f"UNet f32 CUDA vs CPU max abs err {err} > {tol}")
    return res


# Limits of the f32 gradient parity: both sides f32 with sums in another order
# (cuDNN vs CPU convs, kernels vs plain attention and GroupNorm, K3's atomic
# dq) through ~60 layers forward and back; the forward alone agrees to ~4e-6
# of its scale, so 1e-4 overall leaves room for the backward's longer sums,
# and 1e-3 for the tensor whose gradient is smallest against that error.
GRAD_REL_LIMIT = 1e-4
GRAD_TENSOR_REL_LIMIT = 1e-3
# bf16 compute (autocast over the same f32 weights) vs f32 on the card: the
# JAX package's SD-1.5 UNet drifts 0.0108 (PARITY_FULLSCALE.json, one draw of
# random weights); bf16 keeps 8 mantissa bits and the drift compounds over
# ~60 layers, so the port is held to 2e-2 of the output scale
BF16_DRIFT_LIMIT = 2e-2


def phase_train_parity(seed: int) -> dict:
    """SD-1.5 UNet forward + backward in float32 at a 32x32 latent, batch 1."""
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    unet, cpu_unet = _sd15_unet_pair(seed)
    g = torch.Generator().manual_seed(seed + 2)
    x = torch.randn(1, 32, 32, 4, generator=g)
    t = torch.tensor([301], dtype=torch.int32)
    ctx = torch.randn(1, 77, 768, generator=g)
    w = torch.randn(1, 32, 32, 4, generator=g)
    grads, outs = [], []
    native.reset_counters()
    for module, dev in ((unet, "cuda"), (cpu_unet, "cpu")):
        module.requires_grad_(True)
        t0 = time.perf_counter()
        out = module(x.to(dev), t.to(dev), ctx.to(dev))
        (out * w.to(dev)).sum().backward()
        outs.append(out.detach().cpu())
        grads.append({n: p.grad.detach().cpu() for n, p in module.named_parameters()})
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: native.COUNTERS[k].count for k in TRAIN_KERNELS}
        else:
            cpu_s = time.perf_counter() - t0
    card, cpu = grads

    # the training step's precision: bf16 autocast over the same f32 weights
    unet.zero_grad(set_to_none=True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out_bf = unet(x.cuda(), t.cuda(), ctx.cuda())
    (out_bf.float() * w.cuda()).sum().backward()
    bf_out = out_bf.detach().float().cpu()
    bf_drift = (bf_out - outs[0]).abs().max().item() / max(1.0, outs[0].abs().max().item())
    bf_grad = math.sqrt(sum(((p.grad.detach().cpu() - card[n]).double() ** 2).sum().item()
                            for n, p in unet.named_parameters()) / sum((g.double() ** 2).sum().item()
                                                                       for g in card.values()))
    diff2 = sum(((card[n] - cpu[n]).double() ** 2).sum().item() for n in cpu)
    ref2 = sum((cpu[n].double() ** 2).sum().item() for n in cpu)
    rel = math.sqrt(diff2 / ref2)
    per_tensor = {n: ((card[n] - cpu[n]).norm() / cpu[n].norm().clamp(min=1e-30)).item() for n in cpu}
    worst = max(per_tensor, key=per_tensor.get)
    res = {"phase": "train_parity", "cpu_reference": True, "latent": [1, 32, 32, 4], "n_tensors": len(cpu),
           "grad_rel_err": rel, "limit": GRAD_REL_LIMIT, "worst_tensor": worst,
           "worst_tensor_rel_err": per_tensor[worst], "tensor_limit": GRAD_TENSOR_REL_LIMIT,
           "cuda_launches": launches, "cpu_fwd_bwd_s": cpu_s,
           "all_finite": all(bool(torch.isfinite(v).all()) for v in card.values()),
           "bf16_vs_f32_out_drift": bf_drift, "bf16_drift_limit": BF16_DRIFT_LIMIT,
           "bf16_vs_f32_grad_rel_err": bf_grad, "bf16_finite": bool(torch.isfinite(bf_out).all())}
    res["ok"] = (res["all_finite"] and rel <= GRAD_REL_LIMIT and per_tensor[worst] <= GRAD_TENSOR_REL_LIMIT
                 and all(launches.values()) and res["bf16_finite"] and bf_drift <= BF16_DRIFT_LIMIT)
    emit(res)
    check(res["all_finite"], "non-finite gradient on CUDA")
    check(all(launches.values()), f"a kernel was not launched by the CUDA UNet forward/backward: {launches}")
    check(rel <= GRAD_REL_LIMIT, f"f32 gradient CUDA vs CPU relative error {rel} > {GRAD_REL_LIMIT}")
    check(per_tensor[worst] <= GRAD_TENSOR_REL_LIMIT,
          f"f32 gradient of {worst}: relative error {per_tensor[worst]} > {GRAD_TENSOR_REL_LIMIT}")
    check(res["bf16_finite"] and bf_drift <= BF16_DRIFT_LIMIT,
          f"bf16-autocast UNet output drifts {bf_drift} of scale from f32 (limit {BF16_DRIFT_LIMIT})")
    del unet, cpu_unet, grads
    torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------- #
# phase 5: the txt2img slice; phases 6-7: training and the checkpoint round trip
# --------------------------------------------------------------------------- #


def phase_slice(model, steps: int, num_images: int) -> dict:
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native

    decoded = []
    hook = model.autoencoder.decoder.register_forward_hook(lambda m, i, o: decoded.append(o.detach()))
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    prompt = "a photograph of an astronaut riding a horse"
    try:
        torch.cuda.synchronize()
        native.reset_counters()
        t0 = time.perf_counter()
        with torch.inference_mode():
            images = pipeline.sample(model, image_size=512, prompt=prompt, time_steps=steps,
                                     guidance_scale=7.5, save_dir=out_dir, num_images=num_images, seed=42)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        hook.remove()

    # the denoising loop alone, for seconds per step (not part of the count)
    with torch.inference_mode():
        ctx = model.encode_prompts([prompt] * num_images)
        noise = torch.randn(model.latent_shape(num_images, 512), device="cuda", dtype=model.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample(noise, ctx, guidance_scale=7.5, time_steps=steps)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0

    img = decoded[0]
    res = {
        "phase": "slice", "gpu": gpu_line(), "image_size": 512, "num_images": num_images,
        "steps": steps, "guidance_scale": 7.5, "dtype": str(model.dtype),
        "decoded_shape": list(img.shape), "finite": bool(torch.isfinite(img).all()),
        "png_files": sorted(os.listdir(out_dir)), "launches": launches,
        "total_s": total_s, "images_per_s": num_images / total_s, "s_per_step": loop_s / steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    res["ok"] = (res["finite"] and res["decoded_shape"] == [num_images, 512, 512, 3]
                 and all(launches[k] > 0 for k in SLICE_KERNELS)
                 and len(images) == num_images and images[0].shape == (512, 512, 3))
    emit(res)
    check(res["decoded_shape"] == [num_images, 512, 512, 3], f"decoded shape {res['decoded_shape']}")
    check(res["finite"], "non-finite values in the decoded image")
    check(all(launches[k] > 0 for k in SLICE_KERNELS), f"a kernel was not launched by the slice: {launches}")
    check(res["ok"], "slice output check failed")
    return res


def _timed(fn):
    """(fn(), host seconds) around work that ends in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_hires(model, steps: int) -> dict:
    """(a) txt2img at 1024x1024 with the whole decode; (b) the hires fix from
    512x512 with the tiled decode; then (b)'s stages timed one by one."""
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native

    decoded = []
    hook = model.autoencoder.decoder.register_forward_hook(lambda m, i, o: decoded.append(o.detach()))
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    prompt = "a photograph of an astronaut riding a horse"
    fix = {"hires_scale": 2.0, "hires_strength": 0.6, "vae_tile": HIRES_TILE}
    runs = {}
    try:
        for run, size, extra in (("txt2img_1024", HIRES, {}), ("hires_fix", HIRES_BASE, fix)):
            decoded.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            native.reset_counters()
            with torch.inference_mode():
                images, total_s = _timed(lambda: pipeline.sample(
                    model, image_size=size, prompt=prompt, time_steps=steps, guidance_scale=7.5, save_dir=out_dir,
                    num_images=1, seed=42, name=run, **extra))
            runs[run] = {
                "image_size": size, **extra, "launches": launch_counts(),
                "flash_kv_lengths": sorted({key[2] for key in native.COUNTERS["flash_attention"].shapes}),
                "decoder_outputs": [list(o.shape) for o in decoded],
                "finite": all(bool(torch.isfinite(o).all()) for o in decoded),
                "image_shape": list(images[0].shape), "total_s": total_s, "images_per_s": 1.0 / total_s,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            }
    finally:
        hook.remove()

    # the stages alone (not part of the counts): the 1024 loop; the hires fix's
    # base loop, refine, and tiled vs whole decode of the refined latent
    with torch.inference_mode():
        ctx = model.encode_prompts([prompt])
        gen = torch.Generator(device="cuda").manual_seed(7)
        noise = torch.randn(model.latent_shape(1, HIRES), device="cuda", generator=gen).to(model.dtype)
        _, loop_s = _timed(lambda: model.sample(noise, ctx, guidance_scale=7.5, time_steps=steps))
        noise = torch.randn(model.latent_shape(1, HIRES_BASE), device="cuda", generator=gen).to(model.dtype)
        x0, base_s = _timed(lambda: model.sample(noise, ctx, guidance_scale=7.5, time_steps=steps))
        x1, refine_s = _timed(lambda: pipeline.hires_refine(
            model, x0, ctx, guidance_scale=7.5, sampler="ddim", time_steps=steps, hires_scale=2.0,
            hires_strength=0.6, generator=torch.Generator().manual_seed(8)))
        tiled, tiled_s = _timed(lambda: model.decode_latent(x1, tile=HIRES_TILE))
        whole, whole_s = _timed(lambda: model.decode_latent(x1))
        tile_diff = (tiled.float() - whole.float()).abs().max().item()
        noise = torch.randn(model.latent_shape(1, HIRES), device="cuda", generator=gen).to(model.dtype)
        profile = profile_device(lambda: model.sample(noise, ctx, guidance_scale=7.5, time_steps=2), 2, "step")
    refine_steps = max(min(round(steps * 0.6), steps), 1)
    a, b = runs["txt2img_1024"], runs["hires_fix"]
    res = {
        "phase": "hires", "gpu": gpu_line(), "steps": steps, "guidance_scale": 7.5, "dtype": str(model.dtype),
        "runs": runs, "s_per_step_1024": loop_s / steps,
        "hires_fix_stages_s": {"base": base_s, "refine": refine_s, "tiled_decode": tiled_s,
                               "whole_decode": whole_s},
        "refine_steps": refine_steps, "refine_s_per_step": refine_s / refine_steps,
        "tiled_vs_whole_decode_max_abs": tile_diff, "tiled_vs_whole_image_max_abs": whole.float().abs().max().item(),
        "profile_1024_step": profile,
    }
    emit({k: v for k, v in res.items() if k != "profile_1024_step"})
    emit({"phase": "hires_profile", **{k: v for k, v in profile.items() if k != "top_kernels"}})
    full = [1, HIRES, HIRES, 3]
    check(a["decoder_outputs"] == [full] and a["finite"] and a["image_shape"] == full[1:],
          f"1024x1024 txt2img: decoder outputs {a['decoder_outputs']}, finite {a['finite']}")
    check(HIRES * HIRES // 64 in a["flash_kv_lengths"], f"K1 never ran at kv 16384: {a['flash_kv_lengths']}")
    check(len(b["decoder_outputs"]) > 1 and b["finite"] and b["image_shape"] == full[1:],
          f"hires fix: decoder tiles {b['decoder_outputs']}, finite {b['finite']}, image {b['image_shape']}")
    for run in runs.values():
        check(all(run["launches"][k] > 0 for k in SLICE_KERNELS), f"a kernel was not launched: {run['launches']}")
    check(bool(torch.isfinite(tiled).all() and torch.isfinite(whole).all()), "non-finite staged decode")
    return res


def phase_train(trainer, name: str, image_size: int, batch: int, required) -> dict:
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops import native

    state = trainer.state
    watch = [n for n in state.names if n.endswith(("conv_in.weight", "out.2.weight", "middle_block.1.proj_in.weight"))]
    watch += [state.names[i] for i in range(0, len(state.names), 97)]
    before = {n: p.detach().clone() for n, p in zip(state.names, state.params) if n in watch}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counters()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(trainer.tracker.jsonl_path) as f:
        records = [json.loads(line) for line in f]
    changed = {n: (p.detach() - before[n]).abs().max().item() for n, p in zip(state.names, state.params)
               if n in before}
    train_recs = [r for r in records if "train_loss" in r]
    eval_recs = [r for r in records if "eval_loss" in r]
    losses = [r["train_loss"] for r in train_recs] + [r["eval_loss"] for r in eval_recs]
    timer = trainer.step_timer
    micro = TRAIN_STEPS * trainer.cfg.train.gradient_accumulation_steps
    res = {
        "phase": name, "gpu": gpu_line(), "image_size": image_size, "batch": batch,
        "gradient_accumulation_steps": trainer.cfg.train.gradient_accumulation_steps,
        "optimizer_steps": state.optimizer.count, "micro_steps": state.step, "dtype": str(trainer.dtype),
        "param_dtype": str(state.params[0].dtype), "n_params": sum(p.numel() for p in state.params),
        "train_loss": [r["train_loss"] for r in train_recs], "eval_loss": [r["eval_loss"] for r in eval_recs],
        "lr": [r["lr"] for r in train_recs], "finite": all(math.isfinite(v) for v in losses),
        "max_param_change": changed, "launches": launches,
        "step_ms_p50": timer.percentile(50) * 1e3, "step_ms_samples": len(timer.durations),
        "samples_per_s": batch / timer.percentile(50), "total_s": total_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    res["ok"] = (res["finite"] and len(train_recs) == TRAIN_STEPS and len(eval_recs) == 1
                 and state.step == micro and all(v > 0 for v in changed.values())
                 and all(launches[k] > 0 for k in required))
    emit(res)
    check(len(train_recs) == TRAIN_STEPS and state.step == micro, f"train ran {state.step} micro steps")
    check(res["finite"], f"non-finite loss: {losses}")
    check(all(v > 0 for v in changed.values()), f"parameters did not change: {changed}")
    check(all(launches[k] > 0 for k in required), f"a kernel was not launched by the {name} run: {launches}")
    check(res["ok"], f"{name} phase check failed")
    res["profile"] = profile_window(trainer)
    emit({"phase": f"{name}_profile", **{k: v for k, v in res["profile"].items() if k != "top_kernels"}})
    return res


# kernel-name substrings -> category of the training profile, first match wins
PROFILE_CATEGORIES = [
    ("K1 flash attention fwd", ("fa_forward_kernel",)),
    ("K4/K5 split attention bwd", ("split_dq_kernel", "split_dkv_kernel", "split_delta_kernel")),
    ("K3 flash attention bwd", ("dkv_kernel", "delta_kernel", "cast_kernel<")),
    ("K7 GroupNorm bwd", ("gn_bwd",)),
    ("K6/K8 GroupNorm fwd", ("gn_partial_sums", "gn_finalize", "gn_normalize")),
    ("optimizer and accumulation (foreach)", ("multi_tensor_apply", "foreach")),
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
    ("other elementwise and reductions", ("elementwise", "vectorized", "reduce", "softmax", "norm", "index")),
]


def profile_device(fn, units: int, unit: str) -> dict:
    """torch.profiler around ``fn()``, a window of ``units`` steps: device ms
    per step by kernel category, and the device's busy share of the window's
    wall time (the profiler's own cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats, kernels, top = {}, 0, []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        if us <= 0:
            continue
        name = e.key.lower()
        cat = next((c for c, keys in PROFILE_CATEGORIES if any(k in name for k in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + us / 1e3 / units
        kernels += e.count
        top.append((us / 1e3 / units, cat, e.key[:100]))
    busy = sum(cats.values()) * units
    if busy <= 0:
        return {"measured": False, f"wall_ms_per_{unit}": wall_ms / units}
    return {"measured": True, f"{unit}s": units, f"wall_ms_per_{unit}": wall_ms / units,
            f"device_ms_per_{unit}": busy / units, "idle_share": max(0.0, 1.0 - busy / wall_ms),
            f"kernel_launches_per_{unit}": kernels / units,
            "device_ms_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "category": c, "name": n} for ms, c, n in sorted(top, reverse=True)[:25]]}


def profile_window(trainer) -> dict:
    """One accumulation window (its micro steps and the optimizer update)
    after the train run, profiled."""
    from stable_diffusion_pytorch_tpu_torch.trainers.trainer import step_generator

    accum = trainer.cfg.train.gradient_accumulation_steps
    it = iter(trainer.train_loader)
    batches = [trainer._place_batch(next(it)) for _ in range(accum)]
    del it

    def window():
        for i, batch in enumerate(batches):
            trainer._train_step(batch, step_generator("cuda", 7, i))

    return profile_device(window, accum, "micro_step")


def phase_checkpoint(work: str) -> dict:
    """Small width on the card: train 2 steps saving checkpoint-2, then resume
    ``latest`` in a new trainer and compare every tensor."""
    import shutil

    import torch

    from stable_diffusion_pytorch_tpu_torch.scripts.train_unet import build_trainer
    from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_checkpoint

    shutil.rmtree(work, ignore_errors=True)
    flags = [*TINY_FLAGS, "--resolution", "64", "--train-batch-size", "2", "--eval-batch-size", "2",
             "--gradient-accumulation-steps", "2", "--max-train-steps", "2", "--checkpointing-steps", "2",
             "--lr-warmup-steps", "0", "--ema-decay", "0.9", "--max-train-samples", "8", "--max-val-samples", "2",
             "--log-interval", "0", "--dataloader-num-workers", "0"]
    first = build_trainer(train_argv(work, *flags))
    first.train()
    path = os.path.join(work, "ckpt", "checkpoint-2")
    saved = load_checkpoint(path, map_location="cuda")
    second = build_trainer(train_argv(work, *flags, "--resume-from-checkpoint", "latest", "--seed", "1"))
    replay = second._resume()
    got = second.state.state_dict()
    mismatched = [f"{part}.{n}" for part in ("params", "ema_params")
                  for n, t in saved[part].items() if not torch.equal(got[part][n], t)]
    mismatched += [f"opt_state.{k}" for k in ("mu", "nu")
                   if not all(torch.equal(a, b) for a, b in zip(got["opt_state"][k], saved["opt_state"][k]))]
    live = first.state.state_dict()
    mismatched += [f"live.{n}" for n, t in live["params"].items() if not torch.equal(got["params"][n], t)]
    res = {"phase": "checkpoint", "path": os.path.relpath(path, REPO), "files": sorted(os.listdir(path)),
           "resumed_global_step": replay["global_step"], "step": got["step"],
           "count": got["opt_state"]["count"], "n_tensors": len(saved["params"]), "mismatched": mismatched[:20]}
    res["ok"] = (not mismatched and replay["global_step"] == 2 and got["step"] == saved["step"] == 4
                 and got["opt_state"]["count"] == 2)
    emit(res)
    check(res["ok"], f"checkpoint round trip failed: {res}")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write every phase's JSON to DIR/chip_smoke.json")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "stable_diffusion_pytorch_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    work = os.path.join(REPO, "build", "chip_smoke_train")

    env = phase_env()
    model = build_sd15("cuda", torch.bfloat16, SEED)
    trainer = build_sd15_trainer(work, 512, TRAIN_BATCH)
    hires_trainer = build_sd15_trainer(work + "_1024", HIRES, HIRES_TRAIN_BATCH)
    shapes = record_shapes(model, (trainer, hires_trainer))
    kernels = phase_kernels(shapes)
    parity = phase_unet_parity(SEED)
    train_parity = phase_train_parity(SEED)
    slice_res = phase_slice(model, STEPS, NUM_IMAGES)
    hires_res = phase_hires(model, STEPS)
    del model
    torch.cuda.empty_cache()
    train_res = phase_train(trainer, "train", 512, TRAIN_BATCH, TRAIN_KERNELS)
    del trainer
    torch.cuda.empty_cache()
    hires_train_res = phase_train(hires_trainer, "hires_train", HIRES, HIRES_TRAIN_BATCH, tuple(TPU_KERNELS))
    del hires_trainer
    torch.cuda.empty_cache()
    ckpt = phase_checkpoint(os.path.join(REPO, "build", "chip_smoke_ckpt"))

    main_path = [slice_res["launches"], *(r["launches"] for r in hires_res["runs"].values()),
                 train_res["launches"], hires_train_res["launches"]]
    summary = []
    for name, (route, source, replaces) in TPU_KERNELS.items():
        s = kernels["summary"][name]
        summary.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(launches[name] for launches in main_path),
            "max_abs_err": s["max_abs_err_bf16"], "ms": s["ms_bf16"], "plain_ms": s["plain_ms_bf16"],
            "bound_ms": s["bound_ms_bf16"],
            "bound_by": "operations" if s["ops_bound_ms_bf16"] >= s["bytes_bound_ms_bf16"] else "bytes",
            "library_ms": s["library_ms_bf16"],
        })
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"env": env, "shapes": shapes, "kernels": kernels, "unet_parity": parity,
                       "flash_attention_launches_kv_past_9216": sum(
                           launches["flash_attention_kv_past_9216"] for launches in main_path),
                       "train_parity": train_parity, "slice": slice_res, "hires": hires_res, "train": train_res,
                       "hires_train": hires_train_res, "checkpoint": ckpt, "summary": summary}, f, indent=1)
    print(env["gpu"], flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
