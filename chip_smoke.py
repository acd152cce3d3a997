#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stable_diffusion_pytorch_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Four phases, each printing one JSON line; any failure exits nonzero:

1. env: the card (``nvidia-smi`` name and power limit), torch/CUDA/Triton
   versions, and the time to build the CUDA kernels from ``csrc/``.
2. kernels: the flash-attention kernel (CUDA C++) and the GroupNorm and
   GroupNorm-concat kernels (Triton) against their plain PyTorch versions on
   the card, at every distinct shape the 512x512 slice launches (recorded from
   a one-step run of the slice), in float32 (TF32 off) and bfloat16: max-abs
   error with its tolerance, kernel and plain times (CUDA events, median of 5
   runs of 5 launches).
3. unet_parity: one SD-1.5-size UNet forward (full widths, 64x64 latent) in
   float32 on the card with the kernels, against the same weights and inputs
   on the CPU through the plain path (a deliberate CPU reference).
4. slice: ``pipeline.sample`` at 512x512, DDIM with CFG 7.5, bf16, seeded
   random weights; checks the decoded image is [B, 512, 512, 3] and finite and
   that each kernel was launched by this run; seconds per step and images/s.

Then, each on its own line: the ``nvidia-smi`` name/power-limit line, the
``{"kernels": [...]}`` summary, and ``{"ok": true, "device": ...}`` last. In
the summary, ``launches`` counts phase 4's run alone; ``max_abs_err``, ``ms``
and ``plain_ms`` are phase 2's bf16 numbers, the times summed over the slice's
distinct shapes (one launch of each).
Without a CUDA device, or outside a checkout of the repository, it exits
nonzero and prints no result. Weights are random from a seed, with the
zero-initialized layers (each ResBlock's last conv, each transformer's
proj_out) filled too, so every path contributes to the outputs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0          # of the random weights
STEPS = 10        # DDIM steps of the slice run
NUM_IMAGES = 1    # per slice run; CFG doubles the UNet batch
TPU_KERNELS = {
    "flash_attention": ("cuda", "stable_diffusion_pytorch_tpu_torch/csrc/flash_attention.cu",
                        "stable_diffusion_pytorch_tpu/ops/flash_attention.py:45"),
    "group_norm": ("triton", "stable_diffusion_pytorch_tpu_torch/ops/groupnorm_triton.py",
                   "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:44"),
    "group_norm_cat": ("triton", "stable_diffusion_pytorch_tpu_torch/ops/groupnorm_triton.py",
                       "stable_diffusion_pytorch_tpu/ops/fused_groupnorm.py:187"),
}


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


def _attn_case(key, dtype, gen):
    import torch

    from stable_diffusion_pytorch_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    b, n, m, h, d = key
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype) for s in (n, m, m))
    scale = d ** -0.5
    return (lambda: flash_attention(q, k, v, scale)), (lambda: flash_attention_plain(q, k, v, scale))


def _gn_inputs(shape, c, gen, offset=0.5):
    import torch

    x = torch.randn(*shape, device="cuda", generator=gen) * 2.0 + offset
    w = 1.0 + 0.3 * torch.randn(c, device="cuda", generator=gen)
    b = 0.3 * torch.randn(c, device="cuda", generator=gen)
    return x, w, b


def _gn_case(key, dtype, gen):
    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm
    from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import xla_group_norm

    b, s, c, g, silu = key
    x, w, bias = _gn_inputs((b, s, c), c, gen)
    x = x.to(dtype)
    return (lambda: fused_group_norm(x, w, bias, g, 1e-5, silu)), (lambda: xla_group_norm(x, w, bias, g, 1e-5, silu))


def _gn_cat_case(key, dtype, gen):
    from stable_diffusion_pytorch_tpu_torch.ops.fused_groupnorm import fused_group_norm_cat
    from stable_diffusion_pytorch_tpu_torch.ops.groupnorm import xla_group_norm_cat

    b, s, c1, c2, g, silu = key
    x, w, bias = _gn_inputs((b, s, c1), c1 + c2, gen)
    skip = (_gn_inputs((b, s, c2), c2, gen, offset=-1.0)[0] * 1.5).to(dtype)
    x = x.to(dtype)
    return (
        lambda: fused_group_norm_cat(x, skip, w, bias, g, 1e-5, silu),
        lambda: xla_group_norm_cat(x, skip, w, bias, g, 1e-5, silu),
    )


# Tolerances on max|kernel - plain|, relative to max(1, max|plain|):
# float32 -- another summation order over at most a few thousand terms;
# bfloat16 -- both sides round outputs (and attention's P) to bf16, whose
# spacing is 2^-7 of the magnitude, so a few ulps.
TOLERANCE = {
    "flash_attention": {"float32": 1e-5, "bfloat16": 2e-2},
    "group_norm": {"float32": 5e-5, "bfloat16": 2e-2},
    "group_norm_cat": {"float32": 5e-5, "bfloat16": 2e-2},
}
CASES = {"flash_attention": _attn_case, "group_norm": _gn_case, "group_norm_cat": _gn_cat_case}


def phase_kernels(model) -> dict:
    """Record the slice's kernel shapes with a one-step run, then compare."""
    import torch

    from stable_diffusion_pytorch_tpu_torch import pipeline
    from stable_diffusion_pytorch_tpu_torch.ops import native

    native.reset_counters()
    with torch.inference_mode():
        pipeline.sample(model, image_size=512, prompt="a photo of a cat", time_steps=1,
                        guidance_scale=7.5, save_dir=None, num_images=NUM_IMAGES, seed=0)
    torch.cuda.synchronize()
    shapes = {name: sorted({k[:-1] for k in native.COUNTERS[name].shapes}) for name in CASES}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows, failures = [], []
    summary = {name: {"max_rel_err": {}, "ms_bf16": 0.0, "plain_ms_bf16": 0.0, "max_abs_err_bf16": 0.0}
               for name in CASES}
    with torch.inference_mode():
        for name, keys in shapes.items():
            for key in keys:
                for dname in ("float32", "bfloat16"):
                    kernel, plain = CASES[name](key, getattr(torch, dname), gen)
                    out, ref = kernel(), plain()
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    scale = max(1.0, ref.float().abs().max().item())
                    tol = TOLERANCE[name][dname] * scale
                    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
                    row = {"k": name, "shape": list(key), "dtype": dname, "err": err, "tol": tol,
                           "ms": round(ms, 5), "plain_ms": round(plain_ms, 5)}
                    rows.append(row)
                    s = summary[name]
                    s["max_rel_err"][dname] = max(s["max_rel_err"].get(dname, 0.0), err / scale)
                    if dname == "bfloat16":
                        s["ms_bf16"] += ms
                        s["plain_ms_bf16"] += plain_ms
                        s["max_abs_err_bf16"] = max(s["max_abs_err_bf16"], err)
                    if not (err <= tol):
                        failures.append(row)
                    del out, ref
    result = {"phase": "kernels", "ok": not failures, "n_shapes": {k: len(v) for k, v in shapes.items()},
              "summary": summary, "failures": failures, "shapes": rows}
    emit(result)
    check(all(shapes.values()), f"a kernel recorded no shape in the probe run: {shapes}")
    check(not failures, f"kernel disagrees with its plain version: {failures}")
    return result


def phase_unet_parity(seed: int) -> dict:
    """SD-1.5 UNet in float32: CUDA (kernels, TF32 off) vs CPU (plain path)."""
    import copy

    import torch

    from stable_diffusion_pytorch_tpu_torch.models import presets
    from stable_diffusion_pytorch_tpu_torch.models.build import cast_for_inference, init_weights
    from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
    from stable_diffusion_pytorch_tpu_torch.ops import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("cuda"):
        unet = UNetModel(4, 32, presets.sd15_unet_config())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init_weights(unet, gen)
    fill_zero_weights(unet, gen)
    cast_for_inference(unet, torch.float32)
    cpu_unet = copy.deepcopy(unet).cpu()

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, 64, 64, 4, generator=g)
    t = torch.tensor([601], dtype=torch.int32)
    ctx = torch.randn(1, 77, 768, generator=g)
    native.reset_counters()
    with torch.inference_mode():
        out = unet(x.cuda(), t.cuda(), ctx.cuda()).cpu()
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in native.COUNTERS.items()}
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
        launches = {name: native.COUNTERS[name].count for name in TPU_KERNELS}
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
                 and all(v > 0 for v in launches.values())
                 and len(images) == num_images and images[0].shape == (512, 512, 3))
    emit(res)
    check(res["decoded_shape"] == [num_images, 512, 512, 3], f"decoded shape {res['decoded_shape']}")
    check(res["finite"], "non-finite values in the decoded image")
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched by the slice: {launches}")
    check(res["ok"], "slice output check failed")
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

    env = phase_env()
    model = build_sd15("cuda", torch.bfloat16, SEED)
    kernels = phase_kernels(model)
    parity = phase_unet_parity(SEED)
    slice_res = phase_slice(model, STEPS, NUM_IMAGES)

    summary = []
    for name, (route, source, replaces) in TPU_KERNELS.items():
        s = kernels["summary"][name]
        summary.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": slice_res["launches"][name], "max_abs_err": s["max_abs_err_bf16"],
            "ms": s["ms_bf16"], "plain_ms": s["plain_ms_bf16"],
        })
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"env": env, "kernels": kernels, "unet_parity": parity, "slice": slice_res,
                       "summary": summary}, f, indent=1)
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
