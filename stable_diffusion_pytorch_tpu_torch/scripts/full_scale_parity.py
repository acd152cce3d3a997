"""Full-scale parity of the PyTorch port, the card against the CPU (counterpart of tools/full_scale_parity.py).

    python -m stable_diffusion_pytorch_tpu_torch.scripts.full_scale_parity [--device cuda] \\
        [--out build/parity_fullscale_torch.json] [--vae-size 512] [--seed 0]

The JAX tool holds the JAX package against the original PyTorch reference
at the configurations that matter. The port imports neither, so this tool
holds the port on the card (its CUDA kernels; float32, TF32 off: the
attention kernels' FMA routes) against the port on the CPU (the kernels'
plain versions), on seeded random weights (``init_weights``, the
zero-initialized layers filled so that every path counts), at the JAX
tool's configurations; the CPU tests hold the port's CPU path against the
JAX package (``tests/test_torch_port_tools.py``):

1. the reference's default UNet (channels [160, 320], 8 heads, t_emb 512,
   ctx 768) on a 64x64x4 latent;
2. the SD-1.5 UNet (``presets.sd15_unet_config``) on a 64x64x4 latent;
3. the SD-1.5 VAE's encode (the posterior mean) and decode at
   ``--vae-size`` (512; the smoke run takes 256);
4. the reference-compat sampling loop at the reference's default UNet: 5
   DDPM steps, CFG 7.5 with the reference's swapped formula, the ascending
   loop on the raw timesteps, uniform initial noise, ``scale_factor`` 0;
5. the BPE tokenizer against HF ``CLIPTokenizer`` on a synthetic vocab
   (and the staged one under ``data/pretrained/tokenizer``) where
   ``transformers`` imports and loads it, else null;
6. the bf16 drift: each UNet's bf16 forward (``cast_for_inference``) against
   its float32 one on ``--device`` (recorded, not gated).

Bars, of max(1, max|CPU|) (``PARITY_FULLSCALE.json``'s): 1e-4 for a forward,
2e-3 for the loop. Every UNet has 4 groups, as the JAX tool builds it
(``UNetModel(4, 4, ...)``). The forwards run at timestep 847 on the standard
time embedding: the reference's sign-flipped one reaches ~8900 rad per step
there, where one ulp of the frequency moves the sinusoid by O(1), so two
correct float32 implementations disagree; the loop, on the raw timesteps 4
to 0, takes the reference's embedding and bottleneck groups. With
``--device cpu`` both sides are the CPU: the deltas are 0 by construction
and the bars are not applied (``"mode": "cpu only"``). Prints
ONE JSON line and writes it to ``--out`` (never to the repository root's
``PARITY_FULLSCALE.json``, the JAX package's record).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, DDPMConfig, UnetConfig
from stable_diffusion_pytorch_tpu_torch.models import presets
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer
from stable_diffusion_pytorch_tpu_torch.models.build import (
    cast_for_inference,
    init_weights,
    require_device,
    without_default_init,
)
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import make_sample_fn
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
from stable_diffusion_pytorch_tpu_torch.scripts.stage_check import hf_tokenizer
from stable_diffusion_pytorch_tpu_torch.utils.precision import full_float32

F32_TOL = 1e-4   # a float32 forward, of max(1, max|CPU|)
LOOP_TOL = 2e-3  # the 5-step loop
GROUPS = 4       # UNetModel(4, 4, ...), as the JAX tool builds every UNet
LOOP_STEPS = 5
DEFAULT_OUT = os.path.join("build", "parity_fullscale_torch.json")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``init_weights`` from ``seed`` on the module's device, then the
    weights it leaves at zero (each ResBlock's last conv, each transformer's
    proj_out) drawn too; float32, eval mode."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        init_weights(module, gen)
        for p in module.parameters():
            if p.dim() > 1 and not p.any():
                p.normal_(0.0, 0.5 * p[0].numel() ** -0.5, generator=gen)
    return module.float().eval().requires_grad_(False)


def build_unet(cfg: UnetConfig, seed: int, device="cpu", groups: int = GROUPS, compat: bool = False) -> UNetModel:
    """A seeded UNet; ``compat``: the reference's time embedding and bottleneck groups."""
    with torch.device(device), without_default_init():
        unet = UNetModel(4, groups, cfg, flipped_time_embedding=compat, bottleneck_default_groups=compat)
    return seeded(unet, seed)


def _pair(module: torch.nn.Module, device: torch.device):
    """(``module`` on ``device``, its copy on the CPU)."""
    module = module.to(device)
    return module, (copy.deepcopy(module).cpu() if device.type != "cpu" else module)


def _delta(out: torch.Tensor, ref: torch.Tensor, tol: float, device: torch.device) -> dict:
    out, ref = out.float().cpu(), ref.float().cpu()
    scale = float(ref.abs().max())
    delta = float((out - ref).abs().max())
    rec = {"max_delta": delta, "output_scale": scale, "finite": bool(torch.isfinite(out).all())}
    if device.type == "cpu":
        return {**rec, "mode": "cpu only", "ok": rec["finite"]}
    limit = tol * max(1.0, scale)
    return {**rec, "mode": "card vs cpu", "tol": limit, "ok": rec["finite"] and delta <= limit}


def unet_inputs(cfg: UnetConfig, seed: int, latent: int = 64, batch: int = 1):
    """A latent [batch, latent, latent, 4], timestep 847 and a context, from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, latent, latent, 4)).astype(np.float32)
    ctx = rng.standard_normal((batch, 77, cfg.context_dim)).astype(np.float32)
    return torch.from_numpy(x), torch.full((batch,), 847, dtype=torch.int64), torch.from_numpy(ctx)


def unet_parity(cfg: UnetConfig, seed: int, device, latent: int = 64, groups: int = GROUPS) -> dict:
    """The UNet's float32 forward on ``device`` against the CPU's, and its
    bf16 forward against its float32 one on ``device`` (the drift)."""
    device = torch.device(device)
    unet, cpu_unet = _pair(build_unet(cfg, seed, device, groups), device)
    x, t, ctx = unet_inputs(cfg, seed, latent)
    with torch.no_grad(), full_float32():
        out = unet(x.to(device), t.to(device), ctx.to(device))
        ref = cpu_unet(x, t, ctx)
    rec = _delta(out, ref, F32_TOL, device)
    bf16 = cast_for_inference(copy.deepcopy(unet), torch.bfloat16)
    with torch.no_grad():
        drift = bf16(x.to(device, torch.bfloat16), t.to(device), ctx.to(device, torch.bfloat16)).float()
    rec["bf16_vs_f32_max_delta"] = float((drift - out.float()).abs().max())
    return rec


def vae_parity(seed: int, device, size: int = 512) -> dict:
    """The SD-1.5 VAE's encode (posterior mean) and decode, ``device`` vs CPU, float32."""
    device = torch.device(device)
    vcfg = presets.sd15_autoencoder_config()
    with torch.device(device), without_default_init():
        vae = AutoEncoderKL(vcfg, bottleneck_default_groups=True)
    vae, cpu_vae = _pair(seeded(vae, seed), device)
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.standard_normal((1, size, size, 3)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((1, size // 8, size // 8, vcfg.latent_channels)).astype(np.float32))
    with torch.no_grad(), full_float32():
        enc = _delta(vae.encode(img.to(device)).mean, cpu_vae.encode(img).mean, F32_TOL, device)
        dec = _delta(vae.decode(z.to(device)), cpu_vae.decode(z), F32_TOL, device)
    return {"image_size": size, "encode": enc, "decode": dec}


def compat_sample_fn(unet, steps: int = LOOP_STEPS, noise_steps: int = 1000):
    """The reference-compat loop as the JAX tool builds it: DDPM, CFG 7.5 by
    the swapped formula, ascending over the raw timesteps, ``scale_factor``
    0 (the stochastic term off, so the loop is deterministic)."""
    return make_sample_fn(unet, make_schedule(DDPMConfig(noise_steps=noise_steps)), num_steps=steps, sampler="ddpm",
                          guidance_scale=7.5, scale_factor=0.0, reference_cfg_formula=True, ascending_loop=True,
                          leading_timesteps=True)


def loop_inputs(seed: int, latent: int = 64, context_dim: int = 768):
    """Uniform initial noise [1, latent, latent, 4] (the reference's), a context and an unconditional context."""
    rng = np.random.default_rng(seed + 1)
    x_T = rng.uniform(0.0, 1.0, (1, latent, latent, 4)).astype(np.float32)
    ctx, uncond = (rng.standard_normal((1, 77, context_dim)).astype(np.float32) for _ in range(2))
    return tuple(torch.from_numpy(a) for a in (x_T, ctx, uncond))


def loop_parity(seed: int, device, latent: int = 64) -> dict:
    """The 5-step compat loop at the reference's default UNet, ``device`` vs CPU."""
    device = torch.device(device)
    cfg = presets.reference_unet_config()
    unet, cpu_unet = _pair(build_unet(cfg, seed, device, compat=True), device)
    x_T, ctx, uncond = loop_inputs(seed, latent, cfg.context_dim)
    with torch.no_grad(), full_float32():
        out = compat_sample_fn(unet)(x_T.to(device), ctx.to(device), uncond.to(device),
                                     generator=torch.Generator().manual_seed(seed))
        ref = compat_sample_fn(cpu_unet)(x_T, ctx, uncond, generator=torch.Generator().manual_seed(seed))
    return {"steps": LOOP_STEPS, **_delta(out, ref, LOOP_TOL, device)}


BPE_PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "cathedral reduce, oil painting!!  extra   spaces",
    "UNICODE café — emoji \U0001f600 ok",
    "",
]


def bpe_parity(real_dir: str = os.path.join("data", "pretrained", "tokenizer")) -> dict:
    """The port's BPE token for token against HF ``CLIPTokenizer``: on a
    synthetic vocab always, on the staged one when present; null where
    ``transformers`` does not import or load the vocab
    (``stage_check.hf_tokenizer``)."""

    def compare(vdir: str):
        hf, _ = hf_tokenizer(vdir)
        if hf is None:
            return None
        ours = CLIPBPETokenizer.from_dir(vdir)
        return all(
            np.array_equal(np.asarray(hf([p], max_length=77, padding="max_length", truncation=True).input_ids),
                           np.asarray(ours([p], max_length=77, padding="max_length", truncation=True).input_ids))
            for p in BPE_PROMPTS)

    out = {}
    with tempfile.TemporaryDirectory() as d:
        base = [chr(i) for i in range(33, 33 + 94)] + ["Ġ"]
        vocab = {tok: i for i, tok in enumerate(base)}
        vocab.update({tok + "</w>": 300 + i for i, tok in enumerate(base)})
        merges = ["c a", "t h", "r e", "ca t</w>", "th e</w>", "re d"]
        for i, m in enumerate(merges):
            vocab[m.replace(" ", "")] = 600 + i
        vocab["<|startoftext|>"] = len(vocab)
        vocab["<|endoftext|>"] = len(vocab)
        with open(os.path.join(d, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(d, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
        out["bpe_hf_parity_fixture"] = compare(d)
    staged = os.path.exists(os.path.join(real_dir, "vocab.json"))
    out["bpe_hf_parity_real_vocab"] = compare(real_dir) if staged else None
    return out


def main(argv=None) -> dict:
    """Run every check, write and print the JSON line -> its dict."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")
    parser.add_argument("--out", default=DEFAULT_OUT, help="where to write the JSON record")
    parser.add_argument("--vae-size", type=int, default=512, help="image side of the VAE check")
    parser.add_argument("--seed", type=int, default=0)
    ns = parser.parse_args(argv)
    try:
        device = require_device(ns.device)
    except RuntimeError as exc:
        raise SystemExit(f"full_scale_parity: {exc}") from None

    result = {"metric": "full_scale_parity", "device": str(device)}
    log("[reference-config-unet] ...")
    result["unet_reference_config"] = unet_parity(presets.reference_unet_config(), ns.seed, device)
    log("[sd15-unet] ...")
    result["unet_sd15"] = unet_parity(presets.sd15_unet_config(), ns.seed, device)
    log("[sd15-vae] ...")
    result["vae_sd15"] = vae_parity(ns.seed + 1, device, ns.vae_size)
    log("[sampling-loop] ...")
    result["sampling_loop"] = loop_parity(ns.seed, device)
    result.update(bpe_parity())
    forwards = (result["unet_reference_config"], result["unet_sd15"], result["vae_sd15"]["encode"],
                result["vae_sd15"]["decode"])
    result["pass_f32_forward"] = all(r["ok"] for r in forwards)
    result["pass_sampling_loop"] = result["sampling_loop"]["ok"]
    os.makedirs(os.path.dirname(ns.out) or ".", exist_ok=True)
    with open(ns.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
