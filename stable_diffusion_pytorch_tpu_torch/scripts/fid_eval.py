"""FID of the port's sampling stacks on a tiny model (counterpart of tools/fid_eval.py).

    FID_N=64 FID_STEPS=10 python -m stable_diffusion_pytorch_tpu_torch.scripts.fid_eval [--device cuda]

The JAX tool compares the JAX package's samples with the original PyTorch
reference's, which it imports from a checkout of that repository. The port
imports nothing of it, so that comparison is reported as ``"ref":
"unavailable"``, and the port's side of the protocol runs at the JAX tool's
tiny configuration (UNet channels [16, 32], 4 heads, context 24; an f2 VAE
[8, 16]; 50 noise steps) on seeded random weights (``--seed``):

1. the REFERENCE-COMPAT set: DDPM over the raw timesteps in ascending order,
   CFG 7.5 by the reference's swapped formula, uniform initial noise, the
   reference's time embedding and bottleneck groups;
2. the DEFAULT set: DDIM, descending, standard CFG 7.5, Gaussian initial
   noise;
3. the noise floor: a second compat set from independent seeds;
4. with ``FID_DEEP_CACHE`` ("3,5"): on weights perturbed off their init
   (0.05 N(0, 1) on every tensor; the zero-initialized output convs would
   make the cached trunk a no-op), an exact DDIM set, one from independent
   seeds (its floor), and a DeepCache set at each listed interval.

Each set holds ``FID_N`` images at ``FID_RES`` (32) from ``FID_STEPS`` (10)
steps, in batches of 8, over a bank of context embeddings drawn once. Image
features by ``FID_EXTRACTOR``: ``random_inception`` (default: an ensemble of
``FID_TOWERS`` (4) fixed-seed random InceptionV3 towers, each keeping
``FID_FEAT_DIM`` (256) pool3 channels, FID averaged over the towers),
``vae`` (the tiny VAE's pooled posterior means) or ``inception`` (the staged
InceptionV3, ``utils/fid.py:InceptionFeatureExtractor``); latent features:
the sampled latents average-pooled 4 x 4. Initial noise is drawn per batch
from a torch generator seeded with ``seed + batch index``, and the DDPM
steps' noise from one seeded ``seed + STEP_SEED + batch index``, on the CPU; the functions
take both as arguments (the tests pass the JAX package's in). Prints ONE
JSON line. ``--device`` (default ``cuda``; without a card the run stops
unless given ``--device cpu``) is the port's own.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, DDPMConfig, UnetConfig
from stable_diffusion_pytorch_tpu_torch.models.autoencoder import AutoEncoderKL
from stable_diffusion_pytorch_tpu_torch.models.build import init_weights, require_device, without_default_init
from stable_diffusion_pytorch_tpu_torch.models.latent_diffusion import make_sample_fn
from stable_diffusion_pytorch_tpu_torch.models.schedule import make_schedule
from stable_diffusion_pytorch_tpu_torch.models.unet import UNetModel
from stable_diffusion_pytorch_tpu_torch.utils.fid import (
    InceptionFeatureExtractor,
    RandomInceptionFeatureExtractor,
    VAEFeatureExtractor,
    fid_from_features,
)

UNET_KW = dict(num_res_blocks=1, n_heads=4, attention_resolutions=[1], channels_list=[16, 32], time_emb_dim=32,
               dropout=0.0, n_layers=1, context_dim=24)
VAE_KW = dict(autoencoder_channels_list=[8, 16], groups=4, latent_channels=4)
NOISE_STEPS = 50
BATCH = 8
CTX_TOKENS = 7
GUIDANCE = 7.5
SEEDS = {"compat": 42, "floor": 4242}  # the two compat sets; the DeepCache sets use the same two
PERTURB = 0.05
STEP_SEED = 1_000_003  # the step noise's generators, apart from the initial noise's


class Stack:
    """The tiny UNet (once with the default math, once with the reference's
    time embedding and bottleneck groups, the same weights) and the VAE."""

    def __init__(self, unet_state: dict, vae_state: dict, device="cpu"):
        cfg = UnetConfig(**UNET_KW)
        with torch.device(device), without_default_init():
            self.unet = UNetModel(4, 4, cfg)
            self.compat_unet = UNetModel(4, 4, cfg, flipped_time_embedding=True, bottleneck_default_groups=True)
            self.vae = AutoEncoderKL(AutoencoderConfig(**VAE_KW))
        for module, state in ((self.unet, unet_state), (self.compat_unet, unet_state), (self.vae, vae_state)):
            module.load_state_dict(state, strict=True)
            module.float().eval().requires_grad_(False)
        self.schedule = make_schedule(DDPMConfig(noise_steps=NOISE_STEPS))
        self.device = torch.device(device)

    @classmethod
    def seeded(cls, seed: int, device="cpu") -> "Stack":
        """Weights from ``init_weights`` with a CPU generator seeded ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        with without_default_init():
            unet, vae = UNetModel(4, 4, UnetConfig(**UNET_KW)), AutoEncoderKL(AutoencoderConfig(**VAE_KW))
        with torch.no_grad():
            init_weights(unet, gen)
            init_weights(vae, gen)
        return cls(unet.state_dict(), vae.state_dict(), device)

    def perturbed(self, seed: int) -> dict:
        """The UNet's weights plus ``PERTURB`` N(0, 1), drawn in parameter order from ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        return {k: v.cpu() + PERTURB * torch.randn(v.shape, generator=gen) for k, v in self.unet.state_dict().items()}

    def sample_fn(self, compat: bool, steps: int, deep_cache: int = 0) -> Callable:
        if compat:
            return make_sample_fn(self.compat_unet, self.schedule, num_steps=steps, sampler="ddpm",
                                  guidance_scale=GUIDANCE, reference_cfg_formula=True, ascending_loop=True,
                                  leading_timesteps=True)
        return make_sample_fn(self.unet, self.schedule, num_steps=steps, sampler="ddim", guidance_scale=GUIDANCE,
                              deep_cache_interval=deep_cache)


def initial_noise(compat: bool, seed: int, n: int, lat: int) -> List[torch.Tensor]:
    """Each batch's x_T from a generator seeded ``seed + i`` (i the batch's
    first row): uniform [0, 1) for the compat set (the reference's), else N(0, 1)."""
    draw = torch.rand if compat else torch.randn
    return [draw((min(BATCH, n - i), lat, lat, 4), generator=torch.Generator().manual_seed(seed + i))
            for i in range(0, n, BATCH)]


@torch.no_grad()
def sample_set(stack: Stack, fn: Callable, ctx_bank: np.ndarray, uncond: np.ndarray, x_Ts: Sequence[torch.Tensor],
               step_noise: Optional[Sequence[Sequence[torch.Tensor]]] = None, seed: int = 0):
    """Sample each batch of ``ctx_bank`` from its ``x_Ts[j]`` and decode ->
    (images [N, H, W, 3], latents [N, h, w, 4]) as float32 numpy. DDPM's step
    noise is ``step_noise[j]`` where given, else drawn from a CPU generator
    seeded ``seed + STEP_SEED + 8 j``."""
    device = stack.device
    images, latents = [], []
    for j, x_T in enumerate(x_Ts):
        ctx = torch.from_numpy(ctx_bank[j * BATCH: j * BATCH + len(x_T)]).to(device)
        unc = torch.from_numpy(uncond).to(device).expand_as(ctx)
        noise = None if step_noise is None else [n.to(device) for n in step_noise[j]]
        x0 = fn(x_T.to(device), ctx, unc, generator=torch.Generator().manual_seed(seed + STEP_SEED + j * BATCH),
                noise=noise)
        images.append(stack.vae.decode(x0).float().cpu().numpy())
        latents.append(x0.float().cpu().numpy())
    return np.concatenate(images), np.concatenate(latents)


def latent_features(latents: np.ndarray, pool: int = 4) -> np.ndarray:
    """The JAX tool's latent features: [N, h, w, c] pooled to ``pool`` x ``pool`` cells, flattened."""
    z = np.asarray(latents, np.float64)
    n, hh, _, cc = z.shape
    ph = hh // pool
    z = z[:, : ph * pool, : ph * pool]
    return z.reshape(n, pool, ph, pool, ph, cc).mean(axis=(2, 4)).reshape(n, -1)


def pair_rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def finite(x: float):
    """``x`` rounded, or None where it is not finite (invalid in JSON)."""
    return round(x, 4) if np.isfinite(x) else None


class ImageFID:
    """FID between two image sets with the ``FID_EXTRACTOR`` features, an
    ensemble's FIDs averaged over its towers; each set featurized once."""

    def __init__(self, kind: str, stack: Stack, device, towers: int = 4, feat_dim: int = 256,
                 model_dir: str = "data/pretrained"):
        if kind == "inception":
            self.extractors, self.metric = [InceptionFeatureExtractor(model_dir=model_dir, device=device)], kind
        elif kind == "vae":
            self.extractors, self.metric = [VAEFeatureExtractor(stack.vae)], "fid_vae_proxy"
        elif kind == "random_inception":
            self.extractors = [RandomInceptionFeatureExtractor(seed=s, feat_dim=feat_dim, device=device)
                               for s in range(towers)]
            self.metric = f"fid_inception_random_x{towers}_d{feat_dim or 2048}"
        else:
            raise ValueError(f"unknown FID_EXTRACTOR {kind!r}: random_inception, vae or inception")
        self._cache = {}

    def features(self, t: int, images: np.ndarray) -> np.ndarray:
        key = (t, id(images))
        if key not in self._cache:
            extract = self.extractors[t]
            self._cache[key] = np.concatenate([extract(images[i: i + 16]) for i in range(0, len(images), 16)])
        return self._cache[key]

    def __call__(self, a: np.ndarray, b: np.ndarray) -> float:
        vals = [fid_from_features(self.features(t, a), self.features(t, b)) for t in range(len(self.extractors))]
        vals = [v for v in vals if math.isfinite(v)]
        return float(np.mean(vals)) if vals else float("nan")


def run(stack: Stack, n_images: int, steps: int, res: int, deep_cache: Sequence[int], img_fid: ImageFID,
        seed: int = 0) -> dict:
    """The sets and the JSON record (module docstring)."""
    lat = res // 2  # the f2 VAE
    rng = np.random.default_rng(seed)
    ctx_bank = rng.standard_normal((n_images, CTX_TOKENS, UNET_KW["context_dim"])).astype(np.float32)
    uncond = rng.standard_normal((1, CTX_TOKENS, UNET_KW["context_dim"])).astype(np.float32)

    def one(compat: bool, set_seed: int, deep: int = 0):
        return sample_set(stack, stack.sample_fn(compat, steps, deep), ctx_bank, uncond,
                          initial_noise(compat, set_seed, n_images, lat), seed=set_seed)

    compat_img, compat_lat = one(True, SEEDS["compat"])
    floor_img, floor_lat = one(True, SEEDS["floor"])
    default_img, default_lat = one(False, SEEDS["compat"])
    result = {
        "metric": img_fid.metric, "n_images": n_images, "steps": steps, "ref": "unavailable",
        "fid_compat_vs_compat": finite(img_fid(compat_img, floor_img)),
        "fid_compat_vs_default": finite(img_fid(compat_img, default_img)),
        "fid_latent_compat_vs_compat": finite(fid_from_features(latent_features(compat_lat),
                                                                latent_features(floor_lat))),
        "fid_latent_compat_vs_default": finite(fid_from_features(latent_features(compat_lat),
                                                                 latent_features(default_lat))),
    }
    if deep_cache:
        exact = Stack(stack.perturbed(99), stack.vae.state_dict(), stack.device)
        sets = {k: sample_set(exact, exact.sample_fn(False, steps, k), ctx_bank, uncond,
                              initial_noise(False, SEEDS["compat"], n_images, lat))
                for k in (0, *deep_cache)}
        base_img, base_lat = sets.pop(0)
        floor_img, floor_lat = sample_set(exact, exact.sample_fn(False, steps), ctx_bank, uncond,
                                          initial_noise(False, SEEDS["floor"], n_images, lat))
        base_feat = latent_features(base_lat)
        result.update({
            "rmse_latent_exact_vs_floor": finite(pair_rmse(base_lat, floor_lat)),
            "latent_rms": finite(float(np.sqrt(np.mean(np.square(base_lat.astype(np.float64)))))),
            "fid_latent_exact_vs_exact": finite(fid_from_features(base_feat, latent_features(floor_lat))),
            "fid_exact_vs_exact": finite(img_fid(base_img, floor_img)),
        })
        for k, (dc_img, dc_lat) in sets.items():
            result[f"fid_latent_exact_vs_dc{k}"] = finite(fid_from_features(base_feat, latent_features(dc_lat)))
            result[f"fid_exact_vs_dc{k}"] = finite(img_fid(base_img, dc_img))
            result[f"rmse_latent_exact_vs_dc{k}"] = finite(pair_rmse(base_lat, dc_lat))
    return result


def main(argv=None) -> dict:
    """Sample, score and print the JSON line -> its dict."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda; the CPU only when asked: --device cpu)")
    parser.add_argument("--seed", type=int, default=0, help="of the random weights and the context bank")
    parser.add_argument("--model-dir", default="data/pretrained", help="staged InceptionV3 (FID_EXTRACTOR=inception)")
    ns = parser.parse_args(argv)
    try:
        device = require_device(ns.device)
    except RuntimeError as exc:
        raise SystemExit(f"fid_eval: {exc}") from None
    env = os.environ.get
    stack = Stack.seeded(ns.seed, device)
    img_fid = ImageFID(env("FID_EXTRACTOR", "random_inception"), stack, device, int(env("FID_TOWERS", "4")),
                       int(env("FID_FEAT_DIM", "256")), ns.model_dir)
    deep_cache = [int(tok) for tok in env("FID_DEEP_CACHE", "").split(",") if tok.strip()]
    result = run(stack, int(env("FID_N", "64")), int(env("FID_STEPS", "10")), int(env("FID_RES", "32")), deep_cache,
                 img_fid, ns.seed)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
