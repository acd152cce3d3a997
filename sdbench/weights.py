"""Random weights from the seed, in the reference format, made on the device in
a few large draws.

Every model's parameters, in name order, are cut from standard-normal draws of
at most ``CHUNK`` values each (one ``torch.randn`` per chunk from one seeded
generator on the device) and scaled by kind: a conv or linear weight by
1/sqrt(fan_in), a bias by 0.02, a norm's scale 1 + 0.1 z and shift 0.1 z, an
embedding row by 0.02. No layer is zero, so every branch (each ResBlock's
last conv and each transformer's ``proj_out``, which a fresh model
zero-initializes) reaches the output and the comparison sees it. The values
are stored in ``dtype``, the type the program serves them in, so the program
and the reference compute from the same numbers. The autoencoder reaches the
program staged on disk as a diffusers directory (``stage_vae``), as SD-1.5's
published one does; the other models are loaded into it by name.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from reference import models as ref_models

CHUNK = 1 << 26  # values per draw (256 MB of float32)
SALTS = {"unet": 1, "vae": 2, "clip": 3}  # each model its own draws from the seed


def derive_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for a torch generator, from the run's seed and a salt."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), *salt]).generate_state(1, np.uint64)[0] >> 1)


def _scale(module: nn.Module, pname: str, shape) -> tuple:
    """(multiplier, offset) of the standard normal for one parameter."""
    if isinstance(module, (ref_models.GroupNorm, ref_models.LayerNorm)):
        return (0.1, 1.0) if pname == "weight" else (0.1, 0.0)
    if isinstance(module, ref_models.Embedding):
        return 0.02, 0.0
    if pname == "bias":
        return 0.02, 0.0
    fan_in = int(np.prod(shape[1:]))
    return fan_in ** -0.5, 0.0


def make_state(kind: str, config: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """The reference-format state dict of model ``kind`` ("unet", "vae",
    "clip") at ``config``'s widths, from ``seed``."""
    meta = ref_models.build(kind, config)
    owners = {}
    for mname, module in meta.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            owners[f"{mname}.{pname}" if mname else pname] = (module, pname, tuple(p.shape))
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, SALTS[kind]))
    state: Dict[str, torch.Tensor] = {}
    names = list(owners)
    i = 0
    while i < len(names):
        j, n = i, 0
        while j < len(names) and (n == 0 or n + int(np.prod(owners[names[j]][2])) <= CHUNK):
            n += int(np.prod(owners[names[j]][2]))
            j += 1
        z = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
        at = 0
        for name in names[i:j]:
            module, pname, shape = owners[name]
            size = int(np.prod(shape))
            mult, offset = _scale(module, pname, shape)
            state[name] = (z[at:at + size].view(shape) * mult + offset).to(dtype)
            at += size
        del z
        i = j
    return state


def stage_vae(config: dict, seed: int, dtype: torch.dtype, device, directory: str) -> str:
    """The seed's autoencoder staged as a diffusers ``AutoencoderKL`` directory
    (``config.json`` and ``diffusion_pytorch_model.bin``), the layout in which
    SD-1.5's published weights come and the program loads them -> its path."""
    vae = config["vae"]
    os.makedirs(directory, exist_ok=True)
    part = f".{os.getpid()}.part"  # written whole, then renamed: a reader sees a whole file
    path = os.path.join(directory, "config.json")
    with open(path + part, "w") as f:
        json.dump({"in_channels": vae["in_channels"], "out_channels": vae["out_channels"],
                   "latent_channels": vae["latent_channels"], "block_out_channels": vae["autoencoder_channels_list"],
                   "layers_per_block": vae["autoencoder_num_res_blocks"], "norm_num_groups": vae["groups"]}, f)
    os.replace(path + part, path)
    path = os.path.join(directory, "diffusion_pytorch_model.bin")
    torch.save({k: v.to("cpu") for k, v in make_state("vae", config, seed, dtype, device).items()}, path + part)
    os.replace(path + part, path)
    return directory
