"""The VAE-latent cache (port of utils/latent_cache.py): encode the dataset
once with the frozen VAE, then train the UNet from the cached posteriors.

The cache holds the posterior MOMENTS (mean and log-variance, f32), not
samples, so the train step draws a fresh latent every epoch
(``trainers/steps.py``, the "moments" batch); with a text encoder it also
holds each row's CLIP context (f16) and the empty prompt's embedding (f32),
and CLIP leaves the training loop too. One ``.npz``, the JAX package's
layout (``moments`` [N, h, w, 2c], ``input_ids`` [N, S] int32,
``context_emb`` [N, S, D] f16, ``uncond_emb`` [S, D] f32), so either
package reads the other's file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from stable_diffusion_pytorch_tpu_torch.utils.data import DataLoader, collate_fn
from stable_diffusion_pytorch_tpu_torch.utils.graphs import GraphPool, module_tensors, replayed
from stable_diffusion_pytorch_tpu_torch.utils.preprocess import device_preprocess


@torch.no_grad()
def build_latent_cache(vae, dataset, cache_path: str, batch_size: int = 32, logger=None, text_encoder=None,
                       capture: bool = True) -> str:
    """Encode every row of ``dataset`` with ``vae`` (on its device, in its
    dtype), ``batch_size`` rows at a time, and save the moments and token
    ids to ``cache_path``; with ``text_encoder`` (a ``models.clip.CLIPModel``)
    the context embeddings and the empty prompt's embedding too. Rows in
    uint8 (``--device-preprocess``) are normalized on the device first. On a
    CUDA device the encode is one CUDA graph per batch signature (the JAX
    package's jitted encode; the text encoder's are its own) unless
    ``capture`` is False; the graphs go with the call."""
    device = next(vae.parameters()).device
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False, collate=collate_fn)
    graphs = GraphPool()

    def moments(pixels):
        dist = vae.encode(pixels)
        return torch.cat([dist.mean, dist.log_var], dim=-1).float()

    moments_out, ids_out, ctx_out = [], [], []
    for batch in loader:
        if "pixel_values" in batch:
            pixels = torch.from_numpy(batch["pixel_values"]).to(device)
        else:
            raw = torch.from_numpy(batch["raw_images"]).to(device)
            pixels = device_preprocess(raw, raw.shape[1])
        moments_out.append(replayed(graphs, moments, pixels, what=f"the latent cache's encode ({list(pixels.shape)})",
                                    pinned=module_tensors(vae), capture=capture).cpu().numpy())
        ids_out.append(batch["input_ids"])
        if text_encoder is not None:
            ctx_out.append(text_encoder.encode_text(batch["input_ids"], capture=capture).float().cpu().numpy()
                           .astype(np.float16))
    moments = np.concatenate(moments_out)
    arrays = {"moments": moments, "input_ids": np.concatenate(ids_out)}
    if text_encoder is not None:
        arrays["context_emb"] = np.concatenate(ctx_out)
        uncond = text_encoder.encode_text(text_encoder.tokenize([""]).input_ids, capture=capture)[0]
        arrays["uncond_emb"] = uncond.float().cpu().numpy()
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    np.savez(cache_path, **arrays)
    if logger:
        total_mb = sum(a.nbytes for a in arrays.values()) / 1e6
        logger.info(f"cached {moments.shape[0]} latents{' + text embeddings' if text_encoder is not None else ''} "
                    f"({total_mb:.1f} MB) to {cache_path}")
    return cache_path


class LatentCacheDataset:
    """The rows of a cache file: ``moments`` and ``input_ids``, and
    ``context_emb`` when the file holds text; ``uncond_emb`` is the empty
    prompt's embedding the train step drops prompts to."""

    def __init__(self, cache_path: str):
        with np.load(cache_path) as data:
            self.moments = data["moments"]
            self.input_ids = data["input_ids"]
            self.context_emb = data["context_emb"] if "context_emb" in data else None
            self.uncond_emb = data["uncond_emb"] if "uncond_emb" in data else None

    @property
    def has_text_cache(self) -> bool:
        return self.context_emb is not None

    def __len__(self) -> int:
        return self.moments.shape[0]

    def __getitem__(self, idx: int) -> dict:
        row = {"moments": self.moments[idx], "input_ids": self.input_ids[idx]}
        if self.context_emb is not None:
            row["context_emb"] = self.context_emb[idx]
        return row


def collate_latents(examples) -> dict:
    """Stack cache rows: ``moments`` f32, ``input_ids`` int32, ``context_emb`` f32."""
    out = {
        "moments": np.stack([e["moments"] for e in examples]).astype(np.float32),
        "input_ids": np.stack([e["input_ids"] for e in examples]).astype(np.int32),
    }
    if "context_emb" in examples[0]:
        out["context_emb"] = np.stack([e["context_emb"] for e in examples]).astype(np.float32)
    return out
