"""CLIP vision tower and the CLIP score (port of stable_diffusion_pytorch_tpu/models/clip_vision.py).

The CLIP score (Hessel et al. 2021) of an image and its prompt is
100 * max(cos(text embedding, image embedding), 0), averaged over the pairs.
The embeddings come from a full Hugging Face ``CLIPModel`` (ViT-L/14 by
default: text 768 wide, 12 layers; vision 1024 wide, 24 layers, 16 heads,
patch 14 at 224x224, 257 tokens; both projected to 768), staged at
``{model_dir}/clip_full/model.safetensors`` (or ``pytorch_model.bin``). Both
towers carry HF's names (``vision_model.pre_layrnorm`` included, HF's
spelling) and load by name, strictly.

:class:`CLIPVisionTransformer`: patch conv without bias, class token,
learned positions, pre-LN, unmasked pre-norm layers (the text tower's
``CLIPEncoderLayer``, whose unmasked attention launches the flash-attention
kernel, K1, on the card: [B, 257, 257, 16, 64] at ViT-L/14), the class
token's state after the post-LN. The text embedding is the text tower's
state at the end-of-text token (the largest id, as in CLIP's vocabulary).

:func:`preprocess_images` resizes as the JAX package's
``jax.image.resize(..., "bilinear")``, which antialiases when it shrinks: a
separable triangle filter widened by the shrink factor, at half-pixel
centres, each output's weights normalized (:func:`resize_weights` builds
that matrix as JAX does, in float32); torch's ``antialias=True`` is close to
it but not the same.

:class:`CLIPScorer` computes in full float32 (``utils/precision.py``: no TF32
inside its calls), so a score does not move with the process's TF32
switches. On a CUDA device each tower's embedding is one CUDA graph per
batch signature (the JAX package's jitted ``_embed_text`` and
``_embed_image``), the scorer's graphs in one pool (``utils/graphs.py``);
``capture=False`` runs them eagerly. With no checkpoint staged it warns loudly and scores with seeded
random weights (the machinery runs; the numbers mean nothing).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from stable_diffusion_pytorch_tpu_torch.models.clip import CLIPEncoderLayer, CLIPTextTransformer, tower_state
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import read_weights
from stable_diffusion_pytorch_tpu_torch.utils.graphs import GraphPool, module_tensors, replayed
from stable_diffusion_pytorch_tpu_torch.utils.precision import full_float32

# CLIP preprocessing constants (OpenAI)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
PROJECTION_DIM = 768  # of the random-weight fallback


class _VisionEmbeddings(nn.Module):
    def __init__(self, image_size: int, patch_size: int, d_model: int):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, d_model, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d_model))
        self.position_embedding = nn.Embedding((image_size // patch_size) ** 2 + 1, d_model)


class _Encoder(nn.Module):
    def __init__(self, n_layers: int, d_model: int, n_heads: int, intermediate: int):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(d_model, n_heads, intermediate) for _ in range(n_layers))


class _VisionModel(nn.Module):
    def __init__(self, image_size, patch_size, d_model, n_layers, n_heads, intermediate):
        super().__init__()
        self.embeddings = _VisionEmbeddings(image_size, patch_size, d_model)
        self.pre_layrnorm = nn.LayerNorm(d_model, eps=1e-5)
        self.encoder = _Encoder(n_layers, d_model, n_heads, intermediate)
        self.post_layernorm = nn.LayerNorm(d_model, eps=1e-5)


class CLIPVisionTransformer(nn.Module):
    """[B, H, W, 3] CLIP-normalized, channel-last -> pooled class token [B, d_model]."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, d_model: int = 1024, n_layers: int = 24,
                 n_heads: int = 16, intermediate: int = 4096):
        super().__init__()
        self.image_size = image_size
        self.d_model = d_model
        self.vision_model = _VisionModel(image_size, patch_size, d_model, n_layers, n_heads, intermediate)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        x = emb.patch_embedding(pixel_values.to(emb.patch_embedding.weight.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # [B, P, D], patches in row-major order
        cls = emb.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = vm.pre_layrnorm(x + emb.position_embedding.weight[: x.shape[1]])
        for layer in vm.encoder.layers:
            x = layer(x)  # no mask: bidirectional
        return vm.post_layernorm(x[:, 0])


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of ``jax.image.resize``'s bilinear
    resize with antialiasing (``compute_weight_mat`` of the triangle kernel):
    sample positions at half-pixel centres, the kernel widened by the shrink
    factor, each column normalized to sum to 1."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale) - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def preprocess_images(images, image_size: int = 224, device="cpu") -> torch.Tensor:
    """uint8 images [N, H, W, 3] -> CLIP-normalized float32 [N, S, S, 3] on
    ``device``: the whole frame resized to S x S as the JAX package resizes it
    (module docstring), then normalized with CLIP's mean and std."""
    x = torch.as_tensor(np.asarray(images), device=device).float() / 255.0
    if x.shape[1] != image_size or x.shape[2] != image_size:
        wh = torch.from_numpy(resize_weights(x.shape[1], image_size)).to(device)
        ww = torch.from_numpy(resize_weights(x.shape[2], image_size)).to(device)
        with full_float32():
            x = torch.einsum("nhwc,hp,wq->npqc", x, wh, ww)
    mean, std = (torch.from_numpy(a).to(device) for a in (CLIP_MEAN, CLIP_STD))
    return (x - mean) / std


def load_full_clip_state(model_dir: Optional[str]) -> Optional[dict]:
    """The staged HF ``CLIPModel`` state dict under ``{model_dir}/clip_full/``
    (``model.safetensors``, else ``pytorch_model.bin``), or None."""
    if not model_dir:
        return None
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(model_dir, "clip_full", name)
        if os.path.exists(path):
            return read_weights(path)
    return None


class CLIPScorer:
    """Frozen full CLIP on ``device`` (the card unless the caller asks for the
    CPU): ``score(images, prompts)`` -> the mean CLIP score; ``pretrained``
    says whether staged weights were loaded. ``text_cfg``/``vision_cfg`` are
    the towers' keyword arguments (their defaults are ViT-L/14's);
    ``capture``: each embedding a replayed CUDA graph on a CUDA device."""

    def __init__(self, tokenizer, model_dir: Optional[str] = "data/pretrained", text_cfg: Optional[dict] = None,
                 vision_cfg: Optional[dict] = None, device="cuda", seed: int = 0, capture: bool = True):
        from stable_diffusion_pytorch_tpu_torch.models.build import without_default_init, init_weights, require_device

        device = require_device(device)
        self.tokenizer = tokenizer
        with without_default_init():  # every weight is loaded or drawn below
            self.text_tower = CLIPTextTransformer(**(text_cfg or {}))
            self.vision_tower = CLIPVisionTransformer(**(vision_cfg or {}))
        state = load_full_clip_state(model_dir)
        if state is None:
            warnings.warn(
                "\n" + "!" * 78 + "\n"
                f"!! CLIP-SCORE FALLBACK: no full-CLIP checkpoint under {model_dir!r}/clip_full;\n"
                "!! using RANDOM-INIT weights — scores are meaningless until real weights are staged.\n"
                + "!" * 78, stacklevel=2)
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for tower in (self.text_tower, self.vision_tower):
                    init_weights(tower, gen)
                self.vision_tower.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=gen)
                self.text_proj = torch.randn(PROJECTION_DIM, self.text_tower.d_model, generator=gen) * 0.02
                self.visual_proj = torch.randn(PROJECTION_DIM, self.vision_tower.d_model, generator=gen) * 0.02
            self.pretrained = False
        else:
            self.text_tower.load_state_dict(tower_state(state, "text_model."), strict=True)
            self.vision_tower.load_state_dict(tower_state(state, "vision_model."), strict=True)
            self.text_proj = state["text_projection.weight"].float()  # [p, d]
            self.visual_proj = state["visual_projection.weight"].float()
            self.pretrained = True
        self.device = device
        for tower in (self.text_tower, self.vision_tower):
            tower.float().to(device).eval().requires_grad_(False)
        self.text_proj, self.visual_proj = self.text_proj.to(device), self.visual_proj.to(device)
        self.capture = capture
        self._graphs = GraphPool()

    def _text(self, ids: torch.Tensor) -> torch.Tensor:
        with full_float32():
            hidden = self.text_tower(ids)
            emb = hidden[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)] @ self.text_proj.T
            return emb / emb.norm(dim=-1, keepdim=True)

    def _image(self, pixels: torch.Tensor) -> torch.Tensor:
        with full_float32():
            emb = self.vision_tower(pixels) @ self.visual_proj.T
            return emb / emb.norm(dim=-1, keepdim=True)

    @torch.no_grad()
    def embed_text(self, ids) -> torch.Tensor:
        """[B, S] token ids -> unit text embeddings [B, p] (the state at the EOT token)."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        return replayed(self._graphs, self._text, ids, what=f"the CLIP score's text tower ({list(ids.shape)})",
                        pinned=lambda: [*module_tensors(self.text_tower)(), self.text_proj], capture=self.capture)

    @torch.no_grad()
    def embed_images(self, pixels: torch.Tensor) -> torch.Tensor:
        """CLIP-normalized [B, S, S, 3] -> unit image embeddings [B, p]."""
        pixels = pixels.to(self.device)
        return replayed(self._graphs, self._image, pixels,
                        what=f"the CLIP score's vision tower ({list(pixels.shape)})",
                        pinned=lambda: [*module_tensors(self.vision_tower)(), self.visual_proj], capture=self.capture)

    def similarities(self, images, prompts: Sequence[str], batch: int = 16) -> np.ndarray:
        """cos(text, image) of each (uint8 image [H, W, 3], prompt) pair -> [N] float32."""
        if len(images) != len(prompts):
            raise ValueError(f"one prompt per image: {len(images)} images, {len(prompts)} prompts")
        sims = []
        for i in range(0, len(images), batch):
            px = preprocess_images(np.asarray(images[i: i + batch]), self.vision_tower.image_size, self.device)
            ids = self.tokenizer(list(prompts[i: i + batch]), max_length=77, padding="max_length",
                                 truncation=True).input_ids
            sims.append((self.embed_text(ids) * self.embed_images(px)).sum(-1).cpu().numpy())
        return np.concatenate(sims)

    def score(self, images, prompts: Sequence[str], batch: int = 16) -> float:
        """Mean CLIP score over (image, prompt) pairs; images uint8 [N, H, W, 3]."""
        return float(100.0 * np.maximum(self.similarities(images, prompts, batch), 0.0).mean())
