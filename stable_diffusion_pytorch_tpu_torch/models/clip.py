"""CLIP text encoder and tokenizer (port of stable_diffusion_pytorch_tpu/models/clip.py).

The module tree uses the HF ``CLIPTextModel`` parameter names
(``text_model.encoder.layers.{i}.self_attn.q_proj``, ...), the inverse of the
JAX package's ``convert_text_tower``. The causal-masked attention runs as
``ops.attention.xla_attention`` on every device: it never reached the flash
kernel in the JAX package either.

Tokenizer resolution: the CLIP BPE of ``models/bpe.py`` (the port's copy of
the JAX package's numpy-only tokenizer) with staged ``{model_dir}/tokenizer/vocab.json`` + merges, else its
offline byte-level vocabulary. The HF tokenizer the JAX package tries first is
not used (``transformers`` is not a dependency of the port).
"""

from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np
import torch
from torch import nn

from stable_diffusion_pytorch_tpu_torch.config import ClipConfig
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer
from stable_diffusion_pytorch_tpu_torch.ops.attention import xla_attention

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407
VOCAB_SIZE = 49408


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.n_heads
        q, k, v = (p(x).view(b, s, self.n_heads, dh) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(xla_attention(q, k, v, dh ** -0.5, mask).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, d_model: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(d_model, intermediate)
        self.fc2 = nn.Linear(intermediate, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then x + mlp(ln2(x))."""

    def __init__(self, d_model: int, n_heads: int, intermediate: int):
        super().__init__()
        self.self_attn = CLIPAttention(d_model, n_heads)
        self.layer_norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = CLIPMLP(d_model, intermediate)
        self.layer_norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, max_positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, d_model)
        self.position_embedding = nn.Embedding(max_positions, d_model)


class _Encoder(nn.Module):
    def __init__(self, n_layers: int, d_model: int, n_heads: int, intermediate: int):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(d_model, n_heads, intermediate) for _ in range(n_layers)
        )


class _TextModel(nn.Module):
    def __init__(self, vocab_size, d_model, n_layers, n_heads, intermediate, max_positions):
        super().__init__()
        self.embeddings = _Embeddings(vocab_size, d_model, max_positions)
        self.encoder = _Encoder(n_layers, d_model, n_heads, intermediate)
        self.final_layer_norm = nn.LayerNorm(d_model, eps=1e-5)


class CLIPTextTransformer(nn.Module):
    """The SD-1.5 text tower: ``forward(input_ids [B,S]) -> last_hidden_state [B,S,768]``."""

    def __init__(
        self,
        vocab_size: int = VOCAB_SIZE,
        d_model: int = 768,
        n_layers: int = 12,
        n_heads: int = 12,
        intermediate: int = 3072,
        max_positions: int = 77,
    ):
        super().__init__()
        self.text_model = _TextModel(vocab_size, d_model, n_layers, n_heads, intermediate, max_positions)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        s = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:s]
        causal = torch.triu(
            torch.ones((s, s), dtype=torch.bool, device=input_ids.device), diagonal=1
        )[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)


def resolve_tokenizer(cfg: ClipConfig) -> CLIPBPETokenizer:
    if cfg.model_dir:
        tok_dir = os.path.join(cfg.model_dir, "tokenizer")
        if os.path.exists(os.path.join(tok_dir, "vocab.json")):
            return CLIPBPETokenizer.from_dir(tok_dir, cfg.max_seq_len)
    return CLIPBPETokenizer(max_seq_len=cfg.max_seq_len)


class CLIPModel:
    """Tokenizer + frozen text encoder with the JAX package's call surface."""

    def __init__(self, cfg: ClipConfig, module: CLIPTextTransformer):
        self.cfg = cfg
        self.max_seq_len = cfg.max_seq_len
        self.module = module
        self.tokenizer = resolve_tokenizer(cfg)

    def tokenize(self, prompt: Union[str, Sequence[str]] = ""):
        """Pad to ``max_seq_len`` with EOS, truncate keeping the final EOS."""
        return self.tokenizer(prompt, max_length=self.max_seq_len, padding="max_length", truncation=True)

    @torch.no_grad()
    def encode_text(self, input_ids) -> torch.Tensor:
        """[B, S] token ids -> [B, S, 768] on the encoder's device."""
        device = self.module.text_model.final_layer_norm.weight.device
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device)
        return self.module(ids)
