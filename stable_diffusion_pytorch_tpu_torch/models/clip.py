"""CLIP text encoder and tokenizer (port of stable_diffusion_pytorch_tpu/models/clip.py).

The module tree uses the HF ``CLIPTextModel`` parameter names
(``text_model.encoder.layers.{i}.self_attn.q_proj``, ...), the inverse of the
JAX package's ``convert_text_tower``. Attention goes through
``ops.attention.multi_head_attention``, as the JAX package's
``CLIPEncoderLayer`` does: the text tower's causal mask sends it to
``xla_attention`` on every device (it never reached the flash kernel in the
JAX package either); the vision tower (``models/clip_vision.py``) passes no
mask, so its attention launches the flash-attention kernel (K1) on the card.

Weights (the JAX package's ``load_clip_params``): :func:`load_text_encoder`
loads a staged Hugging Face checkpoint, ``{model_dir}/text_encoder/
model.safetensors`` (read by ``utils/safetensors.py``) or
``pytorch_model.bin``, straight into the tower by name (its
``text_model.*`` keys; the ``position_ids`` buffer is dropped), strictly;
with nothing staged the tower keeps its seeded random weights and the JAX
package's loud warning is given.

Tokenizer resolution: the CLIP BPE of ``models/bpe.py`` (the port's copy of
the JAX package's numpy-only tokenizer) with staged ``{model_dir}/tokenizer/vocab.json`` + merges, else its
offline byte-level vocabulary. The HF tokenizer the JAX package tries first is
not used (``transformers`` is not a dependency of the port).

Prompt weighting and long prompts (the JAX package's ``clip.py:411-559``):
``tokenize_weighted`` parses ``(word:1.3)`` emphasis (``prompt_weighting.py``)
fragment by fragment, ``tokenize_chunked`` cuts a prompt of any length into
K windows of BOS + 75 body tokens + EOS, and ``encode_text(token_weights=)``
applies the weights with the "original mean" rescale in float32.

Textual inversion (inference): ``load_textual_inversion`` reads the port's
checkpoint layout, a ``train_state.pt`` written by
``utils/checkpoint.py:save_checkpoint`` whose ``params`` (or ``ema_params``)
is ``{"ti": [K, 768]}``, with the JAX package's ``textual_inversion.json``
sidecar (``placeholder_token``, ``num_vectors``) beside it; a port of the
textual-inversion trainer writes exactly this. The placeholder tokenizes to
K sentinel ids past the vocabulary, where the tower injects the vectors.
The concept's ids and vectors live in device tensors beside the tower
(made at the first encode on its device, updated in place by
``set_textual_inversion_vectors``).

One program per call (the JAX package's jitted ``_encode`` and
``_encode_ti``): on a CUDA device ``encode_text`` runs the tower as one CUDA
graph per (batch, sequence length, concept present) signature, through the
model's :class:`~stable_diffusion_pytorch_tpu_torch.utils.graphs.GraphPool`:
the first call of a signature is the warm-up (run eagerly on the pool's side
stream) and the capture, later calls copy the ids into the graph's static
input, replay, and clone the output out (a request's cond and uncond
encodes share a signature). The token weighting stays eager after the
tower, as JAX's sits outside its jit. The tower runs eagerly on the CPU,
under ``capture=False`` (a ``LatentDiffusion`` built with ``capture=False``
passes it) and inside another capture.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from stable_diffusion_pytorch_tpu_torch.config import ClipConfig
from stable_diffusion_pytorch_tpu_torch.models.bpe import CLIPBPETokenizer, TokenizerOutput
from stable_diffusion_pytorch_tpu_torch.models.prompt_weighting import parse_weighted_prompt
from stable_diffusion_pytorch_tpu_torch.ops.attention import multi_head_attention
from stable_diffusion_pytorch_tpu_torch.utils.checkpoint import load_params_for_inference, read_weights, resolve_checkpoint
from stable_diffusion_pytorch_tpu_torch.utils.graphs import GraphPool, replayed

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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // self.n_heads
        q, k, v = (p(x).view(b, s, self.n_heads, dh) for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(multi_head_attention(q, k, v, dh ** -0.5, mask).reshape(b, s, d))


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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.text_model = _TextModel(vocab_size, d_model, n_layers, n_heads, intermediate, max_positions)

    def forward(
        self, input_ids: torch.Tensor, token_overrides: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ) -> torch.Tensor:
        """``token_overrides=(ids [K], vectors [K, D])`` puts ``vectors[j]`` in
        place of the token embedding wherever the id is ``ids[j]`` (the
        textual-inversion injection); those ids may lie past the vocabulary,
        so the table lookup is clamped."""
        tm = self.text_model
        s = input_ids.shape[1]
        table = tm.embeddings.token_embedding
        if token_overrides is None:
            tok = table(input_ids)
        else:
            ov_ids, ov_vec = token_overrides
            tok = table(input_ids.clamp(0, self.vocab_size - 1))
            hit = input_ids[..., None] == ov_ids.to(input_ids.device)[None, None, :]  # [B, S, K]
            inj = torch.einsum("bsk,kd->bsd", hit.to(tok.dtype), ov_vec.to(device=tok.device, dtype=tok.dtype))
            tok = torch.where(hit.any(-1, keepdim=True), inj, tok)
        x = tok + tm.embeddings.position_embedding.weight[:s]
        causal = torch.triu(
            torch.ones((s, s), dtype=torch.bool, device=input_ids.device), diagonal=1
        )[None, None]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        return tm.final_layer_norm(x)


def load_clip_state(model_dir: Optional[str]) -> Optional[dict]:
    """The staged HF ``CLIPTextModel`` state dict under ``model_dir``
    (``text_encoder/model.safetensors``, else ``text_encoder/pytorch_model.bin``),
    or None when neither is there."""
    if not model_dir:
        return None
    for name in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(model_dir, "text_encoder", name)
        if os.path.exists(path):
            return read_weights(path)
    return None


def tower_state(state: dict, prefix: str = "text_model.") -> dict:
    """One tower's entries of an HF state dict, the keys under ``prefix``
    (``text_model.``: a CLIPTextModel's, or a full CLIPModel's text half;
    ``vision_model.``), without the ``position_ids`` buffer HF saves."""
    return {k: v for k, v in state.items() if k.startswith(prefix) and not k.endswith("position_ids")}


@torch.no_grad()
def load_text_encoder(module: CLIPTextTransformer, model_dir: Optional[str]) -> bool:
    """Load the staged text encoder under ``model_dir`` into ``module`` by
    name, strictly, in the module's dtype and device -> True; with none
    staged, warn as the JAX package does and leave the weights -> False."""
    state = load_clip_state(model_dir)
    if state is None:
        warnings.warn(
            "\n" + "!" * 78 + "\n"
            f"!! CLIP FALLBACK: no pretrained text-encoder checkpoint under "
            f"{model_dir!r};\n!! using RANDOM-INIT weights (seeded). "
            "Text conditioning is meaningless until real\n!! weights are "
            "staged (e.g. data/pretrained/text_encoder/model.safetensors)."
            "\n" + "!" * 78,
            stacklevel=2,
        )
        return False
    module.load_state_dict(tower_state(state), strict=True)
    return True


def resolve_tokenizer(cfg: ClipConfig) -> CLIPBPETokenizer:
    if cfg.model_dir:
        tok_dir = os.path.join(cfg.model_dir, "tokenizer")
        if os.path.exists(os.path.join(tok_dir, "vocab.json")):
            return CLIPBPETokenizer.from_dir(tok_dir, cfg.max_seq_len)
    return CLIPBPETokenizer(max_seq_len=cfg.max_seq_len)


class CLIPModel:
    """Tokenizer + frozen text encoder with the JAX package's call surface;
    ``pretrained`` says whether staged weights were loaded."""

    def __init__(self, cfg: ClipConfig, module: CLIPTextTransformer, pretrained: bool = False):
        self.cfg = cfg
        self.max_seq_len = cfg.max_seq_len
        self.module = module
        self.pretrained = pretrained
        self.tokenizer = resolve_tokenizer(cfg)
        self._ti: Optional[Tuple[str, np.ndarray, np.ndarray]] = None
        # the concept on the tower's device: (the _ti it holds, ids [K], vectors [K, D] f32)
        self._ti_device: Optional[tuple] = None
        self._graphs = GraphPool()  # the tower's CUDA graphs, one per signature

    # ------------------------------------------------------------------ #
    # textual inversion
    # ------------------------------------------------------------------ #

    def add_textual_inversion(self, placeholder_token: str, vectors) -> np.ndarray:
        """Register a learned concept: ``placeholder_token`` in a prompt
        tokenizes to K sentinel ids (vocab_size + j) and ``vectors`` [K, 768]
        are injected there by ``encode_text``. -> the sentinel ids."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.module.d_model:
            raise ValueError(f"textual-inversion vectors {vectors.shape}, want [K, {self.module.d_model}]")
        ids = np.arange(vectors.shape[0], dtype=np.int32) + VOCAB_SIZE
        self._ti = (placeholder_token, ids, vectors)
        return ids

    def set_textual_inversion_vectors(self, vectors) -> None:
        """New vectors for the registered concept; its device tensor is
        updated in place (the captured towers read it there)."""
        if self._ti is None:
            raise ValueError("call add_textual_inversion first")
        old = self._ti
        self._ti = (old[0], old[1], np.asarray(vectors, np.float32))
        held = self._ti_device
        if held is not None and held[0] is old and held[2].shape == self._ti[2].shape:
            held[2].copy_(torch.from_numpy(self._ti[2]))
            self._ti_device = (self._ti, held[1], held[2])

    def _concept_tensors(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The registered concept's (ids, vectors) on ``device``, made again
        (and the tower's graphs dropped) when the concept or its device
        changed since they were made."""
        held = self._ti_device
        if held is None or held[0] is not self._ti or held[2].device != device:
            _, ids, vectors = self._ti
            held = (self._ti, torch.as_tensor(ids, dtype=torch.long).to(device),
                    torch.from_numpy(np.array(vectors, np.float32)).to(device))
            self._ti_device = held
            self._graphs.clear()
        return held[1], held[2]

    def load_textual_inversion(self, ckpt_dir: str) -> str:
        """Register the concept of a textual-inversion checkpoint (the port's
        layout, module docstring); -> the placeholder token for prompts."""
        with open(os.path.join(ckpt_dir, "textual_inversion.json")) as f:
            sidecar = json.load(f)
        vectors = np.asarray(load_params_for_inference(resolve_checkpoint(ckpt_dir))["ti"].float(), np.float32)
        if vectors.shape[0] != sidecar["num_vectors"]:
            raise ValueError(f"sidecar says {sidecar['num_vectors']} vectors, checkpoint has {vectors.shape[0]}")
        self.add_textual_inversion(sidecar["placeholder_token"], vectors)
        return sidecar["placeholder_token"]

    # ------------------------------------------------------------------ #
    # tokenization
    # ------------------------------------------------------------------ #

    def _plain_ids(self, text: str) -> List[int]:
        """Token ids of ``text`` without BOS, EOS or padding."""
        if not text.strip():
            return []
        ids = list(np.asarray(
            self.tokenizer(text, max_length=10_000, padding=False, truncation=False).input_ids).reshape(-1))
        if ids and ids[0] == BOS_TOKEN_ID:
            ids = ids[1:]
        while ids and ids[-1] == EOS_TOKEN_ID:
            ids = ids[:-1]
        return [int(i) for i in ids]

    def _body_ids(self, text: str) -> List[int]:
        """Fragment ids without specials; a registered placeholder expands to
        its sentinel ids."""
        if self._ti is None:
            return self._plain_ids(text)
        token, sentinel_ids, _ = self._ti
        body: List[int] = []
        for i, part in enumerate(text.split(token)):
            if i > 0:
                body.extend(int(s) for s in sentinel_ids)
            body.extend(self._plain_ids(part))
        return body

    @staticmethod
    def _finish_row(ids: List[int], max_len: int) -> List[int]:
        """BOS + body + EOS, truncated keeping the final EOS, padded with EOS."""
        row = [BOS_TOKEN_ID] + ids + [EOS_TOKEN_ID]
        if len(row) > max_len:
            row = row[: max_len - 1] + [EOS_TOKEN_ID]
        return row + [EOS_TOKEN_ID] * (max_len - len(row))

    def _weighted_body(self, prompt: str) -> Tuple[List[int], List[float]]:
        """(body ids, per-token weights) of one prompt with emphasis syntax."""
        body: List[int] = []
        wts: List[float] = []
        for text, w in parse_weighted_prompt(prompt):
            ids = self._body_ids(text)
            body.extend(ids)
            wts.extend([w] * len(ids))
        return body, wts

    def tokenize(self, prompt: Union[str, Sequence[str]] = ""):
        """Pad to ``max_seq_len`` with EOS, truncate keeping the final EOS; a
        registered placeholder expands to its sentinel ids."""
        if self._ti is not None:
            prompts = [prompt] if isinstance(prompt, str) else list(prompt)
            rows = [self._finish_row(self._body_ids(p), self.max_seq_len) for p in prompts]
            return TokenizerOutput(np.asarray(rows, dtype=np.int32))
        return self.tokenizer(prompt, max_length=self.max_seq_len, padding="max_length", truncation=True)

    def tokenize_weighted(self, prompts: Sequence[str]):
        """Prompts with ``(word:1.3)`` emphasis -> (ids [B, 77], per-token
        weights [B, 77] f32); BOS, EOS and padding weigh 1."""
        max_len = self.max_seq_len
        rows, weight_rows = [], []
        for prompt in prompts:
            body, wts = self._weighted_body(prompt)
            rows.append(self._finish_row(body, max_len))
            wrow = [1.0] + wts[: max_len - 2] + [1.0]
            weight_rows.append(wrow + [1.0] * (max_len - len(wrow)))
        return TokenizerOutput(np.asarray(rows, dtype=np.int32)), np.asarray(weight_rows, dtype=np.float32)

    def tokenize_chunked(self, prompts: Sequence[str], weighted: bool = False, num_chunks: Optional[int] = None):
        """Prompts of any length -> (ids [B, K, 77], weights [B, K, 77] or
        None, K): K windows of BOS + 75 body tokens + EOS each; K is the most
        any prompt of the batch needs unless ``num_chunks`` pins it."""
        window = self.max_seq_len - 2
        bodies = []
        for p in prompts:
            if weighted:
                bodies.append(self._weighted_body(p))
            else:
                b = self._body_ids(p)
                bodies.append((b, [1.0] * len(b)))
        need = max(1, max((len(b) + window - 1) // window for b, _ in bodies))
        k = num_chunks or need
        rows, wrows = [], []
        for body, wts in bodies:
            body, wts = body[: k * window], wts[: k * window]
            chunk_ids, chunk_w = [], []
            for c in range(k):
                piece, wpiece = body[c * window:(c + 1) * window], wts[c * window:(c + 1) * window]
                chunk_ids.append(self._finish_row(piece, self.max_seq_len))
                wrow = [1.0] + wpiece + [1.0]
                chunk_w.append(wrow + [1.0] * (self.max_seq_len - len(wrow)))
            rows.append(chunk_ids)
            wrows.append(chunk_w)
        weights = np.asarray(wrows, dtype=np.float32) if weighted else None
        return np.asarray(rows, dtype=np.int32), weights, k

    # ------------------------------------------------------------------ #
    # encoding
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def encode_text(self, input_ids, token_weights=None, capture: bool = True) -> torch.Tensor:
        """[B, S] token ids -> [B, S, 768] on the encoder's device; the tower
        a replayed CUDA graph on a CUDA device unless ``capture`` is False
        (module docstring).

        ``token_weights`` [B, S]: each token's embedding times its weight,
        then the sequence rescaled so that its mean magnitude is the
        unweighted one (abs-mean before over abs-mean after, floor 1e-8), in
        float32 and cast back."""
        device = self.module.text_model.final_layer_norm.weight.device
        ids = torch.as_tensor(input_ids if isinstance(input_ids, torch.Tensor) else np.asarray(input_ids),
                              dtype=torch.long, device=device)
        concept = None if self._ti is None else self._concept_tensors(device)

        def tower(x):
            return self.module(x) if concept is None else self.module(x, token_overrides=concept)

        emb = replayed(self._graphs, tower, ids, key=(tuple(ids.shape), concept is not None), capture=capture,
                       what=f"the text encoder (ids {list(ids.shape)}, concept {concept is not None})",
                       pinned=lambda: [*self.module.parameters(), *(concept or ())])
        if token_weights is None:
            return emb
        w = torch.as_tensor(np.asarray(token_weights, np.float32), device=device)
        f = emb.float()
        prev = f.abs().mean(dim=(-2, -1), keepdim=True)
        f = f * w[..., None]
        new = f.abs().mean(dim=(-2, -1), keepdim=True)
        return (f * (prev / new.clamp(min=1e-8))).to(emb.dtype)

    def encode_text_chunked(self, ids, token_weights=None, capture: bool = True) -> torch.Tensor:
        """[B, K, 77] chunk ids -> [B, K*77, 768]: each chunk runs through the
        tower alone (positions restart per chunk), the sequences concatenate."""
        b, k, s = np.shape(ids)
        emb = self.encode_text(
            np.asarray(ids).reshape(b * k, s),
            token_weights=None if token_weights is None else np.asarray(token_weights).reshape(b * k, s),
            capture=capture)
        return emb.reshape(b, k * s, -1)
