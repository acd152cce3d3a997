"""CLIP byte-pair-encoding tokenizer (offline-first).

The port's own copy of stable_diffusion_pytorch_tpu/models/bpe.py (numpy
only), kept equal to it by a test.

The reference tokenizes through the pretrained HF ``CLIPTokenizer``
(the reference's stable_diffusion/models/clip_model.py:62-85: pad to 77,
truncate, BOS/EOS). This is a faithful implementation of that tokenizer's
algorithm — byte-to-unicode mapping, ``</w>`` end-of-word markers, ranked merge
loop, the CLIP splitting regex, whitespace cleaning and lowercasing — that
loads the real ``vocab.json``/``merges.txt`` when they are staged locally
(``data/pretrained/tokenizer/``) and produces token-for-token HF equality.

Offline (no vocab files), it constructs the *byte-level base vocabulary with
zero merges*. In the published CLIP vocab, ids 0-255 are exactly the byte
symbols and 256-511 the ``byte</w>`` symbols, so the fallback's ids are REAL
CLIP ids for a character-level segmentation — unlike a word hash, pretrained
embeddings interpret them meaningfully, and the encoding is a strict
coarsening of true BPE.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re as _stdlib_re
from typing import List, Optional, Sequence, Union

import numpy as np

try:  # the exact CLIP pattern needs \p classes (regex module, a transformers dep)
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # ASCII-equivalent approximation
    _PAT = _stdlib_re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
        _stdlib_re.IGNORECASE | _stdlib_re.UNICODE,
    )

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"
BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """The GPT-2/CLIP reversible byte->unicode map: printable bytes keep their
    codepoint, the rest shift to 256+n (so every byte is a visible char)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def whitespace_clean(text: str) -> str:
    return _stdlib_re.sub(r"\s+", " ", text).strip()


class TokenizerOutput:
    def __init__(self, input_ids: np.ndarray):
        self.input_ids = input_ids


class CLIPBPETokenizer:
    """CLIP BPE with the HF call surface the pipeline uses
    (``__call__(prompts, max_length, padding, truncation) -> .input_ids``)."""

    model_max_length = 77

    def __init__(
        self,
        vocab_file: Optional[str] = None,
        merges_file: Optional[str] = None,
        max_seq_len: int = 77,
    ):
        self.max_seq_len = max_seq_len
        self.byte_encoder = bytes_to_unicode()
        if vocab_file and os.path.exists(vocab_file):
            with open(vocab_file, encoding="utf-8") as f:
                self.encoder = json.load(f)
            merges: List[tuple] = []
            if merges_file and os.path.exists(merges_file):
                with open(merges_file, encoding="utf-8") as f:
                    lines = f.read().split("\n")
                # first line is the "#version" header; trailing blanks dropped
                for line in lines[1:]:
                    parts = line.split()
                    if len(parts) == 2:
                        merges.append(tuple(parts))
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            self.pretrained = True
        else:
            # byte-level base vocab, zero merges: ids 0-511 match real CLIP
            base = list(self.byte_encoder.values())
            self.encoder = {tok: i for i, tok in enumerate(base)}
            self.encoder.update(
                {tok + "</w>": 256 + i for i, tok in enumerate(base)}
            )
            self.encoder[BOS_TOKEN] = BOS_TOKEN_ID
            self.encoder[EOS_TOKEN] = EOS_TOKEN_ID
            self.bpe_ranks = {}
            self.pretrained = False
        self.bos_id = self.encoder.get(BOS_TOKEN, BOS_TOKEN_ID)
        self.eos_id = self.encoder.get(EOS_TOKEN, EOS_TOKEN_ID)
        self._cache = {BOS_TOKEN: BOS_TOKEN, EOS_TOKEN: EOS_TOKEN}

    @classmethod
    def from_dir(cls, tokenizer_dir: str, max_seq_len: int = 77) -> "CLIPBPETokenizer":
        return cls(
            vocab_file=os.path.join(tokenizer_dir, "vocab.json"),
            merges_file=os.path.join(tokenizer_dir, "merges.txt"),
            max_seq_len=max_seq_len,
        )

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no specials). HF CLIPTokenizer semantics without
        ftfy: html-unescape twice, collapse whitespace, lowercase."""
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(
                self.byte_encoder[b] for b in token.encode("utf-8")
            )
            for sym in self.bpe(token).split(" "):
                ids.append(self.encoder.get(sym, self.eos_id))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Best-effort inverse (debugging / serving echoes)."""
        decoder = {v: k for k, v in self.encoder.items()}
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(decoder.get(int(i), "") for i in ids)
        text = text.replace(BOS_TOKEN, "").replace(EOS_TOKEN, "")
        raw = bytearray(byte_decoder.get(ch, 32) for ch in text.replace("</w>", " "))
        return raw.decode("utf-8", errors="replace").strip()

    def __call__(
        self,
        prompts: Union[str, Sequence[str]],
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
        **_: object,
    ) -> TokenizerOutput:
        """clip_model.py:72-85 semantics: BOS + ids + EOS, truncate to
        max_length, pad with EOS (CLIP's pad token IS <|endoftext|>)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        max_len = max_length or self.max_seq_len
        rows = []
        for prompt in prompts:
            ids = [self.bos_id] + self.encode(prompt) + [self.eos_id]
            if truncation and len(ids) > max_len:
                ids = ids[: max_len - 1] + [self.eos_id]
            if padding == "max_length":
                ids = ids + [self.eos_id] * (max_len - len(ids))
            rows.append(ids)
        return TokenizerOutput(np.asarray(rows, dtype=np.int32))
