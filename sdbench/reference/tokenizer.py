"""CLIP's tokenizer on its byte-level base vocabulary with no merges: the
offline vocabulary the program uses when no published ``vocab.json`` is
staged (ids 0-255 are the byte symbols, 256-511 the same bytes ending a
word, as in the published CLIP vocabulary).

Text is HTML-unescaped twice, its whitespace collapsed and lowercased, split
into CLIP's pre-tokens (letters, single digits, runs of other symbols) and
each pre-token's bytes mapped through GPT-2's byte-to-unicode table; every
byte is one token, the last of a pre-token in its ``</w>`` form. A row is
BOS + ids + EOS, truncated to keep its final EOS, padded with EOS.
"""

from __future__ import annotations

import html
import re
from typing import List, Sequence

import numpy as np

BOS, EOS = 49406, 49407
_PRE = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
                  re.IGNORECASE | re.UNICODE)


def _byte_symbols() -> List[int]:
    """The byte values in the order of GPT-2's byte-to-unicode table: the
    printable ranges first, then the rest."""
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    return printable + [b for b in range(256) if b not in printable]


_ID_OF_BYTE = {b: i for i, b in enumerate(_byte_symbols())}


def encode(text: str) -> List[int]:
    text = re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip().lower()
    ids: List[int] = []
    for piece in _PRE.findall(text):
        raw = piece.encode("utf-8")
        ids.extend(_ID_OF_BYTE[b] for b in raw[:-1])
        ids.append(256 + _ID_OF_BYTE[raw[-1]])
    return ids


def tokenize(prompts: Sequence[str], max_len: int = 77) -> np.ndarray:
    """[B, max_len] int64 token ids."""
    rows = []
    for p in prompts:
        row = [BOS] + encode(p) + [EOS]
        if len(row) > max_len:
            row = row[:max_len - 1] + [EOS]
        rows.append(row + [EOS] * (max_len - len(row)))
    return np.asarray(rows, dtype=np.int64)
