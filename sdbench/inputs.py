"""Inputs made from the seed that more than one driver uses."""

from __future__ import annotations

from typing import List

import numpy as np

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def rng(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator for one use of the run's seed (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), *salt]))


def prompts(gen: np.random.Generator, count: int, letters, word_letters) -> List[str]:
    """``count`` prompts of random lowercase words: each prompt holds a total
    of letters drawn from ``letters`` (lo, hi), each word ``word_letters``
    (lo, hi) of them. Under the offline CLIP vocabulary a letter is one
    token, so a prompt of at most 75 letters fits one context of 77."""
    lo, hi = letters
    wlo, whi = word_letters
    out = []
    for _ in range(count):
        budget, words = int(gen.integers(lo, hi + 1)), []
        while budget >= wlo:
            n = int(gen.integers(wlo, min(whi, budget) + 1))
            words.append("".join(gen.choice(LETTERS, n)))
            budget -= n
        out.append(" ".join(words))
    return out
