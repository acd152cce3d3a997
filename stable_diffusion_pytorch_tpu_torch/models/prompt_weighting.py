"""Weighted-prompt syntax: ``(word:1.3)``, ``((emphasis))``, ``[de-emphasis]``.

A copy of the JAX package's ``models/prompt_weighting.py`` (the port imports
nothing of that package): the same grammar and the same merge of adjacent
fragments. The syntax and semantics follow the de-facto SD ecosystem
convention (A1111/compel):

- ``(text)``        -> weight x 1.1 (nesting multiplies: ``((x))`` = 1.21)
- ``[text]``        -> weight / 1.1
- ``(text:w)``      -> explicit weight ``w`` (overrides the 1.1 for its group)
- ``\\(`` ``\\)`` ``\\[`` ``\\]`` -> literal brackets
- unbalanced brackets are treated as literals

Application (compel "original mean" scheme): after encoding the cleaned
prompt, each token embedding is multiplied by its fragment weight and the
whole sequence is rescaled so its mean magnitude matches the unweighted
encoding — emphasis shifts attention toward the token without blowing up the
overall context scale.
"""

import re
from typing import List, Tuple

ATTENTION_MULT = 1.1

# one token of the prompt grammar at a time; escaped brackets first
_TOKEN_RE = re.compile(
    r"""
    \\[\(\)\[\]]  # escaped bracket -> literal
    | \(          # open emphasis
    | \[          # open de-emphasis
    | :\s*([+-]?[\d.]+)\s*\)  # explicit-weight close, captures the number
    | \)          # close emphasis
    | \]          # close de-emphasis
    | [^\\()\[\]:]+  # plain text run (no brackets, backslashes, colons)
    | [:\\]       # stray colon / backslash -> literal
    """,
    re.VERBOSE,
)


def parse_weighted_prompt(prompt: str) -> List[Tuple[str, float]]:
    """Parse prompt text into ``[(fragment, weight), ...]`` in reading order.

    Adjacent fragments with equal weight are merged. Unbalanced closers are
    literal; unbalanced openers apply to the rest of the prompt (matching the
    tolerant A1111 behavior).
    """
    # each stack entry: list of [text, weight] fragments collected at that depth
    stack: List[List[List]] = [[]]
    kinds: List[str] = []  # "(" or "[" per open group

    def emit(text: str):
        if text:
            stack[-1].append([text, 1.0])

    def close_group(mult: float):
        group = stack.pop()
        for frag in group:
            frag[1] *= mult
        stack[-1].extend(group)

    for m in _TOKEN_RE.finditer(prompt):
        tok = m.group(0)
        if tok.startswith("\\"):
            emit(tok[1:])
        elif tok == "(" or tok == "[":
            stack.append([])
            kinds.append(tok)
        elif tok == ")" and kinds and kinds[-1] == "(":
            kinds.pop()
            close_group(ATTENTION_MULT)
        elif m.group(1) is not None and kinds and kinds[-1] == "(":
            kinds.pop()
            try:
                close_group(float(m.group(1)))
            except ValueError:  # pragma: no cover - regex admits only numbers
                close_group(ATTENTION_MULT)
        elif tok == "]" and kinds and kinds[-1] == "[":
            kinds.pop()
            close_group(1.0 / ATTENTION_MULT)
        elif tok in (")", "]") or m.group(1) is not None:
            emit(tok)  # unbalanced closer -> literal
        else:
            emit(tok)

    # unbalanced openers: fold remaining groups down with their bracket weight
    while kinds:
        kind = kinds.pop()
        close_group(ATTENTION_MULT if kind == "(" else 1.0 / ATTENTION_MULT)

    # merge adjacent equal-weight fragments
    merged: List[Tuple[str, float]] = []
    for text, weight in stack[0]:
        if merged and abs(merged[-1][1] - weight) < 1e-9:
            merged[-1] = (merged[-1][0] + text, weight)
        else:
            merged.append((text, weight))
    return [(t, w) for t, w in merged if t]


def has_weight_syntax(prompt: str) -> bool:
    """True if the prompt uses any (unescaped) weighting brackets."""
    return bool(re.search(r"(?<!\\)[\(\)\[\]]", prompt))


def plain_text(prompt: str) -> str:
    """The prompt with all weighting syntax stripped (what gets tokenized)."""
    return "".join(t for t, _ in parse_weighted_prompt(prompt))
