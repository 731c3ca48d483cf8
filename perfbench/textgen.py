"""Seeded text for the traffic generators: a vocabulary of pronounceable
lower-case words, drawn by Zipf rank.

Every generator separates two random streams. The *shape* stream (file and
function counts, lengths, docstring sizes, call counts) is seeded by a fixed
constant and the position of the item (iteration, step), so every seed does
the same amount of work. The *content* stream (which words, which callees,
the order of files) is seeded by ``--seed``.
"""

from __future__ import annotations

import keyword

import numpy as np

#: the shape stream's fixed seed
SHAPE_SEED = 0x5EED5

_ONSETS = ["b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "r", "s", "t", "v",
           "w", "z", "br", "ch", "cl", "cr", "dr", "fl", "gr", "pl", "pr", "sh", "sk", "sl",
           "sp", "st", "str", "th", "tr"]
_VOWELS = ["a", "e", "i", "o", "u", "ai", "ea", "io", "ou", "oo"]
_CODAS = ["", "", "", "n", "r", "l", "s", "t", "m", "nd", "st", "rk", "ng", "x"]


def seed64(*parts: int) -> list[int]:
    """Seed words for ``np.random.default_rng``: any whole numbers, as
    unsigned 64-bit words."""
    return [int(p) & ((1 << 64) - 1) for p in parts]


def shape_rng(*position: int) -> np.random.Generator:
    return np.random.default_rng(seed64(SHAPE_SEED, *position))


def content_rng(seed: int, *position: int) -> np.random.Generator:
    return np.random.default_rng(seed64(seed, *position))


def vocabulary(seed: int, size: int) -> list[str]:
    """``size`` distinct words of 1-3 syllables, none a Python keyword, in
    the order of their Zipf rank."""
    rng = content_rng(seed, 0x766F63)
    words: list[str] = []
    seen: set[str] = set()
    while len(words) < size:
        n = 4096
        syl = rng.integers(1, 4, size=n)
        on = rng.integers(len(_ONSETS), size=(n, 3))
        vo = rng.integers(len(_VOWELS), size=(n, 3))
        co = rng.integers(len(_CODAS), size=(n, 3))
        for k in range(n):
            w = "".join(_ONSETS[on[k, j]] + _VOWELS[vo[k, j]] + _CODAS[co[k, j]]
                        for j in range(syl[k]))
            if len(w) < 3 or w in seen or keyword.iskeyword(w):
                continue
            seen.add(w)
            words.append(w)
            if len(words) == size:
                break
    return words


class Words:
    """A vocabulary and its Zipf(s) rank distribution."""

    def __init__(self, seed: int, size: int, s: float):
        self.words = vocabulary(seed, size)
        p = 1.0 / np.arange(1, size + 1, dtype=np.float64) ** s
        self._cdf = np.cumsum(p / p.sum())
        self._cdf[-1] = 1.0

    def draw(self, rng: np.random.Generator, n: int) -> list[str]:
        idx = np.searchsorted(self._cdf, rng.random(n), side="right")
        return [self.words[i] for i in idx]

    def text(self, rng: np.random.Generator, n: int) -> str:
        return " ".join(self.draw(rng, n))
