"""Operation counts of a BERT encoder, and the peaks they are set against.

Counts are of the work the inputs need: a matrix product of ``[m, k]`` by
``[k, n]`` is ``2 m k n`` operations. Elementwise work, norms, softmax and
embedding lookups are not counted.
"""

from __future__ import annotations

from collections.abc import Iterable

#: NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet; at the full 700 W
#: power limit, which each result prints beside its numbers)
BF16_PEAK_FLOPS = 989e12


def dense_params(c: dict) -> int:
    """The matrix-product parameters of the encoder layers: q, k, v, the
    attention output, and the two feed-forward matrices."""
    H, inter = c["hidden_size"], c["intermediate_size"]
    return c["num_hidden_layers"] * (4 * H * H + 2 * H * inter)


def dense_flops(c: dict, tokens: int) -> float:
    """The encoder layers' linear layers over ``tokens`` positions (a
    padded batch's positions are all computed)."""
    return 2.0 * dense_params(c) * tokens


def attention_flops(c: dict, lengths: Iterable[int]) -> float:
    """``q.k^T`` and ``p.v`` of each sequence of the given length: ``2 x 2 x
    L^2 x H`` a layer."""
    return 4.0 * c["num_hidden_layers"] * c["hidden_size"] * float(sum(n * n for n in lengths))


def forward_flops(c: dict, lengths: Iterable[int]) -> float:
    """One forward over sequences of the given lengths."""
    lengths = list(lengths)
    return dense_flops(c, sum(lengths)) + attention_flops(c, lengths)


def train_flops(c: dict, lengths: Iterable[int]) -> float:
    """A training step over sequences of the given lengths: the forward,
    and a backward at twice the forward (``chip_smoke.py::encoder_flops``:
    6 x parameters x tokens plus 3 x the attention products)."""
    return 3.0 * forward_flops(c, lengths)
