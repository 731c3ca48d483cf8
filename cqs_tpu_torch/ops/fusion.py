"""Score fusion ops: min-max normalization, alpha blending, RRF, stable top-k.

Port of ``cqs_tpu/ops/fusion.py``. ``stable_topk`` stands in for
``jax.lax.top_k`` everywhere the reference calls it: descending values, ties
to the lower index. ``torch.topk`` promises no tie order, so it is built on a
stable descending sort.
"""

from __future__ import annotations

import torch

# Python float so kernels and plain code share one sentinel.
NEG = -3.0e38

_VALID_EPS = 1e-12


def stable_topk(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, descending, ties to the lower index
    (``lax.top_k``'s order). Returns (values, int64 indices)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def minmax_normalize(scores: torch.Tensor, valid_floor: float = -1e30) -> torch.Tensor:
    """Min-max normalize over valid (non-sentinel) entries; invalid entries
    stay at the sentinel so they never win fusion. The invalid lanes may
    overflow to -inf in the f32 arithmetic, as in the reference; the final
    select hides them."""
    valid = scores > valid_floor
    big = torch.where(valid, scores, torch.full_like(scores, NEG))
    small = torch.where(valid, scores, torch.full_like(scores, -NEG))
    mx = big.amax(dim=-1, keepdim=True)
    mn = small.amin(dim=-1, keepdim=True)
    rng = torch.clamp(mx - mn, min=_VALID_EPS)
    out = (scores - mn) / rng
    return torch.where(valid, out, torch.full_like(out, NEG))


def fuse_alpha(dense: torch.Tensor, sparse: torch.Tensor,
               alpha: torch.Tensor | float) -> torch.Tensor:
    """Per-category alpha fusion (``alpha`` scalar or [B, 1]):

    - alpha > 0:  ``alpha * dense + (1 - alpha) * sparse_normalized``
    - alpha <= 0: re-rank mode ``dense + 0.1 * sparse_normalized``

    An entry invalid in both legs stays invalid; an entry valid in one leg
    contributes only that leg."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dense.device)
    d_valid = dense > NEG / 2
    s_valid = sparse > NEG / 2
    d = torch.where(d_valid, dense, torch.zeros_like(dense))
    s = torch.where(s_valid, sparse, torch.zeros_like(sparse))
    blended = torch.where(alpha > 0.0, alpha * d + (1.0 - alpha) * s, d + 0.1 * s)
    return torch.where(d_valid | s_valid, blended, torch.full_like(blended, NEG))


def rrf(rank_a: torch.Tensor, rank_b: torch.Tensor, k: int = 60,
        weight_a: float = 1.0, weight_b: float = 1.0) -> torch.Tensor:
    """Reciprocal-rank fusion of two 0-based rank arrays (rank >= len means
    absent from that leg and contributes 0)."""
    n = rank_a.shape[-1]
    zero = torch.zeros((), dtype=torch.float32, device=rank_a.device)
    contrib_a = torch.where(rank_a < n, weight_a / (k + 1.0 + rank_a.float()), zero)
    contrib_b = torch.where(rank_b < n, weight_b / (k + 1.0 + rank_b.float()), zero)
    return contrib_a + contrib_b


def scores_to_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Scores -> 0-based ranks (0 = best), ties by lower index; sentinel
    entries get rank N (absent)."""
    n = scores.shape[-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    ranks = torch.sort(order, dim=-1, stable=True).indices.to(torch.int32)
    return torch.where(scores <= NEG / 2, torch.full_like(ranks, n), ranks)
