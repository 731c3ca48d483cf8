"""Wide-and-deep hybrid embedder: the frozen hash leg beside a learned BERT
leg, ``l2([w_hash * hash_pool(x) ; w_learn * bert(x)])``.

Port of ``cqs_tpu/models/hybrid.py``. The wide leg is the hash family's
table (``models/hash_table.py::normal_table``, the reference's
``jax.random.normal`` table reproduced in numpy, row-normalized), held as a
buffer: it is not a parameter in the reference either. ``scales`` starts at
``[1.0, 0.3]``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cqs_tpu_torch.models.bert import BertConfig, BertEncoder, l2_normalize, pool_hidden
from cqs_tpu_torch.models.hash_table import normal_table


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    bert: BertConfig
    hash_dim: int = 256
    hash_seed: int = 0
    pooling: str = "mean"

    @property
    def dim(self) -> int:
        return self.hash_dim + self.bert.hidden_size


def hash_table(vocab_size: int, dim: int, seed: int = 0) -> torch.Tensor:
    """The hash family's projection table: unit-normalized gaussian rows
    from a fixed seed, [vocab, dim] f32 on the CPU."""
    t = torch.from_numpy(normal_table(seed, vocab_size, dim).copy())
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def hash_pool(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    vecs = table[ids]                                        # [B, L, Dh]
    m = mask.float()[..., None]
    pooled = (vecs * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    return l2_normalize(pooled)


class HybridDenseEmbedder(nn.Module):
    def __init__(self, c: HybridConfig):
        super().__init__()
        self.cfg = c
        self.register_buffer("table", torch.empty(c.bert.vocab_size, c.hash_dim),
                             persistent=False)
        with torch.no_grad():
            self.table.copy_(hash_table(c.bert.vocab_size, c.hash_dim, c.hash_seed))
        self.encoder = BertEncoder(c.bert)
        self.scales = nn.Parameter(torch.tensor([1.0, 0.3]))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = hash_pool(self.table, ids, mask)                               # wide leg
        b = l2_normalize(pool_hidden(self.encoder(ids, mask), mask, self.cfg.pooling))
        out = torch.cat([self.scales[0] * h, self.scales[1] * b.float()], dim=-1)
        return l2_normalize(out)
