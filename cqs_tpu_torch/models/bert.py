"""BERT encoder family: dense embedders (BGE/e5/MiniLM), the SPLADE MLM head
and the cross-encoder reranker.

Port of ``cqs_tpu/models/bert.py`` as ``torch.nn.Module``s whose submodules
carry the reference's Flax names (``embeddings.word``, ``layer_{i}.q``,
``mlm.decoder``, ``pooler``, ...), so parameters carry across by a fixed
rule (``models/convert.py``) and HF checkpoints map by name
(``models/loader.py``). bf16 activations with f32 logits, softmax, norms,
pooling and heads, as in the reference (``models/layers.py``); GeLU is the
exact erf form.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from cqs_tpu_torch.models.layers import Dense, Embed, LayerNorm, attention, pad_bias


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    #: the dtype the Dense and Embed parameters are held in; None: ``dtype``
    #: (serving). The trainers hold f32 master parameters (Flax's
    #: ``param_dtype``), see ``models/layers.py``
    param_dtype: torch.dtype | None = None

    @classmethod
    def large(cls, **kw) -> "BertConfig":
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096, **kw)

    @classmethod
    def mini(cls, **kw) -> "BertConfig":
        # MiniLM-L6 geometry (cross-encoder default)
        return cls(hidden_size=384, num_layers=6, num_heads=12,
                   intermediate_size=1536, **kw)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word = Embed(c.vocab_size, c.hidden_size, c.dtype, c.param_dtype)
        self.position = Embed(c.max_position, c.hidden_size, c.dtype, c.param_dtype)
        self.token_type = Embed(c.type_vocab_size, c.hidden_size, c.dtype, c.param_dtype)
        self.ln = LayerNorm(c.hidden_size, c.layer_norm_eps, c.dtype)

    def forward(self, ids: torch.Tensor, type_ids: torch.Tensor | None = None) -> torch.Tensor:
        pos = torch.arange(ids.shape[-1], device=ids.device)[None, :]
        x = self.word(ids) + self.position(pos)
        if type_ids is None:
            type_ids = torch.zeros_like(ids)
        return self.ln(x + self.token_type(type_ids))


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        H, dt, pd = c.hidden_size, c.dtype, c.param_dtype
        self.q, self.k, self.v = (Dense(H, H, dtype=dt, param_dtype=pd) for _ in range(3))
        self.out = Dense(H, H, dtype=dt, param_dtype=pd)
        self.ln1 = LayerNorm(H, c.layer_norm_eps, dt)
        self.ff1 = Dense(H, c.intermediate_size, dtype=dt, param_dtype=pd)
        self.ff2 = Dense(c.intermediate_size, H, dtype=dt, param_dtype=pd)
        self.ln2 = LayerNorm(H, c.layer_norm_eps, dt)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        shape = (B, L, self.heads, self.head_dim)
        bias = pad_bias(mask)
        ctx = attention(self.q(x).view(shape), self.k(x).view(shape), self.v(x).view(shape),
                        lambda lo, hi: bias[lo:hi], self.head_dim ** -0.5)
        x = self.ln1(x + self.out(ctx.reshape(B, L, -1)))
        ff = self.ff2(F.gelu(self.ff1(x)))
        return self.ln2(x + ff)


def _layers(parent: nn.Module, c: BertConfig) -> list[nn.Module]:
    """``layer_0`` .. ``layer_{n-1}`` registered on ``parent`` by the
    reference's names."""
    for i in range(c.num_layers):
        parent.add_module(f"layer_{i}", BertLayer(c))
    return [getattr(parent, f"layer_{i}") for i in range(c.num_layers)]


class BertEncoder(nn.Module):
    """Token-level encoder: returns [B, L, H] hidden states."""

    def __init__(self, c: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self._stack = _layers(self, c)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(ids)
        for layer in self._stack:
            x = layer(x, mask)
        return x


def pool_hidden(hidden: torch.Tensor, mask: torch.Tensor, mode: str) -> torch.Tensor:
    """mean / cls / last_token pooling in f32 (``bert.py:101-114``)."""
    m = mask.float()[..., None]
    h = hidden.float()
    if mode == "mean":
        return (h * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    if mode == "cls":
        return h[:, 0, :]
    if mode == "last_token":
        idx = torch.clamp(mask.sum(dim=1) - 1, min=0)
        return h[torch.arange(h.shape[0], device=h.device), idx]
    raise ValueError(f"unknown pooling mode {mode!r}")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


class BertDenseEmbedder(nn.Module):
    """BERT + pooling + L2 norm -> [B, H] unit vectors."""

    def __init__(self, c: BertConfig, pooling: str = "cls"):
        super().__init__()
        self.pooling = pooling
        self.encoder = BertEncoder(c)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return l2_normalize(pool_hidden(self.encoder(ids, mask), mask, self.pooling))


class BertMLMHead(nn.Module):
    """Masked-LM head for SPLADE: transform + decoder over the vocabulary."""

    def __init__(self, c: BertConfig):
        super().__init__()
        self.transform = Dense(c.hidden_size, c.hidden_size, dtype=c.dtype,
                               param_dtype=c.param_dtype)
        self.ln = LayerNorm(c.hidden_size, c.layer_norm_eps, c.dtype)
        self.decoder = Dense(c.hidden_size, c.vocab_size, dtype=c.dtype,
                             param_dtype=c.param_dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.ln(F.gelu(self.transform(hidden))))


class SpladeModel(nn.Module):
    """SPLADE encoder: MLM logits -> masked max-pool over the sequence ->
    ReLU -> log1p. Returns [B, V] f32 vocabulary activations."""

    def __init__(self, c: BertConfig):
        super().__init__()
        self.encoder = BertEncoder(c)
        self.mlm = BertMLMHead(c)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        logits = self.mlm(self.encoder(ids, mask)).float()
        neg = torch.finfo(torch.float32).min
        masked = logits.masked_fill(mask[..., None] <= 0, neg)
        return torch.log1p(torch.relu(masked.amax(dim=1)))


class CrossEncoder(nn.Module):
    """(query, passage) -> relevance score (the ms-marco MiniLM layout): the
    encoder's layers sit at the top level, the pooler and classifier in f32."""

    def __init__(self, c: BertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(c)
        self._stack = _layers(self, c)
        self.pooler = Dense(c.hidden_size, c.hidden_size)
        self.classifier = Dense(c.hidden_size, 1)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                type_ids: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(ids, type_ids)
        for layer in self._stack:
            x = layer(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0, :].float()))
        return self.classifier(pooled)[..., 0]
