"""EmbeddingGemma-300m (the default dense embedder) and the qwen3 variant.

Port of ``cqs_tpu/models/gemma.py`` as ``torch.nn.Module``s with the
reference's submodule names (``encoder.tok_embed``,
``encoder.layer_{i}.attn.q``, ``...mlp.gate``, ``proj1``, ...). The same
Gemma3 text-encoder geometry and the same rounding points:

- RMSNorm in f32 with ``1 + w`` (qwen3: ``w``), cast back;
- the embeddings scaled by ``sqrt(H)`` cast to the activation dtype first
  (27.7128 becomes 27.75 in bf16);
- GQA attention with QK-RMSNorm before RoPE; each kv head repeated in a row
  (``repeat_interleave``, as ``jnp.repeat``); logits in f32 times
  ``query_pre_attn_scalar ** -0.5``; each -1e9 bias term (pad, causal,
  window) added on its own; softmax in f32, probabilities and context in the
  config dtype (``models/layers.py::attention``, batch-sliced);
- sliding layers with the local theta and no rope scaling, and under
  bidirectional attention the halved window ``|i - j| < w // 2 + 1``;
- GeGLU with the tanh GeLU (qwen3: SiLU);
- mean (qwen3: last-token) pooling in f32, then the EmbeddingGemma head
  ``proj1``/``proj2`` as f32 layers, then the L2 norm.

The RoPE frequencies are computed as JAX computes ``theta ** (-i / n)`` in
f32 (the f32 exponent raised in f64 and rounded): ``torch.pow`` in f32
differs from it in the last bit of a few frequencies, which moves the angle
at position 2048 by ~1e-4.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cqs_tpu_torch.models.bert import l2_normalize, pool_hidden
from cqs_tpu_torch.models.layers import Dense, Embed, RMSNorm, attention, pad_bias


def _default_layer_types(num_layers: int, pattern: int = 6) -> tuple[str, ...]:
    """Gemma3 default: every ``pattern``-th layer is full attention."""
    return tuple(
        "sliding_attention" if (i + 1) % pattern else "full_attention"
        for i in range(num_layers))


@dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 262144
    hidden_size: int = 768
    num_layers: int = 24
    num_heads: int = 3
    num_kv_heads: int = 1
    head_dim: int = 256
    intermediate_size: int = 1152
    max_seq_len: int = 2048
    rope_theta: float = 1_000_000.0
    rope_local_theta: float = 10_000.0
    rope_scaling_factor: float = 1.0   # linear scaling on full-attention layers
    rms_eps: float = 1e-6
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 512          # RAW config value (pre-halving)
    layer_types: tuple[str, ...] = ()  # per-layer "sliding_attention"/"full_attention"
    embed_dim: int = 768               # output embedding dimension
    proj_hidden: int = 3072            # EmbeddingGemma head inner width
    pooling: str = "mean"              # mean | last_token (qwen3-embedding style)
    use_projection: bool = True        # EmbeddingGemma's 2-layer head
    use_qk_norm: bool = True           # Gemma3 / Qwen3 per-head-dim RMSNorm
    causal: bool = False               # qwen3-embedding runs causal; gemma bidir
    mlp_act: str = "gelu_tanh"         # gelu_tanh | silu (qwen3)
    norm_plus_one: bool = True         # Gemma stores w with scale=(1+w); qwen3 raw
    sandwich_norm: bool = True         # Gemma pre+post norms; qwen3 pre-norm only
    scale_embeddings: bool = True      # Gemma multiplies embeddings by sqrt(H)
    dtype: torch.dtype = torch.bfloat16

    def resolved_layer_types(self) -> tuple[str, ...]:
        if self.layer_types:
            return self.layer_types
        return _default_layer_types(self.num_layers)

    def effective_window(self) -> int:
        """HF halves the configured window for bidirectional attention
        (exclusive bounds): ``w // 2 + 1``."""
        if not self.causal:
            return self.sliding_window // 2 + 1
        return self.sliding_window

    @classmethod
    def small_test(cls, vocab_size: int = 32768) -> "GemmaConfig":
        """Tiny geometry for tests (shape-compatible, fast on CPU)."""
        return cls(vocab_size=vocab_size, hidden_size=64, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=16,
                   intermediate_size=128, max_seq_len=128, embed_dim=64,
                   proj_hidden=192, sliding_window=64,
                   query_pre_attn_scalar=16.0)

    def as_qwen3(self) -> "GemmaConfig":
        """The qwen3-embedding variant of this geometry (the reference's
        weightless qwen3, ``embedder.py:243-249``): causal, SiLU, pre-norm
        only, raw RMSNorm weights, unscaled embeddings, last-token pooling,
        no projection head."""
        return dataclasses.replace(
            self, pooling="last_token", use_projection=False, causal=True,
            embed_dim=self.hidden_size, mlp_act="silu", norm_plus_one=False,
            sandwich_norm=False, scale_embeddings=False)

    @classmethod
    def from_hf_config(cls, model_dir: str | Path, dtype: torch.dtype = torch.bfloat16
                       ) -> "GemmaConfig":
        """The geometry of a HF checkpoint's ``config.json`` (Gemma3TextModel
        or Qwen3Model); EmbeddingGemma's SentenceTransformer Dense head dims
        from ``2_Dense/config.json`` and ``3_Dense/config.json`` when present
        (``gemma.py:97-166``)."""
        model_dir = Path(model_dir)
        with open(model_dir / "config.json") as f:
            c = json.load(f)
        if "text_config" in c:          # multimodal wrapper
            c = c["text_config"]
        archs = [a.lower() for a in c.get("architectures", [])]
        is_qwen = any("qwen" in a for a in archs) or c.get("model_type", "").startswith("qwen")
        num_layers = int(c["num_hidden_layers"])
        hidden = int(c["hidden_size"])
        heads = int(c["num_attention_heads"])
        head_dim = int(c.get("head_dim", hidden // heads))
        bidir = bool(c.get("use_bidirectional_attention", not is_qwen))
        lt = c.get("layer_types")
        if lt is None:
            if is_qwen or not c.get("sliding_window"):
                lt = ["full_attention"] * num_layers
            else:
                lt = list(_default_layer_types(
                    num_layers, int(c.get("sliding_window_pattern", 6))))
        rs = c.get("rope_scaling") or {}
        factor = float(rs.get("factor", 1.0)) if rs.get(
            "rope_type", rs.get("type", "default")) == "linear" else 1.0
        proj_hidden, embed_dim, use_projection = 4 * hidden, hidden, False
        d1 = model_dir / "2_Dense" / "config.json"
        d2 = model_dir / "3_Dense" / "config.json"
        if d1.is_file():
            with open(d1) as f:
                dc = json.load(f)
            proj_hidden = int(dc.get("out_features", 4 * hidden))
            use_projection = True
            if d2.is_file():
                with open(d2) as f:
                    dc2 = json.load(f)
                embed_dim = int(dc2.get("out_features", hidden))
            else:
                embed_dim = proj_hidden
        return cls(
            vocab_size=int(c["vocab_size"]),
            hidden_size=hidden,
            num_layers=num_layers,
            num_heads=heads,
            num_kv_heads=int(c.get("num_key_value_heads", heads)),
            head_dim=head_dim,
            intermediate_size=int(c["intermediate_size"]),
            max_seq_len=min(int(c.get("max_position_embeddings", 2048)), 8192),
            rope_theta=float(c.get("rope_theta", 1_000_000.0)),
            rope_local_theta=float(c.get("rope_local_base_freq", 10_000.0)),
            rope_scaling_factor=factor,
            rms_eps=float(c.get("rms_norm_eps", 1e-6)),
            query_pre_attn_scalar=float(c.get("query_pre_attn_scalar", head_dim)),
            sliding_window=int(c.get("sliding_window") or 0) or 4096,
            layer_types=tuple(lt),
            embed_dim=embed_dim,
            proj_hidden=proj_hidden,
            pooling="last_token" if is_qwen else "mean",
            use_projection=use_projection,
            use_qk_norm=True,
            causal=not bidir,
            mlp_act="silu" if is_qwen else "gelu_tanh",
            norm_plus_one=not is_qwen,
            sandwich_norm=not is_qwen,
            scale_embeddings=not is_qwen,
            dtype=dtype,
        )


@functools.lru_cache(maxsize=64)
def rope_tables(length: int, dim: int, theta: float, scaling: float,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) as ``[L, dim // 2]`` f32 (``gemma.py:185-196``); cached
    per bucket, so a forward pass copies nothing to the device for them."""
    half = dim // 2
    expo = (-np.arange(half, dtype=np.float32) / np.float32(half)).astype(np.float64)
    freq = (np.float64(np.float32(theta)) ** expo).astype(np.float32)
    pos = torch.arange(length, dtype=torch.float32, device=device) / scaling
    ang = pos[:, None] * torch.from_numpy(freq).to(device)[None, :]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding over [B, L, H, D] (rotate-half), in f32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class GemmaAttention(nn.Module):
    def __init__(self, c: GemmaConfig, theta: float, rope_scaling: float, window: int):
        super().__init__()
        self.cfg, self.theta, self.rope_scaling, self.window = c, theta, rope_scaling, window
        H, hd, dt = c.hidden_size, c.head_dim, c.dtype
        self.q = Dense(H, c.num_heads * hd, bias=False, dtype=dt)
        self.k = Dense(H, c.num_kv_heads * hd, bias=False, dtype=dt)
        self.v = Dense(H, c.num_kv_heads * hd, bias=False, dtype=dt)
        if c.use_qk_norm:
            self.q_norm = RMSNorm(hd, c.rms_eps, c.norm_plus_one)
            self.k_norm = RMSNorm(hd, c.rms_eps, c.norm_plus_one)
        self.out = Dense(c.num_heads * hd, H, bias=False, dtype=dt)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                static_bias: torch.Tensor | None) -> torch.Tensor:
        c = self.cfg
        B, L, _ = x.shape
        q = self.q(x).view(B, L, c.num_heads, c.head_dim)
        k = self.k(x).view(B, L, c.num_kv_heads, c.head_dim)
        v = self.v(x).view(B, L, c.num_kv_heads, c.head_dim)
        if c.use_qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        sin, cos = rope_tables(L, c.head_dim, self.theta, self.rope_scaling, x.device)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        rep = c.num_heads // c.num_kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        pad = pad_bias(mask)

        def bias(lo, hi):
            b = pad[lo:hi]
            return b if static_bias is None else b + static_bias

        ctx = attention(q, k, v, bias, c.query_pre_attn_scalar ** -0.5)
        return self.out(ctx.reshape(B, L, -1))


@functools.lru_cache(maxsize=64)
def static_bias(length: int, causal: bool, window: int,
                device: torch.device) -> torch.Tensor | None:
    """The mask-independent bias of a layer as ``[1, 1, L, L]`` f32: the
    causal term, then the window term, each 0 or -1e9 (``gemma.py:222-233``);
    None when the layer has neither. Cached per bucket."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    terms = []
    if causal:
        terms.append(j <= i)
    if window > 0:
        terms.append((i - j).abs() < window if not causal else j > i - window)
    if not terms:
        return None
    bias = torch.zeros(length, length, device=device)
    for keep in terms:
        bias = bias + torch.where(keep, 0.0, -1e9)
    return bias[None, None]


class GemmaMLP(nn.Module):
    def __init__(self, c: GemmaConfig):
        super().__init__()
        self.act = c.mlp_act
        H, I, dt = c.hidden_size, c.intermediate_size, c.dtype
        self.gate = Dense(H, I, bias=False, dtype=dt)
        self.up = Dense(H, I, bias=False, dtype=dt)
        self.down = Dense(I, H, bias=False, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.gate(x)
        act = F.silu(gate) if self.act == "silu" else F.gelu(gate, approximate="tanh")
        return self.down(act * self.up(x))


class GemmaLayer(nn.Module):
    def __init__(self, c: GemmaConfig, layer_type: str = "full_attention"):
        super().__init__()
        sliding = layer_type == "sliding_attention"
        self.window = c.effective_window() if sliding else 0
        self.attn = GemmaAttention(
            c, theta=c.rope_local_theta if sliding else c.rope_theta,
            rope_scaling=1.0 if sliding else c.rope_scaling_factor, window=self.window)
        self.pre_attn_norm = RMSNorm(c.hidden_size, c.rms_eps, c.norm_plus_one)
        self.pre_mlp_norm = RMSNorm(c.hidden_size, c.rms_eps, c.norm_plus_one)
        self.mlp = GemmaMLP(c)
        self.sandwich = c.sandwich_norm
        if c.sandwich_norm:
            self.post_attn_norm = RMSNorm(c.hidden_size, c.rms_eps, c.norm_plus_one)
            self.post_mlp_norm = RMSNorm(c.hidden_size, c.rms_eps, c.norm_plus_one)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                static: torch.Tensor | None) -> torch.Tensor:
        h = self.attn(self.pre_attn_norm(x), mask, static)
        if self.sandwich:
            h = self.post_attn_norm(h)
        x = x + h
        h = self.mlp(self.pre_mlp_norm(x))
        if self.sandwich:
            h = self.post_mlp_norm(h)
        return x + h


class GemmaEncoder(nn.Module):
    """The transformer stack: ids -> final-norm hidden states [B, L, H]."""

    def __init__(self, c: GemmaConfig):
        super().__init__()
        self.cfg = c
        self.tok_embed = Embed(c.vocab_size, c.hidden_size, c.dtype)
        types = c.resolved_layer_types()
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", GemmaLayer(c, layer_type=types[i]))
        self._stack = [getattr(self, f"layer_{i}") for i in range(c.num_layers)]
        self.final_norm = RMSNorm(c.hidden_size, c.rms_eps, c.norm_plus_one)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.tok_embed(ids)
        if c.scale_embeddings:
            x = x * torch.tensor(c.hidden_size ** 0.5, dtype=c.dtype, device=x.device)
        L = ids.shape[1]
        statics = {w: static_bias(L, c.causal, w, ids.device)
                   for w in {layer.window for layer in self._stack}}
        for layer in self._stack:
            x = layer(x, mask, statics[layer.window])
        return self.final_norm(x)


class GemmaEmbedder(nn.Module):
    """Full EmbeddingGemma: encoder -> pool -> projection head -> L2."""

    def __init__(self, c: GemmaConfig):
        super().__init__()
        self.cfg = c
        self.encoder = GemmaEncoder(c)
        if c.use_projection:
            self.proj1 = Dense(c.hidden_size, c.proj_hidden, bias=False)
            self.proj2 = Dense(c.proj_hidden, c.embed_dim, bias=False)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        pooled = pool_hidden(self.encoder(ids, mask), mask,
                             "last_token" if c.pooling == "last_token" else "mean")
        h = self.proj2(self.proj1(pooled)) if c.use_projection else pooled
        return l2_normalize(h)
