"""DeepSeek-V2 (multi-head latent attention, routed and shared experts) as a
dense embedder.

The JAX package has no such model: this family is the port's own, written
from Hugging Face's ``modeling_deepseek.py`` (``DeepseekV2ForCausalLM``) and
held against the plain reference ``perfbench/reference/deepseek_v2.py``. It
runs a decoder the way decoder embedders run (Qwen3-Embedding,
jina-code-embeddings): causal attention, the last real token's final hidden
state, an L2 norm.

- Attention is MLA without q-LoRA, as ``DeepseekV2Attention`` computes it in
  a full forward (no cache, no weight absorption): ``q_proj`` to heads of
  ``qk_nope + qk_rope``; ``kv_a_proj_with_mqa`` to the ``kv_lora_rank``
  latent and one rope key shared by all heads; ``kv_a_layernorm``;
  ``kv_b_proj`` to each head's nope key and value. The rope halves of q and
  k are de-interleaved before the rotate-half rotation, as
  ``apply_rotary_pos_emb`` there does, with YaRN's inverse frequencies and
  mscale (``DeepseekV2YarnRotaryEmbedding``). Logits, softmax and bias as
  the other families compute them (``models/layers.py::attention``; the
  causal and pad bias of ``models/gemma.py``), with the softmax scale
  ``q_head_dim ** -0.5 * mscale(factor, mscale_all_dim) ** 2``.
- The first ``first_k_dense_replace`` layers have a SwiGLU MLP; the others
  an expert layer: a router in f32 (softmax over the routed experts, greedy
  top-k, weights scaled and not renormalised unless ``norm_topk_prob``),
  the routed experts, and the shared experts as one SwiGLU added to their
  sum. The routed experts run grouped (:func:`grouped_mm`): each chunk of
  rows is sorted by expert once, then gate and up together and down are one
  grouped matrix product each over all experts. Each token's k outputs are
  weighted and summed in f32 and cast back, as ``moe_infer`` does.
- Only real positions go through the MLPs. Under the causal mask no real
  position attends to a later one, and the mask pads on the right, so a pad
  position's value reaches no real one: leaving them out is exact.
- The pooled row is the last real position's; its final RMSNorm is taken
  after pooling (the norm is per position), in f32.

Spans ``mla`` (a layer's attention) and ``moe`` (an expert layer; children
``moe_route``, ``moe_experts``) are recorded like every span of the port
(``utils/trace.py``). While a recorder is on, the forward counts
``moe.tokens`` (positions entering the expert layers, one count a layer),
``moe.pad_rows`` (the batch's pad positions left out of them),
``moe.routed_rows`` (token-expert rows) and, accumulated on the device and
read back with the forward's own copy of its vectors to the host
(:meth:`DeepseekEmbedder.flush_counters`), ``moe.max_expert_rows`` (the
heaviest expert's rows in each layer call, summed) and
``moe.active_experts`` (experts with any row, summed over the grouped
launches).
"""

from __future__ import annotations

import functools
import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cqs_tpu_torch.models.bert import l2_normalize, pool_hidden
from cqs_tpu_torch.models.gemma import apply_rope, static_bias
from cqs_tpu_torch.models.layers import _TRUNC_STD, Dense, Embed, RMSNorm, attention, pad_bias
from cqs_tpu_torch.utils.trace import recorder, span

#: an expert layer routes its rows in chunks of at most this many tokens,
#: which bounds its peak: 65,536 tokens route 393,216 rows at top-6, whose
#: gate-and-up output is 2.2 GB in bf16 at DeepSeek-V2-Lite's widths
MOE_CHUNK_TOKENS = 1 << 16


@dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    rms_eps: float = 1e-6
    rope_theta: float = 10000.0
    #: YaRN's settings (``rope_scaling``); factor 1: plain RoPE
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        """``DeepseekV2DecoderLayer``'s rule for an expert layer."""
        return (self.n_routed_experts > 0 and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    def softmax_scale(self) -> float:
        scale = self.q_head_dim ** -0.5
        if self.rope_factor > 1 and self.rope_mscale_all_dim:
            m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
            scale *= m * m
        return scale

    @classmethod
    def small_test(cls, vocab_size: int = 32768, dtype: torch.dtype = torch.float32
                   ) -> "DeepseekV2Config":
        """A tiny geometry of the same kinds of layer (CPU tests): hidden 64,
        one dense and two expert layers, 8 experts top-2 and one shared,
        kv rank 32, nope 16, rope 8, v 16."""
        return cls(vocab_size=vocab_size, hidden_size=64, num_layers=3, num_heads=4,
                   kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                   intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
                   n_shared_experts=1, num_experts_per_tok=2, rope_original_max_position=64,
                   rope_factor=4.0, dtype=dtype)

    @classmethod
    def from_hf_config(cls, src: str | Path | dict, dtype: torch.dtype = torch.bfloat16
                       ) -> "DeepseekV2Config":
        """The geometry of a HF ``DeepseekV2`` ``config.json`` (a checkpoint
        directory, a file, or the parsed dict). What this model does not
        implement is refused, not guessed: a q-LoRA, a routing other than
        greedy top-k over softmax scores, rope scaling other than YaRN."""
        if isinstance(src, dict):
            c = src
        else:
            path = Path(src)
            with open(path / "config.json" if path.is_dir() else path) as f:
                c = json.load(f)
        if c.get("q_lora_rank") is not None:
            raise ValueError(f"q_lora_rank {c['q_lora_rank']}: only q_proj without a "
                             f"q-LoRA is implemented")
        for key, want in (("topk_method", "greedy"), ("scoring_func", "softmax")):
            if c.get(key, want) != want:
                raise ValueError(f"{key} {c[key]!r}: only {want!r} is implemented")
        rs = c.get("rope_scaling") or {}
        kind = rs.get("type", rs.get("rope_type"))
        if rs and kind != "yarn":
            raise ValueError(f"rope_scaling type {kind!r}: only 'yarn' is implemented")
        return cls(
            vocab_size=int(c["vocab_size"]),
            hidden_size=int(c["hidden_size"]),
            num_layers=int(c["num_hidden_layers"]),
            num_heads=int(c["num_attention_heads"]),
            kv_lora_rank=int(c["kv_lora_rank"]),
            qk_nope_head_dim=int(c["qk_nope_head_dim"]),
            qk_rope_head_dim=int(c["qk_rope_head_dim"]),
            v_head_dim=int(c["v_head_dim"]),
            intermediate_size=int(c["intermediate_size"]),
            moe_intermediate_size=int(c["moe_intermediate_size"]),
            n_routed_experts=int(c.get("n_routed_experts") or 0),
            n_shared_experts=int(c.get("n_shared_experts") or 0),
            num_experts_per_tok=int(c.get("num_experts_per_tok") or 0),
            first_k_dense_replace=int(c.get("first_k_dense_replace", 0)),
            moe_layer_freq=int(c.get("moe_layer_freq", 1)),
            routed_scaling_factor=float(c.get("routed_scaling_factor", 1.0)),
            norm_topk_prob=bool(c.get("norm_topk_prob", False)),
            rms_eps=float(c.get("rms_norm_eps", 1e-6)),
            rope_theta=float(c.get("rope_theta", 10000.0)),
            rope_factor=float(rs.get("factor", 1.0)),
            rope_original_max_position=int(rs.get("original_max_position_embeddings", 4096)),
            rope_beta_fast=float(rs.get("beta_fast", 32)),
            rope_beta_slow=float(rs.get("beta_slow", 1)),
            rope_mscale=float(rs.get("mscale", 1)),
            rope_mscale_all_dim=float(rs.get("mscale_all_dim", 0)),
            dtype=dtype,
        )


def yarn_mscale(scale: float, mscale: float) -> float:
    """``yarn_get_mscale``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(c: DeepseekV2Config) -> torch.Tensor:
    """The rope dims' inverse frequencies ``[qk_rope_head_dim // 2]`` in f32,
    as ``DeepseekV2YarnRotaryEmbedding`` computes them (plain RoPE's at
    factor 1): the extrapolated frequencies blended into the interpolated
    ones over YaRN's correction range."""
    dim, base = c.qk_rope_head_dim, c.rope_theta
    extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if c.rope_factor <= 1:
        return extra
    inter = 1.0 / (c.rope_factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))

    def corr_dim(rot: float) -> float:
        return (dim * math.log(c.rope_original_max_position / (rot * 2 * math.pi))) \
            / (2 * math.log(base))
    low = max(math.floor(corr_dim(c.rope_beta_fast)), 0)
    high = min(math.ceil(corr_dim(c.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


@functools.lru_cache(maxsize=16)
def yarn_tables(length: int, c: DeepseekV2Config, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) as ``[L, qk_rope_head_dim // 2]`` f32, scaled by YaRN's
    mscale ratio; cached per bucket."""
    ang = torch.outer(torch.arange(length, dtype=torch.float32), yarn_inv_freq(c))
    m = 1.0
    if c.rope_factor > 1:
        m = yarn_mscale(c.rope_factor, c.rope_mscale) / yarn_mscale(c.rope_factor,
                                                                    c.rope_mscale_all_dim)
    return (torch.sin(ang) * m).to(device), (torch.cos(ang) * m).to(device)


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The last dim's even entries, then its odd ones (``apply_rotary_pos_emb``'s
    ``view(d // 2, 2).transpose``)."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``x [M, K]`` sorted by group, by each group's ``w [G, N, K]``
    (``[out, in]`` matrices): ``[M, N]``, group ``g`` being rows
    ``offs[g-1]:offs[g]`` (``offs`` int32, cumulative). One launch for all
    groups (``torch._grouped_mm``)."""
    return torch._grouped_mm(x, w.transpose(1, 2), offs=offs)


class MLAttention(nn.Module):
    """``DeepseekV2Attention`` without q-LoRA, in a full forward."""

    def __init__(self, c: DeepseekV2Config):
        super().__init__()
        self.cfg = c
        H, n, dt = c.hidden_size, c.num_heads, c.dtype
        self.q = Dense(H, n * c.q_head_dim, bias=False, dtype=dt)
        self.kv_a = Dense(H, c.kv_lora_rank + c.qk_rope_head_dim, bias=False, dtype=dt)
        self.kv_norm = RMSNorm(c.kv_lora_rank, c.rms_eps, plus_one=False)
        self.kv_b = Dense(c.kv_lora_rank, n * (c.qk_nope_head_dim + c.v_head_dim), bias=False,
                          dtype=dt)
        self.out = Dense(n * c.v_head_dim, H, bias=False, dtype=dt)

    def forward(self, x: torch.Tensor, bias, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, L, _ = x.shape
        n, nope, rope = c.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
        q = self.q(x).view(B, L, n, c.q_head_dim)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        latent, k_pe = self.kv_a(x).split([c.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b(self.kv_norm(latent)).view(B, L, n, nope + c.v_head_dim)
        k_nope, v = kv.split([nope, c.v_head_dim], dim=-1)
        q_pe = apply_rope(deinterleave(q_pe), sin, cos)
        k_pe = apply_rope(deinterleave(k_pe.view(B, L, 1, rope)), sin, cos)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, L, n, rope)], dim=-1)
        ctx = attention(q, k, v, bias, c.softmax_scale())
        return self.out(ctx.reshape(B, L, n * c.v_head_dim))


class SwiGLU(nn.Module):
    """``DeepseekV2MLP``: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, hidden: int, inter: int, dtype: torch.dtype):
        super().__init__()
        self.gate = Dense(hidden, inter, bias=False, dtype=dtype)
        self.up = Dense(hidden, inter, bias=False, dtype=dtype)
        self.down = Dense(inter, hidden, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class RoutedExperts(nn.Module):
    """The routed experts' weights stacked by expert, as ``[out, in]``
    matrices: ``gate_up [E, 2 * I, H]`` (each expert's gate rows, then its
    up rows) and ``down [E, H, I]``."""

    def __init__(self, c: DeepseekV2Config):
        super().__init__()
        E, H, I = c.n_routed_experts, c.hidden_size, c.moe_intermediate_size
        self.inter = I
        self.gate_up = nn.Parameter(torch.empty(E, 2 * I, H, dtype=c.dtype))
        self.down = nn.Parameter(torch.empty(E, H, I, dtype=c.dtype))

    def forward(self, xs: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
        """Rows ``xs`` sorted by expert (``offs`` as :func:`grouped_mm`)."""
        gu = grouped_mm(xs, self.gate_up, offs)
        return grouped_mm(F.silu(gu[:, :self.inter]) * gu[:, self.inter:], self.down, offs)

    def reset(self, gen: torch.Generator) -> None:
        """:class:`~cqs_tpu_torch.models.layers.Dense`'s init, each matrix
        by its own fan-in."""
        for w in (self.gate_up, self.down):
            std = 1.0 / math.sqrt(w.shape[2]) / _TRUNC_STD
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


class MoE(nn.Module):
    """``DeepseekV2MoE`` at inference: routed experts and the shared ones."""

    def __init__(self, c: DeepseekV2Config):
        super().__init__()
        self.cfg = c
        self.router = Dense(c.hidden_size, c.n_routed_experts, bias=False, dtype=torch.float32)
        self.experts = RoutedExperts(c)
        self.shared = SwiGLU(c.hidden_size, c.moe_intermediate_size * c.n_shared_experts,
                             c.dtype) if c.n_shared_experts else None

    def route(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``MoEGate``: (top-k expert ids ``[T, k]``, f32 weights ``[T, k]``),
        in descending score order."""
        c = self.cfg
        scores = torch.softmax(self.router(h.float()), dim=-1)
        w, idx = torch.topk(scores, c.num_experts_per_tok, dim=-1)
        if c.num_experts_per_tok > 1 and c.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            w = w * c.routed_scaling_factor
        return idx, w

    def forward(self, h: torch.Tensor, acc: torch.Tensor | None = None) -> torch.Tensor:
        """``h [T, H]`` -> ``[T, H]``. ``acc``, a device ``[2]`` int64, gains
        the heaviest expert's rows and the number of experts with rows."""
        c = self.cfg
        E, k = c.n_routed_experts, c.num_experts_per_tok
        out = []
        heaviest = None
        for lo in range(0, h.shape[0], MOE_CHUNK_TOKENS):
            x = h[lo:lo + MOE_CHUNK_TOKENS]
            with span("moe_route"):
                idx, w = self.route(x)
                flat = idx.reshape(-1)
                order = torch.argsort(flat, stable=True)
                # not bincount, whose output size waits on the device
                counts = torch.zeros(E, dtype=torch.int64, device=flat.device) \
                    .scatter_add_(0, flat, torch.ones_like(flat))
                offs = torch.cumsum(counts, 0, dtype=torch.int32)
                xs = x.index_select(0, order // k)
            with span("moe_experts"):
                ys = self.experts(xs, offs)
                y = torch.empty_like(ys)
                y[order] = ys
                y = (y.view(-1, k, y.shape[-1]).float() * w[..., None]).sum(dim=1).to(x.dtype)
                if self.shared is not None:
                    y = y + self.shared(x)
            out.append(y)
            if acc is not None:
                heaviest = counts if heaviest is None else heaviest + counts
                acc[1] += (counts > 0).sum()
        if acc is not None and heaviest is not None:
            acc[0] += heaviest.max()
        return out[0] if len(out) == 1 else torch.cat(out)


class DeepseekLayer(nn.Module):
    def __init__(self, c: DeepseekV2Config, index: int):
        super().__init__()
        self.pre_attn_norm = RMSNorm(c.hidden_size, c.rms_eps, plus_one=False)
        self.attn = MLAttention(c)
        self.pre_mlp_norm = RMSNorm(c.hidden_size, c.rms_eps, plus_one=False)
        if c.is_moe(index):
            self.moe = MoE(c)
        else:
            self.mlp = SwiGLU(c.hidden_size, c.intermediate_size, c.dtype)

    def forward(self, x: torch.Tensor, bias, sin, cos, real: torch.Tensor,
                acc: torch.Tensor | None) -> torch.Tensor:
        """``real``: the flat indices of the batch's real positions, the only
        rows the MLP computes."""
        with span("mla"):
            x = x + self.attn(self.pre_attn_norm(x), bias, sin, cos)
        flat = x.view(-1, x.shape[-1])
        res = flat.index_select(0, real)
        h = self.pre_mlp_norm(res)
        if hasattr(self, "moe"):
            with span("moe"):
                y = self.moe(h, acc)
        else:
            y = self.mlp(h)
        flat.index_copy_(0, real, res + y)
        return x


def real_positions(mask) -> torch.Tensor:
    """The flat indices of ``mask``'s real positions (``[B, L]``, a tensor or
    a host array), the rows the MLPs compute. From a host array they come
    without a wait on the device."""
    if isinstance(mask, np.ndarray):
        return torch.from_numpy(np.flatnonzero(mask))
    return mask.reshape(-1).nonzero().squeeze(1)


class DeepseekEmbedder(nn.Module):
    """ids, mask -> ``[B, hidden]`` unit vectors: the decoder stack, the last
    real position, the final norm, L2."""

    def __init__(self, c: DeepseekV2Config):
        super().__init__()
        self.cfg = c
        self.tok_embed = Embed(c.vocab_size, c.hidden_size, c.dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", DeepseekLayer(c, i))
        self._stack = [getattr(self, f"layer_{i}") for i in range(c.num_layers)]
        self.final_norm = RMSNorm(c.hidden_size, c.rms_eps, plus_one=False)
        #: (recorder, host copy of the device counts) of the last forward
        #: taken under a recorder, until :meth:`flush_counters`
        self._pending = None

    def hidden_states(self, ids: torch.Tensor, mask: torch.Tensor) -> list[torch.Tensor]:
        """The embeddings and each layer's output ``[B, L, H]`` (the tests'
        view of the stack; real positions only are meaningful)."""
        x = self.tok_embed(ids)
        return [x, *self._layers(x, mask, real_positions(mask), None)]

    def _layers(self, x: torch.Tensor, mask: torch.Tensor, real: torch.Tensor,
                acc: torch.Tensor | None):
        L = mask.shape[1]
        static = static_bias(L, True, 0, mask.device)
        pad = pad_bias(mask)
        sin, cos = yarn_tables(L, self.cfg, mask.device)

        def bias(lo, hi):
            return pad[lo:hi] + static
        for layer in self._stack:
            x = layer(x, bias, sin, cos, real, acc)
            yield x

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                real: torch.Tensor | None = None) -> torch.Tensor:
        """``real``: :func:`real_positions` of ``mask``, built by the caller
        from a host copy of the mask so the forward never waits on the
        device; taken from ``mask`` when not given."""
        c = self.cfg
        if real is None:
            real = real_positions(mask)
        rec = recorder()
        acc = None
        if rec is not None:
            acc = torch.zeros(2, dtype=torch.int64, device=ids.device)
            real_n = real.numel()
            n_moe = sum(c.is_moe(i) for i in range(c.num_layers))
            rec.count("moe.tokens", real_n * n_moe)
            rec.count("moe.pad_rows", (mask.numel() - real_n) * n_moe)
            rec.count("moe.routed_rows", real_n * n_moe * c.num_experts_per_tok)
        x = self.tok_embed(ids)
        for x in self._layers(x, mask, real, acc):
            pass
        pooled = pool_hidden(x, mask, "last_token")
        vecs = l2_normalize(self.final_norm(pooled))
        if acc is not None:
            host = torch.empty(2, dtype=torch.int64, pin_memory=acc.is_cuda)
            host.copy_(acc, non_blocking=True)
            self._pending = (rec, host)
        return vecs

    def flush_counters(self) -> None:
        """Hand the last recorded forward's device counts to its recorder.
        Called once the forward's vectors are on the host: the copy of the
        counts was enqueued before theirs, so it has landed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            rec, host = pending
            rec.count("moe.max_expert_rows", int(host[0]))
            rec.count("moe.active_experts", int(host[1]))
