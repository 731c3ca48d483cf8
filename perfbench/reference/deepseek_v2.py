"""The plain reference of the DeepSeek-V2 configurations, as a code embedder:
Hugging Face's ``modeling_deepseek.py`` (``DeepseekV2Model``) over tensors in
its published key layout, then the last real token's final hidden state and
an L2 norm. Plain ``torch`` operations, computed in float32 with TF32 off;
every routed expert is computed on its own rows, one expert after another.
It imports nothing of the program.

Departures from ``modeling_deepseek.py``, each one of use and not of
substance:

- inference only: no KV cache, no auxiliary loss, no training branch of
  ``DeepseekV2MoE``; attention is the eager ``DeepseekV2Attention`` path;
- ``q_lora_rank`` null, greedy top-k over softmax scores, YaRN or no rope
  scaling: the configurations this benchmark runs, and the others raise;
- the attention mask is the causal mask and the key padding mask filled
  with float32's lowest value (HF's ``_prepare_4d_causal_attention_mask``
  gives the same additive mask);
- the cos and sin tables and the rotation are float32 (HF casts the
  tables to the activations' type: ``precision`` rounds them so);
- the routed experts' outputs are put back by token and slot and summed
  in float32 over the slots, as ``moe_infer`` does, with ``topk`` sorted;
- pooling: the hidden state at each row's last real position after the
  final norm, then L2 (the decoder-as-embedder use; HF's model has no
  pooling).

``precision`` names the type the model computes in, as in
``reference/bert.py``: ``f32`` (the reference), ``bf16`` (as the port
computes this family on a GPU), or ``fp8`` (float8 e4m3, one scale a
tensor: the control of a bf16 configuration). TF32 is turned off before
each forward. ``fault`` leaves part of the
expert layers out, for the checks' controls: ``last_expert`` (each token's
lowest-weighted routed expert) or ``shared`` (the shared experts).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FAULTS = ("last_expert", "shared")
#: the type a precision rounds values to
PRECISIONS = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounding(precision: str):
    """The rounding of ``precision``, a function of a tensor: none for
    ``f32``; else each value rounded to the type of :data:`PRECISIONS` and
    back, a float8 type with one scale that puts the tensor's largest
    magnitude at the type's largest value."""
    if precision == "f32":
        return lambda x: x
    dtype = PRECISIONS[precision]
    if dtype.itemsize > 1:
        return lambda x: x.to(dtype).float()

    def fp8(x):
        scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
        return (x / scale).to(dtype).float() * scale
    return fp8


def check_config(c: dict) -> None:
    if c.get("q_lora_rank") is not None:
        raise ValueError("q_lora_rank: only q_proj without a q-LoRA is implemented")
    if c.get("topk_method", "greedy") != "greedy" or c.get("scoring_func", "softmax") != "softmax":
        raise ValueError("only greedy top-k over softmax scores is implemented")
    rs = c.get("rope_scaling") or {}
    if rs and rs.get("type", rs.get("rope_type")) != "yarn":
        raise ValueError("only YaRN rope scaling is implemented")


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_inv_freq(c: dict) -> tuple[torch.Tensor, float]:
    """(inverse frequencies ``[rope_dim // 2]``, the tables' mscale): plain
    RoPE's, or ``DeepseekV2YarnRotaryEmbedding``'s."""
    dim, base = c["qk_rope_head_dim"], float(c["rope_theta"])
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    freq_extra = 1.0 / (base ** exps)
    rs = c.get("rope_scaling") or {}
    if not rs:
        return freq_extra, 1.0
    factor, orig = float(rs["factor"]), int(rs["original_max_position_embeddings"])
    freq_inter = 1.0 / (factor * base ** exps)

    def find_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))
    low = max(math.floor(find_dim(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(find_dim(rs.get("beta_slow", 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    mscale = yarn_get_mscale(factor, rs.get("mscale", 1)) / \
        yarn_get_mscale(factor, rs.get("mscale_all_dim", 0))
    return inv_freq, mscale


def softmax_scale(c: dict) -> float:
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    rs = c.get("rope_scaling") or {}
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(float(rs["factor"]), rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``apply_rotary_pos_emb`` on ``[B, h, L, d]``: de-interleave, then
    rotate-half."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + _rotate_half(x) * sin


def _w(p: dict, key: str, r) -> torch.Tensor:
    return r(p[key].float())


def _linear(p: dict, key: str, x: torch.Tensor, r) -> torch.Tensor:
    return r(x @ _w(p, key + ".weight", r).T)


def _rms_norm(p: dict, key: str, x: torch.Tensor, eps: float, r) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return r(_w(p, key + ".weight", r) * r(x * torch.rsqrt(var + eps)))


def _mlp(p: dict, key: str, x: torch.Tensor, r) -> torch.Tensor:
    """``DeepseekV2MLP``: ``down(silu(gate(x)) * up(x))``."""
    return _linear(p, key + ".down_proj",
                   r(r(F.silu(_linear(p, key + ".gate_proj", x, r))) * _linear(p, key + ".up_proj", x, r)),
                   r)


def _moe(p: dict, key: str, c: dict, x: torch.Tensor, r, fault: str | None) -> torch.Tensor:
    """``DeepseekV2MoE`` at inference over ``x [T, H]``: the gate, each
    routed expert on the rows routed to it, the shared experts."""
    k = c["num_experts_per_tok"]
    scores = torch.softmax(x @ _w(p, key + ".gate.weight", r).T, dim=-1)
    topk_w, topk_idx = torch.topk(scores, k, dim=-1, sorted=True)
    if k > 1 and c["norm_topk_prob"]:
        topk_w = topk_w / (topk_w.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        topk_w = topk_w * c["routed_scaling_factor"]
    if fault == "last_expert":
        topk_w = topk_w.clone()
        topk_w[:, -1] = 0.0
    outs = torch.zeros(x.shape[0], k, x.shape[1], device=x.device)
    for e in range(c["n_routed_experts"]):
        tok, slot = (topk_idx == e).nonzero(as_tuple=True)
        if tok.numel():
            outs[tok, slot] = _mlp(p, f"{key}.experts.{e}", x[tok], r)
    y = r((outs * topk_w[..., None]).sum(dim=1))
    if c.get("n_shared_experts") and fault != "shared":
        y = r(y + _mlp(p, key + ".shared_experts", x, r))
    return y


def _attention(p: dict, key: str, c: dict, x: torch.Tensor, bias: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, r) -> torch.Tensor:
    """``DeepseekV2Attention`` (no q-LoRA, eager, no cache) over ``[B, L, H]``."""
    B, L, _ = x.shape
    n, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                         c["v_head_dim"])
    q = _linear(p, key + ".q_proj", x, r).view(B, L, n, nope + rope).transpose(1, 2)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    ckv = _linear(p, key + ".kv_a_proj_with_mqa", x, r)
    ckv, k_pe = torch.split(ckv, [c["kv_lora_rank"], rope], dim=-1)
    k_pe = k_pe.view(B, L, 1, rope).transpose(1, 2)
    kv = _linear(p, key + ".kv_b_proj", _rms_norm(p, key + ".kv_a_layernorm", ckv,
                                                    c["rms_norm_eps"], r), r)
    kv = kv.view(B, L, n, nope + vd).transpose(1, 2)
    k_nope, v = torch.split(kv, [nope, vd], dim=-1)
    q_pe = r(_apply_rope(q_pe, cos, sin))
    k_pe = r(_apply_rope(k_pe, cos, sin))
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, n, L, rope)], dim=-1)
    probs = r(torch.softmax(q @ k.transpose(2, 3) * softmax_scale(c) + bias, dim=-1))
    ctx = r(probs @ v).transpose(1, 2).reshape(B, L, n * vd)
    return _linear(p, key + ".o_proj", ctx, r)


def hidden_states(p: dict, c: dict, ids: torch.Tensor, mask: torch.Tensor,
                  precision: str = "f32", fault: str | None = None,
                  every_layer: bool = False):
    """The final-norm hidden states ``[B, L, H]`` in f32 (with
    ``every_layer``, also the embeddings and each layer's output before it,
    as a list). ``p``: ``model.*`` tensors of a ``DeepseekV2ForCausalLM``
    checkpoint."""
    check_config(c)
    tf32_off()
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    r = rounding(precision)
    B, L = ids.shape
    eps = float(c["rms_norm_eps"])
    inv_freq, mscale = rope_inv_freq(c)
    freqs = torch.outer(torch.arange(L, dtype=torch.float32), inv_freq).to(ids.device)
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = r(emb.cos() * mscale), r(emb.sin() * mscale)
    causal = torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()
    keep = causal[None, None] & (mask[:, None, None, :] > 0)
    bias = torch.zeros(B, 1, L, L, device=ids.device).masked_fill(~keep, torch.finfo(torch.float32).min)
    x = r(_w(p, "model.embed_tokens.weight", r)[ids])
    states = [x]
    for i in range(c["num_hidden_layers"]):
        key = f"model.layers.{i}"
        h = _rms_norm(p, key + ".input_layernorm", x, eps, r)
        x = r(x + _attention(p, key + ".self_attn", c, h, bias, cos, sin, r))
        h = _rms_norm(p, key + ".post_attention_layernorm", x, eps, r)
        moe = (c.get("n_routed_experts") and i >= c["first_k_dense_replace"]
               and i % c.get("moe_layer_freq", 1) == 0)
        if moe:
            y = _moe(p, key + ".mlp", c, h.reshape(B * L, -1), r, fault).view(B, L, -1)
        else:
            y = _mlp(p, key + ".mlp", h, r)
        x = r(x + y)
        states.append(x)
    out = _rms_norm(p, "model.norm", x, eps, r)
    return (states, out) if every_layer else out


def pool(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The last real position's state of each row, L2-normalised."""
    last = (mask.sum(dim=1) - 1).clamp(min=0)
    v = h[torch.arange(h.shape[0], device=h.device), last]
    return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def embed(p: dict, c: dict, ids: torch.Tensor, mask: torch.Tensor,
          precision: str = "f32", fault: str | None = None) -> torch.Tensor:
    """Unit vectors ``[B, H]`` in f32."""
    return pool(hidden_states(p, c, ids, mask, precision, fault), mask)
