"""Operation and byte counts of the DeepSeek-V2 configurations, from their
published sizes (``perfbench/configs/dsv2-*.json``). A matrix product of
``[m, k]`` by ``[k, n]`` is ``2 m k n`` operations; elementwise work, norms,
softmax, the router's sort and the embedding lookup are not counted.
"""

from __future__ import annotations

from perfbench.flops import BF16_PEAK_FLOPS

#: NVIDIA H100 SXM's HBM3 bandwidth (data sheet), bytes a second
HBM_BYTES_PER_S = 3.35e12
#: bytes of a bf16 value
BF16 = 2


def attention_params(c: dict) -> int:
    """One layer's MLA matrices: q, the latent and rope key, kv_b, output."""
    H, n = c["hidden_size"], c["num_attention_heads"]
    nope, rope, vd, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                            c["kv_lora_rank"])
    return H * n * (nope + rope) + H * (rank + rope) + rank * n * (nope + vd) + n * vd * H


def moe_layers(c: dict) -> int:
    return sum(1 for i in range(c["num_hidden_layers"])
               if i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0)


def active_params(c: dict) -> int:
    """The matrix parameters one token's forward uses: every layer's
    attention; the dense layers' SwiGLU; an expert layer's router, its
    ``num_experts_per_tok`` routed experts and the shared experts."""
    H, L = c["hidden_size"], c["num_hidden_layers"]
    n_moe = moe_layers(c)
    expert = 3 * H * c["moe_intermediate_size"]
    moe = (H * c["n_routed_experts"] + c["num_experts_per_tok"] * expert
           + c["n_shared_experts"] * expert)
    return L * attention_params(c) + (L - n_moe) * 3 * H * c["intermediate_size"] + n_moe * moe


def forward_flops(c: dict, real_tokens: int) -> float:
    """The active parameters' operations over ``real_tokens`` tokens."""
    return 2.0 * active_params(c) * real_tokens


def expert_flops(c: dict, routed_rows: int) -> float:
    """The routed experts' grouped products over ``routed_rows`` token-expert
    rows: gate and up (``2 x I`` outputs) and down."""
    return 2.0 * 3 * c["hidden_size"] * c["moe_intermediate_size"] * routed_rows


def expert_bytes(c: dict, routed_rows: int, active_experts: int) -> float:
    """The bytes the grouped products must move at the least: each launch
    pair reads the weights of every expert that has rows (``active_experts``
    summed over the launches), and each row is read and written once by
    each product (gate-up: ``H`` in, ``2 I`` out; down: ``I`` in, ``H`` out),
    all in bf16."""
    H, inter = c["hidden_size"], c["moe_intermediate_size"]
    return BF16 * (active_experts * 3 * H * inter + routed_rows * (2 * H + 3 * inter))


def expert_roofline_s(c: dict, routed_rows: int, active_experts: int) -> float:
    """The least time the card takes for those products: the larger of
    operations at the bf16 peak and bytes at the HBM bandwidth."""
    return max(expert_flops(c, routed_rows) / BF16_PEAK_FLOPS,
               expert_bytes(c, routed_rows, active_experts) / HBM_BYTES_PER_S)
