"""The heaviest expert's rows in each expert-layer call, summed
(``moe.max_expert_rows``), over the mean rows an expert took in them
(``moe.routed_rows`` over the routed experts), in one profiled pull: 1 when
the router spreads rows evenly."""


def read(r: dict):
    t = r.get("trace")
    n = (t or {}).get("moe_counters") or {}
    if r.get("cell") != "index" or not n.get("moe.routed_rows") \
            or "moe.max_expert_rows" not in n:
        return None
    return n["moe.max_expert_rows"] / (n["moe.routed_rows"] / r["n_experts"])
