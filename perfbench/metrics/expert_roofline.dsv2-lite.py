"""The grouped expert products of one profiled pull: the least time the card
could take for them (the larger of their operations at the bf16 peak and
their bytes at the HBM bandwidth, from the program's ``moe.routed_rows`` and
``moe.active_experts``; ``perfbench/flops_dsv2.py``) over the device time of
``aten::_grouped_mm``'s kernels, in %."""


def read(r: dict):
    t = r.get("trace")
    if r.get("cell") != "index" or not t or not t.get("grouped_mm_s") \
            or not t.get("expert_roofline_s"):
        return None
    return 100.0 * t["expert_roofline_s"] / t["grouped_mm_s"]
