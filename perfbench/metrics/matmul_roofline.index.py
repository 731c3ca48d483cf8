"""The linear layers' matrix products in the traced window: their operations
(padded positions; forward, and twice that backward in training) over the
device time of the kernels of ``aten::addmm`` and ``aten::mm`` at the bf16 peak,
in %."""

from perfbench.flops import BF16_PEAK_FLOPS


def read(r: dict):
    t = r.get("trace")
    if r.get("cell") != "index" or not t or not t.get("gemm_s") or not t.get("gemm_flops"):
        return None
    return 100.0 * t["gemm_flops"] / (t["gemm_s"] * BF16_PEAK_FLOPS)
