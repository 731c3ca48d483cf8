"""Forward operations of the real tokens (from the masks; ``perfbench/flops.py``)
over the window's index time at the bf16 peak, in %."""

from perfbench.flops import BF16_PEAK_FLOPS


def read(r: dict):
    if r.get("cell") != "index" or not r.get("real_flops"):
        return None
    return 100.0 * r["real_flops"] / (r["window_s"] * BF16_PEAK_FLOPS)
