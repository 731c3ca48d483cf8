"""A training step's operations over the real tokens (3 x the forward;
``perfbench/flops.py``), summed over the window, over the window's time at the
bf16 peak, in %."""

from perfbench.flops import BF16_PEAK_FLOPS


def read(r: dict):
    if r.get("cell") != "train" or not r.get("real_flops"):
        return None
    return 100.0 * r["real_flops"] / (r["window_s"] * BF16_PEAK_FLOPS)
