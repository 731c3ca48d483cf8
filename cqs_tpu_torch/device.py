"""Resolve the explicit device string every entry point takes."""

from __future__ import annotations

import torch


def resolve_device(spec: str | torch.device) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` -> ``torch.device``. A CUDA device
    on a machine without one raises: the port never drops to the CPU
    silently, so CPU runs are always an explicit ``cpu``."""
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(spec)!r} requested but torch.cuda.is_available() "
                f"is false; pass device 'cpu' (CLI: --device cpu) to run on "
                f"the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(spec)!r}: use 'cuda' or 'cpu'")
    return dev
