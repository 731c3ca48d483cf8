"""Carry parameters from the JAX package into the port's models."""

from __future__ import annotations

import numpy as np
import torch


def embedder_params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX hash embedder's ``{"table": [vocab, dim]}`` (already
    row-normalized, host numpy) -> the port's embedder parameters, for
    :meth:`cqs_tpu_torch.models.embedder.Embedder.load_params`."""
    table = np.asarray(params["table"], dtype=np.float32)
    if table.ndim != 2:
        raise ValueError(f"table must be [vocab, dim], got {table.shape}")
    return {"table": torch.from_numpy(np.array(table))}
