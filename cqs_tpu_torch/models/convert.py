"""Carry parameters from the JAX package into the port's models."""

from __future__ import annotations

from collections.abc import Mapping

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


def flatten_tree(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    """A nested parameter tree (a Flax ``params`` dict, with or without its
    ``"params"`` level) -> ``{path tuple: array}``."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
    flat = {}
    for name, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, prefix + (name,)))
        else:
            flat[prefix + (name,)] = value
    return flat


def flax_leaf_to_torch(path: tuple, value) -> tuple[str, torch.Tensor]:
    """One Flax parameter -> (state_dict key, tensor) of the port's module of
    the same name. Every model class keeps the reference's module names, so
    one rule covers them all:

    - ``kernel`` -> ``weight`` as ``[out, in]``: a ``Dense`` kernel ``[in,
      out]`` transposed; a ``DenseGeneral`` kernel ``[in, heads, hd]``
      (q/k/v) flattened to ``[in, heads * hd]`` first, and the attention
      ``out`` kernel ``[heads, hd, H]`` to ``[heads * hd, H]``;
    - ``bias`` -> ``bias``, flattened (q/k/v biases are ``[heads, hd]``);
    - ``embedding`` (``Embed``) and ``scale`` (``LayerNorm``, ``RMSNorm``)
      -> ``weight``;
    - anything else (the hybrid's ``scales``) keeps its name.

    The tensor keeps the value's dtype (f32 for a Flax tree);
    ``load_state_dict`` casts it to the parameter's."""
    arr = np.asarray(value)
    leaf = path[-1]
    if leaf == "kernel":
        if arr.ndim == 3:
            arr = arr.reshape(-1, arr.shape[-1]) if path[-2] == "out" else arr.reshape(arr.shape[0], -1)
        arr, leaf = arr.T, "weight"
    elif leaf == "bias":
        arr = arr.reshape(-1)
    elif leaf in ("embedding", "scale"):
        leaf = "weight"
    key = ".".join(map(str, path[:-1] + (leaf,)))
    return key, torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """A reference model's Flax parameter tree -> the port module's
    ``state_dict``, for ``BertDenseEmbedder``, ``SpladeModel``,
    ``CrossEncoder``, ``GemmaEncoder``, ``GemmaEmbedder`` and
    ``HybridDenseEmbedder`` alike."""
    return dict(flax_leaf_to_torch(path, value) for path, value in flatten_tree(tree).items())
