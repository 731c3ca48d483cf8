"""Carry parameters between the JAX package's Flax trees and the port's
modules, both ways."""

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


#: modules whose 2-D ``weight`` is a Flax ``Embed`` table (``embedding``)
EMBED_NAMES = frozenset({"word", "position", "token_type", "tok_embed"})
#: ``DenseGeneral`` modules: q/k/v project to ``[heads, head_dim]``, and
#: ``out`` (every model's attention output) contracts ``[heads, head_dim]``
HEAD_PROJECTIONS = frozenset({"q", "k", "v"})


def flax_leaf_name(path: list[str], ndim: int) -> str:
    """The Flax leaf name of the port's parameter at ``path`` (its
    ``state_dict`` key split on dots) with ``ndim`` dims: ``weight`` of a 1-D
    norm -> ``scale``, of an ``Embed`` (names in :data:`EMBED_NAMES`) ->
    ``embedding``, of a ``Dense`` -> ``kernel``; any other name is kept."""
    leaf, owner = path[-1], (path[-2] if len(path) > 1 else "")
    if leaf != "weight":
        return leaf
    if ndim == 1:
        return "scale"
    return "embedding" if owner in EMBED_NAMES else "kernel"


def flax_tree_from_torch(state_dict: Mapping[str, torch.Tensor], cfg) -> dict:
    """The inverse of :func:`params_from_flax`: a port module's
    ``state_dict`` -> the reference's nested Flax tree ``{"params": ...}`` of
    f32 numpy arrays, at Flax's paths and shapes, for ``params.pkl`` and the
    native checkpoint. ``cfg`` gives the head width (``head_dim``, else
    ``hidden_size // num_heads``: a ``BertConfig`` or ``GemmaConfig``).

    - ``weight`` of a 1-D norm -> ``scale``; of an ``Embed`` (names in
      :data:`EMBED_NAMES`) -> ``embedding``; of a ``Dense`` -> ``kernel``
      transposed, a q/k/v kernel reshaped to ``[in, heads, head_dim]`` and
      an attention ``out`` kernel to ``[heads, head_dim, out]``;
    - ``bias`` -> ``bias``, ``[heads, head_dim]`` for q/k/v;
    - anything else (the hybrid's ``scales``) keeps its name."""
    hd = getattr(cfg, "head_dim", None) or cfg.hidden_size // cfg.num_heads
    tree: dict = {}
    for key, value in state_dict.items():
        path = key.split(".")
        arr = value.detach().float().cpu().numpy()
        leaf, owner = flax_leaf_name(path, arr.ndim), (path[-2] if len(path) > 1 else "")
        if leaf == "kernel":
            arr = arr.T
            if owner in HEAD_PROJECTIONS:
                arr = arr.reshape(arr.shape[0], -1, hd)
            elif owner == "out":
                arr = arr.reshape(-1, hd, arr.shape[-1])
        elif leaf == "bias" and owner in HEAD_PROJECTIONS:
            arr = arr.reshape(-1, hd)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[leaf] = np.array(arr, dtype=np.float32, order="C")
    return {"params": tree}
