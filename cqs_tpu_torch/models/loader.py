"""Checkpoints for the port's neural models: safetensors files, HF layouts
and the native ``cqs_config.json`` checkpoints.

Port of ``cqs_tpu/models/loader.py``. The reference maps checkpoint tensors
into Flax parameter trees; here the target is a module's ``state_dict``,
whose keys carry the reference's module names (``models/bert.py``,
``gemma.py``). A HF ``Linear.weight`` is ``[out, in]``, which is already the
port's layout, so the mappers below move tensors by name without the
reference's transposes and reshapes. As in the reference, a tensor the
checkpoint lacks keeps the module's initial value, and a template entry the
checkpoint fills must match its shape (BERT: element count; Gemma: skipped
when it does not).

One deliberate difference: a BERT position table with more rows than the
module (HF checkpoints have 512; the ``splade-distil`` preset runs 256)
loads its leading rows, the only ones a shorter sequence reads. The
reference's reshape raises there.

The safetensors format is read and written here, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header (``dtype``, ``shape``, ``data_offsets`` per tensor, optional
``__metadata__``), then the raw little-endian data.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.models.convert import flatten_tree, flax_leaf_to_torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64, "I32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """One ``.safetensors`` file -> ``{name: CPU tensor}``. The tensors are
    views of one private (copy-on-write) memory map of the file
    (``torch.frombuffer``), so a tensor's pages are read when first touched
    and nothing is copied; a tensor whose offset is not aligned to its
    element size is copied out alone."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        start, end = info["data_offsets"]
        start, end = start + base, end + base
        shape = tuple(info["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        if end - start != size * int(np.prod(shape, dtype=np.int64)) or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} has offsets {start - base}-{end - base} "
                             f"for {info['dtype']} {list(shape)}")
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        if start % size:
            t = torch.frombuffer(bytearray(data[start:end]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=(end - start) // size, offset=start)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(path: str | Path, tensors: Mapping[str, torch.Tensor]) -> None:
    """``{name: tensor}`` -> one ``.safetensors`` file (tensors in name
    order, the header padded to 8 bytes). Written beside ``path`` and
    renamed over it, so tensors still mapped from the file it replaces
    (:func:`read_safetensors`) keep their bytes."""
    header: dict = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(t)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = Path(f"{path}.partial")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    os.replace(tmp, path)


def _read_dir(model_dir: Path) -> dict[str, torch.Tensor] | None:
    files = sorted(model_dir.glob("*.safetensors"))
    if not files:
        return None
    out: dict[str, torch.Tensor] = {}
    for f in files:
        out.update(read_safetensors(f))
    return out


def _strip_prefix(tensors: dict[str, torch.Tensor],
                  prefixes=("bert.", "model.", "0.auto_model.")) -> dict[str, torch.Tensor]:
    for p in prefixes:
        if any(k.startswith(p) for k in tensors):
            return {k[len(p):] if k.startswith(p) else k: v for k, v in tensors.items()}
    return tensors


def _bert_put(new: dict[str, torch.Tensor]):
    """The reference's ``put`` for BERT trees: absent keys are skipped, other
    shapes reshaped (raising on another element count); position tables
    keep their leading rows (module docstring)."""
    def put(key: str, arr: torch.Tensor) -> bool:
        if key not in new:
            return False
        want = tuple(new[key].shape)
        if tuple(arr.shape) != want:
            if (key.endswith("position.weight") and arr.ndim == 2
                    and arr.shape[1] == want[1] and arr.shape[0] > want[0]):
                arr = arr[: want[0]]
            else:
                arr = arr.reshape(want)
        new[key] = arr
        return True
    return put


def _bert_layer(t: dict, put, li: int, dst: str) -> None:
    """HF ``encoder.layer.{li}`` -> the port's ``{dst}`` BertLayer."""
    base = f"encoder.layer.{li}."
    for hf, ours in (("query", "q"), ("key", "k"), ("value", "v")):
        put(f"{dst}.{ours}.weight", t[base + f"attention.self.{hf}.weight"])
        put(f"{dst}.{ours}.bias", t[base + f"attention.self.{hf}.bias"])
    for hf, ours in (("attention.output.dense", "out"), ("intermediate.dense", "ff1"),
                     ("output.dense", "ff2"), ("attention.output.LayerNorm", "ln1"),
                     ("output.LayerNorm", "ln2")):
        put(f"{dst}.{ours}.weight", t[base + hf + ".weight"])
        put(f"{dst}.{ours}.bias", t[base + hf + ".bias"])


def _bert_embeddings(t: dict, put, dst: str) -> None:
    for hf, ours in (("word_embeddings", "word"), ("position_embeddings", "position"),
                     ("token_type_embeddings", "token_type"), ("LayerNorm", "ln")):
        for leaf in ("weight", "bias") if ours == "ln" else ("weight",):
            src = f"embeddings.{hf}.{leaf}"
            if src in t:
                put(f"{dst}.{ours}.{leaf}", t[src])


def _map_bert(t: dict[str, torch.Tensor], template: Mapping[str, torch.Tensor]
              ) -> dict[str, torch.Tensor] | None:
    """HF BERT tensors -> a ``BertDenseEmbedder``/``SpladeModel`` state dict
    (``loader.py:39-117``)."""
    new = dict(template)
    put = _bert_put(new)
    _bert_embeddings(t, put, "encoder.embeddings")
    li = 0
    while f"encoder.layer.{li}.attention.self.query.weight" in t:
        _bert_layer(t, put, li, f"encoder.layer_{li}")
        li += 1
    if li == 0:
        return None
    for src, dst in (("cls.predictions.transform.dense.weight", "mlm.transform.weight"),
                     ("cls.predictions.transform.dense.bias", "mlm.transform.bias"),
                     ("cls.predictions.transform.LayerNorm.weight", "mlm.ln.weight"),
                     ("cls.predictions.transform.LayerNorm.bias", "mlm.ln.bias"),
                     ("cls.predictions.decoder.weight", "mlm.decoder.weight"),
                     ("cls.predictions.bias", "mlm.decoder.bias")):
        if src in t:
            put(dst, t[src])
    # HF ties the MLM decoder to the word embeddings and may omit it
    if ("mlm.decoder.weight" in new and "cls.predictions.decoder.weight" not in t
            and "embeddings.word_embeddings.weight" in t):
        put("mlm.decoder.weight", t["embeddings.word_embeddings.weight"])
    return new


def _map_gemma(t: dict[str, torch.Tensor], template: Mapping[str, torch.Tensor]
               ) -> dict[str, torch.Tensor] | None:
    """HF Gemma3 / Qwen3 tensors -> a ``GemmaEmbedder`` state dict
    (``loader.py:120-195``): four sandwich norms a layer when the checkpoint
    has ``pre_feedforward_layernorm``, else Qwen's pre-norms (its
    ``post_attention_layernorm`` is the pre-MLP norm); the EmbeddingGemma
    head from the merged ``2_Dense``/``3_Dense`` files."""
    new = dict(template)

    def put(key: str, arr: torch.Tensor) -> bool:
        if key not in new:
            return False
        want = tuple(new[key].shape)
        if tuple(arr.shape) != want:
            if arr.numel() != int(np.prod(want)):
                return False
            arr = arr.reshape(want)
        new[key] = arr
        return True

    if "embed_tokens.weight" in t:
        put("encoder.tok_embed.weight", t["embed_tokens.weight"])
    if "layers.0.pre_feedforward_layernorm.weight" in t:
        norm_map = {"input_layernorm": "pre_attn_norm",
                    "post_attention_layernorm": "post_attn_norm",
                    "pre_feedforward_layernorm": "pre_mlp_norm",
                    "post_feedforward_layernorm": "post_mlp_norm"}
    else:
        norm_map = {"input_layernorm": "pre_attn_norm",
                    "post_attention_layernorm": "pre_mlp_norm"}
    li = 0
    while f"layers.{li}.self_attn.q_proj.weight" in t:
        base, dst = f"layers.{li}.", f"encoder.layer_{li}."
        for hf, ours in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("o_proj", "out")):
            put(dst + f"attn.{ours}.weight", t[base + f"self_attn.{hf}.weight"])
        for hf in ("q_norm", "k_norm"):
            key = base + f"self_attn.{hf}.weight"
            if key in t:
                put(dst + f"attn.{hf}.weight", t[key])
        for hf, ours in (("gate_proj", "gate"), ("up_proj", "up"), ("down_proj", "down")):
            put(dst + f"mlp.{ours}.weight", t[base + f"mlp.{hf}.weight"])
        for hf, ours in norm_map.items():
            key = base + hf + ".weight"
            if key in t:
                put(dst + ours + ".weight", t[key])
        li += 1
    if li == 0:
        return None
    if "norm.weight" in t:
        put("encoder.final_norm.weight", t["norm.weight"])
    for src, dst in (("2_Dense.linear.weight", "proj1"), ("3_Dense.linear.weight", "proj2"),
                     ("dense1.linear.weight", "proj1"), ("dense2.linear.weight", "proj2")):
        if src in t:
            put(dst + ".weight", t[src])
    return new


def _map_deepseek(t: dict[str, torch.Tensor], template: Mapping[str, torch.Tensor]
                  ) -> dict[str, torch.Tensor] | None:
    """HF ``DeepseekV2`` tensors (``model.`` stripped) -> a
    ``DeepseekEmbedder`` state dict (``models/deepseek.py``). Each routed
    expert's ``gate_proj`` and ``up_proj`` rows are stacked into the
    layer's ``gate_up [E, 2 * I, H]``, its ``down_proj`` into ``down [E, H,
    I]``. Every tensor of the module must come from the checkpoint at its
    shape (a model with random layers embeds noise); ``lm_head`` is not
    read."""
    if "layers.0.self_attn.kv_a_proj_with_mqa.weight" not in t:
        return None
    new: dict[str, torch.Tensor] = {}

    def put(key: str, arr: torch.Tensor) -> None:
        if key not in template:
            raise ValueError(f"checkpoint tensor for {key}, which the model lacks")
        if tuple(arr.shape) != tuple(template[key].shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(arr.shape)} vs "
                             f"{tuple(template[key].shape)}")
        new[key] = arr

    put("tok_embed.weight", t["embed_tokens.weight"])
    put("final_norm.weight", t["norm.weight"])
    li = 0
    while f"layers.{li}.self_attn.kv_a_proj_with_mqa.weight" in t:
        src, dst = f"layers.{li}.", f"layer_{li}."
        for hf, ours in (("q_proj", "q"), ("kv_a_proj_with_mqa", "kv_a"),
                         ("kv_a_layernorm", "kv_norm"), ("kv_b_proj", "kv_b"), ("o_proj", "out")):
            put(f"{dst}attn.{ours}.weight", t[f"{src}self_attn.{hf}.weight"])
        put(f"{dst}pre_attn_norm.weight", t[f"{src}input_layernorm.weight"])
        put(f"{dst}pre_mlp_norm.weight", t[f"{src}post_attention_layernorm.weight"])
        if f"{src}mlp.gate.weight" in t:
            m = f"{src}mlp."
            put(f"{dst}moe.router.weight", t[m + "gate.weight"])
            n = 0
            while f"{m}experts.{n}.gate_proj.weight" in t:
                n += 1
            g0, d0 = t[f"{m}experts.0.gate_proj.weight"], t[f"{m}experts.0.down_proj.weight"]
            inter = g0.shape[0]
            gate_up = torch.empty((n, 2 * inter, g0.shape[1]), dtype=g0.dtype)
            down = torch.empty((n, *d0.shape), dtype=d0.dtype)
            for e in range(n):
                x = f"{m}experts.{e}."
                gate_up[e, :inter] = t[x + "gate_proj.weight"]
                gate_up[e, inter:] = t[x + "up_proj.weight"]
                down[e] = t[x + "down_proj.weight"]
            put(f"{dst}moe.experts.gate_up", gate_up)
            put(f"{dst}moe.experts.down", down)
            for proj in ("gate", "up", "down"):
                key = f"{m}shared_experts.{proj}_proj.weight"
                if key in t:
                    put(f"{dst}moe.shared.{proj}.weight", t[key])
        else:
            for proj in ("gate", "up", "down"):
                put(f"{dst}mlp.{proj}.weight", t[f"{src}mlp.{proj}_proj.weight"])
        li += 1
    missing = sorted(set(template) - set(new))
    if missing:
        raise ValueError(f"checkpoint lacks tensors for {', '.join(missing[:4])}"
                         f"{' ...' if len(missing) > 4 else ''} ({len(missing)} in all)")
    return new


def _map_cross_encoder(t: dict[str, torch.Tensor], template: Mapping[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor] | None:
    """HF BertForSequenceClassification -> a ``CrossEncoder`` state dict
    (``loader.py:272-332``): embeddings and layers at the top level."""
    new = dict(template)
    put = _bert_put(new)
    _bert_embeddings(t, put, "embeddings")
    li = 0
    while f"encoder.layer.{li}.attention.self.query.weight" in t:
        _bert_layer(t, put, li, f"layer_{li}")
        li += 1
    if li == 0:
        return None
    for src, dst in (("pooler.dense.weight", "pooler.weight"), ("pooler.dense.bias", "pooler.bias"),
                     ("classifier.weight", "classifier.weight"),
                     ("classifier.bias", "classifier.bias")):
        if src in t:
            put(dst, t[src])
    return new


def load_safetensors_params(model_dir: str | Path, template: Mapping[str, torch.Tensor],
                            family: str) -> dict[str, torch.Tensor] | None:
    """A HF checkpoint in ``model_dir`` mapped onto ``template`` (a module's
    state dict) by the preset ``family``; None when there is no checkpoint
    (``loader.py:198-216``). SentenceTransformer Dense modules in
    ``2_Dense``/``3_Dense`` are merged in with that prefix."""
    model_dir = Path(model_dir)
    tensors = _read_dir(model_dir)
    if tensors is None:
        return None
    for sub in ("2_Dense", "3_Dense"):
        extra = _read_dir(model_dir / sub) if (model_dir / sub).is_dir() else None
        if extra:
            tensors.update({f"{sub}.{k}": v for k, v in extra.items()})
    tensors = _strip_prefix(tensors)
    if family == "bert":
        return _map_bert(tensors, template)
    if family in ("gemma", "qwen3"):
        return _map_gemma(tensors, template)
    if family == "deepseek":
        return _map_deepseek(tensors, template)
    return None


def save_native_checkpoint(params: Mapping, out_dir: str | Path, config: dict) -> None:
    """Write a native checkpoint (``loader.py:228-243``): the Flax-pathed
    tree ``params`` (with or without its ``"params"`` level, e.g. from
    ``models/convert.py::flax_tree_from_torch``) as f32 tensors under
    ``"/".join(path)`` in ``model.safetensors``, and ``config`` as
    ``cqs_config.json``. Either package's native loader reads it."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tensors = {"/".join(map(str, path)): torch.from_numpy(np.array(value, dtype=np.float32))
               for path, value in flatten_tree(params).items()}
    write_safetensors(out_dir / "model.safetensors", tensors)
    with open(out_dir / "cqs_config.json", "w") as f:
        json.dump(config, f, indent=1)


def load_native_checkpoint(model_dir: str | Path, template: Mapping[str, torch.Tensor]
                           ) -> dict[str, torch.Tensor] | None:
    """A native checkpoint (``cqs_config.json`` + ``model.safetensors`` whose
    keys are ``"/".join(flax path)``, as the reference's trainer writes them)
    -> a state dict for ``template``, every key required at its shape
    (``loader.py:246-269``). None when the directory has no
    ``cqs_config.json`` (then the HF mappers apply)."""
    model_dir = Path(model_dir)
    if not (model_dir / "cqs_config.json").is_file():
        return None
    tensors = read_safetensors(model_dir / "model.safetensors")
    mapped = {}
    for name, arr in tensors.items():
        key, value = flax_leaf_to_torch(tuple(name.split("/")), arr.float().numpy())
        mapped[key] = (name, value)
    new = {}
    for key, want in template.items():
        if key not in mapped:
            raise ValueError(f"native checkpoint missing tensor for {key}")
        name, value = mapped[key]
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {name}: {tuple(value.shape)} "
                             f"vs {tuple(want.shape)}")
        new[key] = value
    return new


def load_cross_encoder_params(model_dir: str | Path, template: Mapping[str, torch.Tensor]
                              ) -> dict[str, torch.Tensor] | None:
    """A native checkpoint first, then a HF BertForSequenceClassification
    layout; None when neither exists (``loader.py:335-348``)."""
    model_dir = Path(model_dir)
    native = load_native_checkpoint(model_dir, template)
    if native is not None:
        return native
    tensors = _read_dir(model_dir)
    if tensors is None:
        return None
    return _map_cross_encoder(_strip_prefix(tensors), template)
