"""Seeded BERT weights in the published (Hugging Face ``BertModel``) key
layout, drawn on the device in one call, and a safetensors writer.

Linear and embedding weights and biases are N(0, 0.02) (BERT's
``initializer_range``), LayerNorm weights 1 + N(0, 0.05), LayerNorm biases
N(0, 0.02). The writer is the benchmark's own, so the checkpoint the program
loads is not made by the program.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import torch

_ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}
#: the configurations' ``compute_dtype`` names
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the keys of a configuration that a Hugging Face ``config.json`` carries
HF_KEYS = ("architectures", "model_type", "vocab_size", "hidden_size", "num_hidden_layers",
           "num_attention_heads", "intermediate_size", "max_position_embeddings",
           "type_vocab_size", "layer_norm_eps", "hidden_act")


def bert_shapes(c: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of a ``BertModel`` with its pooler;
    kind: ``w`` weight or embedding, ``b`` bias, ``g`` LayerNorm weight,
    ``n`` LayerNorm bias."""
    H, inter = c["hidden_size"], c["intermediate_size"]
    out = [("embeddings.word_embeddings.weight", (c["vocab_size"], H), "w"),
           ("embeddings.position_embeddings.weight", (c["max_position_embeddings"], H), "w"),
           ("embeddings.token_type_embeddings.weight", (c["type_vocab_size"], H), "w"),
           ("embeddings.LayerNorm.weight", (H,), "g"), ("embeddings.LayerNorm.bias", (H,), "n")]
    for i in range(c["num_hidden_layers"]):
        b = f"encoder.layer.{i}."
        for name, (o, n) in (("attention.self.query", (H, H)), ("attention.self.key", (H, H)),
                             ("attention.self.value", (H, H)), ("attention.output.dense", (H, H)),
                             ("intermediate.dense", (inter, H)), ("output.dense", (H, inter))):
            out += [(b + name + ".weight", (o, n), "w"), (b + name + ".bias", (o,), "b")]
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            out += [(b + name + ".weight", (H,), "g"), (b + name + ".bias", (H,), "n")]
    out += [("pooler.dense.weight", (H, H), "w"), ("pooler.dense.bias", (H,), "b")]
    return out


def draw_bert(c: dict, seed: int, device: torch.device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every tensor of :func:`bert_shapes`, drawn on ``device`` from ``seed``
    by one ``randn`` call, in ``dtype``."""
    shapes = bert_shapes(c)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (key, shape, kind), n in zip(shapes, sizes):
        x = flat[at:at + n].view(shape)
        at += n
        x = 1.0 + 0.05 * x if kind == "g" else 0.02 * x
        out[key] = x.to(dtype)
    return out


def write_safetensors(path: Path, tensors: dict[str, torch.Tensor]) -> None:
    """``{name: tensor}`` as one ``.safetensors`` file (names in order)."""
    header, offset = {}, 0
    cpu = {}
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        cpu[name] = t
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in sorted(cpu):
            f.write(cpu[name].reshape(-1).view(torch.uint8).numpy().tobytes())


def write_checkpoint(out: Path, c: dict, tensors: dict[str, torch.Tensor]) -> Path:
    """A Hugging Face checkpoint directory of configuration ``c``:
    ``config.json`` and ``model.safetensors``."""
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps({k: c[k] for k in HF_KEYS if k in c}, indent=1))
    write_safetensors(out / "model.safetensors", tensors)
    return out
