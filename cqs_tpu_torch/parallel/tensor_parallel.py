"""The trainers' (dp, tp) grid in one process: parameter placement and the
tensor-parallel forward of the dual encoders.

Port of the reference's training mesh (``cqs_tpu/parallel/train.py``):
there ``_param_sharding_spec`` (:53-64) places the parameters over a (dp,
tp) ``Mesh``, the batch is constrained to ``P("dp", None)`` and XLA inserts
the collectives. The port keeps the reference's single controller: one
process drives every device of a :class:`~cqs_tpu_torch.parallel.mesh.Mesh`
(the cards of :func:`~cqs_tpu_torch.parallel.mesh.make_2d_mesh`, or logical
devices on one card from an explicit ``Mesh([cuda0] * n, ("dp", "tp"),
(dp, tp))``), and each collective is a tensor copy, concatenation or sum,
whose backward autograd carries across ``.to(device)``. No process group:

- **placement** (:func:`param_sharding_spec`): embedding tables and the
  MLP's ``ff1`` / ``ff2`` split over tp, everything else replicated. One f32
  master copy of each parameter: a split one as tp shards on the devices of
  mesh row 0, a replicated one on device (0, 0); the optimizer's moments sit
  beside each shard. Parameters and optimizer state are the same on every
  dp row, as in the reference, so they are held once;
- **the forward of dp row r** (:meth:`TPGrid.embed`): the word, position
  and token-type lookups on their column shards on (r, t), summed there and
  concatenated along H on (r, 0) (the all-gather); the norms, q/k/v/out and
  attention on (r, 0); ``ff1`` column-parallel (each (r, t) computes
  ``gelu(x @ W1_t + b1_t)`` on its slice of the intermediate width) and
  ``ff2`` row-parallel (the tp partial products summed on (r, 0), its bias
  added once); pooling, the norm and the hybrid's hash leg on (r, 0). A row
  r > 0 reads copies of the masters on its own devices, and the copies'
  gradients flow back into the masters, summed over the rows: the dp
  all-reduce. On logical devices of one card every copy is the master
  itself (``.to`` of a tensor already there);
- **the batch**: its rows split over dp in order (row r takes the r-th of
  dp equal blocks), each row's unit vectors gathered on (0, 0), where the
  trainers' losses contract the whole batch.

The module's own code is reused where a step runs on one device
(``functional_call`` of its norms and projections with the row's
parameters); the split ``Dense`` and ``Embed`` steps repeat those layers'
casts (``models/layers.py``).
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from cqs_tpu_torch.models.bert import BertDenseEmbedder, l2_normalize, pool_hidden
from cqs_tpu_torch.models.convert import flax_leaf_name
from cqs_tpu_torch.models.hybrid import HybridDenseEmbedder, hash_pool
from cqs_tpu_torch.models.layers import attention, pad_bias
from cqs_tpu_torch.parallel.mesh import Mesh

#: a parameter whose Flax path holds one of these may split over tp
SPLIT_NAMES = ("embedding", "ff1", "ff2")


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def param_sharding_spec(key: str, shape: Sequence[int], tp: int) -> int | None:
    """The dim of the port's parameter ``key`` (its ``state_dict`` key, of
    shape ``shape``) that a mesh's tp axis splits, or None (replicated): the
    reference's ``_param_sharding_spec`` read through the port's layout.

    A leaf whose Flax path holds ``embedding``, ``ff1`` or ``ff2``, with ndim
    >= 2 and its last Flax dim divisible by tp, is split: ``ff2`` over its
    Flax rows when they divide by tp too, the others over their last Flax
    dim. A ``Dense`` weight is its Flax kernel transposed (``[out, in]``), so
    Flax ``ff1/kernel [H, I]`` split on I is ``ff1.weight [I, H]`` split on
    dim 0 and Flax ``ff2/kernel [I, H]`` split on I is ``ff2.weight [H, I]``
    split on dim 1; the ``Embed`` tables ``[num, H]`` split on H in both."""
    path = key.split(".")
    ndim = len(shape)
    leaf = flax_leaf_name(path, ndim)
    joined = "/".join(path[:-1] + [leaf])
    kernel = leaf == "kernel"
    flax_shape = tuple(shape)[::-1] if kernel else tuple(shape)
    tp = max(tp, 1)
    if ndim < 2 or flax_shape[-1] % tp or not any(n in joined for n in SPLIT_NAMES):
        return None
    flax_dim = 0 if "ff2" in joined and flax_shape[0] % tp == 0 else ndim - 1
    return ndim - 1 - flax_dim if kernel else flax_dim


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            dtype: torch.dtype) -> torch.Tensor:
    """``models/layers.py::Dense``'s step on a weight (or a shard of one):
    input, weight and bias cast to the layer's ``dtype``."""
    return F.linear(x.to(dtype), w.to(dtype), None if b is None else b.to(dtype))


def _gather(parts: list[torch.Tensor], dev: torch.device, dim: int = -1) -> torch.Tensor:
    """Shards concatenated along ``dim`` on ``dev``."""
    return torch.cat([p.to(dev) for p in parts], dim=dim)


class TPGrid:
    """A dual encoder's (``BertDenseEmbedder`` or ``HybridDenseEmbedder``)
    parameters placed over a (dp, tp) mesh, and its sharded forward.

    Built from the whole module, initialized on device (0, 0): each split
    parameter is cut into tp shards on row 0 and taken out of the module, so
    the module's one-device forward cannot run on stale weights; the
    replicated ones stay in the module. :meth:`state_dict` and
    :meth:`load_state_dict` read and write the whole module's keys and
    shapes."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        if tuple(mesh.shape) != ("dp", "tp"):
            raise ValueError(f"a training mesh has axes ('dp', 'tp'), not {tuple(mesh.shape)}")
        if not isinstance(model, (BertDenseEmbedder, HybridDenseEmbedder)):
            raise TypeError(f"no tensor-parallel forward for {type(model).__name__}")
        self.model, self.mesh = model, mesh
        self.dp, self.tp = mesh.shape["dp"], mesh.shape["tp"]
        #: the one-device module's parameter keys, in its order
        self.keys = [k for k, _ in model.named_parameters()]
        #: split parameter -> its split dim, and its tp master shards
        self.split: dict[str, int] = {}
        self.shards: dict[str, list[nn.Parameter]] = {}
        with torch.no_grad():
            for key, p in list(model.named_parameters()):
                dim = param_sharding_spec(key, p.shape, self.tp)
                if dim is None:
                    continue
                n = p.shape[dim] // self.tp
                self.split[key] = dim
                self.shards[key] = [nn.Parameter(
                    p.narrow(dim, t * n, n).to(mesh.device_at(0, t), copy=True,
                                               memory_format=torch.contiguous_format),
                    requires_grad=p.requires_grad) for t in range(self.tp)]
                owner, _, name = key.rpartition(".")
                del model.get_submodule(owner)._parameters[name]
        self._tables: dict[torch.device, torch.Tensor] = {}

    def parameters(self) -> list[nn.Parameter]:
        """Every master parameter once, in the module's order, a split one as
        its tp shards."""
        own = dict(self.model.named_parameters())
        return [p for k in self.keys for p in (self.shards[k] if k in self.shards else [own[k]])]

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The whole module's ``state_dict``: each split parameter's shards
        concatenated on device (0, 0)."""
        own = self.model.state_dict()
        first = self.mesh.devices[0]
        return {k: (_gather([s.detach() for s in self.shards[k]], first, self.split[k])
                    if k in self.shards else own[k]) for k in self.keys}

    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """The whole module's ``state_dict`` (``models/convert.py::
        params_from_flax``), each split parameter cut into its shards."""
        if set(state) != set(self.keys):
            raise KeyError(f"keys differ from the model's: missing "
                           f"{sorted(set(self.keys) - set(state))[:3]}, unexpected "
                           f"{sorted(set(state) - set(self.keys))[:3]}")
        with torch.no_grad():
            self.model.load_state_dict({k: v for k, v in state.items() if k not in self.shards})
            for k, parts in self.shards.items():
                dim, n = self.split[k], parts[0].shape[self.split[k]]
                want = list(parts[0].shape)
                want[dim] *= self.tp
                if list(state[k].shape) != want:
                    raise ValueError(f"{k}: shape {tuple(state[k].shape)}, the model's {tuple(want)}")
                for t, s in enumerate(parts):
                    s.copy_(state[k].narrow(dim, t * n, n))

    def embed(self, ids, mask) -> torch.Tensor:
        """The model's f32 unit vectors of host ``[N, L]`` ids and mask on
        device (0, 0): the rows cut into dp blocks in order (``np.array_split``),
        block r through dp row r's forward."""
        first = self.mesh.devices[0]
        outs = [self._forward(r, i, m).to(first) for r, (i, m) in enumerate(
            zip(np.array_split(ids, self.dp), np.array_split(mask, self.dp))) if len(i)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _row(self, r: int) -> tuple[list[torch.device], dict]:
        """Row r's devices, and the parameters as row r reads them: the
        replicated ones on (r, 0), a split one as its shards on (r, t)."""
        devs = [self.mesh.device_at(r, t) for t in range(self.tp)]
        params: dict = {k: p.to(devs[0]) for k, p in self.model.named_parameters()}
        for k, parts in self.shards.items():
            params[k] = [s.to(d) for s, d in zip(parts, devs)]
        return devs, params

    def _table(self, dev: torch.device) -> torch.Tensor:
        """The hybrid's hash table (a buffer, not a parameter) on ``dev``."""
        table = self.model.table
        return table if table.device == dev else self._tables.setdefault(dev, table.to(dev))

    def _forward(self, r: int, ids, mask) -> torch.Tensor:
        devs, params = self._row(r)
        ids0, mask0 = to_device(ids, devs[0]).long(), to_device(mask, devs[0])
        enc = self.model.encoder
        x = self._embeddings(enc.embeddings, params, devs, ids0)
        for i, layer in enumerate(enc._stack):
            x = self._layer(layer, f"encoder.layer_{i}.", params, devs, x, mask0)
        if isinstance(self.model, BertDenseEmbedder):
            return l2_normalize(pool_hidden(x, mask0, self.model.pooling))
        h = hash_pool(self._table(devs[0]), ids0, mask0)                     # wide leg
        b = l2_normalize(pool_hidden(x, mask0, self.model.cfg.pooling))
        scales = params["scales"]
        return l2_normalize(torch.cat([scales[0] * h, scales[1] * b.float()], dim=-1))

    @staticmethod
    def _sub(module: nn.Module, params: dict, prefix: str, *args) -> torch.Tensor:
        """A replicated submodule's own forward on the row's parameters."""
        own = {n: params[prefix + n] for n, _ in module.named_parameters()}
        return functional_call(module, own, args)

    def _embeddings(self, emb: nn.Module, params: dict, devs, ids: torch.Tensor) -> torch.Tensor:
        pre = "encoder.embeddings."
        dt, L = emb.word.dtype, ids.shape[-1]
        tables = [params[pre + n + ".weight"] for n in ("word", "position", "token_type")]

        def lookup(ids, word, pos, types):
            # BertEmbeddings' sums, in its order, on whole tables or column shards
            positions = torch.arange(L, device=ids.device)[None, :]
            x = F.embedding(ids, word.to(dt)) + F.embedding(positions, pos.to(dt))
            return x + F.embedding(torch.zeros_like(ids), types.to(dt))

        if isinstance(tables[0], list):          # the three tables split on H together
            x = _gather([lookup(ids.to(d), *(tab[t] for tab in tables))
                         for t, d in enumerate(devs)], devs[0])
        else:
            x = lookup(ids, *tables)
        return self._sub(emb.ln, params, pre + "ln.", x)

    def _layer(self, layer: nn.Module, pre: str, params: dict, devs, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """``models/bert.py::BertLayer.forward`` with the MLP over tp."""
        B, L, _ = x.shape
        shape = (B, L, layer.heads, layer.head_dim)

        def sub(name, *args):
            return self._sub(getattr(layer, name), params, f"{pre}{name}.", *args)

        bias = pad_bias(mask)
        ctx = attention(sub("q", x).view(shape), sub("k", x).view(shape), sub("v", x).view(shape),
                        lambda lo, hi: bias[lo:hi], layer.head_dim ** -0.5)
        x = sub("ln1", x + sub("out", ctx.reshape(B, L, -1)))
        return sub("ln2", x + self._mlp(layer, pre, params, devs, x))

    def _mlp(self, layer: nn.Module, pre: str, params: dict, devs, x: torch.Tensor) -> torch.Tensor:
        """``ff2(gelu(ff1(x)))`` as the placement splits it."""
        d0, dt = devs[0], layer.ff1.dtype
        w1, b1 = params[pre + "ff1.weight"], params[pre + "ff1.bias"]
        w2, b2 = params[pre + "ff2.weight"], params[pre + "ff2.bias"]
        if isinstance(w1, list):                 # column-parallel: a slice of I on each (r, t)
            n = w1[0].shape[0]
            h = [F.gelu(_linear(x.to(d), w, b1[t * n:(t + 1) * n].to(d), dt))
                 for t, (w, d) in enumerate(zip(w1, devs))]
        else:
            h = F.gelu(_linear(x, w1, b1, dt))
        dim2 = self.split.get(pre + "ff2.weight")
        if dim2 == 1:
            # row-parallel over I (split only where ff1 is, so h is in
            # slices): the partial products summed on (r, 0), the bias once
            parts = [_linear(h_t, w, None, dt).to(d0) for h_t, w in zip(h, w2)]
            return torch.stack(parts).sum(0) + b2.to(dt)
        if isinstance(h, list):
            h = _gather(h, d0)
        if dim2 == 0:                            # H % tp == 0 but I % tp != 0: split on H
            n = w2[0].shape[0]
            return _gather([_linear(h.to(d), w, b2[t * n:(t + 1) * n].to(d), dt)
                            for t, (w, d) in enumerate(zip(w2, devs))], d0)
        return _linear(h, w2, b2, dt)
