"""Device mesh + sharded dense retrieval.

Port of ``cqs_tpu/parallel/mesh.py``. The reference shards over a JAX
``Mesh`` inside one serving process (a single controller): each row block
lives on its device and XLA gathers the per-shard candidates. The port keeps
the single controller: a :class:`Mesh` is an ordered tuple of
``torch.device``\\ s driven by one process, each shard's tensors live on its
device, each shard takes its own exact top-k there, and only the [B, k]
candidate lists are copied to the mesh's first device for the merge. No
``torch.distributed`` group is needed.

A mesh may repeat a device only when a caller builds it explicitly
(``Mesh([cuda0] * 4)``: logical shards on one card, each with its own
tensors and kernel launches). :func:`make_mesh` never repeats a CUDA device;
on the CPU, whose one ``torch.device`` stands for the whole host, it gives
``n`` logical shards, the counterpart of the reference's forced n-device host
platform.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from cqs_tpu_torch.ops.fusion import NEG, stable_topk
from cqs_tpu_torch.ops.topk import shard_scan_rows, shard_topk


class Mesh:
    """Devices laid out on named axes (row-major over ``shape``)."""

    def __init__(self, devices: Sequence[str | torch.device],
                 axis_names: Sequence[str] = ("data",),
                 shape: Sequence[int] | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        dims = tuple(shape) if shape is not None else (len(self.devices),)
        if len(dims) != len(self.axis_names) or int(np.prod(dims)) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices do not fill a mesh of shape "
                             f"{dims} over axes {self.axis_names}")
        cards = local_device_count("cuda") if any(
            d.type == "cuda" for d in self.devices) else 0
        missing = [str(d) for d in self.devices if d.type == "cuda" and (d.index or 0) >= cards]
        if missing:
            raise ValueError(f"a mesh over {missing[0]} needs that card; {cards} are visible")
        #: axis name -> size, read as ``mesh.shape.get("dp", 1)``
        self.shape = dict(zip(self.axis_names, dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def device_at(self, *coords: int) -> torch.device:
        """The device at ``coords`` on the axes, row-major (the reference's
        ``devices.reshape(shape)``): on a (dp, tp) mesh, (r, t) is
        ``devices[r * tp + t]``."""
        flat = 0
        for c, n in zip(coords, self.shape.values(), strict=True):
            if not 0 <= c < n:
                raise IndexError(f"{coords} is off a mesh of shape {tuple(self.shape.values())}")
            flat = flat * n + c
        return self.devices[flat]


def local_device_count(device_type: str) -> int:
    """Local devices of a type: the CUDA cards, or the CPU's one device."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type == "cpu":
        return 1
    raise ValueError(f"unsupported device type {device_type!r}: use 'cuda' or 'cpu'")


def _devices(n: int | None, device: str | torch.device) -> list[torch.device]:
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n or 1)
    have = local_device_count(kind)
    n = n or have
    if n < 1 or n > have:
        raise ValueError(f"a mesh of {n} {kind} devices needs {n} cards; "
                         f"{have} are visible")
    return [torch.device(kind, i) for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = "data", *,
              device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh: the first ``n_devices`` CUDA cards (all of them when
    None; more than exist raises), or ``n_devices`` logical CPU shards."""
    return Mesh(_devices(n_devices, device), (axis,))


def make_2d_mesh(n_devices: int | None = None, dp: int | None = None,
                 axes: tuple[str, str] = ("dp", "tp"), *,
                 device: str | torch.device = "cuda") -> Mesh:
    """Factor n into a (dp, tp) grid as the reference does: tp the largest
    of 8, 4, 2, 1 dividing n unless ``dp`` is given."""
    devs = _devices(n_devices, device)
    n = len(devs)
    if dp is None:
        tp = next(c for c in (8, 4, 2, 1) if n % c == 0)
        dp = n // tp
    else:
        tp = n // dp
    return Mesh(devs, axes, (dp, tp))


def place_rows(t: torch.Tensor, devices: Sequence[torch.device],
               dtype: torch.dtype | None = None, scan: bool = True) -> tuple[torch.Tensor, ...]:
    """Cut ``t`` [rows, ...] into ``len(devices)`` equal row blocks, one on
    each device (in ``dtype``); a scan tensor's block is padded with zero
    rows to :func:`shard_scan_rows`, whole scan tiles (a multiple of 2,048
    rows, or a power of two below that; the mask pads with 0, so those rows
    never leave their shard as real rows). A block already on its device in
    its dtype is a view."""
    n_s = t.shape[0] // len(devices)
    out = []
    for i, dev in enumerate(devices):
        b = t[i * n_s:(i + 1) * n_s].to(device=dev, dtype=dtype)
        pad = shard_scan_rows(n_s) - n_s if scan else 0
        out.append(torch.cat([b, b.new_zeros((pad, *b.shape[1:]))]) if pad else b)
    return tuple(out)


def merge_shard_topk(parts, k: int, first: torch.device):
    """Global top-``k`` of per-shard candidates: ``parts`` is, in shard
    order, (vals [B, k_s], global rows [B, k_s]) with NEG slots' rows at -1.
    The lists are copied to ``first`` and merged by value descending, ties to
    the lower global row (each list is in that order and the shards hold
    ascending row ranges, so a stable sort of the concatenation gives it)."""
    vals = torch.cat([v.to(first) for v, _ in parts], dim=1)
    rows = torch.cat([r.to(first) for _, r in parts], dim=1)
    top_v, pos = stable_topk(vals, k)
    return top_v, rows.gather(1, pos)


def shard_candidates(scan: torch.Tensor, q: torch.Tensor, k: int, mask: torch.Tensor,
                     lo: int):
    """One shard's exact top-``k`` with global rows; slots past its valid
    rows (NEG) get row -1, whatever the scan left there."""
    v, r = shard_topk(scan, q, k, mask)
    return v, torch.where(v > NEG / 2, r + lo, torch.full_like(r, -1))


class ShardedDenseIndex:
    """Row-sharded dense index over a 1-D mesh: each device's rows are
    normalised on the host, padded to ``n_shards * 8`` and held in bf16;
    ``search`` takes each shard's exact top-k on its device and merges the
    candidate lists into the exact global top-k in ``lax.top_k``'s order.
    Slots past the valid rows hold NEG and row 0."""

    def __init__(self, ids: list[str], matrix: np.ndarray, mesh: Mesh,
                 dtype: torch.dtype = torch.bfloat16):
        self.mesh = mesh
        self.ids = list(ids)
        n_shards = mesh.size
        n, d = matrix.shape
        pad = (-n) % (n_shards * 8)
        full = np.zeros((n + pad, d), dtype=np.float32)
        norms = np.linalg.norm(matrix, axis=1, keepdims=True)
        full[:n] = matrix / np.maximum(norms, 1e-12)
        mask = np.zeros((n + pad,), dtype=np.int32)
        mask[:n] = 1
        #: rows per shard, and the padded row count (the reference's layout)
        self.rows_per_shard = (n + pad) // n_shards
        self.padded = n + pad
        self.matrix = place_rows(torch.from_numpy(full), mesh.devices, dtype)
        self.mask = place_rows(torch.from_numpy(mask), mesh.devices)

    @property
    def count(self) -> int:
        return len(self.ids)

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        k_eff = min(k, self.padded)
        k_s = min(k_eff, self.rows_per_shard)
        q_t = torch.from_numpy(q)
        parts = [shard_candidates(m, q_t.to(m.device), k_s, mask, i * self.rows_per_shard)
                 for i, (m, mask) in enumerate(zip(self.matrix, self.mask))]
        vals, rows = merge_shard_topk(parts, k_eff, self.mesh.devices[0])
        return vals.cpu().numpy(), rows.clamp(min=0).cpu().numpy()
