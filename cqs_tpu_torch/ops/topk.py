"""Fused exact scan + top-k: CUDA kernel wrappers and their plain twins.

Port of ``cqs_tpu/ops/topk.py``. Two layers:

- Plain PyTorch versions: :func:`topk_plain` (twin of ``topk_xla``) and the
  per-tile semantics of the two Pallas kernel bodies,
  :func:`scan_topk_plain_loop` and :func:`scan_topk_plain_grouped`, on
  ``[num_tiles, B, m]`` outputs, plus the stage-2 merge :func:`merge_tiles`.
- :func:`scan_topk`, the twin of ``topk_pallas``: on a CUDA tensor it
  launches the hand-written kernel (``csrc/scan_topk.cu``, through
  :data:`LOOP` / :data:`GROUPED`); on a CPU tensor it runs the plain version.

Stage 2 is the exact stable top-k, which is what the reference computes off
the TPU and in interpret mode (the TPU-only ``approx_max_k`` is not ported).
"""

from __future__ import annotations

import torch

from cqs_tpu_torch.ops.fusion import NEG, stable_topk

#: Widest row the kernels take (the query block sits in shared memory).
MAX_DIM = 4096
#: Group lanes of the grouped extraction.
GROUP_LANES = 128
#: Dynamic shared memory one CTA may use on Hopper, less the static part.
_SMEM_LIMIT = 227 * 1024 - 1024


def _scores(index: torch.Tensor, queries: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    """[B, N] f32 scores (products of the stored values, summed in f32),
    masked rows at NEG."""
    s = queries.to(index.dtype).float() @ index.float().T
    if mask is not None:
        s = torch.where(mask[None, :] > 0, s, torch.full_like(s, NEG))
    return s


def _tile_scores(index, queries, mask, tile_n: int) -> torch.Tensor:
    s = _scores(index, queries, mask)
    return s.view(s.shape[0], index.shape[0] // tile_n, tile_n)


def topk_plain(index: torch.Tensor, queries: torch.Tensor, k: int,
               mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact scan, the twin of ``topk_xla``: index [N, D], queries [B, D] ->
    (scores [B, k] f32, rows [B, k] int32), descending, ties to the lower row."""
    vals, idx = stable_topk(_scores(index, queries, mask), k)
    return vals, idx.to(torch.int32)


def _tile_major(vals: torch.Tensor, rows: torch.Tensor):
    return (vals.permute(1, 0, 2).contiguous(),
            rows.to(torch.int32).permute(1, 0, 2).contiguous())


def scan_topk_plain_loop(index: torch.Tensor, queries: torch.Tensor,
                         mask: torch.Tensor | None, tile_n: int, m: int):
    """Per-tile exact top-m (``_scan_kernel``): descending, ties to the
    lower column; once a tile has no valid row left, the remaining slots
    hold NEG and the tile's first row, as the reference's m rounds of
    max -> lowest argmax -> retire leave them. Returns tile-major
    (vals [tiles, B, m] f32, rows [tiles, B, m] int32 global rows)."""
    s = _tile_scores(index, queries, mask, tile_n)
    v, col = stable_topk(s, m)
    exhausted = v <= NEG / 2
    col = torch.where(exhausted, torch.zeros_like(col), col)
    base = torch.arange(s.shape[1], device=s.device)[None, :, None] * tile_n
    return _tile_major(v, col + base)


def scan_topk_plain_grouped(index: torch.Tensor, queries: torch.Tensor,
                            mask: torch.Tensor | None, tile_n: int, m: int):
    """Per-tile top-m groups (``_scan_kernel_grouped``): group g holds the
    columns g, 128+g, ...; its maximum keeps the lowest offset on ties; the
    m best groups (ties to the lowest lane) give one row each. Exhausted
    slots hold NEG and lane 0's winning row. Tile-major outputs as
    :func:`scan_topk_plain_loop`."""
    s = _tile_scores(index, queries, mask, tile_n)
    b, t, _ = s.shape
    gs = tile_n // GROUP_LANES
    grid = s.view(b, t, gs, GROUP_LANES)
    gmax = grid.amax(dim=2)                                       # [B, T, 128]
    offs = torch.arange(gs, device=s.device).view(1, 1, gs, 1)
    s_sel = torch.where(grid == gmax[:, :, None, :], offs,
                        torch.full_like(offs, gs)).amin(dim=2)    # lowest offset
    v, lane = stable_topk(gmax, m)
    exhausted = v <= NEG / 2
    lane = torch.where(exhausted, torch.zeros_like(lane), lane)
    col = s_sel.gather(2, lane) * GROUP_LANES + lane
    base = torch.arange(t, device=s.device)[None, :, None] * tile_n
    return _tile_major(v, col + base)


def merge_tiles(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """Stage 2: tile-major [tiles, B, m] candidates -> exact top-k [B, k]
    (``topk.py:168-180`` without the TPU's approx_max_k); padded with NEG
    and row 0 when the tiles hold fewer than k slots."""
    t, b, m = vals.shape
    flat_v = vals.permute(1, 0, 2).reshape(b, t * m)
    flat_r = rows.permute(1, 0, 2).reshape(b, t * m)
    kk = min(k, t * m)
    top_v, pos = stable_topk(flat_v, kk)
    top_r = flat_r.gather(1, pos)
    if kk < k:
        top_v = torch.cat([top_v, top_v.new_full((b, k - kk), NEG)], dim=1)
        top_r = torch.cat([top_r, top_r.new_zeros((b, k - kk))], dim=1)
    return top_v, top_r


def check_geometry(n: int, tile_n: int, m: int, grouped: bool) -> None:
    """Raise on a tiling or per-tile k that neither the kernels nor their
    plain twins define."""
    if tile_n % 32 or n % tile_n or n // tile_n < 1:
        raise ValueError(f"{n} rows do not split into tiles of {tile_n} "
                         f"(tile must be a multiple of 32)")
    if not 1 <= m <= tile_n:
        raise ValueError(f"per-tile k {m} outside [1, {tile_n}]")
    if grouped and (tile_n % GROUP_LANES or m > GROUP_LANES):
        raise ValueError(f"grouped extraction needs tile % 128 == 0 and m <= 128 "
                         f"(tile {tile_n}, m {m})")


def check_kernel_args(index: torch.Tensor, queries: torch.Tensor,
                      mask: torch.Tensor, tile_n: int, m: int,
                      grouped: bool) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if index.dtype != torch.bfloat16 or queries.dtype != torch.bfloat16:
        raise TypeError(f"scan kernels take bf16 rows and queries, got "
                        f"{index.dtype} and {queries.dtype}")
    if mask.dtype != torch.int32:
        raise TypeError(f"mask must be int32, got {mask.dtype}")
    if index.dim() != 2 or queries.dim() != 2 or mask.dim() != 1:
        raise ValueError("index [N, D], queries [B, D] and mask [N] expected")
    n, d = index.shape
    if queries.shape[1] != d or mask.shape[0] != n or queries.shape[0] < 1:
        raise ValueError(f"shape mismatch: index {tuple(index.shape)}, queries "
                         f"{tuple(queries.shape)}, mask {tuple(mask.shape)}")
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"row width {d} must be a multiple of 8 and <= {MAX_DIM}")
    check_geometry(n, tile_n, m, grouped)
    if not (index.is_contiguous() and queries.is_contiguous() and mask.is_contiguous()):
        raise ValueError("scan kernels take contiguous tensors")
    if index.data_ptr() % 16:
        raise ValueError("index rows must be 16-byte aligned")
    if not (index.device == queries.device == mask.device):
        raise ValueError("index, queries and mask must share one device")


class ScanKernel:
    """One hand-written CUDA scan kernel. ``launches`` counts the times this
    wrapper launched it (and nothing else)."""

    def __init__(self, name: str, symbol: str, grouped: bool, replaces: str):
        self.name = name
        self.symbol = symbol
        self.grouped = grouped
        self.replaces = replaces
        self.source = "cqs_tpu_torch/csrc/scan_topk.cu"
        self.launches = 0

    def __call__(self, index: torch.Tensor, queries: torch.Tensor,
                 mask: torch.Tensor, tile_n: int, m: int):
        from cqs_tpu_torch.ops import _kernels

        if not index.is_cuda:
            raise ValueError(f"{self.name} launches on CUDA tensors only")
        check_kernel_args(index, queries, mask, tile_n, m, self.grouped)
        lib = _kernels.load()
        n, d = index.shape
        b = queries.shape[0]
        qb = 8
        while qb > 1 and (qb >= 2 * b or lib.cqs_scan_smem_bytes(qb, d, tile_n) > _SMEM_LIMIT):
            qb //= 2
        if lib.cqs_scan_smem_bytes(qb, d, tile_n) > _SMEM_LIMIT:
            raise ValueError(f"tile {tile_n} x width {d} exceeds shared memory")
        vals = torch.empty((n // tile_n, b, m), dtype=torch.float32, device=index.device)
        rows = torch.empty((n // tile_n, b, m), dtype=torch.int32, device=index.device)
        with torch.cuda.device(index.device):    # launch in the tensors' context
            stream = torch.cuda.current_stream(index.device).cuda_stream
            err = getattr(lib, self.symbol)(
                queries.data_ptr(), index.data_ptr(), mask.data_ptr(), vals.data_ptr(),
                rows.data_ptr(), b, n, d, tile_n, m, qb, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err}")
        self.launches += 1
        return vals, rows


LOOP = ScanKernel("scan_topk_loop", "cqs_scan_topk_loop_bf16", grouped=False,
                  replaces="cqs_tpu/ops/topk.py:58")
GROUPED = ScanKernel("scan_topk_grouped", "cqs_scan_topk_grouped_bf16", grouped=True,
                     replaces="cqs_tpu/ops/topk.py:183")
KERNELS = (LOOP, GROUPED)


def scan_topk(index: torch.Tensor, queries: torch.Tensor, k: int,
              mask: torch.Tensor | None = None, tile_n: int = 2048,
              per_tile_k: int | None = None, extraction: str = "loop"):
    """Two-stage fused scan, the twin of ``topk_pallas``. ``index`` rows are
    padded to a multiple of ``tile_n``; ``mask`` marks valid rows.
    ``per_tile_k`` < k makes it candidate generation; ``extraction`` picks
    the in-tile reduction ("loop": exact per-tile top-m, "grouped": top-m
    groups of tile_n/128 rows). Queries are cast to the index dtype.
    Returns (vals [B, k] f32, rows [B, k] int32)."""
    if extraction not in ("loop", "grouped"):
        raise ValueError(f"unknown extraction {extraction!r}")
    n = index.shape[0]
    m = per_tile_k or k
    grouped = extraction == "grouped"
    check_geometry(n, tile_n, m, grouped)
    if mask is None:
        mask = torch.ones(n, dtype=torch.int32, device=index.device)
    queries = queries.to(index.dtype)
    if index.is_cuda:
        vals, rows = (GROUPED if grouped else LOOP)(index, queries.contiguous(),
                                                    mask.to(torch.int32).contiguous(),
                                                    tile_n, m)
    elif grouped:
        vals, rows = scan_topk_plain_grouped(index, queries, mask, tile_n, m)
    else:
        vals, rows = scan_topk_plain_loop(index, queries, mask, tile_n, m)
    return merge_tiles(vals, rows, k)
