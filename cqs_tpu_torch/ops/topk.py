"""Fused exact scan + top-k: CUDA kernel wrappers and their plain twins.

Port of ``cqs_tpu/ops/topk.py``. Two layers:

- Plain PyTorch versions: :func:`topk_plain` (twin of ``topk_xla``) and the
  per-tile semantics of the two Pallas kernel bodies,
  :func:`scan_topk_plain_loop` and :func:`scan_topk_plain_grouped`, on
  ``[num_tiles, B, m]`` outputs, plus the stage-2 merge :func:`merge_tiles`.
- :func:`scan_topk`, the twin of ``topk_pallas``: on a CUDA tensor it
  launches the hand-written kernel of the extraction and of the (rows,
  query) dtype pair, as the reference's kernel bodies branch on them: bf16
  x bf16 (:data:`LOOP` / :data:`GROUPED`), int8 x int8 (:data:`LOOP_I8` /
  :data:`GROUPED_I8`) and int8 rows widened against a bf16 query
  (:data:`LOOP_I8W` / :data:`GROUPED_I8W`). :data:`GROUPED` and
  :data:`GROUPED_I8W` are the tensor-core kernel of ``csrc/scan_topk_mma.cu``;
  the other four the CUDA-core template of ``csrc/scan_topk.cu``. On a CPU
  tensor it runs the plain version.

Stage 2 is the exact stable top-k, which is what the reference computes off
the TPU and in interpret mode (the TPU-only ``approx_max_k`` is not ported).
"""

from __future__ import annotations

import torch

from cqs_tpu_torch.ops.fusion import NEG, stable_topk

#: Widest row the kernels take (the CUDA-core kernels hold the query block
#: in shared memory).
MAX_DIM = 4096
#: Group lanes of the grouped extraction.
GROUP_LANES = 128
#: Dynamic shared memory one CTA may use on Hopper, less the static part.
_SMEM_LIMIT = 227 * 1024 - 1024
#: Query blocks the tensor-core grouped kernel is built for.
MMA_QUERY_BLOCKS = (8, 16, 32, 64)
#: Tallest tile it takes: a group's winning sub-tile is kept in a byte.
MMA_MAX_TILE = 256 * GROUP_LANES


#: rows of the int8 twin's float64 product taken at a time (bounds the
#: widened copy at 1 GB for 1024-wide rows)
_I8_CHUNK = 131072


def scan_query(index: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """The query as the scan takes it against ``index`` (the dtype rule of
    ``topk_pallas``): an int8 query against int8 rows stays int8; a float
    query against int8 rows becomes bf16, the widening kernel's query type,
    and is never cast to int8 (that would zero a unit-norm query); against
    float rows the query takes the rows' dtype, as ``topk_xla`` and every
    program call site do."""
    if index.dtype == torch.int8:
        if queries.dtype == torch.int8:
            return queries
        if queries.is_floating_point():
            return queries.to(torch.bfloat16)
        raise TypeError(f"{queries.dtype} query against int8 rows")
    return queries.to(index.dtype)


def _scores(index: torch.Tensor, queries: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    """[B, N] f32 scores, masked rows at NEG. int8 x int8: the exact integer
    dot cast to f32 (``topk.py:73-75``). Torch has no integer matmul on
    CUDA and an f32 product of int8 values is exact only while |sum| < 2^24,
    so the twin multiplies in float64 on every device (|sum| <= 127^2 * D
    < 2^53, exact) and then casts. Otherwise: products of the stored values
    (int8 rows widen exactly), summed in f32."""
    queries = scan_query(index, queries)
    if index.dtype == torch.int8 and queries.dtype == torch.int8:
        q64 = queries.double()
        s = torch.cat([(q64 @ index[i:i + _I8_CHUNK].double().T).float()
                       for i in range(0, index.shape[0], _I8_CHUNK)], dim=1)
    else:
        s = queries.float() @ index.float().T
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


#: (rows dtype, query dtype) -> row kind of the kernels
ROW_KINDS = {(torch.bfloat16, torch.bfloat16): "bf16", (torch.int8, torch.int8): "i8",
             (torch.int8, torch.bfloat16): "i8w"}
#: row kind -> the ``kind`` argument of ``cqs_scan_smem_bytes``
_KIND_ABI = {"bf16": 0, "i8": 1, "i8w": 2}


def check_kernel_args(index: torch.Tensor, queries: torch.Tensor,
                      mask: torch.Tensor, tile_n: int, m: int,
                      grouped: bool) -> str:
    """Raise on anything the CUDA kernels do not take; return the row kind
    of the (rows, query) dtype pair."""
    kind = ROW_KINDS.get((index.dtype, queries.dtype))
    if kind is None:
        raise TypeError(f"no scan kernel for {index.dtype} rows and a {queries.dtype} "
                        f"query (bf16 x bf16, int8 x int8, int8 x bf16)")
    if mask.dtype != torch.int32:
        raise TypeError(f"mask must be int32, got {mask.dtype}")
    if index.dim() != 2 or queries.dim() != 2 or mask.dim() != 1:
        raise ValueError("index [N, D], queries [B, D] and mask [N] expected")
    n, d = index.shape
    if queries.shape[1] != d or mask.shape[0] != n or queries.shape[0] < 1:
        raise ValueError(f"shape mismatch: index {tuple(index.shape)}, queries "
                         f"{tuple(queries.shape)}, mask {tuple(mask.shape)}")
    vec = 16 // index.element_size()          # values per 16-byte load
    if d % vec or d > MAX_DIM:
        raise ValueError(f"row width {d} must be a multiple of {vec} and <= {MAX_DIM}")
    check_geometry(n, tile_n, m, grouped)
    if not (index.is_contiguous() and queries.is_contiguous() and mask.is_contiguous()):
        raise ValueError("scan kernels take contiguous tensors")
    if index.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("index rows and queries must be 16-byte aligned")
    if not (index.device == queries.device == mask.device):
        raise ValueError("index, queries and mask must share one device")
    return kind


def mma_query_block(b: int) -> int:
    """Query block of the tensor-core grouped kernel for a batch of ``b``:
    the narrowest built block that holds the batch, else the widest, so a
    row tile is read by ceil(b / 64) CTAs (two at B=128). Its shared memory
    does not depend on the row width: rows and queries both stream along
    it."""
    return next((qb for qb in MMA_QUERY_BLOCKS if qb >= b), MMA_QUERY_BLOCKS[-1])


class ScanKernel:
    """One hand-written CUDA scan kernel on CUDA cores (``csrc/scan_topk.cu``):
    one extraction over one row kind. ``launches`` counts the times this
    wrapper launched it (and nothing else)."""

    source = "cqs_tpu_torch/csrc/scan_topk.cu"

    def __init__(self, name: str, kind: str, grouped: bool, replaces: str):
        self.name = name
        self.kind = kind
        self.symbol = f"cqs_scan_topk_{'grouped' if grouped else 'loop'}_{kind}"
        self.grouped = grouped
        self.replaces = replaces
        self.launches = 0

    def query_block(self, lib, b: int, d: int, tile_n: int) -> int:
        """Queries per CTA: at most 8, halved while the [qb, tile_n] score
        block and the query block overflow shared memory."""
        def smem(qb):
            return lib.cqs_scan_smem_bytes(_KIND_ABI[self.kind], qb, d, tile_n)

        qb = 8
        while qb > 1 and (qb >= 2 * b or smem(qb) > _SMEM_LIMIT):
            qb //= 2
        if smem(qb) > _SMEM_LIMIT:
            raise ValueError(f"tile {tile_n} x width {d} exceeds shared memory")
        return qb

    def __call__(self, index: torch.Tensor, queries: torch.Tensor,
                 mask: torch.Tensor, tile_n: int, m: int):
        from cqs_tpu_torch.ops import _kernels

        if not index.is_cuda:
            raise ValueError(f"{self.name} launches on CUDA tensors only")
        kind = check_kernel_args(index, queries, mask, tile_n, m, self.grouped)
        if kind != self.kind:
            raise TypeError(f"{self.name} takes {self.kind} rows, got {kind}")
        lib = _kernels.load()
        n, d = index.shape
        b = queries.shape[0]
        qb = self.query_block(lib, b, d, tile_n)
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


class MmaScanKernel(ScanKernel):
    """The grouped extraction on tensor cores (``csrc/scan_topk_mma.cu``):
    bf16 rows, or int8 rows widened to bf16, against a bf16 query block of
    :func:`mma_query_block`; rows and queries stream through shared memory,
    so no score block exists."""

    source = "cqs_tpu_torch/csrc/scan_topk_mma.cu"

    def query_block(self, lib, b: int, d: int, tile_n: int) -> int:
        if tile_n > MMA_MAX_TILE:
            raise ValueError(f"tile {tile_n} taller than {MMA_MAX_TILE} rows")
        return mma_query_block(b)


LOOP = ScanKernel("scan_topk_loop", "bf16", grouped=False,
                  replaces="cqs_tpu/ops/topk.py:58")
GROUPED = MmaScanKernel("scan_topk_grouped", "bf16", grouped=True,
                        replaces="cqs_tpu/ops/topk.py:183")
LOOP_I8 = ScanKernel("scan_topk_loop_i8", "i8", grouped=False,
                     replaces="cqs_tpu/ops/topk.py:69")
GROUPED_I8 = ScanKernel("scan_topk_grouped_i8", "i8", grouped=True,
                        replaces="cqs_tpu/ops/topk.py:206")
LOOP_I8W = ScanKernel("scan_topk_loop_i8w", "i8w", grouped=False,
                      replaces="cqs_tpu/ops/topk.py:76")
GROUPED_I8W = MmaScanKernel("scan_topk_grouped_i8w", "i8w", grouped=True,
                            replaces="cqs_tpu/ops/topk.py:210")
KERNELS = (LOOP, GROUPED, LOOP_I8, GROUPED_I8, LOOP_I8W, GROUPED_I8W)
_BY_KIND = {(k.kind, k.grouped): k for k in KERNELS}


def scan_topk(index: torch.Tensor, queries: torch.Tensor, k: int,
              mask: torch.Tensor | None = None, tile_n: int = 2048,
              per_tile_k: int | None = None, extraction: str = "loop"):
    """Two-stage fused scan, the twin of ``topk_pallas``. ``index`` rows are
    padded to a multiple of ``tile_n``; ``mask`` marks valid rows.
    ``per_tile_k`` < k makes it candidate generation; ``extraction`` picks
    the in-tile reduction ("loop": exact per-tile top-m, "grouped": top-m
    groups of tile_n/128 rows). The query dtype follows :func:`scan_query`;
    on CUDA a (rows, query) pair with no kernel raises.
    Returns (vals [B, k] f32, rows [B, k] int32)."""
    if extraction not in ("loop", "grouped"):
        raise ValueError(f"unknown extraction {extraction!r}")
    n = index.shape[0]
    m = per_tile_k or k
    grouped = extraction == "grouped"
    check_geometry(n, tile_n, m, grouped)
    if mask is None:
        mask = torch.ones(n, dtype=torch.int32, device=index.device)
    queries = scan_query(index, queries)
    if index.is_cuda:
        kernel = _BY_KIND.get((ROW_KINDS.get((index.dtype, queries.dtype)), grouped))
        if kernel is None:
            raise TypeError(f"no scan kernel for {index.dtype} rows and a "
                            f"{queries.dtype} query")
        vals, rows = kernel(index, queries.contiguous(), mask.to(torch.int32).contiguous(),
                            tile_n, m)
    elif grouped:
        vals, rows = scan_topk_plain_grouped(index, queries, mask, tile_n, m)
    else:
        vals, rows = scan_topk_plain_loop(index, queries, mask, tile_n, m)
    return merge_tiles(vals, rows, k)
