"""Graph ANN: a fixed-degree kNN graph, built and searched on the device.

Port of ``cqs_tpu/index/graph.py`` (a CAGRA-style graph: fixed out-degree,
itopk beam search, the reference's ``.npz`` format and checksum, so either
package loads the other's graph).

- The exact build (:func:`build_knn_graph`, to ``GraphIndex.EXACT_BUILD_MAX``
  rows) is an exact top-(degree + 1) scan of each block of 1,024 rows
  against the whole matrix, through ``ops/topk.py::scan_topk`` with the
  "loop" extraction: on a CUDA tensor that launches the hand-written split
  scan kernel (``LOOP_SPLIT``, the Hopper kernel of the reference's
  ``_scan_kernel``), on a CPU tensor its plain twin. The reference calls
  ``lax.top_k`` off the TPU, so the build is exact and ties go to the lower
  row. Self-matches go to the end, then the reverse-edge pass
  (:func:`add_reverse_edges`, numpy on the host) runs.
- :func:`nn_descent_graph` (the 1M-row regime) draws the same numbers from
  numpy's ``default_rng(seed)`` in the same order as the reference, and
  refines each block on the device: gathers, products of the bf16 rows with
  f32 sums, self and first-copy masking, a stable top-degree.
- The beam search (:func:`graph_search`) is the reference's fixed-iteration
  program over ``[B, ...]`` tensors: static shapes, no early exit, the pool
  carries an ``expanded`` flag, duplicates of the pool and earlier copies
  within the candidates score NEG, and ``fusion.stable_topk`` stands in for
  ``lax.top_k`` everywhere.

Two choices keep a batched search equal to a solo one bit for bit: every dot
product is summed by :func:`rowdot` (elementwise halvings, the same order
whatever the batch, where a library reduction or GEMM may pick its order by
shape), and duplicates are found by sorting (the same answer as the
reference's ``[C, C]`` and ``[C, beam]`` equality masks, without their
memory: at beam 1024, expand 64, degree 32 the within-candidate mask alone
is 4 MB a query per iteration). Batches are cut to :data:`SEARCH_BUDGET_BYTES`
of per-iteration temporaries.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from cqs_tpu_torch.config import limits as default_limits
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.index.stamp import Stamp, StampMismatch, checksum
from cqs_tpu_torch.ops.fusion import NEG, stable_topk
from cqs_tpu_torch.ops.topk import scan_topk
from cqs_tpu_torch.utils.trace import get_tracer

log = get_tracer("graph")

#: rows of one exact-build block (the reference's ``batch``)
KNN_BLOCK = 1024
#: bytes of per-iteration temporaries one search chunk may hold: the
#: gathered bf16 candidate rows and their f32 products, about
#: ``expand * degree * D * 8`` bytes a query
SEARCH_BUDGET_BYTES = 1 << 30


def default_itopk(n: int) -> int:
    """CAGRA's itopk scaling: log2(n) * 32 clamped to [128, 4096]
    (ref: README.md:817 — 1k->320, 100k->532, 1M->640)."""
    if n <= 1:
        return 128
    return int(min(max(math.log2(n) * 32, 128), 4096))


def add_reverse_edges(neighbors: np.ndarray, half: int | None = None) -> np.ndarray:
    """Reverse-edge diversification (the CAGRA optimize analog): nodes pointed
    at by many forward edges get reciprocal links written into their tail
    slots. Fully vectorized numpy — the r1 dict loop was O(N*degree) python
    at 1M rows (VERDICT weak #5)."""
    n, degree = neighbors.shape
    half = degree // 4 if half is None else half
    rslots = degree - half
    if half <= 0 or rslots <= 0 or n == 0:
        return neighbors
    src = np.repeat(np.arange(n, dtype=np.int64), half)
    dst = neighbors[:, :half].ravel().astype(np.int64)
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    starts = np.searchsorted(dst_s, np.arange(n))
    # position of each edge within its destination's segment
    seg_pos = np.arange(len(dst_s)) - starts[dst_s]
    sel = seg_pos < rslots
    inc = np.full((n, rslots), -1, np.int64)
    inc[dst_s[sel], seg_pos[sel]] = src_s[sel]

    out = neighbors.copy()
    CH = 131072
    for s in range(0, n, CH):
        e = min(n, s + CH)
        inc_c = inc[s:e]                                      # [c, r]
        present = (inc_c[:, :, None] == out[s:e][:, None, :]).any(axis=2)
        ok = (inc_c >= 0) & ~present & (inc_c != np.arange(s, e)[:, None])
        # compact the usable incoming to the front, then write them into the
        # tail slots from the END first (matching the r1 slot order)
        ordp = np.argsort(~ok, axis=1, kind="stable")
        fill = np.take_along_axis(inc_c, ordp, axis=1)
        use = np.take_along_axis(ok, ordp, axis=1)
        tail = out[s:e, half:]
        out[s:e, half:] = np.where(use[:, ::-1], fill[:, ::-1], tail).astype(np.int32)
    return out


def rowdot(vecs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``[..., C, D]`` rows x ``[..., D]`` queries -> ``[..., C]`` f32 dots of
    the stored values (bf16 products are exact in f32), summed by halving D
    with elementwise adds (an odd width folds its last column into the
    first). Each sum is thus taken in one order whatever the batch or the
    device's reduction kernels, which is what keeps a batched beam search
    equal to a solo one bit for bit."""
    p = vecs.float() * q.float().unsqueeze(-2)
    w = p.shape[-1]
    while w > 1:
        if w % 2:
            p = torch.cat([p[..., :1] + p[..., w - 1:w], p[..., 1:w - 1]], dim=-1)
            w -= 1
        w //= 2
        p = p[..., :w] + p[..., w:2 * w]
    return p[..., 0]


def _device_rows(matrix, device: torch.device) -> torch.Tensor:
    """The rows as a bf16 tensor on ``device`` (a tensor already there is
    used as it is)."""
    if isinstance(matrix, torch.Tensor):
        return matrix.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(matrix, dtype=np.float32)).to(
        device=device, dtype=torch.bfloat16)


def knn_lists(matrix, degree: int, batch: int = KNN_BLOCK, *,
              device: str | torch.device) -> np.ndarray:
    """The exact kNN lists before the reverse-edge pass: [N, degree] int32,
    each row's nearest other rows by the bf16 dot, descending, ties to the
    lower row. ``matrix`` is [N, D] normalized rows (numpy, or a tensor on
    the device). Each block of ``batch`` rows is one ``scan_topk`` call over
    the rows padded to a multiple of the scan tile (padding masked), k =
    degree + 1; self-matches are pushed to the end (stable) and trimmed, and
    at N <= degree the lists are padded with their last entry."""
    dev = resolve_device(device)
    n, d = matrix.shape
    k = min(degree + 1, n)
    tile = default_limits.scan_tile_n
    n_pad = max(tile, -(-n // tile) * tile)
    rows_dev = _device_rows(matrix, dev)
    mat = torch.zeros((n_pad, d), dtype=torch.bfloat16, device=dev)
    mat[:n] = rows_dev
    del rows_dev
    mask = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    mask[:n] = 1
    blocks = []
    for s in range(0, n, batch):
        e = min(n, s + batch)
        _, idx = scan_topk(mat, mat[s:e], k, mask, tile_n=tile, extraction="loop")
        idx = idx.cpu().numpy()                                # [b, k]
        rowid = np.arange(s, e)[:, None]
        # push self-matches to the end (stable), then trim to degree
        ordp = np.argsort(idx == rowid, axis=1, kind="stable")
        idx = np.take_along_axis(idx, ordp, axis=1)[:, :degree]
        if idx.shape[1] < degree:                              # tiny-N corner
            idx = np.pad(idx, ((0, 0), (0, degree - idx.shape[1])), mode="edge")
        blocks.append(idx.astype(np.int32))
    return np.concatenate(blocks) if blocks else np.zeros((0, degree), np.int32)


def build_knn_graph(matrix, degree: int, batch: int = KNN_BLOCK, *,
                    device: str | torch.device) -> np.ndarray:
    """Exact kNN graph over normalized rows -> [N, degree] int32 neighbor ids:
    :func:`knn_lists`, then :func:`add_reverse_edges`. O(N^2 D) operations,
    the default to ``GraphIndex.EXACT_BUILD_MAX`` rows."""
    return add_reverse_edges(knn_lists(matrix, degree, batch, device=device))


def refine(mat: torch.Tensor, nbrs: torch.Tensor, block_ids: torch.Tensor,
           samp_pos: torch.Tensor, rand_ids: torch.Tensor, degree: int) -> torch.Tensor:
    """One NN-descent refinement of a block of rows (the reference's jitted
    ``refine``): each row's candidates are its current neighbors, sampled
    neighbors of neighbors and random rows ([B, C]); they are scored against
    the row (bf16 products, f32 sums), the row itself and every later copy of
    a candidate score NEG, and the top ``degree`` stay. int64 tensors on
    ``mat``'s device; returns [B, degree] int64."""
    cur = nbrs[block_ids]                                      # [B, K]
    non = nbrs[cur]                                            # [B, K, K]
    samp = non.reshape(cur.shape[0], -1)[:, samp_pos]          # [B, sample*K]
    cand = torch.cat([cur, samp, rand_ids], dim=1)             # [B, C]
    s = rowdot(mat[cand], mat[block_ids])
    s = torch.where(cand == block_ids[:, None], NEG, s)        # no self
    eq = cand[:, None, :] == cand[:, :, None]
    lower = torch.tril(torch.ones(eq.shape[-2:], dtype=torch.bool, device=eq.device),
                       diagonal=-1)
    s = torch.where((eq & lower).any(dim=2), NEG, s)           # first copy wins
    _, selk = stable_topk(s, degree)
    return cand.gather(1, selk)


def nn_descent_graph(matrix, degree: int, rounds: int = 8, sample: int = 2,
                     batch: int = 8192, seed: int = 0,
                     mat_dev: torch.Tensor | None = None, *,
                     device: str | torch.device) -> np.ndarray:
    """NN-descent kNN graph build: start from a random graph and refine each
    node's neighbor list from its neighbors-of-neighbors, with a reverse-edge
    merge between rounds. ``matrix`` gives the shape (and the rows, unless
    ``mat_dev`` holds them as bf16 on the device already, so a 1M corpus
    never passes through the host). The draws from ``default_rng(seed)``
    are the reference's, in its order: the initial [N, degree] graph, then
    per round and per block ``samp_pos``, then ``rand_ids``."""
    dev = resolve_device(device)
    n, d = matrix.shape
    if n <= degree + 1:
        return build_knn_graph(matrix if mat_dev is None else mat_dev, degree, device=dev)
    if mat_dev is None:
        mat_dev = _device_rows(matrix, dev)
    rng = np.random.default_rng(seed)
    neighbors = rng.integers(0, n, size=(n, degree), dtype=np.int32)
    for r in range(rounds):
        nbrs_dev = torch.from_numpy(neighbors.astype(np.int64)).to(dev)
        out = np.empty_like(neighbors)
        for s in range(0, n, batch):
            e = min(n, s + batch)
            samp_pos = torch.from_numpy(
                rng.integers(0, degree * degree, size=(sample * degree,))).to(dev)
            rand_ids = torch.from_numpy(rng.integers(0, n, size=(e - s, 8))).to(dev)
            block_ids = torch.arange(s, e, device=dev)
            out[s:e] = refine(mat_dev, nbrs_dev, block_ids, samp_pos, rand_ids,
                              degree).cpu().numpy()
        neighbors = add_reverse_edges(out)                     # nn-descent join
        log.info("nn-descent round %d/%d done", r + 1, rounds)
    return neighbors


def _dup_in_pool(cand: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[B, C] bool: cand[b, i] is one of rows[b, :] (the reference's
    ``(cand[:, None] == rows[None, :]).any(1)``), by a sorted lookup."""
    srt = torch.sort(rows, dim=1).values
    pos = torch.searchsorted(srt, cand).clamp_(max=rows.shape[1] - 1)
    return srt.gather(1, pos) == cand


def _dup_earlier(cand: torch.Tensor) -> torch.Tensor:
    """[B, C] bool: cand[b, i] equals some cand[b, j], j < i (the reference's
    lower-triangular equality mask): after a stable sort equal values keep
    their order, so all but the first of a run are later copies."""
    srt, order = torch.sort(cand, dim=1, stable=True)
    later = torch.zeros_like(cand, dtype=torch.bool)
    later[:, 1:] = srt[:, 1:] == srt[:, :-1]
    return torch.zeros_like(later).scatter(1, order, later)


def _beam_search(matrix, graph, valid, qs, start_ids, k: int, iters: int, expand: int):
    """Best-first beam search for a batch of queries (the reference's
    ``_graph_search_impl`` over ``[B, ...]``): each iteration expands the
    best ``expand`` unexpanded pool entries (with fewer left, ``top_k`` over
    NEG re-picks expanded entries, lowest index first), scores their
    neighbors, masks duplicates and keeps the best ``beam``."""
    b, beam = qs.shape[0], start_ids.shape[0]
    q = qs.to(matrix.dtype)

    def score_rows(rows):
        s = rowdot(matrix[rows], q)
        return torch.where(valid[rows] > 0, s, NEG)

    rows = start_ids.to(torch.int64)[None, :].expand(b, beam).contiguous()
    scores = score_rows(rows)
    expanded = torch.zeros((b, beam), dtype=torch.bool, device=matrix.device)
    for _ in range(iters):
        _, f_sel = stable_topk(torch.where(expanded, NEG, scores), expand)
        frontier = rows.gather(1, f_sel)
        expanded = expanded.scatter(1, f_sel, True)
        cand = graph[frontier].reshape(b, -1)                  # [B, expand*degree]
        cand_scores = torch.where(_dup_in_pool(cand, rows) | _dup_earlier(cand), NEG,
                                  score_rows(cand))
        all_rows = torch.cat([rows, cand], dim=1)
        all_expanded = torch.cat([expanded, torch.zeros_like(cand, dtype=torch.bool)], dim=1)
        scores, sel = stable_topk(torch.cat([scores, cand_scores], dim=1), beam)
        rows, expanded = all_rows.gather(1, sel), all_expanded.gather(1, sel)
    vals, sel = stable_topk(scores, k)
    return vals, rows.gather(1, sel)


def graph_search(matrix: torch.Tensor, graph: torch.Tensor, valid: torch.Tensor,
                 qs: torch.Tensor, start_ids: torch.Tensor, k: int, iters: int,
                 expand: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search (``_graph_search_batch``): ``matrix`` [N, D] bf16,
    ``graph`` [N, degree] int64, ``valid`` [N] int32, ``qs`` [B, D] and
    ``start_ids`` [beam] on one device -> (vals [B, k] f32, rows [B, k]
    int64). One program over the batch, cut into chunks of at most
    :data:`SEARCH_BUDGET_BYTES` of temporaries; equals a solo search of each
    query bit for bit."""
    per_query = expand * graph.shape[1] * matrix.shape[1] * 8
    chunk = max(1, SEARCH_BUDGET_BYTES // per_query)
    outs = [_beam_search(matrix, graph, valid, qs[i:i + chunk], start_ids, k, iters, expand)
            for i in range(0, qs.shape[0], chunk)]
    return torch.cat([v for v, _ in outs]), torch.cat([r for _, r in outs])


class GraphIndex:
    """Fixed-degree kNN-graph ANN over the dense matrix. The normalized f32
    rows stay on the host (``_host``, persisted as float16 as the reference
    does); ``matrix`` is their bf16 copy on ``device``, ``graph`` the
    neighbor lists there (int64, for the gathers), ``mask`` the int32
    tombstone mask."""

    #: above this row count the O(N^2) exact build switches to nn-descent
    EXACT_BUILD_MAX = 200_000

    def __init__(self, ids: list[str], matrix: np.ndarray, neighbors: np.ndarray,
                 stamp: Stamp, *, device: str | torch.device):
        self.device = resolve_device(device)
        self.ids = list(ids)
        self.stamp = stamp
        norms = np.linalg.norm(matrix, axis=1, keepdims=True)
        self._host = (matrix / np.maximum(norms, 1e-12)).astype(np.float32)
        self._neighbors = np.asarray(neighbors, dtype=np.int32)
        self.matrix = _device_rows(self._host, self.device)
        self.graph = torch.from_numpy(self._neighbors.astype(np.int64)).to(self.device)
        self.mask = torch.ones(len(self.ids), dtype=torch.int32, device=self.device)
        self.degree = int(self._neighbors.shape[1])

    @classmethod
    def build(cls, ids: list[str], matrix: np.ndarray, stamp: Stamp,
              degree: int | None = None, method: str = "auto", *,
              device: str | torch.device) -> "GraphIndex":
        """Build the graph. ``method``: auto (exact to ``EXACT_BUILD_MAX``
        rows, nn-descent beyond), exact, or nnd."""
        degree = degree or default_limits.graph_degree
        norms = np.linalg.norm(matrix, axis=1, keepdims=True)
        normed = (matrix / np.maximum(norms, 1e-12)).astype(np.float32)
        if method == "auto":
            method = "exact" if len(ids) <= cls.EXACT_BUILD_MAX else "nnd"
        if method == "nnd":
            neighbors = nn_descent_graph(normed, degree, device=device)
        else:
            neighbors = build_knn_graph(normed, degree, device=device)
        return cls(ids, normed, neighbors, stamp, device=device)

    @property
    def count(self) -> int:
        return len(self.ids)

    def remove(self, doomed: set[str]) -> int:
        """Tombstone rows by chunk id (masked during beam search; reclaimed
        at the next rebuild): a new mask tensor is bound. Returns the number
        removed."""
        rows = [i for i, cid in enumerate(self.ids) if cid in doomed]
        if not rows:
            return 0
        mask = self.mask.clone()
        mask[torch.tensor(rows, device=self.device)] = 0
        self.mask = mask
        return len(rows)

    def search(self, queries: np.ndarray, k: int, iters: int | None = None,
               beam: int | None = None, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Beam search from evenly spaced start rows (deterministic). The
        defaults scale with the corpus as the reference's do: beam =
        max(``graph_search_width``, ``default_itopk(n)``) capped at n, iters
        = max(4, int(1.6 * log2 n)), expand = max(8, beam // 16)."""
        q = np.array(queries, dtype=np.float32, ndmin=2)
        n = self.count
        if beam is None:
            beam = min(max(default_limits.graph_search_width, default_itopk(n)), n)
        k = min(k, beam)
        iters = iters if iters is not None else max(4, int(1.6 * math.log2(max(n, 2))))
        starts = np.linspace(0, n - 1, beam).astype(np.int32)
        vals, rows = graph_search(
            self.matrix, self.graph, self.mask, torch.from_numpy(q).to(self.device),
            torch.from_numpy(starts).to(self.device), k, iters, expand=max(8, beam // 16))
        return vals.cpu().numpy(), rows.to(torch.int32).cpu().numpy()

    # -- persistence (the reference's format) --------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        ck = checksum(np.ascontiguousarray(self._neighbors), "|".join(self.ids).encode())
        tmp = path.with_suffix(".tmp.npz")
        np.savez_compressed(tmp, neighbors=self._neighbors,
                            matrix=self._host.astype(np.float16),
                            ids=np.array(self.ids),
                            stamp=np.array(self.stamp.to_json()), checksum=np.array(ck))
        tmp.rename(path)

    @classmethod
    def load(cls, path: str | Path, expect: Stamp | None = None, *,
             device: str | torch.device) -> "GraphIndex":
        with np.load(Path(path), allow_pickle=False) as z:
            stamp = Stamp.from_json(str(z["stamp"]))
            ids = [str(x) for x in z["ids"]]
            neighbors = z["neighbors"]
            matrix = z["matrix"].astype(np.float32)
            ck = str(z["checksum"])
        if checksum(np.ascontiguousarray(neighbors), "|".join(ids).encode()) != ck:
            raise StampMismatch(f"checksum mismatch in {path}")
        if expect is not None and stamp != expect:
            raise StampMismatch(f"stamp mismatch in {path}")
        return cls(ids, matrix, neighbors, stamp, device=device)
