#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cqs_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases kernels,e2e,commands,scale,shard,serve,neural,graph,train,grid,host]

Phases, each fatal on error (non-zero exit, no result line):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels from ``cqs_tpu_torch/csrc`` (timed);
3. kernels: each of the eight kernels (the six branches of the two Pallas
   bodies; the bf16 and int8 x int8 loop branches each as the split
   tensor-core kernel and the CUDA-core template it routes to) against its
   plain PyTorch twin on the card, on the adversarial cases of the
   reference's op tests and at the programs' shapes, with both times. The
   split loop kernel at the main path's shapes (4,096 rows, tile 2048, m
   64: every batch size the batcher pads to, ``BATCH_RUNGS`` = B
   1/4/8/16/32/64/128, so each query block the daemon launches is held
   against the twin; 65,536 rows, m 32, B 64; 1,048,576 rows: B=1 m 4 and
   B=128 m 64; int8 also the screened scan, tile 16384 x 256, B=1, m 16),
   timed in turns with the template at the same shape; every timing
   beside one library call on the same inputs, the bare score product (not
   the same function: no top-m): ``torch.matmul`` for bf16 and for int8
   rows widened to bf16 before the timing, ``torch._int_mm`` for int8 x
   int8 with the query padded to a multiple of 8 rows;
   both split kernels also at width 768 (EmbeddingGemma's), 4,096 and
   65,536 rows, B 1 and 64;
   int8 x int8 and int8-widened: 1,048,576 rows of width 256 and 1024,
   tiles 2048 and 4096, B 1/8/128, m 4/16. The tensor-core kernels also
   where an MMA design breaks: widths 16/24/48/256/1024/4096, not
   multiples of 16 or of the K-chunk; B
   3 and 65 and the batcher's rungs; tiles 128 (one row a group, one slice) to 16384;
   m up to 128, a fully masked tile; the split kernels also at m 129/256/500/512
   (lists of 256 and 512 keys, slices of fewer rows than m, the merge of 16
   slices' 512-key lists). int8 x int8 (and integer-valued bf16)
   must equal the twin exactly, slot for slot; random bf16 within a score
   near-tie;
4. e2e: index a copy of this repository's sources through the port's CLI,
   answer searches through it and the engine, then a paused burst through
   the ``QueryBatcher`` whose results must equal the solo ones; once with
   the default knobs, then with ``scan_q8=1`` (q8) and ``scan_q8=2`` (sk8)
   at ``scan_q8_min_rows`` 1024 (solo and batched) and ``screen_enable=1``
   at ``screen_min_rows`` 1024 (solo; the screened program is B=1 only);
4b. commands (run after phase 5, with launch counts of its own): the
   ``search`` command's flags (``--rrf``, ``--pattern``, ``--no-demote``,
   ``--expand-parent``, ``--budget``, ``--project``, ``--name-only``), the
   agent context commands, the diff, registry and eval commands through
   ``cli.main.main`` on a copy of the repository corpus (and a second
   project of ``scripts/`` and ``native/`` for ``--project``): each
   search-based command three times on the card, where it must launch the
   split loop kernel, and with ``--device cpu`` three ways: once on the
   device programs (``host_mirror`` off, their plain scans), whose answer
   it must equal (the same rows in the same order, every float within
   1e-5), and once each through the host mirror, the CPU's serving route,
   at ``host_sparse_csr`` 1 and 0, which must reach the mirror and whose
   hits shared with the card's hold the same exact legs (dense within rtol
   2e-4 / atol 1e-5, sparse within rtol 1e-4 / atol 1e-5; the mirror takes
   each leg's global top-pool where the card takes per-tile candidates, so
   the order and fused scores may differ); the
   host-only commands once on the card; ``eval`` over 64 queries made from
   the corpus's docstrings (R@1/5/20 and p50 printed with the card's name
   and power limit); ``onboard``, ``health`` and ``scout`` asked of a
   ``BatchContext`` by four threads while the watch loop indexes an added
   file (no error answer); then the CLI's last 22 commands on that corpus
   (``rest_commands``): ``gc`` then a search, ``chat`` with two pipelines
   from a pipe, ``label-queries --mock``, and ``summaries --max 256`` over
   the port's LLM stub on 127.0.0.1, then ``index`` and the 10 e2e queries,
   each three times on the card (``LOOP_SPLIT`` must launch) and with
   ``--device cpu`` the three ways above; the host commands (``init``, ``slot``,
   ``model``, ``brief``, ``cache``, ``diff`` against the slot before the
   summaries, ``audit-extraction``, ``audit-mode``, ``telemetry``,
   ``completions``, ``convert``, ``hook``, ``context``, ``blame`` over a
   one-commit git history, ``reconstruct``, ``improve-docs``, ``doctor``,
   which must name the card, ``stale`` after an edit) three times each on
   the card with the reference's exit codes; a line per command with its
   median wall, ``LOOP_SPLIT`` launches and the card;
5. scale: a daemon-sized synthetic index (65,536 rows, the bf16 batch
   program at B=64, which scans with the split loop kernel: wall and
   device-busy time), then a synthetic 1,048,576-row index at the hash
   tier's widths (seeded numpy): ``hybrid_query`` at B=1 and
   ``hybrid_query_batch`` at B=128, the
   q8 and sk8 programs at B=1 and B=128, the screened program (int8 and proj
   screens) at B=1, the int8 quantization of the index, and a direct
   ``scan_topk`` over the int8 rows with a bf16 query (the widening kernels'
   only entry point), each with top-10 agreement against the exact plain
   scan. At both sizes every program (bf16, q8, sk8, screened) also runs
   once with the hand-written kernels and once with their plain twins on
   the same inputs, and the two pools are held against each other slot by
   slot (``pool_check``: shared rows' fused scores within rtol 1e-5 / atol
   1e-6; a row in one pool only must be a near-tie at a scan's or the
   pool's boundary);
5b. shard: mesh-sharded hybrid serving on the one card. A corpus at
   ``docs/scale-10m.md``'s production geometry (1,048,576 rows, 768-d, T
   128 terms, sketch 1024, vocab 30522; the clustered generator of
   ``scripts/validate_sharded_8m.py``, drawn from the seed) built with
   ``ShardedHybridIndex.from_row_blocks`` over ``Mesh([cuda:0] * 4)`` (four
   logical shards of 262,144 rows) and over ``Mesh([cuda:0])``, in modes 0
   (bf16), 1 (q8) and 2 (sk8), each shard's bytes printed against that doc's
   budget (the scan rows, padding included: at most 2,047 a shard); 64
   queries (a row's vector and its terms, pool 500, alpha 0.8)
   through ``sharded_search_legs``: 4 shards must equal 1 shard bit for bit,
   the kernels' pools must match the plain per-shard step's on the card
   (``pool_check``'s rule), and each shard's scans must launch the split
   kernels exactly as the mode implies (mode 0: 2 ``LOOP_SPLIT`` a shard a
   query; mode 1: 2 ``LOOP_SPLIT_I8``; mode 2: one each) and never the
   template (``LOOP_CC`` / ``LOOP_I8_CC``); B=1 median and device-busy ms
   for 4 and 1 shards; both split kernels at a shard's scans (262,144 x 768
   and x 1024, m 500) against their plain twins, in turns with the template
   they replaced there, again at m 4 (the scan without the selection),
   against their bound, the per-shard step (and its tile merge alone) and
   one library way (``torch.matmul`` + ``torch.topk``; int8:
   ``torch._int_mm`` on the query padded to 8 rows + ``torch.topk``); a
   shard that is not a power of two (250,000 x 768, padded to whole tiles)
   through ``shard_topk`` against ``topk_plain``. Then the engine at the
   repository corpus: ``mesh_shards=4`` on one card must warn and serve
   from one device; on an explicit ``Mesh([cuda:0] * 4)`` the queries' top
   5 must equal the single-device engine's and launch ``LOOP_SPLIT``. Last,
   shards under 128 rows (8 of 40 rows, pool 100, modes 0 and 1), the
   template's one program: exactly 2 ``LOOP_CC`` (mode 0) or ``LOOP_I8_CC``
   (mode 1) a shard a query, pools held to the plain per-shard step's;
6. serve: the warm daemon, in this process plus threads: ``DaemonServer``
   over a micro-batching ``BatchContext`` on the repository corpus, asked
   over its Unix socket by 1, 4 and 16 client threads (queries per second,
   round-trip median and p95, mean batch size; every answer equal to the
   solo search); the watch loop's ``reconcile_once`` after one file is
   added, one edited and one deleted, which must answer through
   ``refresh_incremental`` without a rebuild while clients keep asking,
   leave every live row's tensors equal to what the daemon was given (the
   saved artifacts' values for the rows it loaded at its start, the
   store's for the appended rows) and upload only the new rows; one request each through the batch loop, the MCP bridge and
   the web API; the idle unload and the query after it. An error answer
   from the daemon fails the run;
7. neural: the default configuration at full width, from HF checkpoints
   written from the seed at published geometry (EmbeddingGemma-300m,
   splade-distil, the minilm-l6 cross-encoder): the repository indexed
   through the CLI, the 10 queries solo, batched (equal to solo) and with
   ``--rerank``; the bf16 EmbeddingGemma forward against an f32 forward of
   the same weights on the card (per-row cosine >= 0.99 on 64 chunks); the
   forward's time, tokens/s, share of the bf16 peak and peak memory at the
   index's shapes and at 512 x 2048, its kernel profile; the B=1 query
   embedding;
8. graph: the graph ANN and the tiered index. A clustered 1,048,576 x 768
   bf16 corpus made on the card (the recipe of
   ``scripts/validate_graph_1m.py``) and 2,048 queries near its rows; their
   exact top-10 through the split loop kernel (16 held against the plain
   scan); an NN-descent graph (degree 32, 8 rounds; seconds split into
   device refine and host reverse edges; peak memory); R@10 of the beam
   search against exact at the default beam (640) and at beams 512 (>= 0.95)
   and 1024 (>= 0.98), over all queries and over the first 256; the
   search's wall time, device-busy time and
   launches at B=1 and B=128; the exact kNN build at 196,608 rows through
   the split kernel (one launch a 1,024-row block), its lists held slot by
   slot against the plain build (>= 99.9% equal, every other slot a
   near-tie within 1e-5); the engine on the repository corpus under
   ``index_kind`` graph and tiered with every alpha at 1 (the ANN answers,
   batched == solo, top-10 against the exact dense-only program), the watch
   loop's add/edit/delete under tiered (no graph rebuild; the added
   function found from the delta tier); one ``--worktree`` search and one
   ``embed-2d`` through the CLI;
9. train: the training path on the repository corpus through the CLI:
   ``train-data --source all --max 2000 --engine-negatives 2`` and the
   teacher pass (``train-distill --labels-only`` over a pool written from
   the pairs, 64 queries held out as a gate), both through the engine and
   the split kernel at width 256; ``train-distill`` at the FINAL recipe of
   ``docs/trained-tier.md`` (B 16, H 384, I 768, K 16, 300 steps, the gate
   probe's R@1/5/20), ``train`` at the r3a recipe (H 384, 6 layers, I 1536,
   seq 128, B 128, 2 negatives a pair, 100 steps), ``train-reranker`` (50
   steps) and a hybrid ``train`` (20 steps): every loss finite, the mean of
   the last 20 (or half a shorter run) below the first's, the hybrid's
   frozen scales still [1.0, 0.3]; the distilled checkpoint as slot
   ``distilled`` (``cqs-mini``) indexed through the CLI and served as the
   tier of ``TieredServing``: the tier answers, a batcher burst equals solo,
   the split kernel launches at width 384; three f32 ``DistillTrainer``
   steps on the card against the CPU from the same parameters; each
   trainer's step time (forward, backward, optimizer), sequences/s,
   tokens/s, share of the bf16 peak, peak memory and profile (printed, not
   checked);
9b. grid: the trainers' (dp, tp) grid on logical meshes of the card, (1, 2),
   (1, 4), (1, 8) and (3, 2) (and every real card through ``make_2d_mesh()``
   on a machine with more than one): the FINAL distillation step and the
   r3a contrastive step (2 mined negatives) at their published widths, three
   steps from one init against the one-device trainer at the same global
   batch (bf16: losses within rtol 2e-2, deltas' cosine >= 0.99 over the
   model, >= 0.9 a parameter), a small f32 configuration at (1, 4) (rtol
   1e-5, cosine >= 0.9999, <= 1% of entries off by 1e-6); each mesh's step
   ms, launches, busy ms and peak memory; then ``train-distill --steps 3``
   through the CLI with ``make_2d_mesh`` giving a (1, 4) logical mesh, its
   checkpoint served as a one-device tier. At most 90 s;
10. host: the sparse-only API on the card against the same calls on the
   CPU (``SpladeIndex.search`` over 70,000 rows, ``sparse_scores_batch``
   across its 65,536-row tile, ``build_doc_sketch_device`` against the host
   build in bf16); the host mirror (``hybrid_query_host``) on this
   machine's CPU against the card's program: at 2,048 rows against its
   exact branch with every row a candidate, to the reference's pins (the
   same valid rows and top 10, values within rtol 2e-4 / atol 1e-5), at
   65,536 rows against the serving program, each shared row's exact legs
   (and in csr mode the best exact-sparse row a candidate), at
   ``host_sparse_csr`` 1 and 0; a CUDA engine's searches and batch make no
   mirror call, a ``--device cpu`` CLI search makes one and launches no
   kernel, a CPU batcher serves through it; then solo times on the CPU
   (at 65,536 rows and on the repository corpus): the mirror at csr 1 and
   0 against the device programs on the CPU, with the CPU's model. At
   most 60 s.

The kernels' launch counters are zeroed before phase 4 and read after
phase 5, read just before and just after each run of phase 5b's path (the
sharded path must launch ``LOOP_SPLIT`` and ``LOOP_SPLIT_I8`` and nothing
else, its small shards ``LOOP_CC`` and ``LOOP_I8_CC``), zeroed again before
phase 4b and read after it, and again around
phase 6, phase 7, phase 8, phase 9 and phase 9b (the split bf16 loop kernel
must have launched from the commands' path, the socket path, the neural
path, the graph path, the train path and the grid path's corpus and tier),
and around phase 10 (the split kernel
must launch on its path); a
branch wrapper that
did not launch in phases 4-5 fails the run, and so
does a split loop kernel that did not, a search of phase 4 whose solo or
batched program did not launch the split kernel, a widening kernel that
did not launch in phase 3, and any module of JAX or of the JAX package
(``cqs_tpu``) in ``sys.modules`` at the end. The CUDA-core template's bf16
and int8 x int8 instances serve only m > 512 and tiles that are not whole
128-row sub-tiles: their program is a shard under 128 rows, phase 5b's
small shards, whose launches are counted on a path of their own (zeroed
just before, read just after); they are also held to their twins in phase
3 and timed beside the split kernels in phase 5b. The third-to-last line is a
JSON object with each kernel's launches, error, times, bound and library
time; then the card's name and power limit; the last is ``{"ok": true,
"device": {...}}``. Needs one CUDA card; exits non-zero without one or
outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RTOL, ATOL = 1e-5, 1e-6
SCALE_ROWS = 1 << 20
QUERIES = [
    "fused scan top k kernel per tile", "count sketch of sparse terms",
    "reciprocal rank fusion of the lexical legs", "parse python source into chunks",
    "embedding cache lookup by content hash", "which functions call the store upsert",
    "incremental index refresh after file changes", "min max normalize sparse scores",
    "tokenize camel case identifiers", "daemon micro batching of concurrent queries",
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over iters launches (after one
    warm-up), by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: kernels against their plain twins ------------------------------

#: H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s, and tensor-core
#: operations/s for the kernels' operand types (int8; bf16, which the
#: widening kernels multiply in)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"i8": 1979e12, "bf16": 989e12, "i8w": 989e12}
#: the library way of a shard's exact top-pool, one per row kind (two calls each)
SHARD_LIBRARY = {"bf16": "torch.matmul + torch.topk",
                 "i8": "torch._int_mm (query padded to 8 rows) + torch.topk"}
#: (rows, width, tile, B, m) of each kernel's entry on the kernels line: the
#: split loop kernel at a repository-size solo query's sketch scan (bf16)
#: and at the screened program's scan (int8); the CUDA-core templates at a
#: shard's scans in the shard phase (262,144 rows, m = pool 500: the bf16
#: dense scan, the int8 sketch scan), timed there in turns with the split
#: kernels that replaced them; the widening kernel at 1,048,576 x 1024
#: B=1 m 4; the grouped kernels at their B=128 sketch scan
KERNEL_CASES = {
    "scan_topk_loop_split": (4096, 1024, 2048, 1, 64),
    "scan_topk_loop_cc": (SCALE_ROWS // 4, 768, 2048, 1, 500),
    "scan_topk_grouped": (SCALE_ROWS, 1024, 2048, 128, 4),
    "scan_topk_loop_split_i8": (SCALE_ROWS, 256, 16384, 1, 16),
    "scan_topk_loop_i8_cc": (SCALE_ROWS // 4, 1024, 2048, 1, 500),
    "scan_topk_grouped_i8": (SCALE_ROWS, 1024, 2048, 128, 4),
    "scan_topk_loop_i8w": (SCALE_ROWS, 1024, 2048, 1, 4),
    "scan_topk_grouped_i8w": (SCALE_ROWS, 1024, 2048, 128, 4),
}


def library_call(torch, kind: str, index, q):
    """The one PyTorch call timed beside a scan as ``library_ms``, and its
    name: the bare score product on the scan's inputs (no single call
    computes a per-tile top-m). bf16: ``torch.matmul``; int8 rows with a bf16
    query: ``torch.matmul`` on the rows widened to bf16 once, before the
    timing; int8 x int8: ``torch._int_mm``, the query padded with zero rows
    to a multiple of 8 (its shape rule)."""
    if kind == "bf16":
        return (lambda: torch.matmul(q, index.t())), "torch.matmul"
    if kind == "i8w":
        wide = index.to(torch.bfloat16)
        return (lambda: torch.matmul(q, wide.t())), "torch.matmul (rows widened to bf16)"
    pad = -q.shape[0] % 8
    qt = torch.cat([q, q.new_zeros(pad, q.shape[1])]).t().contiguous()   # [D, B + pad]
    return (lambda: torch._int_mm(index, qt)), ("torch._int_mm" + (
        f" (query padded to {q.shape[0] + pad} rows)" if pad else ""))


def bound_ms(kind: str, n: int, d: int, b: int, tile: int, m: int) -> tuple[float, str]:
    """Least time of one scan on the card: its bytes (rows, mask and queries
    read once, the [tiles, B, m] values and rows written once) over HBM's
    rate, or its 2*B*N*D operations over the tensor-core peak of its type,
    whichever is larger."""
    row_b = 2 if kind == "bf16" else 1
    q_b = 1 if kind == "i8" else 2
    nbytes = n * d * row_b + n * 4 + b * d * q_b + (n // tile) * b * m * 8
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2.0 * b * n * d / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

def compare_tiles(kernel, plain, index, q, mask, tile, m, label):
    """Kernel vs plain per-tile outputs. Values within rtol/atol; rows equal
    except where the two rows' plain scores are within the same tolerance
    (f32 sums in another order may swap near-ties). Returns max |err|."""
    import torch

    kv, kr = kernel(index, q, mask, tile, m)
    pv, pr = plain(index, q, mask, tile, m)
    torch.cuda.synchronize()
    if not torch.allclose(kv, pv, rtol=RTOL, atol=ATOL):
        bad = (kv - pv).abs().max().item()
        fail(f"{label}: values differ from plain (max |err| {bad})")
    diff = kr != pr
    if diff.any():
        full = q.float() @ index.float().T
        full = torch.where(mask[None, :] > 0, full, torch.full_like(full, -3.0e38))
        b_idx = torch.arange(q.shape[0], device=q.device)[None, :, None].expand_as(kr)
        a = full[b_idx[diff], kr[diff].long()]
        c = full[b_idx[diff], pr[diff].long()]
        if not torch.all((a - c).abs() <= ATOL + RTOL * c.abs()):
            fail(f"{label}: {int(diff.sum())} rows differ beyond a score near-tie")
    return float((kv - pv).abs().max().item())


def compare_exact(kernel, plain, index, q, mask, tile, m, label):
    """Kernel vs plain where every sum is exact (int8 x int8, or integer
    values): sums have no order, so values and rows must be equal slot for
    slot. Returns max |err| (0.0)."""
    import torch

    kv, kr = kernel(index, q, mask, tile, m)
    pv, pr = plain(index, q, mask, tile, m)
    torch.cuda.synchronize()
    if not (torch.equal(kv, pv) and torch.equal(kr, pr)):
        fail(f"{label}: {int((kv != pv).sum())} values and {int((kr != pr).sum())} rows "
             f"differ from the plain twin (exact sums must match exactly)")
    return 0.0


def check_grouped_i8(torch, dev, seed: int) -> int:
    """The tensor-core GROUPED_I8, slot for slot equal to its float64 twin
    where an MMA design breaks: widths 16 and 48 (K padded inside the last
    chunk), 1024 and 4096; B 1, 3, 65, 128 (zero queries inside an n-tile,
    a second query block; query blocks 8 and 64, the two ring depths);
    tiles 128 (one row a group) to 16384; m up to 128 (every group
    retired). Full-range int8 values (-128 included), 2% of rows masked.
    Draws from a generator of its own, so the later phases' data do not
    depend on it. Returns the number of cases."""
    from cqs_tpu_torch.ops.topk import GROUPED_I8, scan_topk_plain_grouped

    gen = torch.Generator(device=dev).manual_seed(seed + 104729)
    n, cases = 32768, 0
    for d in (16, 48, 1024, 4096):
        index = torch.randint(-128, 128, (n, d), device=dev, generator=gen, dtype=torch.int8)
        mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
        for b in (1, 3, 65, 128):
            q = torch.randint(-128, 128, (b, d), device=dev, generator=gen, dtype=torch.int8)
            for tile in (128, 2048, 4096, 16384):
                for m in (4, 16, 128):
                    compare_exact(GROUPED_I8, scan_topk_plain_grouped, index, q, mask, tile, m,
                                  f"{GROUPED_I8.name} d={d} b={b} tile={tile} m={m}")
                    cases += 1
        del index, mask
    return cases


#: check_loop_split's grids: (widths, batch sizes, tiles, per-tile ks).
#: "narrow", m <= 128: B 3 and 65 and every batch size the batcher pads to
#: (None: 1/4/8/16/32/64/128, each built query block, 8, 16 and 32, and a
#: second block), tiles 128, 2048 and 16384 (1 to 16 slices, so the merge
#: kernel runs), m 128 on 128-row tiles (m equal to a slice); "wide", m
#: 129-512: lists of 256 and 512 keys in 8-query blocks (B 65: 9 blocks),
#: slices of fewer rows than m (tiles 512 and 2048: 128-row slices at B 1, 3)
#: and 16 slices' 512-key lists merged (tile 16384, 64 KiB)
SPLIT_CHECKS = {"narrow": ((16, 48, 256, 768, 1024, 4096), None, (128, 2048, 16384),
                           (4, 16, 64, 128)),
                "wide": ((16, 768, 1024), (1, 3, 65), (512, 2048, 16384), (129, 256, 500, 512))}


def check_loop_split(torch, dev, seed: int, grid: str = "narrow") -> int:
    """The split loop kernel's two kinds slot for slot equal to the loop
    twin where the design breaks, over one grid of :data:`SPLIT_CHECKS`:
    int8 x int8 (full range, -128 included) and bf16 on integer values
    (exact f32 sums in any order, many ties); 2% of rows masked, rows
    4096-6143 masked (a fully masked tile at tiles up to 2048) and rows
    6144-8191 but three (slots past a tile's valid rows). Own generator.
    Returns the number of cases."""
    from cqs_tpu_torch.daemon.batcher import BATCH_RUNGS
    from cqs_tpu_torch.ops.topk import LOOP_SPLIT, LOOP_SPLIT_I8, scan_topk_plain_loop

    widths, batches, tiles, ms = SPLIT_CHECKS[grid]
    gen = torch.Generator(device=dev).manual_seed(seed + 7919 + 8 * (grid == "wide"))
    n, cases = 32768, 0
    for kernel in (LOOP_SPLIT_I8, LOOP_SPLIT):
        for d in widths:
            if kernel is LOOP_SPLIT_I8:
                index = torch.randint(-128, 128, (n, d), device=dev, generator=gen,
                                      dtype=torch.int8)
            else:
                index = torch.randint(-8, 9, (n, d), device=dev, generator=gen).to(torch.bfloat16)
            mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
            mask[4096:8192] = 0
            mask[[6200, 7000, 8191]] = 1
            for b in batches or sorted({3, 65, *BATCH_RUNGS}):
                if kernel is LOOP_SPLIT_I8:
                    q = torch.randint(-128, 128, (b, d), device=dev, generator=gen,
                                      dtype=torch.int8)
                else:
                    q = torch.randint(-3, 4, (b, d), device=dev, generator=gen).to(torch.bfloat16)
                for tile in tiles:
                    for m in ms:
                        compare_exact(kernel, scan_topk_plain_loop, index, q, mask, tile, m,
                                      f"{kernel.name} d={d} b={b} tile={tile} m={m}")
                        cases += 1
            del index, mask
    return cases


def device_busy(torch, fn, calls: int = 5, host: bool = True) -> tuple[float, dict, float, dict]:
    """Device-busy milliseconds per call of fn (``torch.profiler`` kernel
    time over ``calls`` calls after a warm-up call), the per-call time of
    each kernel by name (the first 60 characters; kernels whose names share
    them are summed), the kernel launches per call, and the host's CUDA
    runtime calls per call (``cuda*`` events: count and self milliseconds),
    which show a launch-bound or synchronizing caller. The host's launch
    rate does not move the busy time, unlike wall time. ``host=False``
    traces the device's activity only (no host operators, so no runtime
    calls are returned): it takes a fraction of the time to record and read
    a step of many thousands of launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel, launches, runtime = {}, 0, {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if getattr(getattr(e, "device_type", None), "name", "") == "CUDA" and dev_us:
            key = e.key[:60]
            by_kernel[key] = by_kernel.get(key, 0.0) + dev_us / calls / 1e3
            launches += e.count
        elif e.key.startswith("cuda"):
            runtime[e.key] = (e.count / calls, e.self_cpu_time_total / calls / 1e3)
    return sum(by_kernel.values()), by_kernel, launches / calls, runtime


def adversarial_cases(torch, dev, rng):
    """bf16 twins of the reference's Pallas op tests (tests/test_ops.py)."""
    import numpy as np

    def normed(n, d):
        x = rng.normal(size=(n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    def t(x, dtype=torch.bfloat16):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    cases = []
    mask = np.ones(512, np.int32)
    mask[100:110] = 0
    cases.append(("mask", normed(512, 32), normed(4, 32), mask, 128, 8))
    spikes = rng.normal(size=(1024, 16)).astype(np.float32) * 1e-3
    for rank, row in enumerate([3, 200, 650, 900]):
        spikes[row] = 0.0
        spikes[row, 0] = 10.0 - rank
    e0 = np.eye(16, dtype=np.float32)[:1]
    cases.append(("spread_spikes", spikes, e0, np.ones(1024, np.int32), 512, 2))
    coll = np.zeros((512, 8), np.float32)
    coll[5, 0], coll[133, 0], coll[300, 0] = 10.0, 9.0, 1.0
    cases.append(("same_group_collision", coll, np.eye(8, dtype=np.float32)[:1],
                  np.ones(512, np.int32), 512, 2))
    heavy = np.zeros(1024, np.int32)
    heavy[rng.choice(1024, size=51, replace=False)] = 1
    cases.append(("heavy_mask", normed(1024, 16), normed(2, 16), heavy, 128, 8))
    ties = np.tile(np.eye(8, dtype=np.float32)[0], (512, 1))
    cases.append(("ties", ties, np.eye(8, dtype=np.float32)[:1], np.ones(512, np.int32), 256, 4))
    return [(name, t(ix), t(qq), t(mm, torch.int32), tile, m)
            for name, ix, qq, mm, tile, m in cases]


def int8_cases(torch, dev, rng):
    """int8 twins of the adversarial cases (row widths a multiple of 16):
    (name, int8 rows, int8 query, bf16 query, mask, tile, m)."""
    import numpy as np

    def i8(*shape):
        return rng.integers(-127, 128, size=shape).astype(np.int8)

    e0 = np.eye(16, dtype=np.int8)[:1] * 127
    cases = []
    mask = np.ones(512, np.int32)
    mask[100:110] = 0
    cases.append(("mask", i8(512, 32), i8(4, 32), mask, 128, 8))
    spikes = i8(1024, 16) // 64
    spikes[:, 0] = 0
    for rank, row in enumerate([3, 200, 650, 900]):
        spikes[row] = 0
        spikes[row, 0] = 120 - 10 * rank
    cases.append(("spread_spikes", spikes, e0, np.ones(1024, np.int32), 512, 2))
    coll = np.zeros((512, 16), np.int8)
    coll[5, 0], coll[133, 0], coll[300, 0] = 100, 90, 10
    cases.append(("same_group_collision", coll, e0, np.ones(512, np.int32), 512, 2))
    heavy = np.zeros(1024, np.int32)
    heavy[rng.choice(1024, size=51, replace=False)] = 1
    cases.append(("heavy_mask", i8(1024, 16), i8(2, 16), heavy, 128, 8))
    ties = np.tile(np.eye(16, dtype=np.int8)[0] * 100, (512, 1))
    cases.append(("ties", ties, e0, np.ones(512, np.int32), 256, 4))

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    return [(name, t(ix, torch.int8), t(qq, torch.int8), t(qq, torch.float32).to(torch.bfloat16),
             t(mm, torch.int32), tile, m) for name, ix, qq, mm, tile, m in cases]


def phase_kernels(torch, dev, rng, seed, report):
    from cqs_tpu_torch.daemon.batcher import BATCH_RUNGS
    from cqs_tpu_torch.ops.topk import (GROUPED, GROUPED_I8, GROUPED_I8W, IMPLS, LOOP_CC,
                                        LOOP_I8_CC, LOOP_I8W, LOOP_SPLIT, LOOP_SPLIT_I8,
                                        scan_topk_plain_grouped, scan_topk_plain_loop)

    def plain_of(kernel):
        return scan_topk_plain_grouped if kernel.grouped else scan_topk_plain_loop

    errs = {k.name: 0.0 for k in IMPLS}
    timings = []

    def check(kernel, index, q, mask, tile, m, label):
        cmp = compare_exact if kernel.kind == "i8" else compare_tiles
        errs[kernel.name] = max(errs[kernel.name],
                                cmp(kernel, plain_of(kernel), index, q, mask, tile, m, label))

    def timed(kernel, index, q, mask, tile, m, iters, rival=None):
        """The kernel's and its plain twin's times, and a rival kernel's on
        the same inputs, in turns (plain, kernel, rival, rival, kernel,
        plain); the library call beside it (:func:`library_call`, the bare
        score product on the same inputs: not the same function, no top-m),
        which holds for the rival too."""
        n, d = index.shape
        b = q.shape[0]
        label = f"n={n} d={d} tile={tile} b={b} m={m}"
        for k in (kernel, rival) if rival else (kernel,):
            check(k, index, q, mask, tile, m, f"{k.name} {label}")
        plain = plain_of(kernel)
        pm1 = cuda_ms(lambda: plain(index, q, mask, tile, m), iters)
        km1 = cuda_ms(lambda: kernel(index, q, mask, tile, m), iters)
        rm = rival and [cuda_ms(lambda: rival(index, q, mask, tile, m), iters) for _ in (0, 1)]
        km2 = cuda_ms(lambda: kernel(index, q, mask, tile, m), iters)
        pm2 = cuda_ms(lambda: plain(index, q, mask, tile, m), iters)
        lib, lib_name = library_call(torch, kernel.kind, index, q)
        lib_ms = cuda_ms(lib, iters)
        del lib
        timings.append({"kernel": kernel.name, "n": n, "d": d, "tile": tile, "b": b, "m": m,
                        "ms": (km1 + km2) / 2, "plain_ms": (pm1 + pm2) / 2,
                        "library_ms": lib_ms, "library_call": lib_name,
                        "rival": rival and rival.name,
                        "rival_ms": rival and sum(rm) / 2})

    cases = check_grouped_i8(torch, dev, seed)
    print(f"kernels: {GROUPED_I8.name} exact at {cases} (width, B, tile, m) cases: widths "
          f"16/48/1024/4096, B 1/3/65/128, tiles 128-16384, m 4/16/128")
    cases = check_loop_split(torch, dev, seed)
    print(f"kernels: {LOOP_SPLIT.name} (bf16, integer values) and {LOOP_SPLIT_I8.name} exact "
          f"at {cases} cases: widths 16/48/256/768/1024/4096, B 3/65 and the batcher's rungs "
          f"1/4/8/16/32/64/128, tiles 128-16384 "
          f"(1-16 slices), m 4/16/64/128, a fully masked tile, one of 3 valid rows")
    cases = check_loop_split(torch, dev, seed, "wide")
    print(f"kernels: {LOOP_SPLIT.name} and {LOOP_SPLIT_I8.name} exact at m 129/256/500/512 "
          f"({cases} cases: widths 16/768/1024, B 1/3/65, tiles 512/2048/16384, slices of "
          f"fewer rows than m, 16 slices' 512-key lists merged)")
    for name, index, q, mask, tile, m in adversarial_cases(torch, dev, rng):
        for kernel in (LOOP_SPLIT, LOOP_CC, GROUPED):
            check(kernel, index, q, mask, tile, m, f"{kernel.name}/{name}")
    for name, index, q8, qbf, mask, tile, m in int8_cases(torch, dev, rng):
        for kernel in (LOOP_SPLIT_I8, LOOP_I8_CC, GROUPED_I8):
            check(kernel, index, q8, mask, tile, m, f"{kernel.name}/{name}")
        for kernel in (LOOP_I8W, GROUPED_I8W):
            check(kernel, index, qbf, mask, tile, m, f"{kernel.name}/{name}")
    print("kernels: adversarial cases ok for all eight kernels (mask, spread spikes, "
          "same-group collision, heavy mask, ties); int8 x int8 exact")
    # the tensor-core grouped kernels where an MMA design breaks: K padded
    # inside the last chunk, zero queries inside an n-tile and a second query
    # block, one row a group and 128 rows a group. Then integer rows and
    # queries, whose sums are exact in f32 in any order: slot for slot equal
    # to the twin, through many ties and m 128 rounds that retire every group
    # (near-zero random scores carry more f32 noise than ATOL in any order)
    for kernel, widths in ((GROUPED, (24, 4096)), (GROUPED_I8W, (48, 4096))):
        for d in widths:
            n = 32768
            gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
            if kernel is GROUPED:
                index = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
                int_rows = torch.randint(-8, 9, (n, d), device=dev, generator=gen).to(
                    torch.bfloat16)
            else:
                index = int_rows = torch.randint(-127, 128, (n, d), device=dev, generator=gen,
                                                 dtype=torch.int8)
            mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
            for b in (3, 65, 128):
                label = f"{kernel.name} n={n} d={d} b={b}"
                q = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
                for tile, m in ((128, 4), (128, 16), (16384, 16)):
                    check(kernel, index, q, mask, tile, m, f"{label} tile={tile} m={m}")
                    if kernel is GROUPED:     # the split loop kernel on random bf16
                        check(LOOP_SPLIT, index, q, mask, tile, m, f"{label} split m={m}")
                q_int = torch.randint(-3, 4, (b, d), device=dev, generator=gen).to(torch.bfloat16)
                for tile, m in ((128, 128), (16384, 16)):
                    compare_exact(kernel, plain_of(kernel), int_rows, q_int, mask, tile, m,
                                  f"{label} tile={tile} m={m} integer")
    print("kernels: tensor-core grouped kernels ok at widths 24/48/4096, B 3/65/128, "
          "tiles 128 and 16384; exact on integer inputs through m 128; split loop kernel "
          "within a near-tie on random bf16")
    # bf16 main-path shapes: the repository corpus (4,096 rows, per-tile k
    # 64) at every batch size the batcher pads to (the daemon's launches: 16
    # clients give batches of 9-10, padded to 16), a daemon-sized corpus (65,536 rows, k 32) at B 64,
    # 1,048,576 rows at B=1 k 4 (the solo program) and B=128 k 64 (loop at
    # B>1); the split kernel in turns with the template at each shape; the
    # grouped kernel at B 1/8/128, k 4/16
    # (the rows' seeds come from rng at the shapes earlier runs timed, so the
    # scale phase's data, drawn from rng after this phase, stays the same)
    for n in (4096, 65536, SCALE_ROWS):
        for d in (256, 1024):
            gen = torch.Generator(device=dev).manual_seed(
                seed + n + d if n == 65536 else int(rng.integers(1 << 30)))
            index = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
            mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
            shapes = {4096: tuple((b, 64) for b in BATCH_RUNGS), 65536: ((64, 32),),
                      SCALE_ROWS: ((1, 4), (128, 64)) if d == 1024 else ((1, 4),)}[n]
            for b, m in shapes:
                q = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
                timed(LOOP_SPLIT, index, q, mask, 2048, m, 10 if n == SCALE_ROWS else 100,
                      rival=LOOP_CC)
            if n != 65536:
                for b in (1, 8, 128):
                    q = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
                    for m in (4, 16):
                        timed(GROUPED, index, q, mask, 2048, m, 20 if n == SCALE_ROWS else 100)
            del index, mask
            torch.cuda.empty_cache()
    # width 768 (EmbeddingGemma's): the split kernels at the neural path's
    # shapes, the repository corpus (4,096 rows, k 64) and a daemon-sized
    # corpus (65,536, k 32), B 1 and 64 (K is 12 bf16 or 6 int8 chunks)
    for n in (4096, 65536):
        gen = torch.Generator(device=dev).manual_seed(seed + n + 768)
        index = torch.randn(n, 768, device=dev, generator=gen).to(torch.bfloat16)
        index8 = torch.randint(-127, 128, (n, 768), device=dev, generator=gen, dtype=torch.int8)
        mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
        for b in (1, 64):
            q = torch.randn(b, 768, device=dev, generator=gen).to(torch.bfloat16)
            q8 = torch.randint(-127, 128, (b, 768), device=dev, generator=gen, dtype=torch.int8)
            m = 64 if n == 4096 else 32
            timed(LOOP_SPLIT, index, q, mask, 2048, m, 100)
            timed(LOOP_SPLIT_I8, index8, q8, mask, 2048, m, 100)
        del index, index8, mask
    # width 384 (the distilled tier's, cqs-mini at H 384): the bf16 split
    # kernel at the repository corpus (4,096 rows, k 64), B 1 and 16 (a
    # daemon batch of 9-16 queries on the tier)
    gen = torch.Generator(device=dev).manual_seed(seed + 4096 + 384)
    index = torch.randn(4096, 384, device=dev, generator=gen).to(torch.bfloat16)
    mask = (torch.rand(4096, device=dev, generator=gen) > 0.02).to(torch.int32)
    for b in (1, 16):
        q = torch.randn(b, 384, device=dev, generator=gen).to(torch.bfloat16)
        timed(LOOP_SPLIT, index, q, mask, 2048, 64, 100)
    del index, mask
    # int8 shapes: q8/sk8 at the repository corpus (k 64, the batcher's
    # rungs) and 65,536 rows (k 32); at 1,048,576 rows the q8 dense (x 256) and sketch (x 1024) scans
    # at tile 2048, sk8's sketch scan at tile 4096, B 1/8/128, k 4/16, and
    # the screened int8 scan at tile 16384 x 256, B=1, k 16; widening kernels
    # at k 4
    for n, d in ((4096, 256), (4096, 1024), (65536, 256), (65536, 1024), (SCALE_ROWS, 256),
                 (SCALE_ROWS, 1024)):
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.integers(1 << 30)) if n == SCALE_ROWS else seed + n + d)
        index = torch.randint(-127, 128, (n, d), device=dev, generator=gen, dtype=torch.int8)
        mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
        if n < SCALE_ROWS:
            for b in BATCH_RUNGS if n == 4096 else (1, 64):
                q8 = torch.randint(-127, 128, (b, d), device=dev, generator=gen, dtype=torch.int8)
                timed(LOOP_SPLIT_I8, index, q8, mask, 2048, 64 if n == 4096 else 32, 100,
                      rival=LOOP_I8_CC)
        else:
            for b in (1, 8, 128):
                q8 = torch.randint(-127, 128, (b, d), device=dev, generator=gen, dtype=torch.int8)
                qbf = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
                for tile in (2048, 4096):
                    for m in (4, 16):
                        timed(LOOP_SPLIT_I8, index, q8, mask, tile, m, 10, rival=LOOP_I8_CC)
                        timed(GROUPED_I8, index, q8, mask, tile, m, 10)
                    for kernel in (LOOP_I8W, GROUPED_I8W):
                        timed(kernel, index, qbf, mask, tile, 4, 10)
                if d == 256 and b == 1:
                    timed(LOOP_SPLIT_I8, index, q8, mask, 16384, 16, 10, rival=LOOP_I8_CC)
                    timed(GROUPED_I8, index, q8, mask, 16384, 16, 10)
                    for kernel in (LOOP_I8W, GROUPED_I8W):
                        timed(kernel, index, qbf, mask, 16384, 16, 10)
        del index, mask
        torch.cuda.empty_cache()
    print("kernels: main-path shapes ok; times (ms, CUDA events, kernel vs plain, and vs "
          "the template in turns; library: torch.matmul (bf16; int8 rows widened to bf16 "
          "before the timing) or torch._int_mm (query padded to a multiple of 8 rows), the "
          "score product only, not the same function):")
    kinds = {k.name: k.kind for k in IMPLS}
    for t in timings:
        lib = f"  library {t['library_ms']:9.4f}"
        riv = f"  {t['rival']} {t['rival_ms']:9.4f}" if t["rival"] else ""
        bound = bound_ms(kinds[t["kernel"]], t["n"], t["d"], t["b"], t["tile"], t["m"])
        print(f"  {t['kernel']:26s} n={t['n']:8d} d={t['d']:5d} tile={t['tile']:5d} "
              f"b={t['b']:4d} m={t['m']:3d}  kernel {t['ms']:9.4f}  plain {t['plain_ms']:9.4f}"
              f"  bound {bound[0]:9.4f} ({bound[1]}){lib}{riv}")
    for name, err in errs.items():
        print(f"kernels: {name} max |err| vs plain {err:.3g}")
    report["errs"] = errs
    report["timings"] = timings


# -- phase 4: end to end through the CLI and the batcher -----------------------

def copy_corpus(dst: Path) -> None:
    ignore = shutil.ignore_patterns("__pycache__", "*.so", "*.srchash", ".cqs-tpu", "_build")
    for name in ("cqs_tpu", "tests", "docs", "scripts", "native"):
        if (REPO / name).is_dir():
            shutil.copytree(REPO / name, dst / name, ignore=ignore)
    (dst / ".cqs-tpu").mkdir()          # pins the project root here


def run_cli(main, argv) -> tuple[int, dict | None, float]:
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    ms = (time.perf_counter() - t0) * 1e3
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), ms


@contextlib.contextmanager
def knobs(env: dict):
    """Set ``CQST_*`` knobs in this process's environment, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


#: (label, knobs, batched must equal solo); the screened program is B=1
#: only, so its batched queries run the bf16 batch program
E2E_RUNS = (
    ("bf16", {}, True),
    ("q8", {"CQST_SCAN_Q8": "1", "CQST_SCAN_Q8_MIN_ROWS": "1024"}, True),
    ("sk8", {"CQST_SCAN_Q8": "2", "CQST_SCAN_Q8_MIN_ROWS": "1024"}, True),
    ("screened", {"CQST_SCREEN_ENABLE": "1", "CQST_SCREEN_MIN_ROWS": "1024"}, False),
)


def e2e_run(dev, proj, label, batched, main):
    """Solo searches through the CLI and the engine, then a paused batcher
    burst, under the knobs already set. Fails when a search has no hits,
    when a solo search or the burst does not launch the split loop kernel
    its program scans with, or (``batched``) when a batched result differs
    from solo."""
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.daemon.batcher import QueryBatcher
    from cqs_tpu_torch.ops.topk import GROUPED_I8, LOOP_I8, LOOP_SPLIT, LOOP_SPLIT_I8

    # the kernel every solo search of this run must launch: the split loop
    # kernel, bf16 or int8 (small corpora take loop: per-tile k 64 > 16)
    kernel = LOOP_SPLIT if label == "bf16" else LOOP_SPLIT_I8
    cli_ms = []
    for q in QUERIES if label == "bf16" else QUERIES[:3]:
        before = kernel.launches
        rc, env, ms = run_cli(main, [q, "--path", str(proj), "--device", str(dev), "--json"])
        if rc != 0 or env is None or not env["results"]:
            fail(f"{label}: search {q!r}: rc {rc}, no hits")
        if dev.type == "cuda" and kernel.launches <= before:
            fail(f"{label}: search {q!r} did not launch {kernel.name}")
        cli_ms.append(ms)
    ctx = CommandContext.create(str(proj), device=dev)
    eng = ctx.engine
    if label == "screened" and eng.dense.screen is None:
        fail("screen_enable=1 built no screen")
    if label == "bf16":
        cap = eng.dense.capacity
        print(f"e2e: {eng.dense.count} rows padded to {cap} ({cap // 2048} tiles of 2048)")
    solo, e2e_ms, dev_ms = {}, [], []
    for q in QUERIES:
        res = eng.search(q)
        solo[q] = [(h.row.id, h.score) for h in res.hits]
        e2e_ms.append(res.elapsed_ms)
        if "device_ms" in res.meta:
            dev_ms.append(res.meta["device_ms"])
    out = {"cli_ms": statistics.median(cli_ms), "search_ms": statistics.median(e2e_ms),
           "device_ms": statistics.median(dev_ms)}
    ctx2 = CommandContext.create(str(proj), device=dev)
    batcher = QueryBatcher(ctx2.engine)
    i8_before = LOOP_I8.launches + GROUPED_I8.launches
    split_before = (LOOP_SPLIT if label in ("bf16", "screened") else LOOP_SPLIT_I8).launches
    try:
        batcher.pause()
        futs = [batcher.submit(q) for q in QUERIES[:8]]
        batcher.resume()
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.stop()
    st = batcher.stats
    if st["fused"] != 8 or st["solo"] != 0:
        fail(f"{label}: burst did not run batched: {st}")
    if (dev.type == "cuda" and label in ("q8", "sk8")
            and LOOP_I8.launches + GROUPED_I8.launches <= i8_before):
        fail(f"{label}: the batched program launched no int8 kernel")
    split = LOOP_SPLIT if label in ("bf16", "screened") else LOOP_SPLIT_I8
    if dev.type == "cuda" and split.launches <= split_before:
        fail(f"{label}: the batched program did not launch {split.name}")
    if batched:
        for q, res in zip(QUERIES[:8], results):
            got = [(h.row.id, h.score) for h in res.hits]
            if [i for i, _ in got] != [i for i, _ in solo[q]] or any(
                    abs(a - b) > 1e-5 for (_, a), (_, b) in zip(got, solo[q])):
                fail(f"{label}: batched result of {q!r} differs from solo")
    out["batch_ms"] = sorted({r.meta.get("device_ms", 0.0) for r in results})
    print(f"e2e[{label}]: {'batched == solo' if batched else 'batched ran'} for 8 queries "
          f"({st['batches']} device batch(es), sizes {st['batch_size_hist']}); solo ms: CLI "
          f"call median {out['cli_ms']:.2f}, engine.search median {out['search_ms']:.2f}, "
          f"device program median {out['device_ms']:.3f} (host clock incl. transfer); "
          f"batch device ms {', '.join(f'{x:.3f}' for x in out['batch_ms'])}")
    ctx2.close()
    ctx.close()
    return out


def phase_e2e(torch, dev, report):
    from cqs_tpu_torch.cli.main import main

    tmp = Path(tempfile.mkdtemp(prefix="cqs_smoke_"))
    try:
        proj = tmp / "corpus"
        proj.mkdir()
        copy_corpus(proj)
        rc, env, ms = run_cli(main, ["index", "--path", str(proj), "--device", str(dev), "--json"])
        if rc != 0 or env is None:
            fail(f"index exited {rc}")
        stats = env["results"]
        print(f"e2e: indexed {stats['files_parsed']} files -> {stats['chunks_upserted']} "
              f"chunks ({stats['embedded']} embedded, {stats['sparse_encoded']} sparse) "
              f"in {ms / 1e3:.1f} s")
        report["e2e"] = {"chunks": stats["chunks_upserted"], "index_s": ms / 1e3}
        for label, env_knobs, batched in E2E_RUNS:
            with knobs(env_knobs):
                report["e2e"][label] = e2e_run(dev, proj, label, batched, main)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 4b: the search surface, the agent context and eval commands ----------

#: the eval phase's query file: this many documented functions of the corpus
COMMAND_QUERIES = 64
#: (label, argv) of the commands that run ``engine.search``: each runs on the
#: card three times (it must launch the split loop kernel) and once with
#: ``--device cpu``, whose result it must equal. ``{q64}``, ``{q16}``, ``{diff}``
#: and ``{out}`` name the phase's files
SEARCH_COMMANDS = (
    ("search --rrf", ["search", "reciprocal rank fusion of the lexical legs", "--rrf"]),
    ("search --pattern", ["search", "walk the call graph", "--pattern", "recursion"]),
    ("search --no-demote", ["search", "test the store upsert", "--no-demote"]),
    ("search --expand-parent", ["search", "embedding cache lookup by content hash",
                                "--expand-parent"]),
    ("search --budget", ["search", "tokenize camel case identifiers", "--budget", "400"]),
    ("search --project", ["search", "parse python source into chunks", "--project", "repo",
                          "--project", "tools"]),
    ("scout", ["scout", "incremental index refresh after file changes"]),
    ("task", ["task", "add a knob for the rescore pool"]),
    ("where", ["where", "a helper that normalizes sparse scores"]),
    ("plan", ["plan", "add a knob for the rescore pool"]),
    ("explain", ["explain", "classify a query into a category", "classify_query"]),
    ("onboard concept", ["onboard", "classify a query into a category"]),
    ("eval", ["eval", "{q64}"]),
    ("sweep", ["sweep", "name_boost", "0", "0.2", "--pool", "{q16}", "--save", "{out}"]),
    ("ablate", ["ablate", "{q16}", "--levers", "name_boost,sig_boost", "--save", "{out}"]),
)
#: the commands that read the store, the call graph, a diff or the registry
#: (``drift`` embeds on the card): each runs once on the card
HOST_COMMANDS = (
    ("search --name-only", ["search", "classify", "--name-only"]),
    ("onboard", ["onboard"]), ("related", ["related", "classify_query"]),
    ("suggest", ["suggest"]), ("kind", ["kind", "SearchEngine"]), ("health", ["health"]),
    ("structural", ["structural"]), ("review", ["review", "--diff-file", "{diff}"]),
    ("impact-diff", ["impact-diff", "--diff-file", "{diff}"]),
    ("ci", ["ci", "--diff-file", "{diff}", "--threshold", "Medium"]),
    ("affected", ["affected", "--diff-file", "{diff}"]), ("deps", ["deps", "Store"]),
    ("neighbors", ["neighbors", "classify_query"]), ("drift", ["drift"]),
    ("note", ["note", "classify_query", "read on the card"]), ("notes", ["notes"]),
    ("project list", ["project", "list"]), ("ref add", ["ref", "add", "tools", "{tools}"]),
    ("ref list", ["ref", "list"]), ("ref remove", ["ref", "remove", "tools"]),
)
#: commands whose answer is text, not a JSON envelope
TEXT_COMMANDS = {"search --budget", "sweep", "ablate", "neighbors", "note", "project list",
                 "ref add", "ref list", "ref remove"}
#: the analysis requests a daemon's clients send while its watch loop writes
ANALYSIS_REQUESTS = (("onboard", {}), ("health", {}),
                     ("scout", {"query": "incremental index refresh"}))


def docstring_queries(index_dir: Path, n: int) -> list[dict]:
    """A v3 query list from the corpus's own functions: each query the first
    line of a documented function's or method's docstring (each text once),
    its gold that function's origin and name; ``n`` of them spread evenly
    over the corpus in (origin, line) order."""
    from cqs_tpu_torch.search.router import classify_query
    from cqs_tpu_torch.store import Store

    store = Store.open(index_dir, readonly=True)
    try:
        rows = list(store.iter_chunks("chunk_type IN ('function','method') AND doc != ''"))
    finally:
        store.close()
    qs, seen = [], set()
    for r in sorted(rows, key=lambda r: (r.origin, r.line_start)):
        line = r.doc.strip().splitlines()[0].strip() if r.doc.strip() else ""
        if line and line not in seen:
            seen.add(line)
            qs.append({"query": line, "category": classify_query(line).category.value,
                       "gold_chunk": {"origin": r.origin, "name": r.name}})
    return qs[::max(1, len(qs) // n)][:n]


def one_line_diff(root: Path, origin: str, func: str, added: str) -> str:
    """A unified diff of ``origin`` that adds ``added`` two lines into the
    module-level function ``func``."""
    lines = (root / origin).read_text().splitlines()
    i = next(n for n, ln in enumerate(lines) if ln.startswith(f"def {func}("))
    return (f"diff --git a/{origin} b/{origin}\n--- a/{origin}\n+++ b/{origin}\n"
            f"@@ -{i + 1},2 +{i + 1},3 @@\n"
            + "".join(f" {ln}\n" for ln in lines[i:i + 2]) + f"+    {added}\n")


def same_answer(got, want, diffs: list, path: str = "") -> str | None:
    """None when two answers agree, else where they first differ: equal
    structures (hits in the same order), floats within 1e-5, clock readings
    and the device field left out. Each float's difference is appended to
    ``diffs``."""
    skip = {"generated_at", "elapsed_ms", "latency_ms", "device"}
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) - skip != set(want) - skip:
            return path or "."
        for k in sorted(set(want) - skip):
            where = same_answer(got[k], want[k], diffs, f"{path}.{k}")
            if where:
                return where
        return None
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return path
        for i, (a, b) in enumerate(zip(got, want)):
            where = same_answer(a, b, diffs, f"{path}[{i}]")
            if where:
                return where
        return None
    if isinstance(want, float) and not isinstance(want, bool):
        if not isinstance(got, (int, float)):
            return path
        diffs.append(abs(got - want))
        return None if diffs[-1] <= 1e-5 else path
    return None if got == want else path


def same_text(got: str, want: str) -> bool:
    """Equal lines, numbers with a fraction within one unit of their last
    printed digit; a search header's clock reading and device name left out."""
    import re

    def norm(text):
        return [re.sub(r" \(\d+ ms, [\w:]+\)$", "", ln) if ln.startswith("# ") else ln
                for ln in text.splitlines()]

    num = re.compile(r"[-+]?\d+\.\d+")
    g, w = norm(got), norm(want)
    if len(g) != len(w):
        return False
    for a, b in zip(g, w):
        if num.sub("#", a) != num.sub("#", b):
            return False
        for x, y in zip(num.findall(a), num.findall(b)):
            if abs(float(x) - float(y)) > 10.0 ** -len(y.split(".")[1]) + 1e-9:
                return False
    return True


# -- the CPU's two routes: the device programs and the host mirror -------------

@contextlib.contextmanager
def cpu_device_route():
    """Within the block every engine runs the device programs even on the
    CPU (``host_mirror`` off, their plain scans): the route a ``--device
    cpu`` search took before the host mirror, whose answers equal the
    card's. The package never makes that choice: this wraps the engine's
    constructor here."""
    from cqs_tpu_torch.search.engine import SearchEngine

    real = SearchEngine.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.host_mirror = False

    SearchEngine.__init__ = init
    try:
        yield
    finally:
        SearchEngine.__init__ = real


@contextlib.contextmanager
def mirror_calls():
    """Within the block, count the calls of the host mirror
    (``hybrid_query_host``, ``dense_query_host``) that the engine and the
    batcher make, by wrapping the names those modules call."""
    from cqs_tpu_torch.daemon import batcher
    from cqs_tpu_torch.search import engine

    counts = {"hybrid_query_host": 0, "dense_query_host": 0}
    saved = []
    for mod in (engine, batcher):
        for name in counts:
            if hasattr(mod, name):
                real = getattr(mod, name)

                def spy(*a, _real=real, _name=name, **kw):
                    counts[_name] += 1
                    return _real(*a, **kw)

                saved.append((mod, name, real))
                setattr(mod, name, spy)
    try:
        yield counts
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


#: (rtol, atol) of a leg's value between the card's program and the host
#: mirror: the dense leg to the reference's mirror pin, the exact sparse leg
#: to its CSR pin (``tests/test_host_path.py``)
LEG_PINS = {"dense": (2e-4, 1e-5), "sparse": (1e-4, 1e-5)}


def answer_hits(answer, out: dict | None = None, path: tuple = ()) -> dict:
    """(where, id) -> signals of every hit (a dict with ``id`` and
    ``signals``) in an answer, at any depth; ``where`` is the path of the
    list that holds the hit (one query's hits), so the same chunk in the
    answers of two queries is two hits. The first of a key wins."""
    out = {} if out is None else out
    if isinstance(answer, dict):
        if isinstance(answer.get("id"), str) and isinstance(answer.get("signals"), dict):
            out.setdefault((path[:-1], answer["id"]), answer["signals"])
        for k, v in answer.items():
            answer_hits(v, out, path + (k,))
    elif isinstance(answer, list):
        for i, v in enumerate(answer):
            answer_hits(v, out, path + (i,))
    return out


def leg_pins(card, mirror, label: str) -> dict:
    """Hold an answer the host mirror served on the CPU to the card's. The
    mirror takes each leg's global top-pool (the reference's CPU program)
    where the card's program takes per-tile candidates (its TPU program),
    so the sparse leg's min-max range, the fused scores and the hits'
    order may differ; a hit both answers hold has the same exact legs:
    its dense leg within the reference's mirror pin, its sparse leg within
    the CSR pin (``LEG_PINS``). Answers that both hold hits must share one.
    Returns the counts and the largest differences."""
    a, b = answer_hits(card), answer_hits(mirror)
    shared = [i for i in a if i in b]
    if a and b and not shared:
        fail(f"{label}: the card's answer and the host mirror's share no hit")
    worst = {"dense": 0.0, "sparse": 0.0}
    for i in shared:
        for leg, (rtol, atol) in LEG_PINS.items():
            x, y = a[i].get(leg), b[i].get(leg)
            if isinstance(x, (int, float)) and isinstance(y, (int, float)):
                worst[leg] = max(worst[leg], abs(x - y))
                if abs(x - y) > atol + rtol * abs(x):
                    fail(f"{label}: hit {i[1]} at {i[0]}: {leg} leg {y} through the host "
                         f"mirror, {x} "
                         f"on the card (rtol {rtol}, atol {atol})")
    return {"hits": len(a), "mirror_hits": len(b), "shared": len(shared),
            "max_dense_diff": worst["dense"], "max_sparse_diff": worst["sparse"]}


def mirror_answers(run, card, label: str) -> dict:
    """``run()`` (one ``--device cpu`` call: exit code, answer, ms) through
    the host mirror at ``host_sparse_csr`` 1 (the default: exact CSR
    candidates) and 0 (the device program's sketch candidates), each answer
    held to the card's by :func:`leg_pins`. Fails when a call fails or
    never reaches the mirror."""
    out = {}
    for csr in ("1", "0"):
        with knobs({"CQST_HOST_SPARSE_CSR": csr}), mirror_calls() as calls:
            rc, got, ms = run()
        if rc != 0 or got is None:
            fail(f"{label} through the host mirror (host_sparse_csr {csr}) exited {rc}")
        if not sum(calls.values()):
            fail(f"{label} with --device cpu made no host-mirror call")
        out[f"csr{csr}"] = {**leg_pins(card, got, f"{label} (host_sparse_csr {csr})"),
                            "ms": ms, "mirror_calls": dict(calls)}
    return out


def mirror_line(m: dict) -> str:
    return "; ".join(f"mirror {k}: {v['shared']}/{v['hits']} hits shared, legs within "
                     f"{max(v['max_dense_diff'], v['max_sparse_diff']):.2e}"
                     for k, v in m.items())


def phase_commands(torch, dev, report, smi: str):
    """The ``search`` command's flags, the agent context, diff, registry and
    eval commands through ``cli.main.main`` on the repository corpus: each
    search-based command on the card (``LOOP_SPLIT`` must launch) and with
    ``--device cpu`` (the same rows in the same order, scores within 1e-5);
    the host-only commands on the card; ``eval`` over
    64 of the corpus's docstrings; a daemon's analysis requests while its
    watch loop writes."""
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.ops.topk import LOOP_SPLIT

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="cqs_cmds_"))
    out: dict = {"search": {}, "host": {}}
    try:
        proj, tools = tmp / "corpus", tmp / "tools"
        proj.mkdir()
        copy_corpus(proj)
        tools.mkdir()
        for name in ("scripts", "native"):
            shutil.copytree(REPO / name, tools / name,
                            ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.srchash"))
        (tools / ".cqs-tpu").mkdir()
        for root in (proj, tools):
            rc, env, ms = run_cli(main, ["index", "--path", str(root), "--device", str(dev),
                                         "--json"])
            if rc != 0 or env is None:
                fail(f"commands: index of {root.name} exited {rc}")
            out.setdefault("index_s", {})[root.name] = ms / 1e3
        qs = docstring_queries(proj / ".cqs-tpu", COMMAND_QUERIES)
        if len(qs) != COMMAND_QUERIES:
            fail(f"commands: {len(qs)} docstring queries, not {COMMAND_QUERIES}")
        files = {"q64": tmp / "q64.v3.json", "q16": tmp / "q16.v3.json",
                 "diff": tmp / "change.diff", "tools": tools}
        files["q64"].write_text(json.dumps({"queries": qs}))
        files["q16"].write_text(json.dumps({"queries": qs[:16]}))
        files["diff"].write_text(one_line_diff(proj, "cqs_tpu/search/router.py",
                                               "classify_query", "audit(query)"))
        with knobs({"XDG_DATA_HOME": str(tmp / "xdg")}):
            for name, root in (("repo", proj), ("tools", tools)):
                if main(["project", "add", name, str(root), "--path", str(proj),
                         "--device", str(dev)]) != 0:
                    fail(f"commands: project add {name} failed")

            def call(label: str, argv: list[str], device: str, n: int):
                argv = [a.format(**files, out=tmp / f"{device}_out.json") for a in argv]
                argv += ["--path", str(proj), "--device", device]
                text = label in TEXT_COMMANDS
                runs = [run_cli_text(main, argv) if text else run_cli(main, argv + ["--json"])
                        for _ in range(n)]
                rc, answer = runs[-1][0], runs[-1][1]
                if label in ("sweep", "ablate"):
                    answer = json.loads((tmp / f"{device}_out.json").read_text())
                return rc, answer, statistics.median(r[2] for r in runs)

            for label, argv in SEARCH_COMMANDS:
                n = 1 if label in ("eval", "sweep", "ablate") else 3
                before = LOOP_SPLIT.launches
                rc, card, ms = call(label, argv, str(dev), n)
                launched = LOOP_SPLIT.launches - before
                if rc != 0 or card is None:
                    fail(f"commands: {label} on the card exited {rc}")
                if dev.type == "cuda" and launched == 0:
                    fail(f"commands: {label} did not launch {LOOP_SPLIT.name}")
                # --device cpu on the device programs (their plain scans):
                # the card's answer exactly
                with cpu_device_route():
                    rc, cpu, cpu_ms = call(label, argv, "cpu", 1)
                if rc != 0 or cpu is None:
                    fail(f"commands: {label} with --device cpu exited {rc}")
                diffs: list = []
                if label in TEXT_COMMANDS and label not in ("sweep", "ablate"):
                    where = None if same_text(card, cpu) else "text"
                else:
                    where = same_answer(card, cpu, diffs, label)
                if where:
                    fail(f"commands: {label} on the card differs from --device cpu's device "
                         f"programs at {where}")
                # --device cpu as served: the host mirror, csr and sketch
                mirror = mirror_answers(lambda: call(label, argv, "cpu", 1), card,
                                        f"commands: {label}")
                out["search"][label] = {"launches": launched, "runs": n, "ms": ms,
                                        "cpu_ms": cpu_ms, "max_abs_diff": max(diffs, default=0.0),
                                        "mirror": mirror}
                print(f"commands: {label}: card == cpu device programs (floats within "
                      f"{max(diffs, default=0.0):.2e}); {mirror_line(mirror)}; "
                      f"{LOOP_SPLIT.name} {launched} launches in {n} run(s), median {ms:.1f} ms "
                      f"a CLI call (cpu {cpu_ms:.1f} ms, mirror {mirror['csr1']['ms']:.1f} ms)")
                if label == "eval":
                    rep = card["results"]
                    r, p = rep["recall"], rep["latency_ms"]
                    out["eval"] = {"total": rep["total"], **r, **p,
                                   "skipped_missing": rep["skipped_missing"],
                                   "cpu_latency_ms": cpu["results"]["latency_ms"]}
                    print(f"commands: eval on the card over {rep['total']} docstring queries "
                          f"({rep['skipped_missing']} gold not extracted): R@1 {r['r@1']} "
                          f"R@5 {r['r@5']} R@20 {r['r@20']}, p50 {p['p50']} ms, p95 "
                          f"{p['p95']} ms (cpu p50 {cpu['results']['latency_ms']['p50']} ms); "
                          f"{smi}")
            for label, argv in HOST_COMMANDS:
                rc, answer, ms = call(label, argv, str(dev), 1)
                if rc not in ((0, 3) if label == "ci" else (0,)) or answer is None:
                    fail(f"commands: {label} on the card exited {rc}")
                out["host"][label] = {"rc": rc, "ms": ms}
            print(f"commands: {len(HOST_COMMANDS)} host commands on the card, rc 0 "
                  f"(ci {out['host']['ci']['rc']}): "
                  + ", ".join(f"{k} {v['ms']:.0f} ms" for k, v in out["host"].items()))
        out["analysis_under_writes"] = analysis_under_writes(dev, proj)
        out["rest"] = rest_commands(torch, dev, proj, tmp, smi)
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"commands: the phase took {out['phase_s']:.1f} s; {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["commands"] = out


def analysis_under_writes(dev, proj: Path, clients: int = 4) -> dict:
    """A daemon's client threads ask its dispatch table for ``onboard``,
    ``health`` and ``scout`` while the watch loop, on the store's home
    thread, indexes an added file and refreshes the engine. Any error
    answer fails the run."""
    import threading

    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.daemon.dispatch import BatchContext
    from cqs_tpu_torch.daemon.watch import WatchLoop

    ctx = CommandContext.create(str(proj), device=dev)
    _ = ctx.store, ctx.engine                # opened on this, the watch loop's, thread
    bctx = BatchContext(ctx)
    stop = threading.Event()
    errors: list = []
    answers = [0] * clients

    def client(k: int) -> None:
        try:
            while not stop.is_set() or answers[k] < len(ANALYSIS_REQUESTS):
                for command, args in ANALYSIS_REQUESTS:
                    resp = bctx.dispatch(command, args)
                    if "error" in resp:
                        errors.append((command, resp["error"]))
                        return
                    answers[k] += 1
        except BaseException as e:           # reported by the main thread
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    try:
        for t in threads:
            t.start()
        (proj / "docs" / "added_while_asked.py").write_text(ADDED_FILE)
        t0 = time.perf_counter()
        changed = WatchLoop(ctx).reconcile_once()
        reconcile_s = time.perf_counter() - t0
        stop.set()
        for t in threads:
            t.join(timeout=300)
        if any(t.is_alive() for t in threads):
            fail("commands: a client thread did not finish")
        if errors:
            fail(f"commands: analysis answers under writes: {errors[:3]}")
        if changed != 1:
            fail(f"commands: the watch loop saw {changed} changed files, not 1")
    finally:
        stop.set()
        bctx.close()
        ctx.close()
    print(f"commands: {sum(answers)} onboard/health/scout answers from {clients} client "
          f"threads while the watch loop indexed a file ({reconcile_s:.2f} s), no error")
    return {"answers": sum(answers), "reconcile_s": reconcile_s}


#: the last commands' fixture: a page, a PDF, a file convert skips
CONVERT_HTML = ("<html><body><h1>Scan kernels</h1><p>The split loop kernel keeps an "
                "<b>exact</b> per-tile top-m.</p><pre>python3 chip_smoke.py</pre></body></html>")
#: two pipelines piped to ``chat`` (the batch grammar: a search fanned out)
CHAT_SESSION = ('search "reciprocal rank fusion of the lexical legs" | callers\n'
                'search "parse python source into chunks" -k 5 | callees\n')
GIT_ENV = {"GIT_AUTHOR_NAME": "Ada Example", "GIT_AUTHOR_EMAIL": "ada@example.com",
           "GIT_AUTHOR_DATE": "2024-01-02T03:04:05+00:00",
           "GIT_COMMITTER_NAME": "Ada Example", "GIT_COMMITTER_EMAIL": "ada@example.com",
           "GIT_COMMITTER_DATE": "2024-01-02T03:04:05+00:00"}


def tiny_pdf(text: bytes) -> bytes:
    """A one-page PDF whose content stream shows ``text`` (a literal string)."""
    content = b"BT /F1 12 Tf 72 720 Td (" + text + b") Tj ET"
    return (b"%PDF-1.4\n1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
            b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 >>\nendobj\n"
            b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Contents 4 0 R "
            b"/Resources << /Font << /F1 5 0 R >> >> >>\nendobj\n"
            b"4 0 obj\n<< /Length " + str(len(content)).encode() + b" >>\nstream\n" + content
            + b"\nendstream\nendobj\n"
            b"5 0 obj\n<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>\nendobj\n"
            b"trailer\n<< /Root 1 0 R >>\n%%EOF\n")


@contextlib.contextmanager
def piped_stdin(text: str):
    """``sys.stdin`` reads ``text`` from the read end of an OS pipe."""
    r, w = os.pipe()
    os.write(w, text.encode())
    os.close(w)
    old = sys.stdin
    sys.stdin = os.fdopen(r)
    try:
        yield
    finally:
        sys.stdin.close()
        sys.stdin = old


@contextlib.contextmanager
def llm_stub():
    """The port's deterministic OpenAI-compatible stub on 127.0.0.1, named by
    ``CQST_LLM_BASE_URL``; no Anthropic key is visible meanwhile (the
    provider would prefer the local server, but nothing may leave the host)."""
    from cqs_tpu_torch.llm import stub

    srv, url = stub.start()
    key = os.environ.pop("ANTHROPIC_API_KEY", None)
    try:
        with knobs({"CQST_LLM_BASE_URL": url, "NO_PROXY": "127.0.0.1,localhost",
                    "no_proxy": "127.0.0.1,localhost"}):
            yield url
    finally:
        if key is not None:
            os.environ["ANTHROPIC_API_KEY"] = key
        srv.shutdown()
        srv.server_close()


def rest_commands(torch, dev, proj: Path, tmp: Path, smi: str) -> dict:
    """The CLI's last 22 commands on the repository corpus, on the card.
    Search-based (``gc`` then a search, ``chat`` with two piped pipelines,
    ``label-queries --mock``, ``summaries --max 256`` over the LLM stub then
    ``index`` then the 10 e2e queries): three runs on the card, each must
    launch ``LOOP_SPLIT``, and one with ``--device cpu``, whose answer must
    equal the card's (the same rows in the same order, floats within 1e-5;
    chat's text equal). Host commands: three runs on the card, each exit
    code the reference's on this project (``doctor``: its device rows ok and
    naming the card; its model row fails, as the reference's does, for a
    neural preset without weights). Each line: median wall of the runs (host
    clock), ``LOOP_SPLIT`` launches, the card."""
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.ops.topk import LOOP_SPLIT

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    git = shutil.which("git") is not None
    if git:
        for cmd in (["git", "-c", "init.defaultBranch=main", "init", "-q"],
                    ["git", "add", "cqs_tpu/search/router.py"],
                    ["git", "commit", "-q", "-m", "fixture"]):
            subprocess.run(cmd, cwd=proj, env={**os.environ, **GIT_ENV}, check=True,
                           capture_output=True, timeout=60)
    docs = tmp / "docs"
    docs.mkdir()
    (docs / "kernels.html").write_text(CONVERT_HTML)
    (docs / "scan.pdf").write_bytes(tiny_pdf(b"exact per-tile top-m on the card"))
    (docs / "notes.txt").write_text("convert skips this\n")
    (tmp / "queries.txt").write_text("\n".join(QUERIES) + "\n")
    slots = proj / ".cqs-tpu" / "slots"
    shutil.copytree(slots / "default", slots / "before")     # diff's other slot
    files = {"docs": docs, "queries": tmp / "queries.txt"}
    res: dict = {"search": {}, "host": {}}
    t_rest = time.perf_counter()

    def runs(argv: list[str], device: str, n: int, stdin: str | None = None):
        """n runs of one command line: the last's exit code and output, the
        median wall ms, the LOOP_SPLIT launches of the n runs."""
        argv = [a.format(**files, out=tmp / f"{device}_rest.json",
                         pool=tmp / f"{device}_pool.json") for a in argv]
        argv += ["--path", str(proj), "--device", device]
        before = LOOP_SPLIT.launches
        got = []
        for _ in range(n):
            with piped_stdin(stdin) if stdin is not None else contextlib.nullcontext():
                got.append(run_cli_text(main, argv))
        return got[-1][0], got[-1][1], statistics.median(g[2] for g in got), \
            LOOP_SPLIT.launches - before

    def report(label: str, ms: float, launched: int, extra: str = "") -> None:
        print(f"commands: {label}: median {ms:.1f} ms a CLI call (host clock), "
              f"{LOOP_SPLIT.name} {launched} launches{extra}; {smi}")

    def last_json(text: str):
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        return json.loads(lines[-1]) if lines else None

    with knobs({"XDG_DATA_HOME": str(tmp / "xdg"), "CQST_TELEMETRY": "1"}), llm_stub():
        # -- search-based: the card against --device cpu
        def searched(label: str, steps: list[tuple[list[str], str | None]], compare) -> None:
            answers, step_ms, launched = {}, [], 0

            def answer(device: str, n: int):
                nonlocal launched
                outs, t0 = [], time.perf_counter()
                for argv, stdin in steps:
                    rc, text, ms, k = runs(argv, device, n, stdin)
                    if rc != 0:
                        fail(f"commands: {label}: {' '.join(argv)} with --device {device} "
                             f"exited {rc}")
                    outs.append(text)
                    if device != "cpu":
                        step_ms.append((argv[0], ms))
                        launched += k
                return 0, compare(outs, device), (time.perf_counter() - t0) * 1e3

            answers[str(dev)] = answer(str(dev), 3)[1]
            with cpu_device_route():       # the device programs' plain scans
                answers["cpu"] = answer("cpu", 1)[1]
            if dev.type == "cuda" and launched == 0:
                fail(f"commands: {label} did not launch {LOOP_SPLIT.name}")
            diffs: list = []
            where = same_answer(answers[str(dev)], answers["cpu"], diffs, label)
            if where:
                fail(f"commands: {label} on the card differs from --device cpu's device "
                     f"programs at {where}")
            mirror = mirror_answers(lambda: answer("cpu", 1), answers[str(dev)],
                                    f"commands: {label}")
            res["search"][label] = {"step_ms": step_ms, "launches": launched,
                                    "max_abs_diff": max(diffs, default=0.0), "mirror": mirror}
            ms = [m for _, m in step_ms]
            walls = (f"median {ms[0]:.1f} ms a CLI call" if len(ms) == 1 else
                     "medians " + ", ".join(f"{c} {m:.1f}" for c, m in step_ms) + " ms"
                     if len(ms) < 4 else f"median {statistics.median(ms):.1f} ms a query "
                     f"(its CLI calls' medians {min(ms):.1f}-{max(ms):.1f})")
            print(f"commands: {label}: {walls} (host clock), {LOOP_SPLIT.name} {launched} "
                  f"launches in 3 runs, card == cpu device programs (floats within "
                  f"{max(diffs, default=0.0):.2e}); {mirror_line(mirror)}; {smi}")

        searched("gc then search", [(["gc"], None),
                                    (["search", "walk the call graph", "--json"], None)],
                 lambda outs, d: last_json(outs[1]))
        searched("chat (two pipelines from a pipe)", [(["chat"], CHAT_SESSION)],
                 lambda outs, d: outs[0])
        searched("label-queries --mock", [(["label-queries", "{queries}", "--out", "{out}",
                                            "--pool-out", "{pool}", "--mock"], None)],
                 lambda outs, d: [json.loads((tmp / f"{d}_rest.json").read_text()),
                                  json.loads((tmp / f"{d}_pool.json").read_text()),
                                  outs[0].splitlines()[0]])
        # summaries enrich the store once (host work over the stub); the
        # re-embedding index then runs on the card, and the queries on both
        t0 = time.perf_counter()
        rc, text, _, _ = runs(["summaries", "--max", "256"], str(dev), 1)
        summaries_ms = (time.perf_counter() - t0) * 1e3
        if rc != 0 or not text.startswith("enriched 256 chunks"):
            fail(f"commands: summaries exited {rc}: {text[:200]}")
        rc, text, index_ms, launched = runs(["index"], str(dev), 1)
        if rc != 0:
            fail(f"commands: index after summaries exited {rc}")
        res["summaries"] = {"summaries_ms": summaries_ms, "index_ms": index_ms,
                            "index_line": text.strip()}
        report("summaries --max 256 (512 stub calls)", summaries_ms, 0)
        report(f"index after summaries ({text.strip()})", index_ms, launched)
        searched("search after summaries + index (the 10 e2e queries)",
                 [(["search", q, "--json"], None) for q in QUERIES],
                 lambda outs, d: [last_json(t) for t in outs])
        # -- host commands: three runs each on the card, the reference's exit code
        host = [("init", ["init"], 0), ("slot list", ["slot", "list"], 0),
                ("model", ["model"], 0), ("brief", ["brief", "cqs_tpu/search/router.py"], 0),
                ("cache stats", ["cache", "stats", "--per-model"], 0),
                ("cache prune", ["cache", "prune", "3650"], 0),
                ("cache compact", ["cache", "compact"], 0),
                ("diff", ["diff", "before", "--json"], 0),
                ("audit-extraction", ["audit-extraction"], 0),
                ("audit-mode", ["audit-mode"], 0), ("telemetry", ["telemetry"], 0),
                ("telemetry --mine", ["telemetry", "--mine"], 0),
                ("completions", ["completions"], 0), ("completions zsh", ["completions", "zsh"], 0),
                ("convert", ["convert", "{docs}/kernels.html", "{docs}/scan.pdf",
                             "{docs}/notes.txt", "--out", "converted"], 0),
                ("hook", ["hook"], 0 if git else 1), ("hook --uninstall", ["hook", "--uninstall"], 0),
                ("context", ["context", "classify_query", "--lines", "2"], 0),
                ("blame", ["blame", "classify_query"], 0 if git else 1),
                ("reconstruct", ["reconstruct", "cqs_tpu/search/router.py"], 0),
                ("improve-docs", ["improve-docs", "--out", "{out}"], 0),
                ("doctor", ["doctor"], None), ("stale", ["stale"], 0)]
        for label, argv, want in host:
            if label == "stale":                      # one file edited since the index
                with open(proj / "cqs_tpu" / "search" / "router.py", "a") as f:
                    f.write("\n# edited after the index\n")
            rc, text, ms, launched = runs(argv, str(dev), 3)
            if label == "doctor":
                rows = text.splitlines()
                want = 1 if any(r.startswith("[FAIL]") for r in rows) else 0
                if dev.type == "cuda" and not (rows[0].startswith("[ok ] torch device")
                                               and name in rows[0]
                                               and rows[1].startswith("[ok ] cuda available")):
                    fail(f"commands: doctor does not report the card: {rows[:2]}")
                if any(r.startswith("[FAIL]") and "model" not in r
                       and (dev.type == "cuda" or "cuda" not in r) for r in rows):
                    fail(f"commands: doctor failed a row: {rows}")
            if rc != want:
                fail(f"commands: {label} exited {rc}, not {want}: {text[:300]}")
            if label == "stale" and "cqs_tpu/search/router.py" not in text:
                fail(f"commands: stale did not list the edited file: {text[:300]}")
            if label == "diff" and not last_json(text)["results"]:
                fail("commands: diff against the slot before summaries found no change")
            if label == "convert" and not (proj / "converted" / "scan.md").is_file():
                fail("commands: convert wrote no scan.md")
            res["host"][label] = {"rc": rc, "ms": ms, "launches": launched}
            report(f"{label} (rc {rc})", ms, launched, " in 3 runs")
    res["s"] = time.perf_counter() - t_rest
    print(f"commands: the last 22 commands took {res['s']:.1f} s; {smi}")
    return res


# -- phase 10: the sparse-only API and the CPU serving mirror --------------------

#: rows of the host phase's sparse corpus: past ``sparse_scores_batch``'s
#: 65,536-row tile, so its tiled path runs on the card
HOST_SPARSE_ROWS = 70000
#: rows of the synthetic index the host mirror runs at (a daemon-sized corpus)
HOST_MIRROR_ROWS = 65536
#: the host phase's time limit, seconds
HOST_PHASE_S = 60.0


def cpu_model() -> str:
    """The host CPU as far as this machine tells it: ``/proc/cpuinfo``'s
    ``model name`` (else ``lscpu``'s) where it is not "unknown", its vendor,
    family, model and stepping numbers, the vector ISA torch dispatches to,
    and the core count."""
    import platform

    import torch

    fields: dict = {}
    try:
        for ln in Path("/proc/cpuinfo").read_text().splitlines():
            k, _, v = ln.partition(":")
            fields.setdefault(k.strip().lower(), v.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if name.lower() in ("", "unknown") and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                     if ln.lower().startswith("model name")), "")
    parts = [name if name.lower() not in ("", "unknown") else "model name not reported"]
    if fields.get("vendor_id"):
        parts.append(f"{fields['vendor_id']} family {fields.get('cpu family', '?')} model "
                     f"{fields.get('model', '?')} stepping {fields.get('stepping', '?')}")
    parts.append(f"{platform.machine()} {torch.backends.cpu.get_cpu_capability()}")
    return ", ".join(parts) + f", {os.cpu_count()} cores"


def same_rows_or_ties(got_rows, got_vals, want_rows, want_vals, label: str,
                      rtol: float, atol: float) -> int:
    """Rows equal slot for slot, except where both sides' values there are a
    near-tie (within ``atol + rtol * |v|``, a tie broken by the last bits of
    a sum taken in another order); values within the same tolerance.
    Returns the number of slots whose rows differ."""
    import numpy as np

    swapped = 0
    for i in range(len(want_rows)):
        a, b = float(got_vals[i]), float(want_vals[i])
        if abs(a - b) > atol + rtol * abs(b):
            fail(f"{label}: slot {i}: value {a} against {b}")
        if got_rows[i] != want_rows[i]:
            # the two rows must hold near-equal values in the reference run
            j = np.flatnonzero(np.asarray(want_rows) == got_rows[i])
            if not len(j) or abs(float(want_vals[j[0]]) - b) > atol + rtol * abs(b):
                fail(f"{label}: slot {i}: row {got_rows[i]} against {want_rows[i]}")
            swapped += 1
    return swapped


def host_sparse_api(torch, dev, rng, out: dict) -> None:
    """The sparse-only API on the card against the same calls on the CPU:
    ``SpladeIndex.search`` (rows equal but for near-ties, scores within rtol
    1e-5 / atol 1e-6), ``sparse_scores_batch`` over 70,000 rows (two of its
    65,536-row tiles; same tolerance), ``build_doc_sketch_device`` against
    the host ``build_doc_sketch`` rounded to bf16 (one bf16 ulp)."""
    import numpy as np

    from cqs_tpu_torch.index import SpladeIndex, Stamp
    from cqs_tpu_torch.ops import sparse as sp

    n, t, v, s, b = HOST_SPARSE_ROWS, 64, 32768, 1024, 8
    doc_ids = rng.integers(4, v, size=(n, t), dtype=np.int32)
    doc_w = np.log1p(rng.integers(1, 6, size=(n, t))).astype(np.float32)
    doc_w[:, 48:] = 0.0                               # zero-weight padding terms
    ids = [f"r{i}" for i in range(n)]
    stamp = Stamp(model_fingerprint="synthetic", dim=256, chunk_count=n, generation=0)
    t0 = time.perf_counter()
    card = SpladeIndex(ids, doc_ids, doc_w, v, stamp, device=dev, sketch_dim=s)
    host = SpladeIndex(ids, doc_ids, doc_w, v, stamp, device="cpu", sketch_dim=s)
    build_s = time.perf_counter() - t0
    qrows = rng.choice(n, size=b, replace=False)
    q_ids = np.ascontiguousarray(doc_ids[qrows, :16])
    q_w = np.log1p(np.arange(16, 0, -1, dtype=np.float32))
    swapped = 0
    t0 = time.perf_counter()
    for i in range(b):
        cv, cr = card.search(q_ids[i], q_w, 10)
        hv, hr = host.search(q_ids[i], q_w, 10)
        if cr[0] != qrows[i]:
            fail(f"host: SpladeIndex.search on the card did not find row {qrows[i]} first")
        swapped += same_rows_or_ties(cr, cv, hr, hv, f"host: SpladeIndex.search query {i}",
                                     1e-5, 1e-6)
    search_ms = (time.perf_counter() - t0) * 1e3 / b
    qv_card = torch.stack([sp.query_to_dense(torch.from_numpy(q_ids[i]).to(dev),
                                             torch.from_numpy(q_w).to(dev), v)
                           for i in range(b)])
    got = sp.sparse_scores_batch(qv_card, card.doc_ids, card.doc_w, card.mask)
    want = sp.sparse_scores_batch(qv_card.cpu(), host.doc_ids, host.doc_w, host.mask)
    got = got.cpu().numpy()
    want = want.numpy()
    if got.shape != (b, card.capacity) or card.capacity <= 65536:
        fail(f"host: sparse_scores_batch shape {got.shape} does not cross a 65,536-row tile")
    valid = want > -1e30
    err = float(np.abs(got[valid] - want[valid]).max())
    if not np.array_equal(got > -1e30, valid) or not np.allclose(got[valid], want[valid],
                                                               rtol=1e-5, atol=1e-6):
        fail(f"host: sparse_scores_batch on the card differs from the CPU's (max {err:.3e})")
    sk = sp.build_doc_sketch_device(card.doc_ids[:n], card.doc_w[:n], s).float().cpu()
    ref = torch.from_numpy(sp.build_doc_sketch(doc_ids, doc_w, s)).to(torch.bfloat16).float()
    sk_eq = float((sk == ref).float().mean())
    if not torch.allclose(sk, ref, rtol=2.0 ** -8, atol=0):
        fail("host: build_doc_sketch_device on the card is not within one bf16 ulp of the "
             "host build")
    out["sparse_api"] = {"rows": n, "capacity": card.capacity, "build_s": build_s,
                         "search_ms": search_ms, "search_swapped_ties": swapped,
                         "scores_batch_max_err": err, "sketch_equal_share": sk_eq}
    print(f"host: sparse API on the card == the CPU: SpladeIndex.search over {n} rows "
          f"({b} queries, {swapped} near-tie swaps, {search_ms:.2f} ms a query on the card), "
          f"sparse_scores_batch over {card.capacity} rows (max |diff| {err:.2e}), "
          f"build_doc_sketch_device == host build in bf16 for {sk_eq:.6f} of entries "
          f"(the rest within one ulp)")


def mirror_inputs(w, csr: bool) -> dict:
    """``hybrid_query_host``'s index-side arguments from workload ``w``'s
    indexes (their host views, copied off the card once)."""
    mat_h, mask_h = w.dense.host_view()
    if csr:
        return dict(matrix=mat_h, doc_ids=None, doc_w=None, sketch=None, valid_mask=mask_h,
                    csr=w.sparse.host_csr(), mat_bf16=w.dense.host_bf16())
    ids_h, w_h, sk_h = w.sparse.host_view()
    return dict(matrix=mat_h, doc_ids=ids_h, doc_w=w_h, sketch=sk_h, valid_mask=mask_h,
                mat_bf16=w.dense.host_bf16())


def exact_program(torch, w, alphas, pool: int):
    """The card's hybrid program on its exact branch (materialised [B, N]
    scores, each leg's stable top-pool; the branch the reference's program
    takes on a CPU backend) for workload ``w``'s queries."""
    from cqs_tpu_torch.search import program

    qm = w.q_dense.to(torch.bfloat16)
    qsk = program._query_sketch(w.q_ids_t, w.q_w_t, w.s).to(torch.bfloat16)
    r, dc = program._exact_candidates(w.dense.matrix, w.sparse.sketch, w.dense.mask, qm, qsk,
                                      pool)
    return program._exact_rescore_fuse(w.packed, None, w.dense.mask, w.q_ids_t, w.q_w_t,
                                       alphas, r.to(torch.int32), dc, pool, w.v)


def host_mirror_program(torch, dev, seed: int, smi: str, cpu: str, out: dict) -> None:
    """The host mirror on this machine's CPU at 65,536 rows against the
    card's program. Against the card's program on its exact branch
    (:func:`exact_program`, 2,048 rows, pool = every row) the mirror holds
    the reference's pins, at ``host_sparse_csr`` 0 and 1: the same valid
    rows, the same top 10, values within rtol 2e-4 / atol 1e-5. At 65,536
    rows (32 tiles) the card's program takes per-tile candidates and the
    mirror each leg's global top-pool, so rows both return are held to
    their exact legs (``LEG_PINS``), the top-10 agreement is printed, and
    in csr mode the best exact-sparse row (scored on the card by
    ``sparse_scores``) must be among the mirror's candidates
    (alpha 0.1). Then solo (B=1) times on the CPU: the mirror, csr and
    sketch, against the device program on the CPU (its plain scans)."""
    import numpy as np

    from cqs_tpu_torch.ops import sparse as sp
    from cqs_tpu_torch.search import program

    NEG = program.NEG
    for n, pool in ((2048, 2048), (HOST_MIRROR_ROWS, 500)):
        w = scale_workload(torch, dev, np.random.default_rng(seed + 3), n, 8)
        q_h = program.bf16_round(w.q)
        q_ids, q_w = w.q_ids_t.cpu().numpy(), w.q_w_t.cpu().numpy()
        for alpha in (0.8, 0.1):
            alphas = torch.full((8,), alpha, device=dev)
            if n == 2048:
                card = [x.cpu().numpy() for x in exact_program(torch, w, alphas, pool)]
            else:
                card = [x.cpu().numpy() for x in program.hybrid_query_batch(
                    w.dense.matrix, w.packed, None, w.sparse.sketch, w.dense.mask, w.q_dense,
                    w.q_ids_t, w.q_w_t, alphas, pool, w.v, extraction=w.ext)]
            for csr in (True, False):
                label = f"host: mirror at {n} rows, pool {pool}, csr {int(csr)}, alpha {alpha}"
                host = program.hybrid_query_host(
                    q_dense=q_h, q_ids=q_ids, q_w=q_w, alphas=alphas.cpu().numpy(), pool=pool,
                    vocab_size=w.v, **mirror_inputs(w, csr))
                agree = []
                for b in range(8):
                    cv, hv = card[0][b] > -1e30, host[0][b] > -1e30
                    if n == 2048:
                        # one tile: the card's exact branch over every row
                        if set(card[1][b][cv].tolist()) != set(host[1][b][hv].tolist()):
                            fail(f"{label}: query {b}: valid row sets differ")
                        same_rows_or_ties(host[1][b][:10], host[0][b][:10], card[1][b][:10],
                                          card[0][b][:10], f"{label}: query {b}",
                                          2e-4, 1e-5)
                    at = {r: j for j, r in enumerate(card[1][b][cv].tolist())}
                    shared = [(j, at[r]) for j, r in enumerate(host[1][b][hv].tolist())
                              if r in at]
                    if not shared:
                        fail(f"{label}: query {b}: no row in both pools")
                    for leg, k in (("dense", 2), ("sparse", 3)):
                        rtol, atol = LEG_PINS[leg]
                        x = np.asarray([host[k][b][j] for j, _ in shared])
                        y = np.asarray([card[k][b][i] for _, i in shared])
                        both = (x > NEG / 2) & (y > NEG / 2)
                        if not np.array_equal(x > NEG / 2, y > NEG / 2) or not np.allclose(
                                x[both], y[both], rtol=rtol, atol=atol):
                            fail(f"{label}: query {b}: the {leg} leg of a shared row differs")
                    agree.append(len(set(host[1][b][:10]) & set(card[1][b][:10])) / 10)
                    if csr and alpha == 0.1:
                        qv = sp.query_to_dense(w.q_ids_t[b], w.q_w_t[b], w.v)
                        s_true = sp.sparse_scores(qv, w.packed[:, :w.t],
                                                  w.packed[:, w.t:].contiguous().view(
                                                      torch.float32), w.dense.mask)
                        best = int(torch.argmax(s_true))
                        if float(s_true[best]) > 0 and best not in set(host[1][b][hv].tolist()):
                            fail(f"{label}: query {b}: the best exact-sparse row {best} is "
                                 "not a candidate")
                out.setdefault("mirror_vs_card", {})[f"{n}/{pool}/csr{int(csr)}/a{alpha}"] = \
                    float(np.mean(agree))
        print(f"host: mirror at {n} rows, pool {pool} == the card's program to the "
              + ("reference's pins (exact branch: every row a candidate); " if n == 2048 else
                 "legs of every shared row (per-tile candidates on the card); ")
              + "top-10 agreement " + ", ".join(
                  f"{k.split('/', 2)[2]} {v:.3f}" for k, v in out["mirror_vs_card"].items()
                  if k.startswith(f"{n}/")))
    # solo times on the CPU at 65,536 rows: the mirror (csr, sketch) and the
    # device program on CPU tensors (the engine's B=1 call of each)
    cpu_arrays = (w.dense.matrix.cpu(), w.packed.cpu(), None, w.sparse.sketch.cpu(),
                  w.dense.mask.cpu())
    times: dict = {"mirror csr 1": [], "mirror csr 0": [], "device program": []}
    views = {True: mirror_inputs(w, True), False: mirror_inputs(w, False)}
    for rnd in range(2):
        order = list(times) if rnd == 0 else list(reversed(times))
        for name in order:
            for b in range(8):
                t0 = time.perf_counter()
                if name == "device program":
                    program.hybrid_query(*cpu_arrays, w.q_dense[b].cpu(), w.q_ids_t[b].cpu(),
                                         w.q_w_t[b].cpu(), 0.8, 500, w.v)
                else:
                    program.hybrid_query_host(
                        q_dense=q_h[b:b + 1], q_ids=q_ids[b:b + 1], q_w=q_w[b:b + 1],
                        alphas=np.asarray([0.8], np.float32), pool=500, vocab_size=w.v,
                        **views[name == "mirror csr 1"])
                times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    out["cpu_solo_ms_65536"] = med
    print(f"host: solo hybrid query on the CPU at {HOST_MIRROR_ROWS} rows (median of 16, host "
          "clock): " + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
          + f"; CPU: {cpu}; torch threads {torch.get_num_threads()}; {smi}")


def host_engine_routes(torch, dev, smi: str, cpu: str, out: dict) -> None:
    """The engine's routes on the repository corpus: a CUDA engine's solo
    searches and a batcher burst make no host-mirror call and launch the
    split kernel; a ``--device cpu`` CLI search makes at least one and
    launches no kernel; a CPU batcher burst serves through the mirror.
    Then solo ``engine.search`` on the CPU, in turns: the mirror at
    ``host_sparse_csr`` 1 and 0 against the device programs on the CPU."""
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.daemon.batcher import QueryBatcher
    from cqs_tpu_torch.ops.topk import IMPLS, LOOP_SPLIT

    tmp = Path(tempfile.mkdtemp(prefix="cqs_host_"))
    try:
        proj = tmp / "corpus"
        proj.mkdir()
        copy_corpus(proj)
        rc, env, ms = run_cli(main, ["index", "--path", str(proj), "--device", str(dev),
                                     "--json"])
        if rc != 0 or env is None:
            fail(f"host: index exited {rc}")
        out["index_s"] = ms / 1e3
        with mirror_calls() as calls:
            before = LOOP_SPLIT.launches
            ctx = CommandContext.create(str(proj), device=dev)
            try:
                for q in QUERIES:
                    if not ctx.engine.search(q).hits:
                        fail(f"host: the card's search {q!r} has no hits")
                batcher = QueryBatcher(ctx.engine)
                try:
                    batcher.pause()
                    futs = [batcher.submit(q + " again") for q in QUERIES[:8]]
                    batcher.resume()
                    [f.result(timeout=120) for f in futs]
                finally:
                    batcher.stop()
            finally:
                ctx.close()
            card_calls = dict(calls)
            if dev.type == "cuda" and sum(card_calls.values()):
                fail(f"host: a CUDA engine called the host mirror: {card_calls}")
            if dev.type == "cuda" and LOOP_SPLIT.launches <= before:
                fail(f"host: the card's searches did not launch {LOOP_SPLIT.name}")
            launched = sum(k.launches for k in IMPLS)
            rc, env, cli_ms = run_cli(main, [QUERIES[0], "--path", str(proj), "--device", "cpu",
                                             "--json"])
            if rc != 0 or env is None or not env["results"]:
                fail(f"host: a --device cpu search exited {rc} or found nothing")
            cli_calls = {k: v - card_calls[k] for k, v in calls.items()}
            if cli_calls["hybrid_query_host"] < 1:
                fail(f"host: a --device cpu search made no host-mirror call: {cli_calls}")
            if sum(k.launches for k in IMPLS) != launched:
                fail("host: a --device cpu search launched a kernel")
            ctx = CommandContext.create(str(proj), device="cpu")
            try:
                batcher = QueryBatcher(ctx.engine)
                try:
                    batcher.pause()
                    futs = [batcher.submit(q) for q in QUERIES[:8]]
                    batcher.resume()
                    [f.result(timeout=120) for f in futs]
                finally:
                    batcher.stop()
            finally:
                ctx.close()
            batch_calls = calls["hybrid_query_host"] - card_calls["hybrid_query_host"] \
                - cli_calls["hybrid_query_host"]
            if batch_calls < 1 or batcher.stats["fused"] != 8:
                fail(f"host: the CPU batcher did not serve through the mirror "
                     f"({batch_calls} calls, {batcher.stats})")
        out["calls"] = {"card": card_calls, "cpu_cli": cli_calls, "cpu_batcher": batch_calls}
        print(f"host: a CUDA engine's {len(QUERIES)} searches and 8-query burst made "
              f"{sum(card_calls.values())} host-mirror calls; a --device cpu CLI search made "
              f"{cli_calls['hybrid_query_host']} and launched no kernel ({cli_ms:.1f} ms); the "
              f"CPU batcher's burst {batch_calls} call(s)")
        # solo engine.search on the CPU, in turns, each engine fresh (its
        # result cache empty) after one pass that fills the query-embedding cache
        ctx = CommandContext.create(str(proj), device="cpu")
        try:
            for q in QUERIES:
                ctx.engine.search(q)
        finally:
            ctx.close()
        routes = {"mirror csr 1": ("1", True), "mirror csr 0": ("0", True),
                  "device program": ("1", False)}
        ms = {k: [] for k in routes}
        dev_ms = {k: [] for k in routes}
        for rnd in range(2):
            for name in (list(routes) if rnd == 0 else list(reversed(routes))):
                csr, mirror = routes[name]
                with knobs({"CQST_HOST_SPARSE_CSR": csr}):
                    ctx = CommandContext.create(str(proj), device="cpu")
                    try:
                        ctx.engine.host_mirror = mirror
                        for q in QUERIES:
                            res = ctx.engine.search(q)
                            ms[name].append(res.elapsed_ms)
                            dev_ms[name].append(res.meta["device_ms"])
                    finally:
                        ctx.close()
        med = {k: (statistics.median(ms[k]), statistics.median(dev_ms[k])) for k in routes}
        out["cpu_engine_search_ms"] = med
        print(f"host: solo engine.search on the CPU, repository corpus (median of "
              f"{2 * len(QUERIES)}, host clock; program part in brackets): "
              + ", ".join(f"{k} {a:.2f} ms ({b:.2f})" for k, (a, b) in med.items())
              + f"; CPU: {cpu}; torch threads {torch.get_num_threads()}; {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_host(torch, dev, seed: int, report, smi: str) -> None:
    """The sparse-only API on the card against the CPU, the host mirror on
    this machine's CPU against the card's program, and the engine's routes
    (a CUDA engine never calls the mirror; a CPU one serves through it),
    with the CPU's times. At most ``HOST_PHASE_S`` seconds."""
    import numpy as np

    t0 = time.perf_counter()
    out: dict = {"cpu": cpu_model()}
    host_sparse_api(torch, dev, np.random.default_rng(seed + 2), out)
    host_mirror_program(torch, dev, seed, smi, out["cpu"], out)
    host_engine_routes(torch, dev, smi, out["cpu"], out)
    out["phase_s"] = time.perf_counter() - t0
    report["host"] = out
    print(f"host: the phase took {out['phase_s']:.1f} s of its {HOST_PHASE_S:.0f}; {smi}")
    if out["phase_s"] > HOST_PHASE_S:
        fail(f"the host phase took {out['phase_s']:.1f} s, over its {HOST_PHASE_S:.0f} s")


# -- phase 5: a 1M-row index at the hash tier's widths --------------------------

def top10_agreement(got, ref) -> float:
    """Mean share of each query's exact top-10 rows found in its top-10."""
    import numpy as np

    return float(np.mean([len(set(g.tolist()) & set(r.tolist())) / 10
                          for g, r in zip(got[:, :10].cpu(), ref[:, :10].cpu())]))


def scale_workload(torch, dev, rng, n: int = SCALE_ROWS, b: int = 128):
    """The scale phase's workload: a synthetic n-row index at the hash
    tier's widths (D=256, T=256, S=1024, vocab 32768, pool 500) and b
    queries near indexed rows, all drawn from ``rng`` in a fixed order, the
    index's int8 copies, and the bf16, q8 and sk8 programs over queries i:j
    as the engine calls them. ``scripts/torch_ab.py`` runs this workload in
    turns on two checkouts. Returns a namespace."""
    import types

    import numpy as np

    from cqs_tpu_torch.index import DenseIndex, SpladeIndex, Stamp
    from cqs_tpu_torch.search import program
    from cqs_tpu_torch.search.engine import bf16_extraction

    d, t, s, v, pool = 256, 256, 1024, 32768, 500
    t0 = time.perf_counter()
    mat = rng.standard_normal((n, d), dtype=np.float32)
    doc_ids = rng.integers(4, v, size=(n, t), dtype=np.int32)
    nnz = rng.integers(32, t + 1, size=n)
    doc_w = np.log1p(rng.integers(1, 6, size=(n, t))).astype(np.float32)
    doc_w[np.arange(t)[None, :] >= nnz[:, None]] = 0.0
    gen_s = time.perf_counter() - t0
    ids = [f"r{i}" for i in range(n)]
    stamp = Stamp(model_fingerprint="synthetic", dim=d, chunk_count=n, generation=0)
    t0 = time.perf_counter()
    dense = DenseIndex(ids, mat, stamp, device=dev)
    t1 = time.perf_counter()
    sparse = SpladeIndex(ids, doc_ids, doc_w, v, stamp, device=dev, sketch_dim=s)
    t2 = time.perf_counter()
    packed = sparse.packed_terms()
    dense_i8, sketch_i8 = dense.dense_i8(), sparse.sketch_i8()

    rows = rng.choice(n, size=b, replace=False)
    q = mat[rows] / np.linalg.norm(mat[rows], axis=1, keepdims=True)
    q = (q + 0.5 * rng.standard_normal((b, d), dtype=np.float32) / np.sqrt(d)).astype(np.float32)
    q_ids = np.ascontiguousarray(doc_ids[rows, :16])
    q_w = np.log1p(np.arange(16, 0, -1, dtype=np.float32))[None, :].repeat(b, 0)
    q_dense = torch.from_numpy(q).to(dev)
    q_ids_t, q_w_t = torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev)
    alphas = torch.full((b,), 0.8, device=dev)
    arrays = (dense.matrix, packed, None, sparse.sketch, dense.mask)
    ext = bf16_extraction(dense.capacity, b)

    def qs(i, j):
        return q_dense[i:j], q_ids_t[i:j], q_w_t[i:j], alphas[i:j]

    def bf16(i, j):
        if j - i == 1:
            out = program.hybrid_query(*arrays, q_dense[i], q_ids_t[i], q_w_t[i], 0.8, pool, v,
                                       extraction=bf16_extraction(dense.capacity, 1))
            return tuple(x[None] for x in out)
        return program.hybrid_query_batch(*arrays, *qs(i, j), pool, v, extraction=ext)

    def q8(i, j):      # the engine's knobs: scan_extraction "grouped" at every B
        return program.hybrid_query_batch_q8(dense.matrix, dense_i8, packed, None, sketch_i8,
                                             dense.mask, *qs(i, j), pool, v)

    def sk8(i, j):
        return program.hybrid_query_batch_sk8(dense.matrix, packed, None, sketch_i8,
                                              dense.mask, *qs(i, j), pool, v)

    return types.SimpleNamespace(
        n=n, b=b, d=d, t=t, s=s, v=v, pool=pool, q=q, dense=dense, sparse=sparse, packed=packed,
        dense_i8=dense_i8, sketch_i8=sketch_i8, q_dense=q_dense, q_ids_t=q_ids_t, q_w_t=q_w_t,
        alphas=alphas, ext=ext, programs={"bf16": bf16, "q8": q8, "sk8": sk8},
        gen_s=gen_s, dense_s=t1 - t0, sparse_s=t2 - t1)


def exact_rows(torch, w, bq: int):
    """Rows of the exact bf16 program (materialised [B, N] scores, stable
    top-pool) for the first ``bq`` queries of workload ``w``."""
    from cqs_tpu_torch.search import program

    qm = w.q_dense[:bq].to(torch.bfloat16)
    qsk = program._query_sketch(w.q_ids_t[:bq], w.q_w_t[:bq], w.s).to(torch.bfloat16)
    r, dc = program._exact_candidates(w.dense.matrix, w.sparse.sketch, w.dense.mask, qm, qsk,
                                      w.pool)
    return program._exact_rescore_fuse(w.packed, None, w.dense.mask, w.q_ids_t[:bq],
                                       w.q_w_t[:bq], w.alphas[:bq], r.to(torch.int32), dc,
                                       w.pool, w.v)[1]


def screened_program(torch, w, mode: str = "int8"):
    """Build workload ``w``'s dense screen (``screen_mode`` int8 or proj,
    default knobs otherwise) and return (the screened program over queries
    i:j, build seconds). The screen stays on ``w.dense`` until it is built
    again."""
    import numpy as np

    from cqs_tpu_torch.search import program

    with knobs({"CQST_SCREEN_ENABLE": "1", "CQST_SCREEN_MODE": mode,
                "CQST_SCREEN_MIN_ROWS": str(min(w.n, 131072))}):   # the default at 1M
        t0 = time.perf_counter()
        w.dense._build_screen()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    if w.dense.screen is None:
        fail(f"no {mode} screen at {w.n} rows")
    q_scr = torch.from_numpy(np.stack([w.dense.project_query(x) for x in w.q])).to(
        w.q_dense.device)
    mini = w.sparse.sketch_mini(128)

    def screened(i, j):
        return program.hybrid_query_screened(
            w.dense.matrix, w.dense.screen, w.packed, None, mini, w.dense.mask, w.q_dense[i:j],
            q_scr[i:j], w.q_ids_t[i:j], w.q_w_t[i:j], w.alphas[i:j], w.pool, 4096, w.v,
            w.s // 128, 4)
    return screened, build_s


# -- each program's whole pool against the plain twins' program -----------------

@contextlib.contextmanager
def recorded_scans(plain: bool, record: bool = True):
    """Within the block every scan of a program (stage 1 of ``scan_topk``)
    is recorded as (index, queries, mask, tile, vals, rows) unless
    ``record`` is false, and with ``plain`` it runs the plain twin on the
    card in the kernel's place. The package itself never makes that choice:
    this swaps the function here."""
    from cqs_tpu_torch.ops import topk

    real, log = topk.scan_tiles, []

    def scan_tiles(index, queries, mask, tile_n, m, grouped):
        if plain:
            twin = topk.scan_topk_plain_grouped if grouped else topk.scan_topk_plain_loop
            vals, rows = twin(index, queries, mask, tile_n, m)
        else:
            vals, rows = real(index, queries, mask, tile_n, m, grouped)
        if record:
            log.append((index, queries, mask, tile_n, vals, rows))
        return vals, rows

    topk.scan_tiles = scan_tiles
    try:
        yield log
    finally:
        topk.scan_tiles = real


def near(a: float, b: float) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def tied_with_a_candidate(log, qi: int, row: int) -> bool:
    """Whether ``row``'s score in one of the recorded scans lies within the
    tolerance of a candidate that scan selected in the row's tile: the row
    missed (or won) its place by a near-tie."""
    from cqs_tpu_torch.ops import topk

    for index, queries, mask, tile_n, vals, _ in log:
        if qi >= queries.shape[0] or row >= index.shape[0] or int(mask[row]) == 0:
            continue
        score = float(topk._scores(index[row:row + 1], queries[qi:qi + 1], None)[0, 0])
        picked = vals[row // tile_n, qi]
        if any(near(score, float(c)) for c in picked[picked > -1e30].tolist()):
            return True
    return False


def pool_check(torch, label: str, run) -> dict:
    """One program run with the hand-written kernels and once more with
    their plain twins, on the same inputs: the two pools (rows and fused
    scores, every slot) must agree. A row in both pools has fused scores
    within rtol 1e-5 / atol 1e-6. A row in one pool only must owe that to a
    near-tie: its scan score within the same tolerance of a candidate that
    the other run's scan picked in its tile, or its fused score within it of
    the other pool's last slot. Anything else fails the run. Returns the
    counts."""
    with recorded_scans(plain=False) as k_log:
        k_fused, k_rows = (x.cpu().numpy() for x in run()[:2])
    with recorded_scans(plain=True) as p_log:
        p_fused, p_rows = (x.cpu().numpy() for x in run()[:2])
    if not k_log or len(k_log) != len(p_log):
        fail(f"pool[{label}]: {len(k_log)} kernel scans against {len(p_log)} twin scans")
    if k_fused.shape != p_fused.shape:
        fail(f"pool[{label}]: pool shapes {k_fused.shape} and {p_fused.shape}")
    slots = same = strays = 0
    worst = 0.0
    for qi in range(k_fused.shape[0]):
        kp = {int(r): float(f) for r, f in zip(k_rows[qi], k_fused[qi]) if f > -1e30}
        pp = {int(r): float(f) for r, f in zip(p_rows[qi], p_fused[qi]) if f > -1e30}
        if not pp:
            fail(f"pool[{label}]: query {qi}: the twins' pool is empty")
        slots += len(pp)
        same += int(((k_rows[qi] == p_rows[qi]) & (p_fused[qi] > -1e30)).sum())
        for row in kp.keys() & pp.keys():
            worst = max(worst, abs(kp[row] - pp[row]))
            if not near(kp[row], pp[row]):
                fail(f"pool[{label}]: query {qi} row {row}: fused {kp[row]!r} with the "
                     f"kernels, {pp[row]!r} with the twins")
        for mine, other, other_log, who in ((kp, pp, p_log, "kernels"), (pp, kp, k_log, "twins")):
            tail = min(other.values()) if other else 0.0
            for row in mine.keys() - other.keys():
                strays += 1
                if not (near(mine[row], tail) or tied_with_a_candidate(other_log, qi, row)):
                    fail(f"pool[{label}]: query {qi}: row {row} (fused {mine[row]!r}) is in "
                         f"the pool of the {who} only, and no near-tie explains it")
    return {"queries": int(k_fused.shape[0]), "slots": slots, "same_slot_rows": same,
            "rows_in_one_pool_only": strays, "max_fused_diff": worst}


def pool_checks(torch, w, report_key: str, report, b1_queries: int = 4) -> None:
    """:func:`pool_check` for the bf16, q8, sk8 and screened (int8 screen)
    programs of workload ``w``: ``b1_queries`` calls at B=1 (summed on one
    line) and, where the program batches, one call at the workload's B."""
    def b1(name, fn):
        runs = [pool_check(torch, f"{name}, {w.n} rows, B=1, query {i}",
                           lambda: fn(i, i + 1)) for i in range(b1_queries)]
        out = {k: sum(r[k] for r in runs) for k in runs[0] if k != "max_fused_diff"}
        out["max_fused_diff"] = max(r["max_fused_diff"] for r in runs)
        return out

    screened, _ = screened_program(torch, w, "int8")
    out = {"screened_b1": b1("screened", screened)}
    w.dense._build_screen()                      # knobs restored: no screen
    for name, fn in w.programs.items():
        out[f"{name}_b1"] = b1(name, fn)
        out[f"{name}_b{w.b}"] = pool_check(torch, f"{name}, {w.n} rows, B={w.b}",
                                           lambda: fn(0, w.b))
    for label, r in sorted(out.items()):
        print(f"pool[{w.n} rows, {label}]: kernels against plain twins, {r['queries']} "
              f"queries, {r['slots']} slots: {r['same_slot_rows']} hold the same row, "
              f"{r['rows_in_one_pool_only']} rows in one pool only (each a near-tie), max "
              f"|fused diff| on shared rows {r['max_fused_diff']:.3g} (rtol {RTOL}, atol {ATOL})")
    report[report_key] = out


def phase_daemon(torch, dev, seed: int, report, n: int = 65536, b: int = 64):
    """A daemon-sized corpus: the bf16 batch program at B=64 on ``n`` rows,
    below the 131,072 rows at which batches turn grouped, so both scans run
    the split loop kernel (per-tile k 32). Wall (CUDA events) beside
    device-busy (``torch.profiler``), and top-10 agreement with the exact
    program. Own generator."""
    import numpy as np

    from cqs_tpu_torch.ops.topk import LOOP_SPLIT

    w = scale_workload(torch, dev, np.random.default_rng(seed + 1), n, b)
    if w.ext != "loop":
        fail(f"B={b} at {n} rows did not select the loop kernel ({w.ext})")
    before = LOOP_SPLIT.launches
    fn = w.programs["bf16"]
    wall = cuda_ms(lambda: fn(0, b), 20)
    busy, by_kernel, _, _ = device_busy(torch, lambda: fn(0, b), 5)
    if dev.type == "cuda" and LOOP_SPLIT.launches <= before:
        fail(f"the B={b} batch at {n} rows did not launch {LOOP_SPLIT.name}")
    scans = {k: x for k, x in by_kernel.items() if "loop_split" in k or "merge_slices" in k}
    agree = top10_agreement(fn(0, b)[1], exact_rows(torch, w, b))
    print(f"daemon: {n} rows, bf16 batch B={b}: wall {wall:.4f} ms (CUDA events), device-busy "
          f"{busy:.4f} ms, of it the split scans {sum(scans.values()):.4f} ms; top-10 "
          f"agreement {agree:.4f}")
    if agree < 0.9:
        fail("daemon-sized bf16 top-10 agreement with the exact scan below 0.9")
    report["daemon"] = {"n": n, "b": b, "wall_ms": wall, "device_busy_ms": busy,
                        "scan_busy_ms": scans, "agree_top10": agree}
    pool_checks(torch, w, "daemon_pools", report)


def phase_scale(torch, dev, rng, report, n: int = SCALE_ROWS):
    from cqs_tpu_torch.ops.topk import scan_topk, topk_plain
    from cqs_tpu_torch.search import program

    w = scale_workload(torch, dev, rng, n)
    dense, sparse, packed, pool, s, b = w.dense, w.sparse, w.packed, w.pool, w.s, w.b
    q_dense = w.q_dense
    torch.cuda.synchronize()
    gb = sum(x.numel() * x.element_size() for x in
             (dense.matrix, sparse.doc_ids, sparse.doc_w, sparse.sketch, packed)) / 1e9
    print(f"scale: {n} rows, D={w.d}, T={w.t}, S={s}: data {w.gen_s:.1f} s, dense index "
          f"{w.dense_s:.1f} s, sparse index incl. host sketch build {w.sparse_s:.1f} s; "
          f"{gb:.2f} GB on the device")

    nq = 16
    ptk, ran = program.scan_geometry(n, pool, 2048, w.ext)
    if n >= 131072 and ran != "grouped":
        fail(f"B={b} at {n} rows did not select the grouped kernel ({ran})")

    # the int8 copies a q8/sk8 engine builds once per index generation
    q8_build_ms = cuda_ms(dense._int8_copy, 3)
    sk8_build_ms = cuda_ms(lambda: program.quantize_sketch(sparse.sketch), 3)
    dense_i8 = w.dense_i8

    ref_b, ref_1 = exact_rows(torch, w, b), exact_rows(torch, w, nq)

    def solo_rows(fn):
        return torch.cat([fn(i, i + 1)[1] for i in range(nq)])

    res = {}
    for name, fn in w.programs.items():
        res[name] = {"b1_ms": cuda_ms(lambda: fn(0, 1), 20),
                     "b128_ms": cuda_ms(lambda: fn(0, b), 10),
                     "agree_b1": top10_agreement(solo_rows(fn), ref_1),
                     "agree_b128": top10_agreement(fn(0, b)[1], ref_b)}

    # the screened B=1 program, int8 and proj screens (default screen knobs)
    for mode in ("int8", "proj"):
        screened, build_s = screened_program(torch, w, mode)
        res[f"screened_{mode}"] = {"b1_ms": cuda_ms(lambda: screened(0, 1), 20),
                                   "agree_b1": top10_agreement(solo_rows(screened), ref_1),
                                   "screen_build_s": build_s}
    dense._build_screen()                       # knobs restored: no screen

    # the widening kernels' entry point: scan_topk over the int8 rows with a
    # bf16 query (no program takes it), against the exact bf16 dense scan
    qbf = q_dense.to(torch.bfloat16)
    dense_ref = topk_plain(dense.matrix, qbf, 10, dense.mask)[1]
    for bq, extraction in ((1, "loop"), (b, "grouped")):
        def widen():
            return scan_topk(dense_i8, qbf[:bq], 10, mask=dense.mask, tile_n=2048,
                             per_tile_k=4, extraction=extraction)
        res[f"widen_b{bq}"] = {"ms": cuda_ms(widen, 20),
                               "agree_dense_top10": top10_agreement(widen()[1], dense_ref[:bq])}

    print(f"scale: int8 copies of the index: dense {q8_build_ms:.3f} ms, sketch "
          f"{sk8_build_ms:.3f} ms (CUDA events); per-tile k {ptk} at tile 2048")
    for name, r in res.items():
        print(f"scale: {name:14s} " + ", ".join(
            f"{k} {x:.4f}" if isinstance(x, float) else f"{k} {x}" for k, x in r.items()))
    print("scale: TPU history for comparison only (TPU v5e, docs/q8-serving.md): top-10 "
          "agreement q8 0.971, sk8 0.973")
    if min(res["bf16"]["agree_b1"], res["bf16"]["agree_b128"]) < 0.9:
        fail("bf16 top-10 agreement with the exact scan below 0.9")
    for name in ("q8", "sk8", "screened_int8"):
        if min(x for k, x in res[name].items() if k.startswith("agree")) < 0.8:
            fail(f"{name} top-10 agreement with the exact scan below 0.8")
    report["scale"] = {"device_gb": gb, "sketch_build_s": w.sparse_s, "ptk": ptk,
                       "dense_i8_ms": q8_build_ms, "sketch_i8_ms": sk8_build_ms, **res}
    pool_checks(torch, w, "scale_pools", report)


# -- phase 5b: mesh-sharded hybrid serving ---------------------------------------

#: the sharded corpus: docs/scale-10m.md's production geometry (768-d dense,
#: T 128 terms, sketch 1024, vocab 30522) at 1,048,576 rows in 4 logical
#: shards on the one card; 64 queries at the engine's pool and alpha 0.8
SHARD_GEOMETRY = {"n": SCALE_ROWS, "d": 768, "t": 128, "s": 1024, "v": 30522, "shards": 4,
                  "queries": 64, "pool": 500, "alpha": 0.8}
#: the kernels of the per-shard scans each placement launches (the split
#: kernels at m = pool 500): mode 0 bf16 dense and sketch, mode 1 int8 both,
#: mode 2 bf16 dense and int8 sketch
SHARD_SCANS = {0: ("scan_topk_loop_split", "scan_topk_loop_split"),
               1: ("scan_topk_loop_split_i8", "scan_topk_loop_split_i8"),
               2: ("scan_topk_loop_split", "scan_topk_loop_split_i8")}
#: the split kernel's and merge kernel's names in a profile (the template's
#: is ``scan_topk_kernel``)
SCAN_KERNEL_NAMES = ("loop_split_kernel", "merge_slices_kernel", "scan_topk_kernel")


def shard_row_bytes(mode: int, d: int, s: int, t: int) -> tuple[str, int]:
    """The resident bytes a row of each placement holds, by
    ``docs/scale-10m.md``'s budget: (formula, bytes)."""
    return [("2D + 2S + 8T", 2 * d + 2 * s + 8 * t), ("2D + D + S + 8T", 3 * d + s + 8 * t),
            ("2D + S + 8T", 2 * d + s + 8 * t)][mode]


def shard_corpus(torch, dev, seed: int, n: int, d: int, t: int, v: int, centers: int = 65536):
    """``scripts/validate_sharded_8m.py``'s clustered corpus (65,536
    centers, noise 0.3, uniform term ids, lognormal weights), drawn on the
    device from ``seed`` and brought to the host, where ``from_row_blocks``
    reads it block by block."""
    import numpy as np

    gen = torch.Generator(device=dev).manual_seed(seed + 31337)
    c = torch.randn(centers, d, device=dev, generator=gen)
    mat = np.empty((n, d), np.float32)
    step = 1 << 18
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        cid = torch.randint(0, centers, (hi - lo,), device=dev, generator=gen)
        mat[lo:hi] = (c[cid] + 0.3 * torch.randn(hi - lo, d, device=dev, generator=gen)).cpu()
    ids = torch.randint(0, v, (n, t), device=dev, generator=gen, dtype=torch.int32).cpu().numpy()
    w = torch.exp(0.8 * torch.randn(n, t, device=dev, generator=gen)).cpu().numpy()
    return mat, ids, w


@contextlib.contextmanager
def plain_shard_scans(log: list | None = None):
    """Within the block each shard's top-k runs the plain per-shard step
    (``topk_plain``: a full score vector and one stable top-k) in the
    kernel's place, on the card, each call recorded in ``log`` as (rows, q,
    vals). The package itself never makes that choice: this swaps the
    function here."""
    from cqs_tpu_torch.ops import topk
    from cqs_tpu_torch.parallel import mesh

    real = mesh.shard_topk

    def plain(rows, q, k, mask):
        v, r = topk.topk_plain(rows, q, k, mask)
        if log is not None:
            log.append((rows, q, v))
        return v, r

    mesh.shard_topk = plain
    try:
        yield
    finally:
        mesh.shard_topk = real


def shard_pool_check(torch, label: str, kernel_out, plain_out, log, n_shards: int,
                     n_s: int, pool: int) -> dict:
    """:func:`pool_check`'s rule for one sharded query: the kernels' pool
    against the plain per-shard step's. A row in both has fused scores
    within rtol 1e-5 / atol 1e-6; a row in one pool only must owe it to a
    near-tie: its fused score near the other pool's last slot, or one of
    its leg scores near that leg's pool boundary (the pool-th best over the
    shards, from ``log``, this query's 2 x N plain scans)."""
    from cqs_tpu_torch.ops import topk

    k_f, k_r = (x[0].cpu().numpy() for x in kernel_out[:2])
    p_f, p_r = (x[0].cpu().numpy() for x in plain_out[:2])
    kp = {int(r): float(f) for r, f in zip(k_r, k_f) if f > -1e30}
    pp = {int(r): float(f) for r, f in zip(p_r, p_f) if f > -1e30}
    if not pp:
        fail(f"shard pool[{label}]: the plain pool is empty")
    worst = 0.0
    for row in kp.keys() & pp.keys():
        worst = max(worst, abs(kp[row] - pp[row]))
        if not near(kp[row], pp[row]):
            fail(f"shard pool[{label}]: row {row}: fused {kp[row]!r} with the kernels, "
                 f"{pp[row]!r} plain")
    bounds = []
    for leg in range(2):
        vals = torch.cat([v for _, _, v in log[leg * n_shards:(leg + 1) * n_shards]], dim=1)
        bounds.append(float(torch.sort(vals[0], descending=True).values[pool - 1]))
    strays = 0
    for mine, other in ((kp, pp), (pp, kp)):
        tail = min(other.values()) if other else 0.0
        for row in mine.keys() - other.keys():
            strays += 1
            s, local = divmod(row, n_s)
            legs = [float(topk._scores(log[leg * n_shards + s][0][local:local + 1],
                                       log[leg * n_shards + s][1], None)[0, 0])
                    for leg in range(2)]
            if not (near(mine[row], tail) or any(near(x, b) for x, b in zip(legs, bounds))):
                fail(f"shard pool[{label}]: row {row} (fused {mine[row]!r}, leg scores "
                     f"{legs}, leg bounds {bounds}) is in one pool only, no near-tie")
    return {"slots": len(pp), "same_slot_rows": int(((k_r == p_r) & (p_f > -1e30)).sum()),
            "rows_in_one_pool_only": strays, "max_fused_diff": worst}


def same_topk(torch, index, q, mask, got, want, label: str, exact: bool) -> None:
    """A shard's top-k (vals, rows) against the plain step's: equal where
    the sums are exact (int8 x int8), else values within rtol/atol and a
    differing row only at a score near-tie (the rows' full f32 scores)."""
    (gv, gr), (wv, wr) = got, want
    if exact:
        if not (torch.equal(gv, wv) and torch.equal(gr, wr)):
            fail(f"{label}: the per-shard step differs from the plain step")
        return
    if not torch.allclose(gv, wv, rtol=RTOL, atol=ATOL):
        fail(f"{label}: per-shard step values differ from the plain step "
             f"(max |err| {(gv - wv).abs().max().item()})")
    diff = gr != wr
    if diff.any():
        full = torch.where(mask[None, :] > 0, q.float() @ index.float().T,
                           torch.full((q.shape[0], index.shape[0]), -3.0e38, device=q.device))
        b_idx = torch.arange(q.shape[0], device=q.device)[:, None].expand_as(gr)
        a = full[b_idx[diff], gr[diff].long()]
        c = full[b_idx[diff], wr[diff].long()]
        if not torch.all((a - c).abs() <= ATOL + RTOL * c.abs()):
            fail(f"{label}: {int(diff.sum())} rows of the per-shard step differ beyond a "
                 f"score near-tie")


def shard_inputs(torch, dev, gen, kind: str, n: int, d: int):
    """A shard's scan rows, a B=1 query and a mask (2% masked): bf16 random
    normal, or int8 x int8 full range."""
    if kind == "bf16":
        index = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
        q = torch.randn(1, d, device=dev, generator=gen).to(torch.bfloat16)
    else:
        index = torch.randint(-127, 128, (n, d), device=dev, generator=gen, dtype=torch.int8)
        q = torch.randint(-127, 128, (1, d), device=dev, generator=gen, dtype=torch.int8)
    mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
    return index, q, mask


def shard_library_call(torch, kind: str, index, q, pool: int):
    """The library way of a shard's top-pool (:data:`SHARD_LIBRARY`): a full
    score vector from one product call, then ``torch.topk``."""
    if kind == "bf16":
        return lambda: torch.topk(torch.matmul(q, index.t()), pool)
    q8 = torch.zeros(8, q.shape[1], dtype=torch.int8, device=q.device)
    q8[:1] = q
    qt = q8.t().contiguous()                  # [D, 8]: index @ qt, column 0 is the query's
    return lambda: torch.topk(torch._int_mm(index, qt)[:, 0], pool)


def shard_kernel_times(torch, dev, seed: int, report, n: int, pool: int) -> None:
    """The split kernels at one shard's scans (n rows x 768 and x 1024, tile
    2048, m = pool, B=1): each held against its plain twin (int8 exactly,
    bf16 by ``compare_tiles``) and timed in turns with it and with the
    template it replaced on this path (``LOOP_CC`` / ``LOOP_I8_CC``, the
    rival: plain, kernel, rival, rival, kernel, plain), then at m 4 (the scan
    without the selection); the whole per-shard step (kernel + tile merge)
    and the tile merge alone, against the plain per-shard step (full score
    vector + stable top-k); the library way (:data:`SHARD_LIBRARY`). Then a
    shard that is not a power of two (250,000 x 768 rows padded to whole
    2,048-row tiles by ``shard_scan_rows``) through ``shard_topk`` against
    ``topk_plain``, in both row kinds; each must launch its split kernel."""
    from cqs_tpu_torch.ops.topk import (LOOP_CC, LOOP_I8_CC, LOOP_SPLIT, LOOP_SPLIT_I8,
                                        merge_tiles, scan_topk_plain_loop, shard_geometry,
                                        shard_scan_rows, shard_topk, topk_plain)

    errs = report.setdefault("errs", {})
    rows = []
    for kernel, rival, d in ((LOOP_SPLIT, LOOP_CC, 768), (LOOP_SPLIT, LOOP_CC, 1024),
                             (LOOP_SPLIT_I8, LOOP_I8_CC, 768), (LOOP_SPLIT_I8, LOOP_I8_CC, 1024)):
        kind = kernel.kind
        gen = torch.Generator(device=dev).manual_seed(seed + n + d + (kind == "i8"))
        index, q, mask = shard_inputs(torch, dev, gen, kind, n, d)
        label = f"n={n} d={d} tile=2048 b=1 m={pool}"
        cmp = compare_exact if kind == "i8" else compare_tiles
        for k in (kernel, rival):
            err = cmp(k, scan_topk_plain_loop, index, q, mask, 2048, pool, f"{k.name} {label}")
            errs[k.name] = max(errs.get(k.name, 0.0), err)
        same_topk(torch, index, q, mask, shard_topk(index, q, pool, mask),
                  topk_plain(index, q, pool, mask), f"shard step {label} ({kind})", kind == "i8")

        def plain():
            return scan_topk_plain_loop(index, q, mask, 2048, pool)

        def split():
            return kernel(index, q, mask, 2048, pool)

        def templ():
            return rival(index, q, mask, 2048, pool)

        pm1, km1 = cuda_ms(plain, 5), cuda_ms(split, 20)
        rm = [cuda_ms(templ, 10) for _ in (0, 1)]
        km2, pm2 = cuda_ms(split, 20), cuda_ms(plain, 5)
        m4_ms = cuda_ms(lambda: kernel(index, q, mask, 2048, 4), 20)
        tv, tr = split()
        merge_ms = cuda_ms(lambda: merge_tiles(tv, tr, pool), 20)
        step_ms = cuda_ms(lambda: shard_topk(index, q, pool, mask), 20)
        step_plain_ms = cuda_ms(lambda: topk_plain(index, q, pool, mask), 10)
        lib_ms = cuda_ms(shard_library_call(torch, kind, index, q, pool), 20)
        bound = bound_ms(kind, n, d, 1, 2048, pool)
        t = {"kernel": kernel.name, "n": n, "d": d, "tile": 2048, "b": 1, "m": pool,
             "ms": (km1 + km2) / 2, "plain_ms": (pm1 + pm2) / 2, "library_ms": lib_ms,
             "library_call": SHARD_LIBRARY[kind], "rival": rival.name,
             "rival_ms": sum(rm) / 2, "m4_ms": m4_ms, "step_ms": step_ms,
             "merge_ms": merge_ms, "step_plain_ms": step_plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1]}
        report.setdefault("timings", []).append(t)
        rows.append(t)
        del index, q, mask, tv, tr
        torch.cuda.empty_cache()
    for t in rows:
        print(f"shard: {t['kernel']:23s} {t['n']} x {t['d']}, tile 2048, B=1, m {t['m']}: "
              f"kernel {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, {t['bound_by']}: "
              f"{t['bound_ms'] / t['ms']:.0%} of it), at m 4 {t['m4_ms']:.4f}; "
              f"{t['rival']} {t['rival_ms']:.4f} in turns; plain twin {t['plain_ms']:.4f}; "
              f"per-shard step {t['step_ms']:.4f} (tile merge {t['merge_ms']:.4f}), plain step "
              f"{t['step_plain_ms']:.4f}; {t['library_call']} {t['library_ms']:.4f}")
    # a shard that is not a power of two: padded with masked rows to whole tiles
    odd = []
    for kernel, d in ((LOOP_SPLIT, 768), (LOOP_SPLIT_I8, 768)):
        kind = kernel.kind
        rows_n = 250_000
        n_s, tile, m = shard_geometry(rows_n, pool)
        gen = torch.Generator(device=dev).manual_seed(seed + rows_n + (kind == "i8"))
        index, q, mask = shard_inputs(torch, dev, gen, kind, n_s, d)
        mask[rows_n:] = 0
        if n_s != shard_scan_rows(rows_n) or n_s % tile or n_s - rows_n >= 2048:
            fail(f"shard: {rows_n} rows padded to {n_s} rows in tiles of {tile}")
        before = kernel.launches
        got = shard_topk(index, q, pool, mask)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            fail(f"shard: a {rows_n}-row shard's step did not launch {kernel.name}")
        same_topk(torch, index, q, mask, got, topk_plain(index, q, pool, mask),
                  f"shard step {rows_n} rows ({kind})", kind == "i8")
        if int(got[1].max()) >= rows_n:
            fail(f"shard: a padding row left the {rows_n}-row shard")
        odd.append({"kernel": kernel.name, "rows": rows_n, "scan_rows": n_s, "tile": tile,
                    "m": m, "step_ms": cuda_ms(lambda: shard_topk(index, q, pool, mask), 20)})
        del index, q, mask
    for o in odd:
        print(f"shard: a {o['rows']}-row shard (x 768) padded to {o['scan_rows']} rows, tile "
              f"{o['tile']}, m {o['m']}: {o['kernel']}, equal to the plain step; per-shard step "
              f"{o['step_ms']:.4f} ms")
    report["shard"]["kernels"] = rows
    report["shard"]["odd_shards"] = odd


@contextlib.contextmanager
def exact_scan_branch():
    """Within the block the single-device hybrid program takes the
    reference's exact branch at every size (``program._scan_tile`` -> None:
    a full [B, N] score matrix and a stable top-pool per leg), the semantics
    of the sharded program. The package itself never makes that choice: this
    swaps the function here."""
    from cqs_tpu_torch.search import program

    real = program._scan_tile
    program._scan_tile = lambda n: None
    try:
        yield
    finally:
        program._scan_tile = real


def shard_engine_run(torch, dev, report, path_run) -> None:
    """The engine's sharded branch at the repository corpus: with
    ``mesh_shards=4`` on one card the engine logs the reference's warning
    and serves from one device; the phase then places the index on
    ``Mesh([dev] * 4)`` itself and runs the queries through
    ``engine.search``. Their top 5 must equal, within 1e-5, the single-device
    engine's on the exact branch (each leg's exact top-pool: the sharded
    program's semantics) and the 1-shard mesh's, and they must launch
    ``LOOP_SPLIT`` (each shard's exact top-500) and no other kernel. Against
    the default single-device program, whose candidates
    are each tile's top 64, the equal top-5 lists are counted, not held.
    Only the placements and the sharded runs go through ``path_run`` (the
    sharded path's count); the index build and the single-device runs fall
    outside it."""
    import logging

    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.ops.topk import LOOP_SPLIT
    from cqs_tpu_torch.parallel import Mesh, ShardedHybridIndex

    tmp = Path(tempfile.mkdtemp(prefix="cqs_shard_"))
    records: list = []
    handler = logging.Handler()
    handler.emit = records.append
    search_log = logging.getLogger("cqs_tpu.search")
    try:
        proj = tmp / "corpus"
        proj.mkdir()
        copy_corpus(proj)
        rc, _, ms = run_cli(main, ["index", "--path", str(proj), "--device", str(dev), "--json"])
        if rc != 0:
            fail(f"shard: index exited {rc}")
        search_log.addHandler(handler)
        with knobs({"CQST_MESH_SHARDS": "4"}):
            ctx = CommandContext.create(str(proj), device=dev)
            eng = ctx.engine
        search_log.removeHandler(handler)
        warned = [r.getMessage() for r in records if "mesh sharding unavailable" in r.getMessage()]
        # (off the card a 4-shard CPU mesh is legal: the rehearsal's engine shards)
        if dev.type == "cuda" and (eng.sharded is not None or not warned):
            fail(f"shard: mesh_shards=4 on {torch.cuda.device_count()} card(s) did not fall "
                 f"back to one device with the reference's warning ({warned})")
        eng.sharded = None

        def top5():
            eng._result_cache = {}
            return {q: [(h.row.id, h.score) for h in eng.search(q, limit=5).hits]
                    for q in QUERIES}

        default = top5()
        with exact_scan_branch():
            exact = top5()
        def sharded_run(shards):
            eng.sharded = ShardedHybridIndex.from_indexes(eng.dense, eng.sparse,
                                                          Mesh([dev] * shards))
            # (queries the sharded branch does not take, on the base index,
            # run the exact branch as in the run they are held to: plain
            # PyTorch, no kernel)
            with exact_scan_branch():
                return top5()

        runs, launched = {}, 0
        for shards in (4, 1):
            runs[shards], delta = path_run(lambda shards=shards: sharded_run(shards))
            launched += delta[LOOP_SPLIT.name]
            if {k for k, x in delta.items() if x} - {LOOP_SPLIT.name}:
                fail(f"shard: the engine's run on {shards} shard(s) launched {delta}: only "
                     f"{LOOP_SPLIT.name} (each shard's exact top-500) belongs to the sharded "
                     f"path")
        for q in QUERIES:
            for label, want in (("the exact single-device program", exact[q]),
                                ("1 shard", runs[1][q])):
                if not same_hits(runs[4][q], want):
                    fail(f"shard: engine top 5 of {q!r} on 4 shards differs from {label}: "
                         f"{runs[4][q]} vs {want}")
        if dev.type == "cuda" and launched == 0:
            fail(f"shard: the engine's sharded queries did not launch {LOOP_SPLIT.name}")
        as_default = sum(same_hits(runs[4][q], default[q]) for q in QUERIES)
        ctx.close()
        print(f"shard: engine at the repository corpus ({eng.dense.count} rows, capacity "
              f"{eng.dense.capacity}, 4 shards of {eng.dense.capacity // 4}): "
              f"mesh_shards=4 warned ({warned[:1]}); on Mesh([{dev}] * 4) the {len(QUERIES)} "
              f"queries' top 5 equal the exact single-device program's and 1 shard's; "
              f"{as_default} of {len(QUERIES)} equal the default program's (per-tile "
              f"candidates: another union, another min-max); {LOOP_SPLIT.name} launched "
              f"{launched} times")
        report["shard"]["engine"] = {"queries": len(QUERIES), "split_launches": launched,
                                     "equal_to_default_program": as_default,
                                     "index_s": ms / 1e3}
    finally:
        search_log.removeHandler(handler)
        shutil.rmtree(tmp, ignore_errors=True)


#: shards under 128 rows, the sharded programs' one use of the CUDA-core
#: template: 320 rows in 8 shards of 40 (each padded to one 64-row tile),
#: pool 100
SMALL_SHARDS = {"rows": 320, "shards": 8, "queries": 8, "pool": 100}


def small_shard_run(torch, dev, seed: int, report, g: dict, run) -> None:
    """Shards under 128 rows, whose tiles are not whole 128-row sub-tiles, so
    each shard's scans take the CUDA-core template: ``ShardedHybridIndex``
    of :data:`SMALL_SHARDS` at the phase's widths over ``Mesh([dev] * 8)``,
    modes 0 (``LOOP_CC``) and 1 (``LOOP_I8_CC``), each query through
    ``sharded_search_legs`` inside ``run`` (the small-shard path's count):
    on the card exactly 2 launches a shard a query of the mode's template
    and nothing else; each query's pool held to the plain per-shard step's
    (:func:`shard_pool_check`)."""
    import numpy as np

    from cqs_tpu_torch.ops.topk import loop_impl, shard_geometry
    from cqs_tpu_torch.parallel import Mesh, ShardedHybridIndex
    from cqs_tpu_torch.parallel.sharded_hybrid import sharded_search_legs

    sm = SMALL_SHARDS
    n, n_sh, pool = sm["rows"], sm["shards"], sm["pool"]
    rng = np.random.default_rng(seed + 11)
    mat = rng.normal(size=(n, g["d"])).astype(np.float32)
    ids = rng.integers(0, g["v"], size=(n, g["t"])).astype(np.int32)
    w = rng.lognormal(0.0, 0.8, size=(n, g["t"])).astype(np.float32)
    q_rows = rng.choice(n, size=sm["queries"], replace=False)
    qs = [(torch.from_numpy(mat[r] / np.linalg.norm(mat[r])).to(dev),
           torch.from_numpy(ids[r].copy()).to(dev), torch.from_numpy(w[r].copy()).to(dev))
          for r in q_rows]
    out = {}
    for mode, kernel in ((0, "scan_topk_loop_cc"), (1, "scan_topk_loop_i8_cc")):
        idx = ShardedHybridIndex([f"s{i}" for i in range(n)], mat, ids, w, g["v"],
                                 Mesh([dev] * n_sh), sketch_dim=g["s"], q8=mode)
        n_s = idx.rows_per_shard
        _, tile, m = shard_geometry(n_s, min(pool, n_s))
        if loop_impl("bf16", tile, m) != "template":
            fail(f"shard: a {n_s}-row shard (tile {tile}, m {m}) does not take the template")
        shards = idx.shards()
        got, delta = run(lambda: [sharded_search_legs(shards, *q, g["alpha"], pool, idx.q8,
                                                      idx.vocab_size) for q in qs])
        want = {kernel: 2 * n_sh * len(qs)} if dev.type == "cuda" else {}
        if {k: x for k, x in delta.items() if x} != want:
            fail(f"shard: {n_sh} shards of {n_s} rows, mode {mode}: launches {delta}, "
                 f"expected {want}")
        checks = []
        for qi, q in enumerate(qs):
            log: list = []
            with plain_shard_scans(log):
                plain = sharded_search_legs(shards, *q, g["alpha"], pool, idx.q8,
                                            idx.vocab_size)
            checks.append(shard_pool_check(torch, f"small shards, mode {mode}, query {qi}",
                                           got[qi], plain, log, n_sh, n_s, pool))
        out[mode] = {"rows_per_shard": n_s, "tile": tile, "m": m,
                     "rows_in_one_pool_only": sum(c["rows_in_one_pool_only"] for c in checks),
                     "max_fused_diff": max(c["max_fused_diff"] for c in checks)}
        print(f"shard: {n_sh} shards of {n_s} rows (tile {tile}, m {m}), mode {mode}: "
              f"{kernel} {delta[kernel]} launches; pools against the plain per-shard step: "
              f"{out[mode]['rows_in_one_pool_only']} rows in one pool only, max |fused diff| "
              f"{out[mode]['max_fused_diff']:.3g}")
    report["shard"]["small_shards"] = out


def phase_shard(torch, dev, seed: int, report, smi: str,
                geometry=SHARD_GEOMETRY) -> tuple[dict, dict]:
    """Mesh-sharded hybrid serving on one card: ``ShardedHybridIndex``
    from ``from_row_blocks`` over ``Mesh([dev] * N)`` (N logical shards)
    and over ``Mesh([dev])``, in modes 0 (bf16), 1 (q8) and 2 (sk8);
    ``sharded_search_legs`` for each query; then the engine's sharded
    branch and shards under 128 rows (:func:`small_shard_run`). Returns the
    launches of the path runs: the placements and the sharded queries, each
    with every count set to 0 just before and read just after
    (``path_run``), and apart those of the small shards' queries; the
    comparisons with the plain steps, the timings and the engine's
    single-device runs fall outside them."""
    import numpy as np

    from cqs_tpu_torch.ops.topk import IMPLS, shard_scan_rows
    from cqs_tpu_torch.parallel import Mesh, ShardedHybridIndex
    from cqs_tpu_torch.parallel.sharded_hybrid import sharded_search_legs

    g = geometry
    n, d, t, s, v, n_sh, pool = g["n"], g["d"], g["t"], g["s"], g["v"], g["shards"], g["pool"]
    report["shard"] = {"geometry": dict(g), "modes": {}}
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    mat, ids, w = shard_corpus(torch, dev, seed, n, d, t, v)
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 5)
    q_rows = rng.choice(n, size=g["queries"], replace=False)
    qs = []
    for r in q_rows:
        qd = mat[r] / np.linalg.norm(mat[r])
        qs.append((torch.from_numpy(qd.astype(np.float32)).to(dev),
                   torch.from_numpy(ids[r].copy()).to(dev), torch.from_numpy(w[r].copy()).to(dev)))
    names = [f"r{i}" for i in range(n)]

    def block_fn(lo, hi):
        return mat[lo:hi], ids[lo:hi], w[lo:hi]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    path: dict[str, int] = {k.name: 0 for k in IMPLS}
    small: dict[str, int] = dict(path)

    def counted_run(fn, into: dict):
        """fn() with every count set to 0 just before and read just after;
        the counts are added to ``into``."""
        for k in IMPLS:
            k.launches = 0
        out = fn()
        sync()
        counts = {k.name: k.launches for k in IMPLS}
        for k, x in counts.items():
            into[k] += x
        return out, counts

    def path_run(fn):
        return counted_run(fn, path)

    print(f"shard: corpus {n} x {d}, T {t}, S {s}, vocab {v} drawn on the card in "
          f"{gen_s:.1f} s; {g['queries']} queries (a row's vector and its {t} terms), pool "
          f"{pool}, alpha {g['alpha']}")
    for mode in (0, 1, 2):
        res = {}
        built = {}
        for shards in (n_sh, 1):
            t0 = time.perf_counter()
            idx, delta = path_run(lambda shards=shards: ShardedHybridIndex.from_row_blocks(
                names, v, Mesh([dev] * shards), block_fn, n, d, t, sketch_dim=s, q8=mode))
            if any(delta.values()):
                fail(f"shard: mode {mode}: the placement launched {delta}")
            built[shards] = idx
            res[f"build_s_{shards}"] = time.perf_counter() - t0
        idx = built[n_sh]
        per_shard = []
        for i in range(n_sh):
            tensors = [x[i] for x in (idx.matrix, idx.doc_ids, idx.doc_w, idx.sketch,
                                      idx.sketch_i8, idx.dense_i8) if x is not None]
            per_shard.append(sum(x.numel() * x.element_size() for x in tensors))
        formula, row_bytes = shard_row_bytes(mode, d, s, t)
        # the budget over the scan rows: a shard's rows and the masked rows
        # that pad it to whole tiles (at most 2,047)
        scan_rows = shard_scan_rows(idx.rows_per_shard)
        if scan_rows - idx.rows_per_shard >= 2048:
            fail(f"shard: {idx.rows_per_shard} rows a shard padded to {scan_rows}")
        budget = scan_rows * row_bytes
        if max(per_shard) > budget:
            fail(f"shard: mode {mode}: a shard holds {max(per_shard)} bytes, above "
                 f"{formula} x {scan_rows} rows = {budget}")
        outs = {}
        for shards, ix in built.items():
            sh = ix.shards()

            def run(sh=sh, ix=ix):
                return [sharded_search_legs(sh, *q, g["alpha"], pool, ix.q8, ix.vocab_size)
                        for q in qs]

            outs[shards], delta = path_run(run)
            want = {}
            for name in SHARD_SCANS[mode] if on_card else ():
                want[name] = want.get(name, 0) + shards * len(qs)
            got = {k: x for k, x in delta.items() if x}
            if got != want:
                fail(f"shard: mode {mode}, {shards} shard(s): launches {got}, expected {want} "
                     f"(per shard per query: {SHARD_SCANS[mode]})")
        for qi, (a, b) in enumerate(zip(outs[n_sh], outs[1])):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"shard: mode {mode}: query {qi} on {n_sh} shards differs from 1 shard")
        # the plain per-shard step on the card, query by query
        checks = []
        for qi, q in enumerate(qs):
            log: list = []
            with plain_shard_scans(log):
                plain = sharded_search_legs(idx.shards(), *q, g["alpha"], pool, idx.q8,
                                            idx.vocab_size)
            checks.append(shard_pool_check(torch, f"mode {mode}, query {qi}", outs[n_sh][qi],
                                           plain, log, n_sh, idx.rows_per_shard, pool))
        pc = {k: sum(c[k] for c in checks) for k in checks[0] if k != "max_fused_diff"}
        pc["max_fused_diff"] = max(c["max_fused_diff"] for c in checks)
        # B=1 wall (host clock around a synchronized call, median over the
        # queries) and device-busy for N and 1 shards
        for shards, ix in built.items():
            sh = ix.shards()
            ms = []
            for q in qs:
                t1 = time.perf_counter()
                sharded_search_legs(sh, *q, g["alpha"], pool, ix.q8, ix.vocab_size)
                sync()
                ms.append((time.perf_counter() - t1) * 1e3)
            res[f"b1_ms_{shards}"] = statistics.median(ms)
            if on_card:
                busy, by_kernel, launches, _ = device_busy(
                    torch, lambda: sharded_search_legs(sh, *qs[0], g["alpha"], pool, ix.q8,
                                                       ix.vocab_size), 5)
                res[f"busy_ms_{shards}"] = busy
                res[f"launches_{shards}"] = launches
                res[f"scan_busy_ms_{shards}"] = sum(
                    x for k, x in by_kernel.items() if any(nm in k for nm in SCAN_KERNEL_NAMES))
        top1 = float(np.mean([int(o[1][0, 0]) == int(r) for o, r in zip(outs[n_sh], q_rows)]))
        res.update({"per_shard_bytes": per_shard, "budget_bytes": budget,
                    "scan_rows": scan_rows, "pool_check": pc,
                    "top1_is_query_row": top1})
        report["shard"]["modes"][mode] = res
        print(f"shard: mode {mode} ({['bf16', 'q8', 'sk8'][mode]}): built {n_sh} shards in "
              f"{res[f'build_s_{n_sh}']:.1f} s, 1 shard in {res['build_s_1']:.1f} s; bytes a "
              f"shard {', '.join(f'{b / 1e9:.4f}' for b in per_shard)} GB against "
              f"{formula} x {scan_rows} scan rows ({scan_rows - idx.rows_per_shard} padding) = "
              f"{budget / 1e9:.4f} GB (docs/scale-10m.md); "
              f"{n_sh} shards == 1 shard bit for bit on {len(qs)} queries; top-1 is the query's "
              f"row {top1:.4f}")
        print(f"shard: mode {mode}: kernels against the plain per-shard step: {pc['slots']} "
              f"slots, {pc['same_slot_rows']} hold the same row, {pc['rows_in_one_pool_only']} "
              f"rows in one pool only (each a near-tie), max |fused diff| "
              f"{pc['max_fused_diff']:.3g}; B=1 median {res[f'b1_ms_{n_sh}']:.3f} ms on "
              f"{n_sh} shards, {res['b1_ms_1']:.3f} ms on 1 (host clock)"
              + (f"; device-busy {res[f'busy_ms_{n_sh}']:.3f} / {res['busy_ms_1']:.3f} ms "
                 f"({res[f'launches_{n_sh}']:.0f} / {res['launches_1']:.0f} launches), "
                 f"of it the scans {res[f'scan_busy_ms_{n_sh}']:.3f} / "
                 f"{res['scan_busy_ms_1']:.3f} ms" if on_card else ""))
        del built, idx, outs
        if on_card:
            torch.cuda.empty_cache()
    del mat, ids, w
    shard_engine_run(torch, dev, report, path_run)
    small_shard_run(torch, dev, seed, report, g, lambda fn: counted_run(fn, small))
    if on_card:
        shard_kernel_times(torch, dev, seed, report, n // n_sh, pool)
    print(f"shard: card {smi}")
    report["shard"]["path_launches"] = path
    report["shard"]["small_shard_launches"] = small
    return path, small


# -- phase 6: the warm daemon over its socket -----------------------------------

#: appended to a query so that no two requests of one round share a text:
#: every request then runs its device program, none is a result-cache hit
SERVE_WORDS = ["store", "index", "query", "chunk", "token", "cache", "batch", "score",
               "parse", "embed", "daemon", "socket", "sketch", "kernel", "filter", "router"]
ADDED_FILE = '''"""Added while the daemon runs."""


def quuxify_flange_adapter(flange, torque):
    """Quuxify the flange adapter until the torque reading settles."""
    return flange * torque
'''
EDIT_TAIL = '''


def wobble_sprocket_tally(sprockets):
    """Tally the wobble of every sprocket on the shaft."""
    return sum(sprockets)
'''
DOOMED_FILE = '''"""Indexed at the start, deleted while the daemon runs."""


def zygomorphic_petal_counter(petals):
    """Count the petals of a zygomorphic flower."""
    return len(petals)
'''


def socket_dir(index_dir: Path) -> tuple[Path, int | None]:
    """The directory to hand the daemon's server and its clients for
    ``index_dir``: itself where a socket under it fits an AF_UNIX address
    (about 107 bytes), else the same directory by way of an open descriptor
    (``/proc/self/fd/N``, which the threads of this process share), so that
    a run under a long temporary directory stays inside it. Returns the
    directory and the descriptor to close, if one was opened."""
    from cqs_tpu_torch.daemon.protocol import socket_path

    if len(os.fsencode(str(socket_path(index_dir)))) <= 100:
        return index_dir, None
    fd = os.open(index_dir, os.O_RDONLY | os.O_DIRECTORY)
    return Path(f"/proc/self/fd/{fd}"), fd


def hit_pairs(results) -> list[tuple[str, float]]:
    return [(h["id"], h["score"]) for h in results]


def same_hits(got, want, tol: float = 1e-5) -> bool:
    return [i for i, _ in got] == [i for i, _ in want] and all(
        abs(a - b) <= tol for (_, a), (_, b) in zip(got, want))


def dense_artifacts(slot_path: Path) -> dict:
    """The rows of the dense artifacts the index command saved, as a daemon
    loads them (fp16 widened to f32): {index name: {chunk id: row}}."""
    import numpy as np

    from cqs_tpu_torch.search.engine import DENSE_BASE_FILE, DENSE_FILE

    out = {}
    for name, filename in (("dense", DENSE_FILE), ("dense_base", DENSE_BASE_FILE)):
        with np.load(slot_path / filename, allow_pickle=False) as z:
            mat = z["matrix"].astype(np.float32)
            out[name] = {str(cid): mat[i] for i, cid in enumerate(z["ids"])}
    return out


def indexes_in_layout(torch, store, eng, dev, loaded: dict) -> dict:
    """Dense, base and sparse indexes in the row layout of ``eng``'s indexes
    (tombstoned rows stay, empty and masked), each beside the index it
    mirrors: {name: (new, current)}. A dense row the daemon loaded from an
    artifact (``loaded``, from :func:`dense_artifacts`) takes the artifact's
    values, a row appended since takes the store's f32 values; the sparse
    artifact holds the store's values as they are."""
    import numpy as np

    from cqs_tpu_torch.index import DenseIndex, SpladeIndex

    out = {}
    for name, base in (("dense", False), ("dense_base", True)):
        cur = getattr(eng, name)
        ids, mat = store.load_embeddings(base=base)
        row = {cid: i for i, cid in enumerate(ids)}
        laid = np.zeros((len(cur.ids), mat.shape[1]), np.float32)
        for i, cid in enumerate(cur.ids):
            if cid:
                laid[i] = loaded[name][cid] if cid in loaded[name] else mat[row[cid]]
        out[name] = (DenseIndex(list(cur.ids), laid, cur.stamp, device=dev), cur)
    cur = eng.sparse
    terms = {cid: (t, w) for cid, t, w in store.load_sparse()}
    doc_ids = np.zeros((len(cur.ids), cur.T), np.int32)
    doc_w = np.zeros((len(cur.ids), cur.T), np.float32)
    for i, cid in enumerate(cur.ids):
        if cid and cid in terms:
            t, w = terms[cid]
            n = min(len(t), cur.T)
            doc_ids[i, :n], doc_w[i, :n] = t[:n], w[:n]
    out["sparse"] = (SpladeIndex(list(cur.ids), doc_ids, doc_w, cur.vocab_size, cur.stamp,
                                 device=dev, sketch_dim=cur.sketch_dim), cur)
    return out


def phase_serve(torch, dev, report, smi: str):
    """The warm daemon on the card, in this process: ``DaemonServer`` over a
    micro-batching ``BatchContext`` on the repository corpus, asked over its
    Unix socket by 1, 4 and 16 client threads; the watch loop's incremental
    refresh while clients keep asking; the batch, MCP and web surfaces; the
    idle unload. Any error answer fails the run."""
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.daemon import BatchContext, DaemonServer, ping, request
    from cqs_tpu_torch.daemon.batch import run_batch_loop
    from cqs_tpu_torch.daemon.mcp import serve_stdio
    from cqs_tpu_torch.daemon.serve import run_server
    from cqs_tpu_torch.daemon.watch import WatchLoop
    from cqs_tpu_torch.ops.topk import LOOP_SPLIT
    import threading
    import urllib.request

    tmp = Path(tempfile.mkdtemp(prefix="cq"))
    ctx = bctx = server = httpd = sock_fd = None
    out: dict = {}
    try:
        proj = tmp / "c"
        proj.mkdir()
        copy_corpus(proj)
        (proj / "docs" / "doomed_module.py").write_text(DOOMED_FILE)
        rc, env, ms = run_cli(main, ["index", "--path", str(proj), "--device", str(dev), "--json"])
        if rc != 0 or env is None:
            fail(f"serve: index exited {rc}")
        ctx = CommandContext.create(str(proj), device=dev)
        # the daemon starts as ``watch --serve`` does after ``index``: its
        # indexes are loaded from the artifacts the index command saved (the
        # dense ones hold fp16), and rows appended later come from the
        # store's f32 values
        loaded = dense_artifacts(ctx.slot_path)
        saved = {a: a.stat().st_mtime_ns for a in ctx.slot_path.glob("*.npz")}
        eng = ctx.engine
        if len(saved) != 3 or any(a.stat().st_mtime_ns != t for a, t in saved.items()):
            fail(f"serve: the daemon's engine did not load the index command's artifacts "
                 f"({sorted(a.name for a in saved)}): it built and saved them anew")
        bctx = BatchContext(ctx, micro_batch=True)
        bctx.warm()
        sock_dir, sock_fd = socket_dir(ctx.index_dir)
        server = DaemonServer(bctx, sock_dir)
        server.start()
        if not ping(sock_dir):
            fail("serve: the daemon does not answer ping")
        def on_the_card(when: str) -> None:
            for t in (eng.dense.matrix, eng.dense.mask, eng.dense_base.matrix,
                      eng.sparse.sketch, eng.sparse.doc_ids, eng.sparse.doc_w, eng.sparse.mask,
                      eng.embedder._model):
                if not t.is_cuda:
                    fail(f"serve: {when}: an index or model tensor is not on the card")

        on_the_card("at the start")
        print(f"serve: daemon on {server.path} over {eng.dense.count} rows "
              f"(capacity {eng.dense.capacity}), indexed in {ms / 1e3:.1f} s")

        errors: list[str] = []     # what client threads found; the main thread fails on it

        def ask(command: str, args: dict) -> dict:
            resp = request(sock_dir, command, args, timeout=120.0)
            if resp is None or "error" in resp or not resp.get("ok"):
                raise RuntimeError(f"serve: {command} {args} answered {resp}")
            return resp

        def in_thread(fn, *a):
            """A thread target: an exception ends the thread and is kept."""
            def run():
                try:
                    fn(*a)
                except Exception as e:
                    errors.append(f"{type(e).__name__}: {e}")
            return threading.Thread(target=run)

        texts = {(k, q): f"{q} {SERVE_WORDS[k]}" for k in range(16) for q in QUERIES}
        solo = {t: [(h.row.id, round(h.score, 6)) for h in eng.search(t).hits]
                for t in texts.values()}
        if not all(solo.values()):
            fail("serve: a solo search has no hits")

        def run_round(n_clients: int) -> dict:
            """n_clients threads, each sending its own variant of the query
            list, one connection a request; round-trip times on the host
            clock."""
            with eng.index_lock:
                eng._result_cache = {}
            before = bctx.batcher_stats() or {"fused": 0, "batches": 0, "solo": 0,
                                              "cache_hits": 0, "batch_size_hist": {}}
            launches = LOOP_SPLIT.launches
            rtt: list[float] = []
            lock = threading.Lock()

            def client(k: int) -> None:
                mine = []
                for q in QUERIES:
                    t0 = time.perf_counter()
                    resp = ask("search", {"query": texts[(k, q)]})
                    mine.append((time.perf_counter() - t0) * 1e3)
                    if not same_hits(hit_pairs(resp["results"]), solo[texts[(k, q)]]):
                        raise RuntimeError(f"serve: hits of {texts[(k, q)]!r} over the "
                                           f"socket differ from the solo search")
                with lock:
                    rtt.extend(mine)

            threads = [in_thread(client, k) for k in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if errors:
                fail(errors[0])
            if any(t.is_alive() for t in threads) or len(rtt) != n_clients * len(QUERIES):
                fail(f"serve: {n_clients} clients: a client did not finish")
            after = bctx.batcher_stats()
            fused = after["fused"] - before["fused"]
            batches = after["batches"] - before["batches"]
            rtt.sort()
            return {"clients": n_clients, "requests": len(rtt), "qps": len(rtt) / wall,
                    "median_ms": statistics.median(rtt),
                    "p95_ms": rtt[min(len(rtt) - 1, int(0.95 * len(rtt)))],
                    "fused": fused, "batches": batches,
                    "solo": after["solo"] - before["solo"],
                    "cache_hits": after["cache_hits"] - before["cache_hits"],
                    "mean_batch": fused / batches if batches else 0.0,
                    "loop_split_launches": LOOP_SPLIT.launches - launches}

        run_round(2)                                  # warm-up, not reported
        out["rounds"] = [run_round(n) for n in (1, 4, 16)]
        for r in out["rounds"]:
            print(f"serve: {r['clients']:2d} clients: {r['qps']:.1f} queries/s over the socket, "
                  f"round trip median {r['median_ms']:.2f} ms, p95 {r['p95_ms']:.2f} ms; "
                  f"{r['batches']} batches, mean size {r['mean_batch']:.2f}, "
                  f"{r['solo']} run solo, {r['cache_hits']} cache hits, "
                  f"{r['loop_split_launches']} {LOOP_SPLIT.name} launches; {smi}")
            if r["loop_split_launches"] <= 0:
                fail(f"serve: the socket path did not launch {LOOP_SPLIT.name}")
        hist = bctx.batcher_stats()["batch_size_hist"]
        if max(hist) <= 1:
            fail(f"serve: no batch held more than one query: {hist}")
        out["batch_size_hist"] = {str(k): v for k, v in sorted(hist.items())}

        # -- the watch loop refreshes the index while clients keep asking
        loop = WatchLoop(ctx)
        if loop.reconcile_once() != 0:
            fail("serve: the first reconcile found changes in an unchanged corpus")
        (proj / "cqs_tpu" / "zz_added_module.py").write_text(ADDED_FILE)
        edited = proj / "scripts" / "torch_ab.py"
        edited.write_text(edited.read_text() + EDIT_TAIL)
        (proj / "docs" / "doomed_module.py").unlink()
        # what the indexes' first upload copied to the card: every index
        # tensor's host array holds 4-byte elements
        full_upload = 4 * sum(t.numel() for t in (
            eng.dense.matrix, eng.dense.mask, eng.dense_base.matrix, eng.dense_base.mask,
            eng.sparse.doc_ids, eng.sparse.doc_w, eng.sparse.sketch, eng.sparse.mask))
        timing: dict = {"uploaded": 0}
        refresh = eng.refresh_incremental
        from_numpy = torch.from_numpy
        refresher = threading.current_thread()

        def counted_from_numpy(a):
            """Every host array the indexes send to the card is wrapped by
            ``torch.from_numpy`` first: its bytes are counted on the
            refreshing thread (client threads upload their queries too)."""
            if threading.current_thread() is refresher:
                timing["uploaded"] += a.nbytes
            return from_numpy(a)

        def timed_refresh():
            torch.cuda.synchronize()
            torch.from_numpy = counted_from_numpy
            t0 = time.perf_counter()
            try:
                timing["outcome"] = refresh()
            finally:
                torch.from_numpy = from_numpy
            torch.cuda.synchronize()
            timing["ms"] = (time.perf_counter() - t0) * 1e3
            return timing["outcome"]

        eng.refresh_incremental = timed_refresh
        stop = threading.Event()
        asked = []

        def background(k: int) -> None:
            while not stop.is_set():
                ask("search", {"query": f"{QUERIES[k]} {SERVE_WORDS[len(asked) % 16]} again"})
                asked.append(k)

        bg = [in_thread(background, k) for k in range(4)]
        for t in bg:
            t.start()
        try:
            t0 = time.perf_counter()
            changed = loop.reconcile_once()
            reconcile_s = time.perf_counter() - t0
        finally:
            stop.set()
            for t in bg:
                t.join(timeout=120)
            del eng.refresh_incremental
        if errors:
            fail(errors[0])
        if any(t.is_alive() for t in bg):
            fail("serve: a client that asked during the refresh did not finish")
        outcome = timing.get("outcome") or {}
        if changed != 3 or "rebuilt" in outcome or not (
                outcome.get("appended", 0) >= 2 and outcome.get("tombstoned", 0) >= 1):
            fail(f"serve: reconcile of 3 changed files gave {changed} and {outcome}")
        on_the_card("after the refresh")
        moved = timing["uploaded"]
        if moved <= 0 or moved >= full_upload // 8:
            fail(f"serve: the refresh copied {moved} bytes to the card "
                 f"(the first upload was {full_upload})")
        out["refresh"] = {"outcome": outcome, "refresh_ms": timing["ms"],
                          "reconcile_s": reconcile_s, "uploaded_bytes": moved,
                          "first_upload_bytes": full_upload, "asked_meanwhile": len(asked)}
        print(f"serve: reconcile of 3 changed files in {reconcile_s:.2f} s; "
              f"refresh_incremental {outcome} in {timing['ms']:.2f} ms, copied {moved} bytes "
              f"to the card (first upload {full_upload}); {len(asked)} queries answered "
              f"meanwhile; {smi}")
        names = [h["name"] for h in ask("search", {"query": "quuxify flange adapter"})["results"]]
        if "quuxify_flange_adapter" not in names[:3]:
            fail(f"serve: the added function is not found after the refresh: {names}")
        names = [h["name"] for h in ask("search", {"query": "wobble sprocket tally"})["results"]]
        if "wobble_sprocket_tally" not in names[:3]:
            fail(f"serve: the edited file's new function is not found: {names}")
        gone = ask("search", {"query": "zygomorphic petal counter"})["results"]
        if any(h["origin"].endswith("doomed_module.py") for h in gone):
            fail("serve: a chunk of the deleted file is still answered")
        checks = QUERIES + ["quuxify flange adapter", "wobble sprocket tally",
                            "zygomorphic petal counter"]
        fresh_ctx = CommandContext.create(str(proj), device=dev)
        try:
            fresh = fresh_ctx.engine
            if "" in fresh.dense.ids or "" not in eng.dense.ids:
                fail("serve: the fresh engine was not built anew, or nothing was tombstoned")
            # (1) a fresh engine, its indexes rebuilt from the store: rows are
            # numbered anew, so rows change tiles, each tile gives its own
            # candidates, and min-max normalisation and the leg ranks run over
            # the candidates: the head agrees, the tail's order may not
            overlap = []
            for q in checks:
                warm = [h.row.id for h in eng.search(q).hits]
                cold = [h.row.id for h in fresh.search(q).hits]
                if warm[:1] != cold[:1]:
                    fail(f"serve: {q!r}: refreshed and rebuilt engines differ in the top "
                         f"hit: {warm[:1]} against {cold[:1]}")
                overlap.append(len(set(warm) & set(cold)) / max(len(cold), 1))
            if statistics.mean(overlap) < 0.9:
                fail(f"serve: refreshed and rebuilt engines share {overlap} of their hits")
            # (2) the same engine with indexes built in the refreshed layout
            # (tombstones kept) from what the daemon was given: the
            # artifacts' values for the rows it loaded, the store's for the
            # rows the refresh appended. Every live row's tensors equal bit
            # for bit, the appended rows among them, and every hit equal
            n_new = sum(1 for c in eng.dense.ids if c and c not in loaded["dense"])
            if n_new != outcome["appended"]:
                fail(f"serve: {n_new} rows of the refreshed index were not in the artifact, "
                     f"the refresh appended {outcome['appended']}")
            relaid = indexes_in_layout(torch, fresh_ctx.store, eng, dev, loaded)
            for name, (new, cur) in relaid.items():
                live = torch.tensor([bool(c) for c in cur.ids], device=dev)
                pairs = ([(new.matrix, cur.matrix)] if name != "sparse" else
                         [(new.doc_ids, cur.doc_ids), (new.doc_w, cur.doc_w),
                          (new.sketch, cur.sketch)])
                for a, b in pairs:
                    if not torch.equal(a[: len(live)][live], b[: len(live)][live]):
                        fail(f"serve: {name}: a refreshed tensor differs from the artifact's "
                             f"(loaded rows) or the store's (appended rows) values")
                if not torch.equal(new.mask, cur.mask) or new.ids_digest != cur.ids_digest:
                    fail(f"serve: {name}: mask or ids of the refreshed index are off")
            with fresh.index_lock:
                fresh.dense, fresh.dense_base = relaid["dense"][0], relaid["dense_base"][0]
                fresh.sparse = relaid["sparse"][0]
                fresh._row_of, fresh._result_cache = fresh.dense.row_of, {}
            for q in checks:
                warm = [(h.row.id, h.score) for h in eng.search(q).hits]
                cold = [(h.row.id, h.score) for h in fresh.search(q).hits]
                if not same_hits(warm, cold):
                    fail(f"serve: {q!r}: the refreshed engine and one built from the store "
                         f"in the same layout differ: {warm} against {cold}")
        finally:
            fresh_ctx.close()
        out["refresh"]["rebuilt_overlap"] = statistics.mean(overlap)
        print(f"serve: refreshed engine == engine built in the same layout from the loaded "
              f"artifacts' rows and the store's rows for the {n_new} appended, on "
              f"{len(checks)} queries (tensors bit for bit, hits to 1e-5); against a rebuilt "
              f"index (rows renumbered) the top hit agrees and {statistics.mean(overlap):.3f} "
              f"of the top 10")

        # -- the other surfaces over the same table
        query = {"query": "count sketch of sparse terms store again", "limit": 5}
        want = hit_pairs(ask("search", query)["results"])
        line = json.dumps({"command": "search", "args": query})
        buf = io.StringIO()
        run_batch_loop(ctx, io.StringIO(line + "\n"), buf)
        got = json.loads(buf.getvalue())
        msg = {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
               "params": {"name": "cqs_search", "arguments": query}}
        buf, stdin = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO(json.dumps(msg) + "\n")
        try:
            with contextlib.redirect_stdout(buf):
                serve_stdio(ctx)
        finally:
            sys.stdin = stdin
        mcp = json.loads(buf.getvalue())["result"]
        httpd, token = run_server(bctx, port=0)
        url = (f"http://127.0.0.1:{httpd.server_address[1]}/api/search?"
               f"q={urllib.request.quote(query['query'])}&k=5")
        req = urllib.request.Request(url, headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req, timeout=120) as r:
            web = json.loads(r.read())
        for name, results in (("batch loop", got.get("results")),
                              ("MCP bridge", None if mcp.get("isError")
                               else json.loads(mcp["content"][0]["text"])),
                              ("web API", web.get("results"))):
            if results is None or not same_hits(hit_pairs(results), want):
                fail(f"serve: the {name} answers {query['query']!r} unlike the socket")
        print("serve: batch loop, MCP bridge and web API answer as the socket does")

        # -- idle unload, then the table comes back on the card
        held = torch.cuda.memory_allocated()
        if not bctx.maybe_idle_unload(idle_s=1e9) or eng.embedder._model is not None:
            fail("serve: the idle unload did not drop the embedder's table")
        freed = held - torch.cuda.memory_allocated()
        if freed <= 0:
            fail("serve: the idle unload freed no device memory")
        resp = ask("search", {"query": "reload the table after an idle unload"})
        table = eng.embedder._model
        if not resp["results"] or table is None or not table.is_cuda:
            fail("serve: the query after the idle unload was not answered from the card")
        out["idle_unload_freed_bytes"] = freed
        print(f"serve: idle unload freed {freed} bytes of device memory; the next query was "
              f"answered and the table is back on {table.device}")
        report["serve"] = out
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if server is not None:
            server.stop()
        if sock_fd is not None:
            os.close(sock_fd)
        if bctx is not None:
            bctx.close()
        if ctx is not None:
            ctx.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 7: the neural models at full width ----------------------------------

#: EmbeddingGemma-300m's published geometry (HF ``config.json`` of a Gemma3
#: text model; both packages' ``GemmaConfig`` defaults): 24 layers, every 6th
#: full attention, the others sliding with window 512
GEMMA_HF = {"architectures": ["Gemma3TextModel"], "model_type": "gemma3_text",
            "vocab_size": 262144, "hidden_size": 768, "num_hidden_layers": 24,
            "num_attention_heads": 3, "num_key_value_heads": 1, "head_dim": 256,
            "intermediate_size": 1152, "max_position_embeddings": 2048, "sliding_window": 512,
            "rope_theta": 1e6, "rope_local_base_freq": 1e4, "query_pre_attn_scalar": 256,
            "rms_norm_eps": 1e-6, "use_bidirectional_attention": True,
            "layer_types": ["sliding_attention" if (i + 1) % 6 else "full_attention"
                            for i in range(24)]}
GEMMA_HEAD = (3072, 768)              # the SentenceTransformer 2_Dense / 3_Dense widths
#: splade-distil (naver/splade-cocondenser-ensembledistil: BERT-base MLM) and
#: the minilm-l6 cross-encoder (ms-marco-MiniLM-L-6-v2), as HF ``config.json``
SPLADE_HF = {"architectures": ["BertForMaskedLM"], "model_type": "bert", "vocab_size": 30522,
             "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
             "intermediate_size": 3072, "max_position_embeddings": 512, "type_vocab_size": 2}
RERANK_HF = {**SPLADE_HF, "architectures": ["BertForSequenceClassification"],
             "hidden_size": 384, "num_hidden_layers": 6, "intermediate_size": 1536,
             "num_labels": 1}
BF16_PEAK_FLOPS = 989e12


def write_checkpoints(torch, dev, root: Path, seed: int, gemma=GEMMA_HF, head=GEMMA_HEAD,
                      splade=SPLADE_HF, rerank=RERANK_HF) -> dict[str, Path]:
    """HF-layout checkpoints (``config.json`` + bf16 ``model.safetensors``,
    written by the port's own safetensors writer) with weights drawn on the
    card from ``seed``: linear and embedding weights N(0, 0.02), norm
    weights at their identity plus N(0, 0.05). EmbeddingGemma carries its
    ``2_Dense``/``3_Dense`` head; the SPLADE checkpoint omits the MLM decoder
    (tied to the word embeddings, as HF saves it); no ``tokenizer.json``
    (the hash tokenizer, as the reference without one)."""
    from cqs_tpu_torch.models.loader import write_safetensors

    gen = torch.Generator(device=dev).manual_seed(seed + 7)

    def draw(*shape, std=0.02, base=0.0):
        return (base + std * torch.randn(*shape, device=dev, generator=gen)).to(torch.bfloat16).cpu()

    def save(d: Path, config: dict, tensors: dict) -> Path:
        d.mkdir(parents=True)
        (d / "config.json").write_text(json.dumps(config, indent=1))
        write_safetensors(d / "model.safetensors", tensors)
        return d

    H, I, L = gemma["hidden_size"], gemma["intermediate_size"], gemma["num_hidden_layers"]
    hd, nh, nkv = gemma["head_dim"], gemma["num_attention_heads"], gemma["num_key_value_heads"]
    g = {"embed_tokens.weight": draw(gemma["vocab_size"], H), "norm.weight": draw(H, std=0.05)}
    for i in range(L):
        b = f"layers.{i}."
        g.update({b + "self_attn.q_proj.weight": draw(nh * hd, H),
                  b + "self_attn.k_proj.weight": draw(nkv * hd, H),
                  b + "self_attn.v_proj.weight": draw(nkv * hd, H),
                  b + "self_attn.o_proj.weight": draw(H, nh * hd),
                  b + "self_attn.q_norm.weight": draw(hd, std=0.05),
                  b + "self_attn.k_norm.weight": draw(hd, std=0.05),
                  b + "mlp.gate_proj.weight": draw(I, H), b + "mlp.up_proj.weight": draw(I, H),
                  b + "mlp.down_proj.weight": draw(H, I)})
        for norm in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            g[b + norm + ".weight"] = draw(H, std=0.05)
    out = {"gemma": save(root / "embeddinggemma", gemma, g)}
    for sub, (i, o) in (("2_Dense", (H, head[0])), ("3_Dense", head)):
        save(out["gemma"] / sub, {"in_features": i, "out_features": o, "bias": False},
             {"linear.weight": draw(o, i)})

    def bert(c: dict, top: dict) -> dict:
        H, I = c["hidden_size"], c["intermediate_size"]
        t = {"bert.embeddings.word_embeddings.weight": draw(c["vocab_size"], H),
             "bert.embeddings.position_embeddings.weight": draw(c["max_position_embeddings"], H),
             "bert.embeddings.token_type_embeddings.weight": draw(c["type_vocab_size"], H),
             "bert.embeddings.LayerNorm.weight": draw(H, std=0.05, base=1.0),
             "bert.embeddings.LayerNorm.bias": draw(H)}
        for i in range(c["num_hidden_layers"]):
            b = f"bert.encoder.layer.{i}."
            for name, (o, n) in (("attention.self.query", (H, H)), ("attention.self.key", (H, H)),
                                 ("attention.self.value", (H, H)),
                                 ("attention.output.dense", (H, H)),
                                 ("intermediate.dense", (I, H)), ("output.dense", (H, I))):
                t[b + name + ".weight"], t[b + name + ".bias"] = draw(o, n), draw(o)
            for name in ("attention.output.LayerNorm", "output.LayerNorm"):
                t[b + name + ".weight"] = draw(H, std=0.05, base=1.0)
                t[b + name + ".bias"] = draw(H)
        t.update(top)
        return t

    H = splade["hidden_size"]
    out["splade"] = save(root / "splade", splade, bert(splade, {
        "cls.predictions.transform.dense.weight": draw(H, H),
        "cls.predictions.transform.dense.bias": draw(H),
        "cls.predictions.transform.LayerNorm.weight": draw(H, std=0.05, base=1.0),
        "cls.predictions.transform.LayerNorm.bias": draw(H),
        "cls.predictions.bias": draw(splade["vocab_size"])}))
    H = rerank["hidden_size"]
    out["rerank"] = save(root / "rerank", rerank, bert(rerank, {
        "bert.pooler.dense.weight": draw(H, H), "bert.pooler.dense.bias": draw(H),
        "classifier.weight": draw(1, H), "classifier.bias": draw(1)}))
    return out


def gemma_flops(cfg, b: int, length: int) -> float:
    """Operations of one ``GemmaEmbedder`` forward over ``b`` rows of
    ``length`` tokens (2 a multiply-add): the projections and the MLP per
    token, q.k and probabilities.v per row over the whole [L, L] (as the
    model computes it, the window being a bias), the head per row."""
    H, hd = cfg.hidden_size, cfg.head_dim
    per_token = 2 * H * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + 2 * cfg.num_heads * hd * H \
        + 3 * 2 * H * cfg.intermediate_size
    per_row = 2 * 2 * cfg.num_heads * length * length * hd
    head = 2 * (H * cfg.proj_hidden + cfg.proj_hidden * cfg.embed_dim) if cfg.use_projection else 0
    return float(cfg.num_layers * (b * length * per_token + b * per_row) + b * head)


def phase_neural(torch, dev, seed: int, report, smi: str, checkpoints=write_checkpoints,
                 timed_shapes=((512, 2048),)):
    """The default configuration end to end at full width: EmbeddingGemma-300m
    dense, splade-distil sparse, ``--rerank`` over minilm-l6, from HF
    checkpoints written here from the seed. Indexes this repository through
    the CLI, answers the 10 queries solo, as one batcher burst (equal to
    solo) and reranked, and two CLI searches (one ``--rerank``); holds the
    card's bf16 EmbeddingGemma forward against an f32 forward of the same
    weights on 64 chunks (cosine >= 0.99); times the forward at every
    (batch, bucket) the index ran and at ``timed_shapes``, the B=1 query
    embedding, and the f32 q.k product against a bf16 one; profiles a 64 x
    2048 forward and a query's 8 x 64 (device-busy, launches, top kernels)."""
    import dataclasses

    import numpy as np

    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.daemon.batcher import QueryBatcher
    from cqs_tpu_torch.models.embedder import Embedder, build_module
    from cqs_tpu_torch.models.gemma import GemmaConfig, GemmaEmbedder
    from cqs_tpu_torch.models.layers import ATTN_SLICE_BYTES
    from cqs_tpu_torch.models.loader import load_safetensors_params

    tmp = Path(tempfile.mkdtemp(prefix="cqs_neural_"))
    out: dict = {"smi": smi}
    ctx = None
    shapes: dict = {}
    forward = Embedder._forward
    try:
        t0 = time.perf_counter()
        ckpt = checkpoints(torch, dev, tmp / "models", seed)
        out["checkpoints_s"] = time.perf_counter() - t0
        proj = tmp / "corpus"
        proj.mkdir()
        copy_corpus(proj)
        (proj / ".cqs-tpu.toml").write_text(
            f'[embedding]\nmodel = "embeddinggemma-300m"\nmodel_path = "{ckpt["gemma"]}"\n'
            f'[splade]\nmodel = "splade-distil"\nmodel_path = "{ckpt["splade"]}"\n'
            f'[reranker]\nmodel = "minilm-l6"\nmodel_path = "{ckpt["rerank"]}"\n')

        def tally(self, ids, mask):                 # the (batch, bucket) shapes the index runs
            shapes[ids.shape] = shapes.get(ids.shape, 0) + 1
            return forward(self, ids, mask)

        Embedder._forward = tally
        try:
            rc, env, ms = run_cli(main, ["index", "--path", str(proj), "--device", str(dev),
                                         "--json"])
        finally:
            Embedder._forward = forward
        if rc != 0 or env is None:
            fail(f"neural: index exited {rc}")
        stats = env["results"]
        out.update(index_s=ms / 1e3, chunks=stats["chunks_upserted"],
                   forward_shapes={f"{b}x{n}": c for (b, n), c in sorted(shapes.items())})
        print(f"neural: indexed {stats['files_parsed']} files -> {stats['chunks_upserted']} chunks "
              f"({stats['embedded']} embedded, {stats['sparse_encoded']} sparse) with "
              f"EmbeddingGemma-300m + splade-distil in {ms / 1e3:.1f} s (checkpoints written in "
              f"{out['checkpoints_s']:.1f} s); forwards (batch x bucket: calls) "
              f"{out['forward_shapes']}; {smi}")
        ctx = CommandContext.create(str(proj), device=dev)
        eng = ctx.engine
        emb = eng.embedder
        model = emb._ensure_model()
        if (emb.preset.name != "embeddinggemma-300m" or not isinstance(model, torch.nn.Module)
                or eng.splade.preset.name != "splade-distil" or eng.dense.matrix.shape[1] != 768):
            fail("neural: the engine does not run EmbeddingGemma + splade-distil at width 768")
        if dev.type == "cuda" and not all(p.is_cuda for p in model.parameters()):
            fail("neural: the embedder's weights are not on the card")

        solo, search_ms = {}, []
        for q in QUERIES:
            res = eng.search(q)
            if not res.hits:
                fail(f"neural: search {q!r} has no hits")
            solo[q] = [(h.row.id, h.score) for h in res.hits]
            search_ms.append(res.elapsed_ms)
        # the burst on a second engine, so no solo result comes from a cache
        ctx2 = CommandContext.create(str(proj), device=dev)
        batcher = QueryBatcher(ctx2.engine)
        try:
            batcher.pause()
            futs = [batcher.submit(q) for q in QUERIES]
            batcher.resume()
            batched = [f.result(timeout=300) for f in futs]
        finally:
            batcher.stop()
            ctx2.close()
        # queries at alpha 1 (dense only) run the solo program in the batcher
        st = batcher.stats
        if st["fused"] == 0 or st["fused"] + st["solo"] != len(QUERIES):
            fail(f"neural: the burst did not run batched: {st}")
        for q, res in zip(QUERIES, batched):
            if not same_hits([(h.row.id, h.score) for h in res.hits], solo[q]):
                fail(f"neural: batched result of {q!r} differs from solo")
        moved, rerank_ms = 0, []
        for q in QUERIES:
            res = eng.search(q, rerank=True)
            if not res.hits:
                fail(f"neural: reranked search {q!r} has no hits")
            moved += [h.row.id for h in res.hits] != [i for i, _ in solo[q]]
            rerank_ms.append(res.elapsed_ms)
        if type(eng._reranker).__name__ != "CrossEncoderReranker":
            fail(f"neural: --rerank ran {type(eng._reranker).__name__}, not the cross-encoder")
        cli = {}
        for label, extra in (("search", []), ("search --rerank", ["--rerank"])):
            rc, env, ms = run_cli(main, [QUERIES[0], *extra, "--path", str(proj), "--device",
                                         str(dev), "--json"])
            if rc != 0 or env is None or not env["results"]:
                fail(f"neural: CLI {label} exited {rc} without hits")
            cli[label] = ms
        out.update(search_ms=statistics.median(search_ms), rerank_ms=statistics.median(rerank_ms),
                   reranked_orders_changed=moved, cli_ms=cli)
        print(f"neural: {len(QUERIES)} queries: batched == solo ({st['fused']} in {st['batches']} "
              f"device batch(es), {st['solo']} dense-only solo); engine.search median {out['search_ms']:.2f} ms, reranked "
              f"{out['rerank_ms']:.2f} ms ({moved} of {len(QUERIES)} orders changed by "
              f"minilm-l6); CLI calls (model loads included): "
              f"{', '.join(f'{k} {v:.0f} ms' for k, v in cli.items())}; {smi}")

        # bf16 on the card against f32 of the same weights on the card
        texts = [r.nl or r.body for r in ctx.store.iter_chunks()][:64]
        cfg = GemmaConfig.from_hf_config(ckpt["gemma"])
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        m32 = build_module(lambda: GemmaEmbedder(cfg32), dev, 0)
        m32.load_state_dict(load_safetensors_params(ckpt["gemma"], m32.state_dict(), "gemma"))
        emb32 = Embedder("embeddinggemma-300m", ckpt["gemma"], device=dev)
        emb32._model = m32
        v16, v32 = emb.embed_documents(texts), emb32.embed_documents(texts)
        cos = (v16 * v32).sum(1) / (np.linalg.norm(v16, axis=1) * np.linalg.norm(v32, axis=1))
        out["bf16_vs_f32_cosine"] = {"min": float(cos.min()), "median": float(np.median(cos)),
                                     "rows": len(texts)}
        print(f"neural: bf16 forward vs f32 forward of the same weights on {len(texts)} chunks: "
              f"per-row cosine min {cos.min():.6f}, median {np.median(cos):.6f}; {smi}")
        if not np.isfinite(v16).all() or cos.min() < 0.99:
            fail(f"neural: bf16 against f32 cosine {cos.min():.6f} < 0.99")
        del m32, emb32
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the forward at the shapes the index ran and at the largest
        gen = torch.Generator(device=dev).manual_seed(seed + 11)
        rows = []
        for b, n in sorted(set(shapes) | set(timed_shapes)):
            ids = torch.randint(3, emb.tokenizer.vocab_size, (b, n), device=dev, generator=gen)
            mask = torch.ones(b, n, dtype=torch.int32, device=dev)
            iters = 2 if b * n >= 1 << 18 else 5 if b * n >= 1 << 15 else 20
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                ms = cuda_ms(lambda: model(ids, mask), iters)
            flops = gemma_flops(cfg, b, n)
            row = {"batch": b, "bucket": n, "ms": ms, "tokens_per_s": b * n / ms * 1e3,
                   "tflops": flops / ms / 1e9, "peak_share": flops / ms * 1e3 / BF16_PEAK_FLOPS,
                   "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                                    if dev.type == "cuda" else None),
                   "index_calls": shapes.get((b, n), 0)}
            rows.append(row)
            print(f"neural: forward {b} x {n}: {ms:.3f} ms, {row['tokens_per_s']:.0f} tokens/s, "
                  f"{row['tflops']:.1f} TFLOP/s = {row['peak_share']:.1%} of the 989 TFLOP/s bf16 "
                  f"dense peak, peak memory {row['peak_mem_gib'] or 0:.2f} GiB "
                  f"({row['index_calls']} calls in the index); {smi}")
            del ids, mask
        out["forward"] = rows
        # the f32 q.k product of one attention slice at the largest timed
        # shape (at 512 x 2048: 21 rows of 3 heads x 2048 x 256) against the
        # same product in bf16
        b, n = max(timed_shapes, key=lambda s: s[0] * s[1] * s[1])
        b = min(b, max(1, ATTN_SLICE_BYTES // (cfg.num_heads * n * n * 4)))
        q = torch.randn(b, cfg.num_heads, n, cfg.head_dim, device=dev, generator=gen)
        k = torch.randn(b, cfg.num_heads, n, cfg.head_dim, device=dev, generator=gen)
        q16, k16 = q.to(torch.bfloat16), k.to(torch.bfloat16)
        f32_ms = cuda_ms(lambda: torch.matmul(q, k.transpose(-1, -2)), 5)
        bf16_ms = cuda_ms(lambda: torch.matmul(q16, k16.transpose(-1, -2)), 5)
        out["qk_slice"] = {"shape": [b, cfg.num_heads, n, n, cfg.head_dim],
                           "f32_ms": f32_ms, "bf16_ms": bf16_ms}
        print(f"neural: q.k of one attention slice ({b} x {cfg.num_heads} x {n} x {n} x "
              f"{cfg.head_dim}): f32 {f32_ms:.3f} ms, bf16 {bf16_ms:.3f} ms; {smi}")
        del q, k, q16, k16
        # where the forward's time goes: one 64 x 2048 forward (per row the
        # mix of 512 x 2048) and the shape of a B=1 query embedding
        out["profile"] = {}
        for b, n in ((64, 2048), (8, 64)):
            ids = torch.randint(3, emb.tokenizer.vocab_size, (b, n), device=dev, generator=gen)
            mask = torch.ones(b, n, dtype=torch.int32, device=dev)
            with torch.inference_mode():
                busy, by_kernel, launches, runtime = device_busy(
                    torch, lambda: model(ids, mask), 2)
                wall = cuda_ms(lambda: model(ids, mask), 2)
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
            host = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:4]
            # operations that make the host wait for the card, one forward
            syncs: dict = {}
            if dev.type == "cuda":
                import warnings

                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with warnings.catch_warnings(record=True) as caught, torch.inference_mode():
                        warnings.simplefilter("always")
                        model(ids, mask)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                for w in caught:
                    line = str(w.message).splitlines()[0][:80]
                    syncs[line] = syncs.get(line, 0) + 1
            out["profile"][f"{b}x{n}"] = {"busy_ms": busy, "wall_ms": wall, "launches": launches,
                                         "top": top, "runtime": host, "syncs": syncs}
            print(f"neural: profile {b} x {n}: device-busy {busy:.3f} ms of {wall:.3f} ms wall, "
                  f"{launches:.0f} kernel launches a forward; top kernels (ms): "
                  f"{'; '.join(f'{k} {v:.3f}' for k, v in top)}; host CUDA calls (count, ms): "
                  f"{'; '.join(f'{k} {c:.0f} {t:.3f}' for k, (c, t) in host)}; host waits "
                  f"(sync debug mode): {syncs or 'none'}; {smi}")
        # B=1 query embedding (a new text each time: no LRU or cache hit)
        lat = []
        for i in range(20):
            t1 = time.perf_counter()
            emb.embed_query(f"{QUERIES[i % len(QUERIES)]} variant {i}")
            lat.append((time.perf_counter() - t1) * 1e3)
        out["query_embed_ms"] = statistics.median(lat)
        print(f"neural: B=1 query embedding (pads to 8 x 64) median {out['query_embed_ms']:.2f} "
              f"ms host clock over 20 new queries; {smi}")
        report["neural"] = out
    finally:
        Embedder._forward = forward
        if ctx is not None:
            ctx.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 8: the graph ANN and tiered index ------------------------------------

#: the graph phase's corpus: rows, width, queries, and the exact build's rows
#: (just under ``GraphIndex.EXACT_BUILD_MAX``). A query whose cluster the beam
#: never reaches finds none of its top-10, and at beam 512 4-6% of queries do,
#: so R@10 over 256 queries spreads by about 0.01 (PERF.md, PR 9): 2,048
#: queries hold it to the floors below, and the first 256 are reported too
GRAPH_ROWS, GRAPH_DIM, GRAPH_QUERIES = 1 << 20, 768, 2048
GRAPH_EXACT_ROWS = 196608
#: (beam, iters) of the recall sweep at 1M: the default (640, 32) and the
#: reference's validation points (``scripts/validate_graph_1m.py``); expand
#: is ``GraphIndex.search``'s max(8, beam // 16); the least R@10 each must reach
GRAPH_BEAMS = ((None, None, None), (512, 32, 0.95), (1024, 48, 0.98))
#: a unique function for the watch loop's added file and the overlay's edit
GRAPH_ADDED = '''"""Added to the tiered index's delta."""


def jubilant_okapi_registrar(okapis):
    """Register every jubilant okapi in the reserve's ledger."""
    return len(okapis)
'''
GRAPH_DIRTY = '''

def wistful_narwhal_cartographer(tusks):
    """Chart the wistful narwhal's migration from its tusk readings."""
    return tusks
'''


def graph_corpus(torch, dev, seed: int, n: int, d: int, queries: int):
    """The recipe of ``scripts/validate_graph_1m.py`` on the card: 1,024
    centers, rows = a center + 0.35 noise, L2-normalized, stored bf16 (made
    in 65,536-row blocks); queries = a corpus row + 0.05 noise, normalized
    (f32). Drawn from a generator of its own."""
    gen = torch.Generator(device=dev).manual_seed(seed + 524287)
    centers = torch.randn(1024, d, generator=gen, device=dev)
    mat = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 65536):
        e = min(n, s + 65536)
        block = (centers[torch.randint(0, 1024, (e - s,), generator=gen, device=dev)]
                 + 0.35 * torch.randn(e - s, d, generator=gen, device=dev))
        mat[s:e] = (block / block.norm(dim=1, keepdim=True).clamp_min(1e-9)).to(torch.bfloat16)
    rows = torch.randint(0, n, (queries,), generator=gen, device=dev)
    q = mat[rows].float() + 0.05 * torch.randn(queries, d, generator=gen, device=dev)
    return mat, q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)


def knn_lists_f64(torch, mat, degree: int, batch: int = 1024):
    """``graph.knn_lists`` with every dot summed in float64 (exact for bf16
    rows): the lists neither f32 sum order moves, to hold both builds to."""
    import numpy as np

    m64, out = mat.double(), []
    n = mat.shape[0]
    for s in range(0, n, batch):
        e = min(n, s + batch)
        idx = torch.sort(m64[s:e] @ m64.T, dim=1, descending=True,
                         stable=True).indices[:, :degree + 1].cpu().numpy()
        ordp = np.argsort(idx == np.arange(s, e)[:, None], axis=1, kind="stable")
        out.append(np.take_along_axis(idx, ordp, axis=1)[:, :degree].astype(np.int32))
    return np.concatenate(out)


def pair_scores(torch, mat, i, j):
    """f32 dots of the bf16 rows mat[i] and mat[j] (1-D index tensors)."""
    return (mat[i].float() * mat[j].float()).sum(dim=1)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def graph_engine_run(torch, dev, proj: Path, kind: str, report) -> None:
    """The engine on the repository corpus with ``index_kind`` = ``kind`` and
    every alpha at 1 (so each query is dense-only, the ANN's case): the ANN
    is built on the card, answers the solo queries, a paused batcher burst
    equals solo, and the top-10 is held against the exact dense-only
    program. Under tiered, the watch loop then adds, edits and deletes a
    file: the refresh stays incremental and the added function is found from
    the delta tier."""
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.daemon.batcher import QueryBatcher
    from cqs_tpu_torch.daemon.watch import WatchLoop
    from cqs_tpu_torch.index import GraphIndex, TieredIndex
    from cqs_tpu_torch.ops.topk import LOOP_SPLIT
    from cqs_tpu_torch.search.engine import SearchEngine
    from cqs_tpu_torch.search.router import Category

    calls = {"n": 0}
    real = SearchEngine._ann_query

    def counted(self, *a, **kw):
        out = real(self, *a, **kw)
        calls["n"] += out is not None
        return out

    env = {"CQST_INDEX_KIND": kind, **{f"CQST_ALPHA_{c.value.upper()}": "1.0" for c in Category}}
    SearchEngine._ann_query = counted
    ctx = ctx2 = None
    out: dict = {}
    try:
        with knobs(env):
            before = LOOP_SPLIT.launches
            t0 = time.perf_counter()
            ctx = CommandContext.create(str(proj), device=dev)
            eng = ctx.engine
            sync(torch, dev)
            out["engine_load_s"] = time.perf_counter() - t0
            want = GraphIndex if kind == "graph" else TieredIndex
            if not isinstance(eng.ann, want) or eng.ann.count != eng.dense.count:
                fail(f"graph[{kind}]: the engine built {type(eng.ann).__name__}, not {want.__name__}")
            base = eng.ann if kind == "graph" else eng.ann.base
            if not base.matrix.is_cuda and dev.type == "cuda":
                fail(f"graph[{kind}]: the ANN's rows are not on the card")
            out["build_launches"] = LOOP_SPLIT.launches - before
            if dev.type == "cuda" and out["build_launches"] <= 0:
                fail(f"graph[{kind}]: the exact graph build did not launch {LOOP_SPLIT.name}")
            solo, ms = {}, []
            for q in QUERIES:
                res = eng.search(q)
                solo[q] = [(h.row.id, h.score) for h in res.hits]
                ms.append(res.elapsed_ms)
                if not res.hits or res.alpha != 1.0:
                    fail(f"graph[{kind}]: {q!r}: alpha {res.alpha}, {len(res.hits)} hits")
            if calls["n"] == 0:
                fail(f"graph[{kind}]: no query was answered by the ANN")
            out["ann_answers"], out["search_ms"] = calls["n"], statistics.median(ms)
            # the ANN's own top-10 against the exact scan of the dense index
            ann_r = []
            for q in QUERIES:
                q_vec = eng._embed_query_cached(q)
                got = eng.ann.search(q_vec, 10)[1]
                got = set(got[0]) if kind == "tiered" else {eng.ann.ids[r] for r in got[0]}
                want = set(eng.dense.rows_to_ids(eng.dense.search(q_vec, 10)[1])[0])
                ann_r.append(len(got & want) / 10)
            out["ann_r_at_10"] = float(statistics.mean(ann_r))
            if out["ann_r_at_10"] < 0.95:
                fail(f"graph[{kind}]: the ANN's R@10 against the exact dense scan is "
                     f"{out['ann_r_at_10']:.4f}")
            # the exact dense-only program on the same indexes
            ann, eng.ann, eng._result_cache = eng.ann, None, {}
            exact = {q: [h.row.id for h in eng.search(q).hits] for q in QUERIES}
            eng.ann, eng._result_cache = ann, {}
            out["top10_vs_exact"] = float(statistics.mean(
                len({i for i, _ in solo[q][:10]} & set(exact[q][:10])) / max(1, len(exact[q][:10]))
                for q in QUERIES))
            ctx2 = CommandContext.create(str(proj), device=dev)
            batcher = QueryBatcher(ctx2.engine)
            try:
                batcher.pause()
                futs = [batcher.submit(q) for q in QUERIES]
                batcher.resume()
                batched = [f.result(timeout=120) for f in futs]
            finally:
                batcher.stop()
            for q, res in zip(QUERIES, batched):
                if [(h.row.id, h.score) for h in res.hits] != solo[q]:
                    fail(f"graph[{kind}]: batched result of {q!r} differs from solo")
            print(f"graph[{kind}]: engine with {type(eng.ann).__name__} over {eng.dense.count} "
                  f"rows loaded in {out['engine_load_s']:.2f} s ({out['build_launches']} "
                  f"{LOOP_SPLIT.name} launches); {out['ann_answers']} queries answered by the "
                  f"ANN; batched == solo for {len(QUERIES)}; the ANN's R@10 against the exact "
                  f"dense scan {out['ann_r_at_10']:.4f}; hits' top-10 against the exact "
                  f"dense-only program's {out['top10_vs_exact']:.4f}; engine.search median "
                  f"{out['search_ms']:.2f} ms")
            if kind == "tiered":
                loop = WatchLoop(ctx)
                if loop.reconcile_once() != 0:
                    fail("graph[tiered]: the first reconcile found changes")
                (proj / "cqs_tpu" / "zz_okapi_module.py").write_text(GRAPH_ADDED)
                edited = proj / "scripts" / "validate_graph_1m.py"
                edited.write_text(edited.read_text() + "\n# edited\n")
                (proj / "docs" / "graph_doomed.py").unlink()
                base0 = eng.ann.base
                t0 = time.perf_counter()
                changed = loop.reconcile_once()
                out["reconcile_s"] = time.perf_counter() - t0
                if changed != 3 or eng.ann.base is not base0 or eng.ann.delta_count < 1:
                    fail(f"graph[tiered]: reconcile gave {changed}; base rebuilt "
                         f"{eng.ann.base is not base0}, delta {eng.ann.delta_count}")
                hit = eng.search("jubilant okapi registrar").hits
                if not hit or hit[0].row.name != "jubilant_okapi_registrar" or \
                        hit[0].row.id not in eng.ann.delta.ids:
                    fail(f"graph[tiered]: the added function was not found from the delta: "
                         f"{[h.row.name for h in hit[:3]]}")
                out["delta_rows"] = eng.ann.delta_count
                print(f"graph[tiered]: reconcile of 3 changed files in {out['reconcile_s']:.2f} s "
                      f"without a graph rebuild; the added function found from the delta "
                      f"({eng.ann.delta_count} rows)")
    finally:
        SearchEngine._ann_query = real
        for c in (ctx2, ctx):
            if c is not None:
                c.close()
    report.setdefault("graph", {})[kind] = out


def phase_graph(torch, dev, seed: int, report, smi: str, n: int = GRAPH_ROWS,
                exact_rows: int = GRAPH_EXACT_ROWS, d: int = GRAPH_DIM,
                queries: int = GRAPH_QUERIES):
    """The graph ANN on the card: a clustered n x d corpus made there, its
    exact top-10 through ``LOOP_SPLIT`` (16 queries against the plain scan),
    an NN-descent graph (degree 32, 8 rounds) with R@10 against exact at the
    default beam and at beams 512 and 1024, the beam search's time at B=1
    and B=128 (wall, device-busy, launches), and the exact kNN build at
    ``exact_rows`` rows through ``LOOP_SPLIT`` held slot by slot against the
    plain build; then the engine on the repository corpus under
    ``index_kind`` graph and tiered, and one ``--worktree`` search and one
    ``embed-2d`` through the CLI."""
    import numpy as np

    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.index import graph
    from cqs_tpu_torch.ops import topk

    out: dict = {"smi": smi, "n": n, "d": d}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mat, q = graph_corpus(torch, dev, seed, n, d, queries)
    sync(torch, dev)
    out["corpus_s"] = time.perf_counter() - t0
    mask = torch.ones(n, dtype=torch.int32, device=dev)

    # -- exact ground truth through the split kernel, 16 queries held to plain
    before = topk.LOOP_SPLIT.launches
    t0 = time.perf_counter()
    gt_v, gt = topk.scan_topk(mat, q, 10, mask, tile_n=2048, extraction="loop")
    sync(torch, dev)
    out["exact_s"] = time.perf_counter() - t0
    if cuda and topk.LOOP_SPLIT.launches <= before:
        fail(f"graph: the exact top-10 did not launch {topk.LOOP_SPLIT.name}")
    pv, pr = topk.topk_plain(mat, q[:16], 10, mask)
    if not torch.allclose(gt_v[:16], pv, rtol=RTOL, atol=ATOL):
        fail("graph: the exact top-10's values differ from the plain scan")
    diff = gt[:16] != pr
    if diff.any():
        qi = torch.arange(16, device=dev)[:, None].expand(16, 10)[diff]
        qb = q[:16].to(torch.bfloat16).float()
        a = (qb[qi] * mat[gt[:16][diff].long()].float()).sum(1)
        b = (qb[qi] * mat[pr[diff].long()].float()).sum(1)
        if not torch.all((a - b).abs() <= ATOL + RTOL * b.abs()):
            fail("graph: the exact top-10's rows differ from the plain scan beyond near-ties")
    gt = gt.cpu().numpy()
    print(f"graph: {n} x {d} bf16 corpus made on the device in {out['corpus_s']:.1f} s; exact "
          f"top-10 of {queries} queries in {out['exact_s']:.2f} s through "
          f"{topk.LOOP_SPLIT.name}, 16 held against the plain scan "
          f"({int(diff.sum())} near-tie swaps)")

    # -- NN-descent build: device refine vs host reverse edges
    host = {"s": 0.0}
    real_rev = graph.add_reverse_edges

    def timed_rev(nbrs, half=None):
        t = time.perf_counter()
        try:
            return real_rev(nbrs, half)
        finally:
            host["s"] += time.perf_counter() - t

    graph.add_reverse_edges = timed_rev
    try:
        t0 = time.perf_counter()
        neighbors = graph.nn_descent_graph(mat, 32, rounds=8, mat_dev=mat, device=dev)
        out["nnd_s"] = time.perf_counter() - t0
    finally:
        graph.add_reverse_edges = real_rev
    out["nnd_reverse_edges_s"] = host["s"]
    out["nnd_refine_s"] = out["nnd_s"] - host["s"]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    if neighbors.shape != (n, 32) or (neighbors == np.arange(n)[:, None]).any():
        fail(f"graph: the NN-descent graph has shape {neighbors.shape} or self-edges")
    print(f"graph: NN-descent (degree 32, 8 rounds) in {out['nnd_s']:.1f} s: device refine "
          f"(with RNG draws and transfers) {out['nnd_refine_s']:.1f} s, host reverse edges "
          f"{out['nnd_reverse_edges_s']:.1f} s; peak device memory "
          f"{out['peak_gib'] or 0:.2f} GiB")

    # -- beam search: recall against exact, then time at B=1 and B=128
    g_dev = torch.from_numpy(neighbors.astype(np.int64)).to(dev)
    recall = {}
    for beam, iters, floor in GRAPH_BEAMS:
        beam = beam or min(max(64, graph.default_itopk(n)), n)
        iters = iters or max(4, int(1.6 * np.log2(max(n, 2))))
        expand = max(8, beam // 16)
        starts = torch.from_numpy(np.linspace(0, n - 1, beam).astype(np.int32)).to(dev)
        _, rows = graph.graph_search(mat, g_dev, mask, q, starts, 10, iters, expand)
        rows = rows.cpu().numpy()
        per = np.array([len(set(rows[i]) & set(gt[i])) / 10 for i in range(queries)])
        r = float(per.mean())
        recall[beam] = {"iters": iters, "expand": expand, "r_at_10": r,
                        "r_at_10_first_256": float(per[:256].mean()),
                        "queries_with_none": int((per == 0).sum())}
        if floor is not None and r < floor:
            fail(f"graph: R@10 against exact {r:.4f} at beam {beam} is below {floor}")
    out["recall"] = recall
    beam0 = next(iter(recall))                            # the default beam
    iters0, expand0 = recall[beam0]["iters"], recall[beam0]["expand"]
    starts0 = torch.from_numpy(np.linspace(0, n - 1, beam0).astype(np.int32)).to(dev)
    timing = {}
    for b in (1, 128):
        def search(b=b):
            return graph.graph_search(mat, g_dev, mask, q[:b], starts0, 10, iters0, expand0)
        search()
        sync(torch, dev)
        reps = 10 if b == 1 else 3
        t0 = time.perf_counter()
        for _ in range(reps):
            search()
        sync(torch, dev)
        wall = (time.perf_counter() - t0) / reps * 1e3
        busy, by_kernel, launches, _ = device_busy(torch, search, calls=3) if cuda else (
            None, {}, None, None)
        timing[b] = {"wall_ms": wall, "ms_per_query": wall / b, "busy_ms": busy,
                     "launches": launches}
    out["search"] = timing
    print(f"graph: R@10 against exact over {queries} queries (first 256; queries with none "
          f"of their top-10): " + "; ".join(
              f"beam {k} (iters {v['iters']}, expand {v['expand']}) {v['r_at_10']:.4f} "
              f"({v['r_at_10_first_256']:.4f}; {v['queries_with_none']})"
              for k, v in recall.items()))
    print("graph: beam search at the default beam " + str(beam0) + ": " + "; ".join(
        f"B={b}: {t['wall_ms']:.2f} ms wall ({t['ms_per_query']:.3f} ms a query), "
        f"device-busy {t['busy_ms'] or 0:.2f} ms, {t['launches'] or 0:.0f} launches a call"
        for b, t in timing.items()))
    del g_dev

    # -- the exact kNN build through the split kernel against the plain build
    sub = mat[:exact_rows]
    before = topk.LOOP_SPLIT.launches
    t0 = time.perf_counter()
    kern = graph.knn_lists(sub, 32, device=dev)
    out["exact_build_s"] = time.perf_counter() - t0
    out["exact_build_launches"] = topk.LOOP_SPLIT.launches - before
    if cuda and out["exact_build_launches"] != -(-exact_rows // graph.KNN_BLOCK):
        fail(f"graph: the exact build launched {topk.LOOP_SPLIT.name} "
             f"{out['exact_build_launches']} times")
    t0 = time.perf_counter()
    with recorded_scans(plain=True, record=False):
        plain = graph.knn_lists(sub, 32, device=dev)
    out["plain_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = knn_lists_f64(torch, sub, 32)
    out["f64_build_s"] = time.perf_counter() - t0
    diff = np.argwhere(kern != plain)
    agree = 1.0 - len(diff) / kern.size
    worst = 0.0
    if len(diff):
        i = torch.from_numpy(diff[:, 0]).to(dev)
        a = pair_scores(torch, sub, i, torch.from_numpy(kern[diff[:, 0], diff[:, 1]]).to(dev))
        b = pair_scores(torch, sub, i, torch.from_numpy(plain[diff[:, 0], diff[:, 1]]).to(dev))
        worst = float((a - b).abs().max())
        if worst > 1e-5:
            fail(f"graph: a kernel-built neighbor differs from the plain build by {worst} "
                 f"in score (not a near-tie)")
    # each f32 build swaps near-ties against the float64 lists by its own sum
    # order: the kernel's must swap no more than the plain build's
    k_exact = float((kern == exact).mean())
    p_exact = float((plain == exact).mean())
    if k_exact < max(0.999, p_exact - 0.0005):
        fail(f"graph: the kernel-built lists agree with the float64 lists in {k_exact:.6f} of "
             f"slots, the plain build's in {p_exact:.6f}")
    full = float((graph.add_reverse_edges(kern) == graph.add_reverse_edges(plain)).mean())
    out["exact_build"] = {"rows": exact_rows, "slot_agreement": agree, "differing": len(diff),
                          "worst_score_gap": worst, "graph_agreement": full,
                          "kernel_vs_f64": k_exact, "plain_vs_f64": p_exact}
    print(f"graph: exact kNN build at {exact_rows} x {d} in {out['exact_build_s']:.2f} s "
          f"({out['exact_build_launches']} {topk.LOOP_SPLIT.name} launches; plain build "
          f"{out['plain_build_s']:.2f} s, float64 build {out['f64_build_s']:.2f} s): slot "
          f"agreement with the plain build {agree:.6f} ({len(diff)} slots differ, every one a "
          f"near-tie, score gap <= {worst:.2e}), after reverse edges {full:.6f}; with the "
          f"float64 lists: kernel {k_exact:.6f}, plain {p_exact:.6f}")
    # one block of the build, timed (these launches are not the path's)
    if cuda:
        counted = topk.LOOP_SPLIT.launches
        block, m = sub[:graph.KNN_BLOCK], 33
        ms = cuda_ms(lambda: topk.LOOP_SPLIT(sub, block, mask[:exact_rows], 2048, m), 20)
        plain_ms = cuda_ms(lambda: topk.scan_topk_plain_loop(sub, block, mask[:exact_rows],
                                                             2048, m), 5)
        lib_ms = cuda_ms(lambda: torch.matmul(block, sub.T), 20)
        topk.LOOP_SPLIT.launches = counted
        bound = bound_ms("bf16", exact_rows, d, graph.KNN_BLOCK, 2048, m)
        out["build_block"] = {"n": exact_rows, "d": d, "b": graph.KNN_BLOCK, "tile": 2048,
                              "m": m, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                              "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"graph: one build block ({exact_rows} x {d}, B={graph.KNN_BLOCK}, tile 2048, "
              f"m {m}): {topk.LOOP_SPLIT.name} {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"torch.matmul of the scores {lib_ms:.3f} ms, bound {bound[0]:.3f} ms by "
              f"{bound[1]}; {smi}")
    del mat, q, sub, mask

    # -- the engine on the repository corpus, then the overlay and embed-2d
    tmp = Path(tempfile.mkdtemp(prefix="cqs_graph_"))
    try:
        proj = tmp / "corpus"
        proj.mkdir()
        copy_corpus(proj)
        (proj / "docs" / "graph_doomed.py").write_text(DOOMED_FILE)
        rc, env, _ = run_cli(main, ["index", "--path", str(proj), "--device", str(dev), "--json"])
        if rc != 0 or env is None:
            fail(f"graph: index exited {rc}")
        for kind in ("graph", "tiered"):
            graph_engine_run(torch, dev, proj, kind, report)
        # a dirty file: the worktree overlay finds its new function, and the
        # index without it does not
        dirty = proj / "cqs_tpu" / "index" / "tiered.py"
        dirty.write_text(dirty.read_text() + GRAPH_DIRTY)
        rc, env, ms = run_cli(main, ["wistful narwhal cartographer", "--worktree", "--path",
                                     str(proj), "--device", str(dev), "--json"])
        names = [h["name"] for h in (env or {}).get("results", [])]
        if rc != 0 or not names or names[0] != "wistful_narwhal_cartographer":
            fail(f"graph: the --worktree search gave rc {rc} and {names[:3]}")
        rc, env, _ = run_cli(main, ["wistful narwhal cartographer", "--path", str(proj),
                                    "--device", str(dev), "--json"])
        if rc != 0 or "wistful_narwhal_cartographer" in [h["name"] for h in env["results"]]:
            fail("graph: a search without --worktree found the uncommitted function")
        out["worktree_cli_ms"] = ms
        rc, _, ms = run_cli(main, ["embed-2d", "--path", str(proj), "--device", str(dev)])
        from cqs_tpu_torch.store import Store

        st = Store.open(proj / ".cqs-tpu", readonly=True)
        try:
            placed, embedded = st.db.execute(
                "SELECT COUNT(umap_x), COUNT(embedding) FROM chunks").fetchone()
        finally:
            st.close()
        if rc != 0 or placed == 0 or placed != embedded:
            fail(f"graph: embed-2d exited {rc} and placed {placed} of {embedded} chunks")
        out["embed_2d"] = {"chunks": placed, "cli_ms": ms}
        print(f"graph: --worktree search through the CLI found the uncommitted function "
              f"({out['worktree_cli_ms']:.0f} ms); embed-2d placed {placed} chunks "
              f"({ms:.0f} ms); {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report.setdefault("graph", {}).update(out)


# -- phase 9: the training path and the distilled tier --------------------------

#: the train phase's command lines (docs/trained-tier.md): the FINAL
#: distillation recipe (:84-90, its repro :138-156), the contrastive recipe
#: of checkpoint r3a (:180), the cross-encoder at its command defaults, the
#: hybrid at ``TrainConfig`` defaults
TRAIN_RECIPES = {
    "distill": ["--steps", "300", "--batch", "16", "--hidden-size", "384",
                "--intermediate-size", "768", "--cands", "16"],
    "contrastive": ["--steps", "100", "--batch", "128", "--hidden-size", "384",
                    "--num-layers", "6", "--intermediate-size", "1536", "--seq-len", "128",
                    "--negatives-per", "2"],
    "reranker": ["--steps", "50"],
    "hybrid": ["--family", "hybrid", "--steps", "20"],
}
#: four e2e queries (the default tier) and four for the tier: negation
#: queries run the tier's hybrid program (tier_categories defaults to
#: identifier_lookup and negation; identifier lookups take the name-only
#: path, no scan)
TIER_QUERIES = QUERIES[:4] + ["not the store upsert", "search without the daemon",
                              "tokenize without the native library", "DistillBatcher"]
#: H100 SXM bf16 dense tensor-core peak (the share a training step reaches)
BF16_PEAK = 989e12


def run_cli_text(main, argv) -> tuple[int, str, float]:
    """A CLI call's exit code, standard output and host milliseconds."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue(), (time.perf_counter() - t0) * 1e3


def write_pool(proj: Path, pairs_path: Path, pool: Path, gate: Path, held: int) -> int:
    """A v3-format labeled pool from mined pairs (query -> the positive's
    origin and name), its first ``held`` queries a held-out gate file.
    Returns the pool's size."""
    from cqs_tpu_torch.store import Store
    from cqs_tpu_torch.train.data import load_pairs

    store = Store.open(proj / ".cqs-tpu", slot="default", readonly=True)
    try:
        qs, seen = [], set()
        for p in load_pairs(pairs_path):
            row = store.get_chunk(p.positive_id) if p.positive_id else None
            if row is None or p.query in seen:
                continue
            seen.add(p.query)
            qs.append({"query": p.query,
                       "gold_chunk": {"origin": row.origin, "name": row.name.split("#w")[0]}})
    finally:
        store.close()
    gate.write_text(json.dumps({"queries": qs[:held]}))
    pool.write_text(json.dumps({"queries": qs[held:]}))
    return len(qs) - held


def check_losses(name: str, log: Path, steps: int) -> dict:
    """Every loss of ``<out>/train_log.jsonl`` finite, and the mean of the
    last n below the mean of the first n (n = 20, or half a shorter run)."""
    import math

    rows = [json.loads(ln) for ln in log.read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    if len(losses) != steps:
        fail(f"train: {name} logged {len(losses)} steps, ran {steps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: {name} has a loss that is not finite")
    n = min(20, steps // 2)
    first, last = statistics.fmean(losses[:n]), statistics.fmean(losses[-n:])
    if not last < first:
        fail(f"train: {name} loss did not fall: mean of the first {n} {first:.4f}, "
             f"of the last {n} {last:.4f}")
    return {"steps": steps, "first": first, "last": last, "n": n}


def encoder_flops(layers: int, hidden: int, inter: int, tokens: int, rows: int,
                  length: int) -> float:
    """Operations of a training step of a BERT encoder (forward, and
    backward at twice the forward): 6 x the matmul parameters x tokens, plus
    the attention products (q.k and p.v: 2 x 2 x L^2 x H a row and layer)
    times 3."""
    params = layers * (4 * hidden * hidden + 2 * hidden * inter)
    return 6.0 * params * tokens + 3.0 * layers * 4.0 * length * length * hidden * rows


def time_step(torch, loss_fn, apply, batch, iters: int = 5, warmup: int = 2) -> dict:
    """One training step's device time split into forward (the loss),
    backward and the optimizer (CUDA events, mean of ``iters`` steps after
    ``warmup`` warm-up steps), its wall time (host clock to a synchronize)
    and the peak device memory of a step."""
    for _ in range(warmup):
        loss, _ = loss_fn(*batch)
        loss.backward()
        apply()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    parts = [0.0, 0.0, 0.0]
    t0 = time.perf_counter()
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = loss_fn(*batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        apply()
        ev[3].record()
        torch.cuda.synchronize()
        for i in range(3):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / iters
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return {"forward_ms": parts[0], "backward_ms": parts[1], "optimizer_ms": parts[2],
            "step_ms": sum(parts), "wall_ms": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def measure_trainers(torch, dev, proj: Path, pairs_path: Path, labels: Path) -> dict:
    """Each recipe's trainer built here on the card at its recipe's widths,
    one batch of the phase's data: ms a step (forward, backward, optimizer),
    sequences/s and tokens/s, the share of the bf16 peak, peak memory, and a
    profile of one step (device-busy, launches)."""
    import dataclasses

    import numpy as np

    from cqs_tpu_torch.models.bert import BertConfig
    from cqs_tpu_torch.models.tokenizer import load_tokenizer
    from cqs_tpu_torch.parallel.train import (ContrastiveTrainer, DistillTrainer,
                                              RerankerTrainer, TrainConfig, make_pair_batch)
    from cqs_tpu_torch.store import Store
    from cqs_tpu_torch.train.data import load_pairs
    from cqs_tpu_torch.train.distill import DistillBatcher, load_teacher_labels

    tok = load_tokenizer(None, vocab_size=32768)
    out = {}
    store = Store.open(proj / ".cqs-tpu", slot="default", readonly=True)
    try:
        cfg = dataclasses.replace(TrainConfig(), batch_per_device=16, hidden_size=384,
                                  intermediate_size=768)
        tr = DistillTrainer(cfg, device=dev)
        batch = DistillBatcher(store, load_teacher_labels(labels), tok, cfg.seq_len,
                               k=16).batch(16)
        rows = 16 * 17
        runs = {"distill": (tr, tr.distill_loss, batch, rows, cfg.seq_len, cfg)}
        cfg = dataclasses.replace(TrainConfig(), batch_per_device=128, hidden_size=384,
                                  num_layers=6, intermediate_size=1536, seq_len=128)
        tr = ContrastiveTrainer(cfg, device=dev)
        pairs = load_pairs(pairs_path)[:128]
        negs = [(p.negatives + [q.positive for q in pairs[:2]])[:2] for p in pairs]
        encs = [tok.encode("d: " + t, cfg.seq_len) for row in negs for t in row]
        batch = (*make_pair_batch(["q: " + p.query for p in pairs],
                                  ["d: " + p.positive for p in pairs], tok, cfg.seq_len),
                 np.stack([e.ids for e in encs]).reshape(128, 2, -1),
                 np.stack([e.mask for e in encs]).reshape(128, 2, -1))
        runs["contrastive"] = (tr, tr.loss, batch, 128 * 4, cfg.seq_len, cfg)
    finally:
        store.close()
    bcfg = BertConfig(vocab_size=32768, hidden_size=256, num_layers=4, num_heads=8,
                      intermediate_size=1024, max_position=192, dtype=torch.bfloat16)
    tr = RerankerTrainer(bcfg, 50, device=dev)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 32768, size=(32, 192)).astype(np.int32)
    mask = np.ones((32, 192), np.int32)
    types = (np.arange(192)[None, :] >= 96).repeat(32, 0).astype(np.int32)
    runs["reranker"] = (tr, tr.loss, (ids, mask, types, ids[::-1].copy(), mask, types), 64,
                        192, bcfg)

    for name, (tr, loss_fn, batch, rows, length, cfg) in runs.items():
        t = time_step(torch, loss_fn, tr.opt.step, batch)
        flops = encoder_flops(cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                              rows * length, rows, length)

        def one_step():
            loss, _ = loss_fn(*batch)
            loss.backward()
            tr.opt.step()

        busy, by_kernel, launches, _ = device_busy(torch, one_step, calls=1)
        t.update({"rows": rows, "length": length, "sequences_s": rows / t["step_ms"] * 1e3,
                  "tokens_s": rows * length / t["step_ms"] * 1e3, "flops": flops,
                  "bf16_peak_share": flops / (t["step_ms"] / 1e3) / BF16_PEAK,
                  "busy_ms": busy, "launches": launches,
                  "top_kernels": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]})
        out[name] = t
        print(f"train[{name}]: {rows} sequences x {length} tokens a step: "
              f"{t['step_ms']:.2f} ms device (forward {t['forward_ms']:.2f}, backward "
              f"{t['backward_ms']:.2f}, optimizer {t['optimizer_ms']:.2f}), wall "
              f"{t['wall_ms']:.2f} ms; {t['sequences_s']:.0f} sequences/s, "
              f"{t['tokens_s']:.0f} tokens/s; {flops / 1e9:.1f} GFLOP, "
              f"{100 * t['bf16_peak_share']:.2f}% of the bf16 peak; peak "
              f"{t['peak_gib']:.2f} GiB; profile: {busy:.2f} ms busy, {launches:.0f} "
              f"launches a step")
        del tr
    return out


def card_against_cpu(torch, dev, proj: Path, labels: Path) -> dict:
    """Three ``DistillTrainer`` steps of a small f32 configuration on the card
    and on the CPU from the same parameters (drawn on the CPU, carried to the
    card) and the same batches. Both sum f32 products in their own orders
    (TF32 off): losses within rtol 1e-4; the parameter deltas' cosine over
    the model >= 0.999 and each entry within 3 x lr (three AdamW steps, each
    at most about lr, sign-like while a gradient is near zero)."""
    import dataclasses

    import numpy as np

    from cqs_tpu_torch.models.tokenizer import load_tokenizer
    from cqs_tpu_torch.parallel.train import DistillTrainer, TrainConfig
    from cqs_tpu_torch.store import Store
    from cqs_tpu_torch.train.distill import DistillBatcher, load_teacher_labels

    if torch.backends.cuda.matmul.allow_tf32:
        fail("train: TF32 is on for f32 matmuls; the trainers need f32 sums")
    cfg = dataclasses.replace(TrainConfig(), hidden_size=128, num_layers=2, num_heads=4,
                              intermediate_size=256, seq_len=32, batch_per_device=8,
                              dtype=torch.float32)
    cpu = DistillTrainer(cfg, device="cpu")
    card = DistillTrainer(cfg, device=dev)
    card.load_params_tree(cpu.params_tree())
    before = cpu.params_tree()
    store = Store.open(proj / ".cqs-tpu", slot="default", readonly=True)
    try:
        batcher = DistillBatcher(store, load_teacher_labels(labels),
                                 load_tokenizer(None, vocab_size=32768), cfg.seq_len, k=4)
        batches = [batcher.batch(8) for _ in range(3)]
    finally:
        store.close()
    losses = []
    for b in batches:
        lc, _ = cpu.distill_step(*b)
        lg, _ = card.distill_step(*b)
        losses.append((lc, lg))
        if abs(lg - lc) > 1e-4 * abs(lc):
            fail(f"train: card loss {lg} vs CPU {lc} beyond rtol 1e-4")

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from (flat(v, prefix + k + "/") if isinstance(v, dict) else [(prefix + k, v)])

    b0, a, g = dict(flat(before)), dict(flat(cpu.params_tree())), dict(flat(card.params_tree()))
    da = np.concatenate([(a[k] - b0[k]).ravel() for k in b0]).astype(np.float64)
    dg = np.concatenate([(g[k] - b0[k]).ravel() for k in b0]).astype(np.float64)
    cos = float(da @ dg / (np.linalg.norm(da) * np.linalg.norm(dg)))
    worst = float(np.abs(da - dg).max())
    if cos < 0.999 or worst > 3 * cfg.lr:
        fail(f"train: card vs CPU parameter deltas: cosine {cos:.6f}, max |diff| {worst:.3g}")
    print(f"train: card vs CPU, 3 f32 DistillTrainer steps: losses {losses}; deltas cosine "
          f"{cos:.6f}, max |diff| {worst:.3g} (rtol 1e-4 / >= 0.999 / <= {3 * cfg.lr:g})")
    return {"losses": losses, "delta_cosine": cos, "max_abs_diff": worst}


def phase_train(torch, dev, report, smi: str, recipes=TRAIN_RECIPES, max_pairs: int = 2000,
                held: int = 64, measure: bool = True):
    """The training path on the repository corpus: ``train-data --source all
    --engine-negatives 2`` (engine negatives through the split kernel at the
    hash tier's width 256), a labeled pool written from the pairs with
    ``held`` queries held out as a gate, the teacher pass (``train-distill
    --labels-only``, the engine on the card), ``train-distill`` at the FINAL
    recipe with the gate probe, ``train`` at the r3a recipe, ``train-reranker``
    and a hybrid ``train`` (its scales must stay [1.0, 0.3]); every loss
    finite and falling (``check_losses``). Then the distilled checkpoint as
    slot ``distilled`` (``cqs-mini``), indexed through the CLI, served as the
    tier of ``TieredServing`` (``tier_slot=distilled``): queries solo and as
    a batcher burst (equal), at least one answered by the tier, the split
    kernel launched at the tier's width 384. Then the card against the CPU
    (``card_against_cpu``) and, with ``measure``, each trainer's step times
    (``measure_trainers``)."""
    import pickle

    import numpy as np

    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.daemon.batcher import QueryBatcher
    from cqs_tpu_torch.ops.topk import LOOP_SPLIT
    from cqs_tpu_torch.search.engine import TieredServing

    cuda = dev.type == "cuda"
    out: dict = {"smi": smi, "seconds": {}}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="cqs_train_"))
    widths = LOOP_SPLIT.launches_by_width

    def cli(label: str, argv: list[str]) -> str:
        before = dict(widths)
        rc, text, ms = run_cli_text(main, argv + ["--path", str(proj), "--device", str(dev)])
        out["seconds"][label] = ms / 1e3
        out.setdefault("split_launches", {})[label] = {
            w: n - before.get(w, 0) for w, n in widths.items() if n != before.get(w, 0)}
        if rc != 0:
            fail(f"train: {label} exited {rc}: {text[-2000:]}")
        print(f"train: {label} in {ms / 1e3:.1f} s; {LOOP_SPLIT.name} launches by width "
              f"{out['split_launches'][label]}")
        return text

    try:
        proj = tmp / "corpus"
        proj.mkdir()
        copy_corpus(proj)
        out["seconds"]["copy"] = time.perf_counter() - t_phase
        cli("index", ["index"])
        pairs, pool, gate = tmp / "pairs.jsonl", tmp / "pool.json", tmp / "gate.json"
        labels = tmp / "labels.jsonl"
        text = cli("train-data", ["train-data", "--source", "all", "--max", str(max_pairs),
                                  "--engine-negatives", "2", "--out", str(pairs)])
        out["pairs"] = text.strip().splitlines()[-1]
        out["pool"] = write_pool(proj, pairs, pool, gate, held)
        cli("teacher", ["train-distill", "--labels-only", "--pool", str(pool),
                        "--exclude", str(gate), "-k", "32", "--labels", str(labels)])
        if cuda and not (out["split_launches"]["train-data"].get(256)
                         and out["split_launches"]["teacher"].get(256)):
            fail("train: the engine negatives or the teacher pass did not launch "
                 f"{LOOP_SPLIT.name} at width 256")
        ckpt = {name: tmp / name for name in recipes}
        text = cli("distill", ["train-distill", "--labels", str(labels), *recipes["distill"],
                               "--gate", str(gate), "--out", str(ckpt["distill"])])
        out["gate"] = [ln for ln in text.splitlines() if ln.startswith("gate ")]
        cli("contrastive", ["train", str(pairs), *recipes["contrastive"],
                            "--out", str(ckpt["contrastive"])])
        cli("reranker", ["train-reranker", str(pairs), *recipes["reranker"],
                         "--out", str(ckpt["reranker"])])
        cli("hybrid", ["train", str(pairs), *recipes["hybrid"], "--out", str(ckpt["hybrid"])])
        out["losses"] = {}
        for name, argv in recipes.items():
            steps = int(argv[argv.index("--steps") + 1])
            out["losses"][name] = check_losses(name, ckpt[name] / "train_log.jsonl", steps)
        with open(ckpt["hybrid"] / "params.pkl", "rb") as f:
            scales = pickle.load(f)["params"]["scales"]
        if scales.tobytes() != np.array([1.0, 0.3], np.float32).tobytes():
            fail(f"train: the hybrid's frozen scales moved to {scales}")
        scales = scales.tolist()
        print(f"train: losses (mean of the first n, of the last n): "
              f"{ {k: (round(v['first'], 4), round(v['last'], 4)) for k, v in out['losses'].items()} }; "
              f"hybrid scales {scales}; gate {out['gate']}")
        # the distilled checkpoint served as a tier
        slot = proj / ".cqs-tpu" / "slots" / "distilled"
        slot.mkdir(parents=True)
        (slot / "config.toml").write_text(
            f'[embedding]\nmodel = "cqs-mini"\nmodel_path = "{ckpt["distill"]}"\n')
        cli("tier index", ["--slot", "distilled", "index"])
        width = int(recipes["distill"][recipes["distill"].index("--hidden-size") + 1])
        before = dict(widths)
        t0 = time.perf_counter()
        with knobs({"CQST_TIER_SLOT": "distilled"}):
            ctx = CommandContext.create(str(proj), device=dev)
            ctx2 = CommandContext.create(str(proj), device=dev)
            try:
                eng = ctx.engine
                if not isinstance(eng, TieredServing):
                    fail(f"train: tier_slot=distilled gave {type(eng).__name__}")
                if eng._tier.embedder.dim != width:
                    fail(f"train: the tier embeds at {eng._tier.embedder.dim}, not {width}")
                routed = [q for q in TIER_QUERIES if eng.engine_for(q) is eng._tier]
                solo = {q: eng.search(q) for q in TIER_QUERIES}
                if not routed or not any(solo[q].hits for q in routed):
                    fail(f"train: no query answered by the tier engine (routed: {routed})")
                batcher = QueryBatcher(ctx2.engine)
                try:
                    batcher.pause()
                    futs = [batcher.submit(q) for q in TIER_QUERIES]
                    batcher.resume()
                    batched = [f.result(timeout=120) for f in futs]
                finally:
                    batcher.stop()
                for q, res in zip(TIER_QUERIES, batched):
                    if not same_hits([(h.row.id, h.score) for h in res.hits],
                                     [(h.row.id, h.score) for h in solo[q].hits]):
                        fail(f"train: batched result of {q!r} differs from solo under the tier")
            finally:
                ctx2.close()
                ctx.close()
        out["seconds"]["tier queries"] = time.perf_counter() - t0
        out["tier"] = {"routed": routed, "batcher": batcher.stats_snapshot(),
                       "split_launches": {w: n - before.get(w, 0) for w, n in widths.items()
                                          if n != before.get(w, 0)}}
        if cuda and not out["tier"]["split_launches"].get(width):
            fail(f"train: the tier did not launch {LOOP_SPLIT.name} at width {width}")
        print(f"train: tier answered {len(routed)} of {len(TIER_QUERIES)} queries "
              f"({routed}); batched == solo; batcher {out['tier']['batcher']}; "
              f"{LOOP_SPLIT.name} launches by width {out['tier']['split_launches']}")
        if cuda:
            t0 = time.perf_counter()
            out["card_vs_cpu"] = card_against_cpu(torch, dev, proj, labels)
            out["seconds"]["card vs cpu"] = time.perf_counter() - t0
            if measure:
                t0 = time.perf_counter()
                out["steps"] = measure_trainers(torch, dev, proj, pairs, labels)
                out["seconds"]["step times"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"train: the phase took {out['phase_s']:.1f} s "
          f"({ {k: round(v, 1) for k, v in out['seconds'].items()} }); {smi}")
    report["train"] = out


# -- phase 9b: the trainers' (dp, tp) grid on logical devices of the card -------

#: the grid phase's logical meshes (dp, tp) on the one card
GRID_MESHES = ((1, 2), (1, 4), (1, 8), (3, 2))
#: its steps at ``docs/trained-tier.md``'s published widths: (TrainConfig
#: fields, global batch, candidates or mined negatives a row): the FINAL
#: distillation step and the r3a contrastive step with two mined negatives
GRID_RECIPES = {
    "distill": (dict(hidden_size=384, num_layers=4, intermediate_size=768, seq_len=64), 16, 16),
    "contrastive": (dict(hidden_size=384, num_layers=6, intermediate_size=1536, seq_len=128),
                    128, 2),
}
#: the small f32 configuration held to f32 tolerance at (1, 4) (a distill step)
GRID_F32 = (dict(hidden_size=128, num_layers=2, num_heads=4, intermediate_size=256,
                 seq_len=32), 8, 4)
#: the grid phase's wall-clock limit, seconds
GRID_LIMIT_S = 90.0
#: the train-distill command line the phase runs over a (1, 4) logical mesh
GRID_CLI = ["--steps", "3", "--batch", "16", "--hidden-size", "384", "--intermediate-size",
            "768", "--cands", "16"]


def grid_batches(kind: str, cfg: dict, rows: int, k: int, steps: int, seed: int):
    """``steps`` host batches of ``rows`` rows at ``cfg``'s sequence length,
    drawn from ``seed``: token ids in [4, 32768), each row's mask a live
    prefix of 8 tokens or more; distill: ``k`` candidates a query, teacher
    scores N(0.5, 0.2), the last lane of row 0 padded (one live token,
    score -1e30, valid 0); contrastive: ``k`` mined negatives a pair."""
    import numpy as np

    rng = np.random.default_rng(seed)
    length = cfg["seq_len"]

    def side(*shape):
        ids = rng.integers(4, 32768, size=(*shape, length)).astype(np.int32)
        live = rng.integers(8, length + 1, size=shape)
        mask = (np.arange(length) < live[..., None]).astype(np.int32)
        return ids * mask, mask

    out = []
    for _ in range(steps):
        if kind == "distill":
            q, d = side(rows), side(rows, k)
            t = rng.normal(0.5, 0.2, size=(rows, k)).astype(np.float32)
            valid = np.ones((rows, k), np.int32)
            d[0][0, k - 1], d[1][0, k - 1] = 0, 0
            d[1][0, k - 1, 0] = 1
            t[0, k - 1], valid[0, k - 1] = -1e30, 0
            out.append([*q, *d, t, valid])
        else:
            out.append([*side(rows), *side(rows), *side(rows, k)])
    return out


def delta_stats(torch, before: dict, after: dict, want: dict) -> dict:
    """A grid's parameter deltas (``after - before``) against the one-device
    trainer's (``want``, already deltas), on the card in float64: the cosine
    over the model, the lowest cosine of one parameter (the attention key
    biases left out: their true gradient is 0, both deltas are rounding
    noise) and the share of entries off by more than 1e-6."""
    dot = na = nb = 0.0
    off = total = 0
    worst = (1.0, "")
    for key, w in want.items():
        d = (after[key] - before[key]).double()
        w = w.double()
        p_dot, p_na, p_nb = float(d.flatten() @ w.flatten()), float(w.norm() ** 2), float(d.norm() ** 2)
        dot, na, nb = dot + p_dot, na + p_na, nb + p_nb
        off += int(((d - w).abs() > 1e-6).sum())
        total += w.numel()
        if not key.endswith("k.bias"):
            cos = 1.0 if torch.equal(d, w) else p_dot / max((p_na * p_nb) ** 0.5, 1e-30)
            worst = min(worst, (cos, key))
    return {"cosine": dot / (na * nb) ** 0.5, "worst": worst[0], "worst_param": worst[1],
            "off_share": off / total}


def phase_grid(torch, dev, report, smi: str, meshes=GRID_MESHES, recipes=GRID_RECIPES,
               f32=GRID_F32, cli_flags=GRID_CLI, held: int = 8,
               corpus=("cqs_tpu/parallel", "cqs_tpu/train", "docs")):
    """The trainers' (dp, tp) grid (``parallel/tensor_parallel.py``) on the
    card, each mesh ``Mesh([card] * dp * tp, ("dp", "tp"), (dp, tp))`` of
    logical devices, and every real card through ``make_2d_mesh()`` when the
    machine has more than one. For each recipe of :data:`GRID_RECIPES` (FINAL
    distillation, r3a contrastive with 2 mined negatives): one init (seed 0)
    and three seeded batches; the one-device trainer at the global batch (at
    dp 3 the multiple of 3 below it, 15 and 126) and each grid trainer at
    ``batch_per_device = global / dp`` run three steps from the same
    parameters (checked bit for bit), held to each other in bf16 by
    ``tests/test_torch_train.py``'s bf16 rule: losses within rtol 2e-2,
    the deltas' cosine over the model >= 0.99 and per parameter >= 0.9 (the
    share of entries off printed). A small f32 configuration at (1, 4) is
    held to the f32 rule: losses within rtol 1e-5, cosine >= 0.9999, at most
    1% of entries off by more than 1e-6. Each mesh's step ms (CUDA events),
    launches and device-busy ms (``torch.profiler``) and peak memory are
    printed beside ``smi``. Then ``train-distill --steps 3`` at the FINAL
    widths through ``cmd_train_distill`` in this process, with the port's
    ``make_2d_mesh`` giving a (1, 4) logical mesh on the card, on a small
    corpus (``corpus``: index, mined pairs, the teacher pass first); its
    checkpoint then serves as the tier of a one-device ``TieredServing``.
    The phase fails past :data:`GRID_LIMIT_S` seconds."""
    import cqs_tpu_torch.parallel as tparallel
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.parallel.mesh import Mesh, make_2d_mesh
    from cqs_tpu_torch.parallel.train import ContrastiveTrainer, DistillTrainer, TrainConfig
    from cqs_tpu_torch.search.engine import TieredServing

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {"smi": smi, "steps": {}, "seconds": {}}
    grids = [(f"{dp}x{tp}", Mesh([dev] * (dp * tp), ("dp", "tp"), (dp, tp)))
             for dp, tp in meshes]
    if cuda and torch.cuda.device_count() > 1:
        real = make_2d_mesh()
        grids.append((f"cards {real.shape['dp']}x{real.shape['tp']}", real))

    def trainer(kind, cfg, rows, mesh=None, seed=0, dtype=torch.bfloat16):
        cls = DistillTrainer if kind == "distill" else ContrastiveTrainer
        dp = mesh.shape["dp"] if mesh is not None else 1
        tcfg = TrainConfig(**cfg, batch_per_device=rows // dp, dtype=dtype)
        return cls(tcfg, seed, device=None if mesh is not None else dev, mesh=mesh)

    def run(tr, kind, batches):
        fn = tr.distill_step if kind == "distill" else tr.train_step
        return [fn(*b)[0] for b in batches]

    def state(tr):
        return {k: v.detach().clone() for k, v in tr.state_dict().items()}

    def measure(tr, kind, batch) -> dict:
        # after the three compared steps: no warm-up of its own; the
        # profile traces the device only (a 3x2 r3a step is ~14,600 launches)
        if not cuda:
            return {}
        loss_fn = tr.distill_loss if kind == "distill" else tr.loss
        t = time_step(torch, loss_fn, tr.opt.step, batch, iters=3, warmup=0)

        def one_step():
            loss, _ = loss_fn(*batch)
            loss.backward()
            tr.opt.step()

        busy, _, launches, _ = device_busy(torch, one_step, calls=1, host=False)
        if not launches:
            fail(f"grid: the profile of a {kind} step saw no kernel launch")
        t.update({"busy_ms": busy, "launches": launches})
        return t

    def check(label, got, ref, before, after, f32_rule):
        rtol = 1e-5 if f32_rule else 2e-2
        bad = [(a, b) for a, b in zip(got, ref["losses"]) if not abs(a - b) <= rtol * abs(b)]
        if bad or not all(math.isfinite(x) for x in got):
            fail(f"grid {label}: losses {got} vs one device {ref['losses']} (rtol {rtol})")
        st = delta_stats(torch, before, after, ref["deltas"])
        ok = (st["cosine"] >= 0.9999 and st["worst"] >= 0.9999 and st["off_share"] <= 0.01
              if f32_rule else st["cosine"] >= 0.99 and st["worst"] >= 0.9)
        if not ok:
            fail(f"grid {label}: parameter deltas against one device: {st}")
        return st

    t0 = time.perf_counter()
    try:
        for kind, (cfg, rows, k) in recipes.items():
            data = grid_batches(kind, cfg, rows, k, 3, seed=11)
            refs = {}
            for glob in sorted({rows, rows // 3 * 3} if any(dp == 3 for dp, _ in meshes)
                               else {rows}):
                tr = trainer(kind, cfg, glob)
                before = state(tr)
                batches = [[a[:glob] for a in b] for b in data]
                losses = run(tr, kind, batches)
                after = state(tr)
                refs[glob] = {"losses": losses, "before": before,
                              "deltas": {k2: after[k2] - before[k2] for k2 in before}}
                del after
                # timed at the recipe's batch; the dp-3 batch is a reference only
                t = measure(tr, kind, batches[0]) if glob == rows else {}
                out["steps"][f"{kind} 1x1 B{glob}"] = {"losses": losses, **t}
                out["seconds"][f"{kind} 1x1 B{glob}"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                del tr
            for label, mesh in grids:
                dp = mesh.shape["dp"]
                glob = rows // dp * dp
                ref = refs.get(glob)
                if ref is None:
                    continue
                tr = trainer(kind, cfg, glob, mesh)
                before = state(tr)
                if any(not torch.equal(before[k2], ref["before"][k2]) for k2 in before):
                    fail(f"grid {kind} {label}: the grid's initial parameters are not the "
                         f"one-device trainer's")
                batches = [[a[:glob] for a in b] for b in data]
                losses = run(tr, kind, batches)
                st = check(f"{kind} {label}", losses, ref, before, state(tr), False)
                t = measure(tr, kind, batches[0])
                out["steps"][f"{kind} {label} B{glob}"] = {"losses": losses, **st, **t}
                out["seconds"][f"{kind} {label}"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                del tr, before
                if cuda:
                    torch.cuda.empty_cache()
            del refs
        # the f32 configuration at (1, 4): the f32 rule
        cfg, rows, k = f32
        data = grid_batches("distill", cfg, rows, k, 3, seed=12)
        one = trainer("distill", cfg, rows, dtype=torch.float32)
        before = state(one)
        ref = {"losses": run(one, "distill", data)}
        ref["deltas"] = {k2: v - before[k2] for k2, v in state(one).items()}
        mesh = Mesh([dev] * 4, ("dp", "tp"), (1, 4))
        tr = trainer("distill", cfg, rows, mesh, dtype=torch.float32)
        losses = run(tr, "distill", data)
        out["f32_1x4"] = {"losses": losses, "one_device": ref["losses"],
                          **check("f32 1x4", losses, ref, before, state(tr), True)}
        out["seconds"]["f32 1x4"] = time.perf_counter() - t0
        del one, tr
        for label, t in out["steps"].items():
            cells = (f"{t['step_ms']:.2f} ms a step (forward {t['forward_ms']:.2f}, backward "
                     f"{t['backward_ms']:.2f}, optimizer {t['optimizer_ms']:.2f}; wall "
                     f"{t['wall_ms']:.2f}), {t['launches']:.0f} launches, {t['busy_ms']:.2f} ms "
                     f"busy, peak {t['peak_gib']:.2f} GiB" if "step_ms" in t else "not timed")
            held_to = ("" if "cosine" not in t else
                       f"; deltas cosine {t['cosine']:.5f} (lowest parameter {t['worst']:.4f}), "
                       f"{100 * t['off_share']:.1f}% of entries off by > 1e-6")
            print(f"grid[{label}]: {cells}; losses "
                  f"{[round(x, 5) for x in t['losses']]}{held_to}; {smi}")
        print(f"grid[f32 1x4]: losses {out['f32_1x4']['losses']} vs one device "
              f"{out['f32_1x4']['one_device']} (rtol 1e-5); deltas cosine "
              f"{out['f32_1x4']['cosine']:.7f}, lowest parameter {out['f32_1x4']['worst']:.6f}, "
              f"{100 * out['f32_1x4']['off_share']:.2f}% off (<= 1%); {smi}")
        out["steps_s"] = time.perf_counter() - t_phase
        # train-distill through the CLI on a (1, 4) logical mesh
        tmp = Path(tempfile.mkdtemp(prefix="cqs_grid_"))
        try:
            proj = tmp / "corpus"
            ignore = shutil.ignore_patterns("__pycache__", "*.so", "*.srchash", ".cqs-tpu",
                                            "_build")
            for name in corpus:
                shutil.copytree(REPO / name, proj / name, ignore=ignore)
            (proj / ".cqs-tpu").mkdir()

            def cli(label, argv):
                rc, text, ms = run_cli_text(main, argv + ["--path", str(proj), "--device",
                                                          str(dev)])
                if rc != 0:
                    fail(f"grid: {label} exited {rc}: {text[-2000:]}")
                return text

            cli("index", ["index"])
            pairs, pool, gate = tmp / "pairs.jsonl", tmp / "pool.json", tmp / "gate.json"
            labels, ckpt = tmp / "labels.jsonl", tmp / "distilled"
            cli("train-data", ["train-data", "--source", "all", "--max", "400",
                               "--engine-negatives", "2", "--out", str(pairs)])
            out["pool"] = write_pool(proj, pairs, pool, gate, held)
            cli("teacher", ["train-distill", "--labels-only", "--pool", str(pool), "-k", "32",
                            "--labels", str(labels)])
            logical = Mesh([dev] * 4, ("dp", "tp"), (1, 4))
            saved = tparallel.make_2d_mesh
            tparallel.make_2d_mesh = lambda *a, **kw: logical
            try:
                t0 = time.perf_counter()
                text = cli("train-distill", ["train-distill", "--labels", str(labels),
                                             *cli_flags, "--out", str(ckpt)])
                out["cli_s"] = time.perf_counter() - t0
                out["seconds"]["train-distill"] = out["cli_s"]
            finally:
                tparallel.make_2d_mesh = saved
            if "mesh {'dp': 1, 'tp': 4}" not in text:
                fail(f"grid: train-distill did not train on the (1, 4) mesh: {text[-800:]}")
            steps = int(cli_flags[cli_flags.index("--steps") + 1])
            logged = [json.loads(ln)["loss"] for ln in
                      (ckpt / "train_log.jsonl").read_text().splitlines()]
            if len(logged) != steps or not all(math.isfinite(x) for x in logged):
                fail(f"grid: train-distill on the (1, 4) mesh logged {logged}")
            out["cli_losses"] = logged
            slot = proj / ".cqs-tpu" / "slots" / "distilled"
            slot.mkdir(parents=True)
            (slot / "config.toml").write_text(
                f'[embedding]\nmodel = "cqs-mini"\nmodel_path = "{ckpt}"\n')
            cli("tier index", ["--slot", "distilled", "index"])
            with knobs({"CQST_TIER_SLOT": "distilled"}):
                ctx = CommandContext.create(str(proj), device=dev)
                try:
                    eng = ctx.engine
                    if not isinstance(eng, TieredServing):
                        fail(f"grid: tier_slot=distilled gave {type(eng).__name__}")
                    routed = [q for q in TIER_QUERIES if eng.engine_for(q) is eng._tier]
                    answered = [q for q in routed if eng.search(q).hits]
                finally:
                    ctx.close()
            if not answered:
                fail(f"grid: no query answered by the grid-trained tier (routed: {routed})")
            out["tier_answered"] = answered
            print(f"grid: train-distill {' '.join(cli_flags)} on a (1, 4) logical mesh through "
                  f"the CLI in {out['cli_s']:.1f} s, losses {[round(x, 4) for x in logged]}; "
                  f"its checkpoint served as the tier of a one-device engine "
                  f"({len(answered)} of {len(routed)} routed queries answered); {smi}")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        out["phase_s"] = time.perf_counter() - t_phase
        report["grid"] = out
    print(f"grid: the phase took {out['phase_s']:.1f} s (steps {out['steps_s']:.1f} s: "
          f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }); {smi}")
    if cuda and out["phase_s"] > GRID_LIMIT_S:
        fail(f"grid: the phase took {out['phase_s']:.1f} s, past its {GRID_LIMIT_S:.0f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="kernels,e2e,commands,scale,shard,serve,neural,graph,train,grid,host")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not (REPO / "cqs_tpu_torch" / "__init__.py").is_file():
        fail(f"no cqs_tpu_torch package beside {Path(__file__).name}: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(REPO))
    import numpy as np

    from cqs_tpu_torch.ops import _kernels
    from cqs_tpu_torch.ops.topk import (IMPLS, KERNELS, LOOP_CC, LOOP_I8_CC, LOOP_SPLIT,
                                        LOOP_SPLIT_I8)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: kernels ready in {time.perf_counter() - t0:.1f} s "
          f"({_kernels.library_path().name}, nvcc {_kernels.build_seconds:.1f} s)")
    rng = np.random.default_rng(args.seed)
    report: dict = {}
    if "kernels" in phases:
        phase_kernels(torch, dev, rng, args.seed, report)
    kernel_phase = {k.name: k.launches for k in IMPLS}
    if "kernels" in phases:
        print(f"launches in the kernel phase: {kernel_phase}")
        for k in KERNELS:
            if k.kind == "i8w" and k.launches == 0:
                fail(f"widening kernel {k.name} was not launched in the kernel phase")
    for k in IMPLS:
        k.launches = 0                        # the main path's run starts here
    if "e2e" in phases:
        phase_e2e(torch, dev, report)
    if "scale" in phases:
        phase_scale(torch, dev, rng, report)
        phase_daemon(torch, dev, args.seed, report)     # last: it runs the profiler
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in IMPLS}
    print(f"launches on the main path (index, search, batcher, scale): {launches}")
    if {"e2e", "scale"} <= phases:
        for k in (*KERNELS, LOOP_SPLIT, LOOP_SPLIT_I8):
            if k.launches == 0:
                fail(f"kernel {k.name} was not launched on the main path")
    # the sharded path: each of its runs zeroes the counts just before and
    # reads them just after (phase_shard); comparisons and timings outside
    for k in IMPLS:
        k.launches = 0
    shard_launches = {k.name: 0 for k in IMPLS}
    small_launches = dict(shard_launches)
    if "shard" in phases:
        shard_launches, small_launches = phase_shard(torch, dev, args.seed, report, smi)
        print(f"launches on the sharded path: {shard_launches}")
        print(f"launches on the small shards' path: {small_launches}")
        for k in (LOOP_CC, LOOP_I8_CC):
            if small_launches[k.name] == 0:
                fail(f"kernel {k.name} was not launched on the small shards' path")
        for k in (LOOP_SPLIT, LOOP_SPLIT_I8):
            if shard_launches[k.name] == 0:
                fail(f"kernel {k.name} was not launched on the sharded path")
        stray = {k: x for k, x in shard_launches.items()
                 if x and k not in (LOOP_SPLIT.name, LOOP_SPLIT_I8.name)}
        if stray:
            fail(f"the sharded path launched {stray}: at pool 500 a shard's scans are "
                 f"{LOOP_SPLIT.name} / {LOOP_SPLIT_I8.name} only (no template)")
    # the ported commands' path: zeroed just before, read just after
    for k in IMPLS:
        k.launches = 0
    if "commands" in phases:
        phase_commands(torch, dev, report, smi)
    torch.cuda.synchronize()
    commands_launches = {k.name: k.launches for k in IMPLS}
    if "commands" in phases:
        print(f"launches on the commands' path: {commands_launches}")
        if LOOP_SPLIT.launches == 0:
            fail(f"kernel {LOOP_SPLIT.name} was not launched on the commands' path")
    # the daemon's path has its own count: zeroed just before, read just after
    for k in IMPLS:
        k.launches = 0
    if "serve" in phases:
        phase_serve(torch, dev, report, smi)
    torch.cuda.synchronize()
    serve_launches = {k.name: k.launches for k in IMPLS}
    if "serve" in phases:
        print(f"launches on the daemon's path: {serve_launches}")
        if LOOP_SPLIT.launches == 0:
            fail(f"kernel {LOOP_SPLIT.name} was not launched on the daemon's path")
    # the neural configuration's path: zeroed just before, read just after
    for k in IMPLS:
        k.launches = 0
    if "neural" in phases:
        phase_neural(torch, dev, args.seed, report, smi)
    torch.cuda.synchronize()
    neural_launches = {k.name: k.launches for k in IMPLS}
    if "neural" in phases:
        print(f"launches on the neural path: {neural_launches}")
        if LOOP_SPLIT.launches == 0:
            fail(f"kernel {LOOP_SPLIT.name} was not launched on the neural path")
    # the graph ANN's path: zeroed just before, read just after
    for k in IMPLS:
        k.launches = 0
    if "graph" in phases:
        phase_graph(torch, dev, args.seed, report, smi)
    torch.cuda.synchronize()
    graph_launches = {k.name: k.launches for k in IMPLS}
    if "graph" in phases:
        print(f"launches on the graph path: {graph_launches}")
        if LOOP_SPLIT.launches == 0:
            fail(f"kernel {LOOP_SPLIT.name} was not launched on the graph path")
    # the training path and the distilled tier: zeroed just before, read just after
    for k in IMPLS:
        k.launches = 0
    if "train" in phases:
        phase_train(torch, dev, report, smi)
    torch.cuda.synchronize()
    train_launches = {k.name: k.launches for k in IMPLS}
    if "train" in phases:
        print(f"launches on the train path: {train_launches}")
        if LOOP_SPLIT.launches == 0:
            fail(f"kernel {LOOP_SPLIT.name} was not launched on the train path")
    # the training grid: zeroed just before, read just after (the grid's
    # steps reach no kernel; its corpus's engine, teacher pass and tier do)
    for k in IMPLS:
        k.launches = 0
    if "grid" in phases:
        phase_grid(torch, dev, report, smi)
    torch.cuda.synchronize()
    grid_launches = {k.name: k.launches for k in IMPLS}
    if "grid" in phases:
        print(f"launches on the grid path: {grid_launches}")
        if LOOP_SPLIT.launches == 0:
            fail(f"kernel {LOOP_SPLIT.name} was not launched on the grid path")
    # the sparse-only API and the host mirror against the card: zeroed just
    # before, read just after
    for k in IMPLS:
        k.launches = 0
    if "host" in phases:
        phase_host(torch, dev, args.seed, report, smi)
    torch.cuda.synchronize()
    host_launches = {k.name: k.launches for k in IMPLS}
    if "host" in phases:
        print(f"launches on the host phase's path: {host_launches}")
        if LOOP_SPLIT.launches == 0:
            fail(f"kernel {LOOP_SPLIT.name} was not launched on the host phase's path")
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")]
    if loaded:
        fail(f"JAX modules were imported: {loaded[:5]}")
    reference = [m for m in sys.modules if m.split(".")[0] == "cqs_tpu"]
    if reference:
        fail(f"modules of the JAX package were imported: {reference[:5]}")
    # each kernel's times on the kernels line come from its KERNEL_CASES
    # shape, timed as the kernel or as the rival of the split kernel there
    kernels = []
    for k in IMPLS:
        case = KERNEL_CASES[k.name]
        t = next((x for x in report.get("timings", [])
                  if k.name in (x["kernel"], x["rival"])
                  and (x["n"], x["d"], x["tile"], x["b"], x["m"]) == case), None)
        own = t is not None and t["kernel"] == k.name
        bound = bound_ms(k.kind, *case[:2], case[3], case[2], case[4])
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces,
                        "launches": (launches[k.name] + shard_launches[k.name]
                                     + small_launches[k.name] + commands_launches[k.name]
                                     + serve_launches[k.name] + neural_launches[k.name]
                                     + graph_launches[k.name] + train_launches[k.name]
                                     + grid_launches[k.name] + host_launches[k.name]),
                        "main_path_launches": launches[k.name],
                        "shard_path_launches": shard_launches[k.name],
                        "small_shard_path_launches": small_launches[k.name],
                        "commands_path_launches": commands_launches[k.name],
                        "daemon_path_launches": serve_launches[k.name],
                        "neural_path_launches": neural_launches[k.name],
                        "graph_path_launches": graph_launches[k.name],
                        "train_path_launches": train_launches[k.name],
                        "grid_path_launches": grid_launches[k.name],
                        "host_path_launches": host_launches[k.name],
                        "kernel_phase_launches": kernel_phase[k.name],
                        "max_abs_err": report.get("errs", {}).get(k.name),
                        "shape": dict(zip(("n", "d", "tile", "b", "m"), case)),
                        "ms": t and (t["ms"] if own else t["rival_ms"]),
                        "plain_ms": t and t["plain_ms"],
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": t and t["library_ms"],
                        "library_call": t and t["library_call"]})
    out_dir = REPO / "chiprun_out"
    if out_dir.is_dir():                     # full record, written when the output dir exists
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {"smi": smi, "name": name, **report, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
