#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cqs_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases kernels,e2e,scale]

Phases, each fatal on error (non-zero exit, no result line):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels from ``cqs_tpu_torch/csrc`` (timed);
3. kernels: each of the six kernels against its plain PyTorch twin on the
   card, on the adversarial cases of the reference's op tests and at the
   programs' shapes, with both times. bf16: row widths 256 and 1024, tile
   2048, B 1/8/128, m 4/16/64, 4096 and 1,048,576 rows. int8 x int8 and
   int8-widened: 1,048,576 rows of width 256 and 1024, tiles 2048 and 4096,
   B 1/8/128, m 4/16, and tile 16384 x 256 at B=1. The two tensor-core
   grouped kernels also where an MMA design breaks: widths 24 (bf16) and 48
   (int8), not multiples of 16 or of the 64-wide K-chunk, and 4096; B 3, 65
   and 128; tiles 128 (one row a group) and 16384 (128). int8 x int8 must
   equal its twin exactly, slot for slot; the others within a score near-tie;
4. e2e: index a copy of this repository's sources through the port's CLI,
   answer searches through it and the engine, then a paused burst through
   the ``QueryBatcher`` whose results must equal the solo ones; once with
   the default knobs, then with ``scan_q8=1`` (q8) and ``scan_q8=2`` (sk8)
   at ``scan_q8_min_rows`` 1024 (solo and batched) and ``screen_enable=1``
   at ``screen_min_rows`` 1024 (solo; the screened program is B=1 only);
5. scale: a synthetic 1,048,576-row index at the hash tier's widths (seeded
   numpy): ``hybrid_query`` at B=1 and ``hybrid_query_batch`` at B=128, the
   q8 and sk8 programs at B=1 and B=128, the screened program (int8 and proj
   screens) at B=1, the int8 quantization of the index, and a direct
   ``scan_topk`` over the int8 rows with a bf16 query (the widening kernels'
   only entry point), each with top-10 agreement against the exact plain
   scan.

The kernels' launch counters are zeroed before phase 4 and read after
phase 5; a kernel that did not launch there fails the run, and so does a
widening kernel that did not launch in phase 3. The second-to-last line is
a JSON object with each kernel's launches, error and times; the last is
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
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


def phase_kernels(torch, dev, rng, report):
    from cqs_tpu_torch.ops.topk import (GROUPED, GROUPED_I8, GROUPED_I8W, KERNELS, LOOP,
                                        LOOP_I8, LOOP_I8W, scan_topk_plain_grouped,
                                        scan_topk_plain_loop)

    def plain_of(kernel):
        return scan_topk_plain_grouped if kernel.grouped else scan_topk_plain_loop

    errs = {k.name: 0.0 for k in KERNELS}
    timings = []

    def check(kernel, index, q, mask, tile, m, label):
        cmp = compare_exact if kernel.kind == "i8" else compare_tiles
        errs[kernel.name] = max(errs[kernel.name],
                                cmp(kernel, plain_of(kernel), index, q, mask, tile, m, label))

    def timed(kernel, index, q, mask, tile, m, iters):
        n, d = index.shape
        b = q.shape[0]
        check(kernel, index, q, mask, tile, m,
              f"{kernel.name} n={n} d={d} tile={tile} b={b} m={m}")
        plain = plain_of(kernel)
        pm1 = cuda_ms(lambda: plain(index, q, mask, tile, m), iters)
        km1 = cuda_ms(lambda: kernel(index, q, mask, tile, m), iters)
        km2 = cuda_ms(lambda: kernel(index, q, mask, tile, m), iters)
        pm2 = cuda_ms(lambda: plain(index, q, mask, tile, m), iters)
        timings.append({"kernel": kernel.name, "n": n, "d": d, "tile": tile, "b": b, "m": m,
                        "ms": (km1 + km2) / 2, "plain_ms": (pm1 + pm2) / 2})

    for name, index, q, mask, tile, m in adversarial_cases(torch, dev, rng):
        for kernel in (LOOP, GROUPED):
            check(kernel, index, q, mask, tile, m, f"{kernel.name}/{name}")
    for name, index, q8, qbf, mask, tile, m in int8_cases(torch, dev, rng):
        for kernel in (LOOP_I8, GROUPED_I8):
            check(kernel, index, q8, mask, tile, m, f"{kernel.name}/{name}")
        for kernel in (LOOP_I8W, GROUPED_I8W):
            check(kernel, index, qbf, mask, tile, m, f"{kernel.name}/{name}")
    print("kernels: adversarial cases ok for all six kernels (mask, spread spikes, "
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
                q_int = torch.randint(-3, 4, (b, d), device=dev, generator=gen).to(torch.bfloat16)
                for tile, m in ((128, 128), (16384, 16)):
                    compare_exact(kernel, plain_of(kernel), int_rows, q_int, mask, tile, m,
                                  f"{label} tile={tile} m={m} integer")
    print("kernels: tensor-core grouped kernels ok at widths 24/48/4096, B 3/65/128, "
          "tiles 128 and 16384; exact on integer inputs through m 128")
    for n in (4096, SCALE_ROWS):
        for d in (256, 1024):
            gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
            index = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
            mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
            for b in (1, 8, 128):
                q = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
                for kernel in (LOOP, GROUPED):
                    for m in ((4, 16, 64) if kernel is LOOP else (4, 16)):
                        timed(kernel, index, q, mask, 2048, m, 20 if n == SCALE_ROWS else 100)
            del index, mask
            torch.cuda.empty_cache()
    # the int8 programs' shapes: q8 dense (x 256) and sketch (x 1024) scans at
    # tile 2048, sk8's sketch scan at tile 4096, the screened int8 scan at
    # tile 16384 x 256, B=1; widening kernels at m 4
    for d in (256, 1024):
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
        index = torch.randint(-127, 128, (SCALE_ROWS, d), device=dev, generator=gen,
                              dtype=torch.int8)
        mask = (torch.rand(SCALE_ROWS, device=dev, generator=gen) > 0.02).to(torch.int32)
        for b in (1, 8, 128):
            q8 = torch.randint(-127, 128, (b, d), device=dev, generator=gen, dtype=torch.int8)
            qbf = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
            for tile in (2048, 4096):
                for m in (4, 16):
                    for kernel in (LOOP_I8, GROUPED_I8):
                        timed(kernel, index, q8, mask, tile, m, 10)
                for kernel in (LOOP_I8W, GROUPED_I8W):
                    timed(kernel, index, qbf, mask, tile, 4, 10)
            if d == 256 and b == 1:
                for kernel in (LOOP_I8, GROUPED_I8):
                    timed(kernel, index, q8, mask, 16384, 16, 10)
                for kernel in (LOOP_I8W, GROUPED_I8W):
                    timed(kernel, index, qbf, mask, 16384, 16, 10)
        del index, mask
        torch.cuda.empty_cache()
    print("kernels: main-path shapes ok; times (ms, CUDA events, kernel vs plain):")
    for t in timings:
        print(f"  {t['kernel']:22s} n={t['n']:8d} d={t['d']:5d} tile={t['tile']:5d} "
              f"b={t['b']:4d} m={t['m']:3d}  kernel {t['ms']:9.4f}  plain {t['plain_ms']:9.4f}")
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
    does not launch the kernel its program scans with, or (``batched``) when
    a batched result differs from solo."""
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.daemon.batcher import QueryBatcher
    from cqs_tpu_torch.ops.topk import GROUPED_I8, LOOP, LOOP_I8

    # the kernel every solo search of this run must launch: bf16 loop, or
    # the int8 loop (small corpora take loop: per-tile k 64 > 16)
    kernel = LOOP if label == "bf16" else LOOP_I8
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


# -- phase 5: a 1M-row index at the hash tier's widths --------------------------

def top10_agreement(got, ref) -> float:
    """Mean share of each query's exact top-10 rows found in its top-10."""
    import numpy as np

    return float(np.mean([len(set(g.tolist()) & set(r.tolist())) / 10
                          for g, r in zip(got[:, :10].cpu(), ref[:, :10].cpu())]))


def phase_scale(torch, dev, rng, report, n: int = SCALE_ROWS):
    import numpy as np

    from cqs_tpu_torch.index import DenseIndex, SpladeIndex, Stamp
    from cqs_tpu_torch.ops.topk import scan_topk, topk_plain
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
    torch.cuda.synchronize()
    gb = sum(x.numel() * x.element_size() for x in
             (dense.matrix, sparse.doc_ids, sparse.doc_w, sparse.sketch, packed)) / 1e9
    print(f"scale: {n} rows, D={d}, T={t}, S={s}: data {gen_s:.1f} s, dense index "
          f"{t1 - t0:.1f} s, sparse index incl. host sketch build {t2 - t1:.1f} s; "
          f"{gb:.2f} GB on the device")

    b, nq = 128, 16
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
    ptk, ran = program.scan_geometry(n, pool, 2048, ext)
    if n >= 131072 and ran != "grouped":
        fail(f"B={b} at {n} rows did not select the grouped kernel ({ran})")

    # the int8 copies a q8/sk8 engine builds once per index generation
    q8_build_ms = cuda_ms(dense._int8_copy, 3)
    sk8_build_ms = cuda_ms(lambda: program.quantize_sketch(sparse.sketch), 3)
    dense_i8, sketch_i8 = dense.dense_i8(), sparse.sketch_i8()

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

    def exact(bq):
        qm = q_dense[:bq].to(torch.bfloat16)
        qsk = program._query_sketch(q_ids_t[:bq], q_w_t[:bq], s).to(torch.bfloat16)
        r, dc = program._exact_candidates(dense.matrix, sparse.sketch, dense.mask, qm, qsk, pool)
        return program._exact_rescore_fuse(packed, None, dense.mask, q_ids_t[:bq], q_w_t[:bq],
                                           alphas[:bq], r.to(torch.int32), dc, pool, v)

    ref_b, ref_1 = exact(b)[1], exact(nq)[1]

    def solo_rows(fn):
        return torch.cat([fn(i, i + 1)[1] for i in range(nq)])

    res = {}
    for name, fn in (("bf16", bf16), ("q8", q8), ("sk8", sk8)):
        res[name] = {"b1_ms": cuda_ms(lambda: fn(0, 1), 20),
                     "b128_ms": cuda_ms(lambda: fn(0, b), 10),
                     "agree_b1": top10_agreement(solo_rows(fn), ref_1),
                     "agree_b128": top10_agreement(fn(0, b)[1], ref_b)}

    # the screened B=1 program, int8 and proj screens (default screen knobs)
    mini = sparse.sketch_mini(128)
    for mode in ("int8", "proj"):
        with knobs({"CQST_SCREEN_ENABLE": "1", "CQST_SCREEN_MODE": mode,
                    "CQST_SCREEN_MIN_ROWS": str(min(n, 131072))}):   # the default at 1M
            t0 = time.perf_counter()
            dense._build_screen()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        if dense.screen is None:
            fail(f"no {mode} screen at {n} rows")
        q_scr = torch.from_numpy(np.stack([dense.project_query(x) for x in q[:nq]])).to(dev)

        def screened(i, j):
            return program.hybrid_query_screened(
                dense.matrix, dense.screen, packed, None, mini, dense.mask, q_dense[i:j],
                q_scr[i:j], q_ids_t[i:j], q_w_t[i:j], alphas[i:j], pool, 4096, v, s // 128, 4)

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
    report["scale"] = {"device_gb": gb, "sketch_build_s": t2 - t1, "ptk": ptk,
                       "dense_i8_ms": q8_build_ms, "sketch_i8_ms": sk8_build_ms, **res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernels,e2e,scale")
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
    from cqs_tpu_torch.ops.topk import KERNELS

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
        phase_kernels(torch, dev, rng, report)
    kernel_phase = {k.name: k.launches for k in KERNELS}
    if "kernels" in phases:
        print(f"launches in the kernel phase: {kernel_phase}")
        for k in KERNELS:
            if k.kind == "i8w" and k.launches == 0:
                fail(f"widening kernel {k.name} was not launched in the kernel phase")
    for k in KERNELS:
        k.launches = 0                        # the main path's run starts here
    if "e2e" in phases:
        phase_e2e(torch, dev, report)
    if "scale" in phases:
        phase_scale(torch, dev, rng, report)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in KERNELS}
    print(f"launches on the main path: {launches}")
    if {"e2e", "scale"} <= phases:
        for k in KERNELS:
            if k.launches == 0:
                fail(f"kernel {k.name} was not launched on the main path")
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")]
    if loaded:
        fail(f"JAX modules were imported: {loaded[:5]}")
    # the case each kernel's times on the kernels line come from: the 1M x
    # 1024 sketch scan, loop at B=1 and grouped at B=128 (tile 2048, m 4)
    kernels = []
    for k in KERNELS:
        t = next((x for x in report.get("timings", [])
                  if (x["kernel"], x["n"], x["d"], x["tile"], x["b"], x["m"])
                  == (k.name, SCALE_ROWS, 1024, 2048, 128 if k.grouped else 1, 4)), None)
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": k.launches,
                        "kernel_phase_launches": kernel_phase[k.name],
                        "max_abs_err": report.get("errs", {}).get(k.name),
                        "ms": t and t["ms"], "plain_ms": t and t["plain_ms"]})
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
