#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cqs_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases kernels,e2e,scale]

Phases, each fatal on error (non-zero exit, no result line):

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels from ``cqs_tpu_torch/csrc`` (timed);
3. kernels: each kernel against its plain PyTorch twin on the card, on the
   adversarial cases of the reference's op tests and at the main path's
   shapes (row widths 256 and 1024, tile 2048, B 1/8/128, m 4/16/64, 4096
   and 1,048,576 rows), with both times;
4. e2e: index a copy of this repository's sources through the port's CLI,
   answer searches through it, then a paused burst through the
   ``QueryBatcher`` whose results must equal the solo ones;
5. scale: a synthetic 1,048,576-row index at the hash tier's widths (seeded
   numpy), ``hybrid_query`` at B=1 and ``hybrid_query_batch`` at B=128, with
   top-10 agreement against the exact plain scan.

The kernels' launch counters are zeroed before phase 4 and read after
phase 5; a kernel of the path that did not launch there fails the run. The
second-to-last line is a JSON object with each kernel's launches, error and
times; the last is ``{"ok": true, "device": {...}}``. Needs one CUDA card;
exits non-zero without one or outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
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


def phase_kernels(torch, dev, rng, report):
    from cqs_tpu_torch.ops.topk import (GROUPED, LOOP, scan_topk_plain_grouped,
                                        scan_topk_plain_loop)

    pairs = ((LOOP, scan_topk_plain_loop), (GROUPED, scan_topk_plain_grouped))
    errs = {k.name: 0.0 for k, _ in pairs}
    for name, index, q, mask, tile, m in adversarial_cases(torch, dev, rng):
        for kernel, plain in pairs:
            errs[kernel.name] = max(errs[kernel.name], compare_tiles(
                kernel, plain, index, q, mask, tile, m, f"{kernel.name}/{name}"))
    print(f"kernels: adversarial cases ok (mask, spread spikes, same-group collision, "
          f"heavy mask, ties)")
    timings = []
    for n in (4096, SCALE_ROWS):
        for d in (256, 1024):
            gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
            index = torch.randn(n, d, device=dev, generator=gen).to(torch.bfloat16)
            mask = (torch.rand(n, device=dev, generator=gen) > 0.02).to(torch.int32)
            for b in (1, 8, 128):
                q = torch.randn(b, d, device=dev, generator=gen).to(torch.bfloat16)
                for kernel, plain in pairs:
                    for m in ((4, 16, 64) if kernel is LOOP else (4, 16)):
                        label = f"{kernel.name} n={n} d={d} b={b} m={m}"
                        errs[kernel.name] = max(errs[kernel.name], compare_tiles(
                            kernel, plain, index, q, mask, 2048, m, label))
                        iters = 20 if n == SCALE_ROWS else 100
                        pm1 = cuda_ms(lambda: plain(index, q, mask, 2048, m), iters)
                        km1 = cuda_ms(lambda: kernel(index, q, mask, 2048, m), iters)
                        km2 = cuda_ms(lambda: kernel(index, q, mask, 2048, m), iters)
                        pm2 = cuda_ms(lambda: plain(index, q, mask, 2048, m), iters)
                        timings.append({"kernel": kernel.name, "n": n, "d": d, "b": b, "m": m,
                                        "ms": (km1 + km2) / 2, "plain_ms": (pm1 + pm2) / 2})
            del index, mask
            torch.cuda.empty_cache()
    print("kernels: main-path shapes ok; times (ms, CUDA events, kernel vs plain):")
    for t in timings:
        print(f"  {t['kernel']:18s} n={t['n']:8d} d={t['d']:5d} b={t['b']:4d} m={t['m']:3d}  "
              f"kernel {t['ms']:9.4f}  plain {t['plain_ms']:9.4f}")
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


def phase_e2e(torch, dev, report):
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.daemon.batcher import QueryBatcher
    from cqs_tpu_torch.ops.topk import LOOP

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
        cli_ms = []
        for q in QUERIES:
            before = LOOP.launches
            rc, env, ms = run_cli(main, [q, "--path", str(proj), "--device", str(dev), "--json"])
            if rc != 0 or env is None or not env["results"]:
                fail(f"search {q!r}: rc {rc}, no hits")
            if dev.type == "cuda" and LOOP.launches <= before:
                fail(f"search {q!r} did not launch the loop kernel")
            cli_ms.append(ms)
        ctx = CommandContext.create(str(proj), device=dev)
        eng = ctx.engine
        cap = eng.dense.capacity
        print(f"e2e: {eng.dense.count} rows padded to {cap} ({cap // 2048} tiles of 2048)")
        solo, e2e_ms, dev_ms = {}, [], []
        for q in QUERIES:
            res = eng.search(q)
            solo[q] = [(h.row.id, h.score) for h in res.hits]
            e2e_ms.append(res.elapsed_ms)
            if "device_ms" in res.meta:
                dev_ms.append(res.meta["device_ms"])
        ctx2 = CommandContext.create(str(proj), device=dev)
        batcher = QueryBatcher(ctx2.engine)
        try:
            batcher.pause()
            futs = [batcher.submit(q) for q in QUERIES[:8]]
            batcher.resume()
            results = [f.result(timeout=120) for f in futs]
        finally:
            batcher.stop()
        batch_ms = sorted({r.meta.get("device_ms", 0.0) for r in results})
        for q, res in zip(QUERIES[:8], results):
            got = [(h.row.id, h.score) for h in res.hits]
            if [i for i, _ in got] != [i for i, _ in solo[q]] or any(
                    abs(a - b) > 1e-5 for (_, a), (_, b) in zip(got, solo[q])):
                fail(f"batched result of {q!r} differs from solo")
        st = batcher.stats
        if st["fused"] != 8 or st["solo"] != 0:
            fail(f"burst did not run batched: {st}")
        print(f"e2e: batched == solo for 8 queries ({st['batches']} device batch(es), "
              f"sizes {st['batch_size_hist']})")
        print(f"e2e: solo search ms (CLI process call incl. engine load) median "
              f"{statistics.median(cli_ms):.2f}; engine.search median "
              f"{statistics.median(e2e_ms):.2f}; device program median "
              f"{statistics.median(dev_ms):.3f} (host clock incl. transfer); "
              f"batch device ms {', '.join(f'{x:.3f}' for x in batch_ms)}")
        report["e2e"] = {"chunks": stats["chunks_upserted"], "capacity": cap,
                         "cli_ms": statistics.median(cli_ms),
                         "search_ms": statistics.median(e2e_ms),
                         "device_ms": statistics.median(dev_ms), "batch_ms": batch_ms}
        ctx2.close()
        ctx.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 5: a 1M-row index at the hash tier's widths --------------------------

def phase_scale(torch, dev, rng, report, n: int = SCALE_ROWS):
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
    torch.cuda.synchronize()
    gb = sum(x.numel() * x.element_size() for x in
             (dense.matrix, sparse.doc_ids, sparse.doc_w, sparse.sketch, packed)) / 1e9
    print(f"scale: {n} rows, D={d}, T={t}, S={s}: data {gen_s:.1f} s, dense index "
          f"{t1 - t0:.1f} s, sparse index incl. host sketch build {t2 - t1:.1f} s; "
          f"{gb:.2f} GB on the device")

    b = 128
    rows = rng.choice(n, size=b, replace=False)
    q = mat[rows] / np.linalg.norm(mat[rows], axis=1, keepdims=True)
    q = q + 0.5 * rng.standard_normal((b, d), dtype=np.float32) / np.sqrt(d)
    q_ids = np.ascontiguousarray(doc_ids[rows, :16])
    q_w = np.log1p(np.arange(16, 0, -1, dtype=np.float32))[None, :].repeat(b, 0)
    q_dense = torch.from_numpy(q.astype(np.float32)).to(dev)
    q_ids_t, q_w_t = torch.from_numpy(q_ids).to(dev), torch.from_numpy(q_w).to(dev)
    alphas = torch.full((b,), 0.8, device=dev)
    arrays = (dense.matrix, packed, None, sparse.sketch, dense.mask)

    ext = bf16_extraction(dense.capacity, b)
    ptk, ran = program.scan_geometry(n, pool, 2048, ext)
    if n >= 131072 and ran != "grouped":
        fail(f"B={b} at {n} rows did not select the grouped kernel ({ran})")

    def solo():
        return program.hybrid_query(*arrays, q_dense[0], q_ids_t[0], q_w_t[0], 0.8, pool, v,
                                    extraction=bf16_extraction(dense.capacity, 1))

    def batch():
        return program.hybrid_query_batch(*arrays, q_dense, q_ids_t, q_w_t, alphas, pool, v,
                                          extraction=ext)

    def exact(bq):
        qm = q_dense[:bq].to(torch.bfloat16)
        qs = program._query_sketch(q_ids_t[:bq], q_w_t[:bq], s).to(torch.bfloat16)
        r, dc = program._exact_candidates(dense.matrix, sparse.sketch, dense.mask, qm, qs, pool)
        return program._exact_rescore_fuse(packed, None, dense.mask, q_ids_t[:bq], q_w_t[:bq],
                                           alphas[:bq], r.to(torch.int32), dc, pool, v)

    solo_ms = cuda_ms(solo, 20)
    batch_ms = cuda_ms(batch, 10)
    got_b, ref_b = batch()[1][:, :10], exact(b)[1][:, :10]
    got_1, ref_1 = solo()[1][:10], exact(1)[1][0, :10]
    agree_b = float(np.mean([len(set(g.tolist()) & set(r.tolist())) / 10
                             for g, r in zip(got_b.cpu(), ref_b.cpu())]))
    agree_1 = len(set(got_1.tolist()) & set(ref_1.tolist())) / 10
    print(f"scale: hybrid_query B=1 (loop, per-tile k {program.scan_geometry(n, pool)[0]}) "
          f"{solo_ms:.3f} ms/query; hybrid_query_batch B={b} ({ran}, per-tile k {ptk}) "
          f"{batch_ms:.3f} ms/batch; top-10 agreement with the exact plain scan: "
          f"B=1 {agree_1:.4f}, B={b} {agree_b:.4f}")
    if agree_b < 0.9 or agree_1 < 0.9:
        fail("top-10 agreement with the exact scan below 0.9")
    report["scale"] = {"solo_ms": solo_ms, "batch_ms": batch_ms, "agree_b1": agree_1,
                       "agree_b128": agree_b, "device_gb": gb, "sketch_build_s": t2 - t1}


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
    pick = {"scan_topk_loop": (SCALE_ROWS, 1024, 1, 4),
            "scan_topk_grouped": (SCALE_ROWS, 1024, 128, 4)}
    kernels = []
    for k in KERNELS:
        t = next((x for x in report.get("timings", [])
                  if (x["kernel"], x["n"], x["d"], x["b"], x["m"]) == (k.name, *pick[k.name])),
                 None)
        kernels.append({"name": k.name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": k.launches,
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
