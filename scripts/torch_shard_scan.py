#!/usr/bin/env python3
"""A shard's exact top-500 on one card: the split loop kernels at large m.

    python3 scripts/torch_shard_scan.py [--ptxas] [--rows 262144] [--pool 500]
                                        [--tiles 2048,4096,8192,16384]
                                        [--slices 1,2,4,8,16] [--seed 0]

With ``--ptxas`` it first compiles ``cqs_tpu_torch/csrc/scan_loop_mma.cu``
with ``-Xptxas -v`` (into a temporary directory) and prints each kernel's
registers, spills and static shared memory, and the dynamic shared memory
the split kernel takes at each query block and list length. Then, from
``chip_smoke.py``: the split kernels at m 129/256/500/512 slot for slot
against the loop twin (``check_loop_split(..., "wide")``), and both at a shard's
scans (``shard_kernel_times``: ``--rows`` x 768 and x 1024, tile 2048, m
``--pool``, B=1; the kernel, its plain twin and the template it replaced in
turns, the kernel at m 4, the per-shard step and its tile merge, the library
way, a 250,000-row shard). Last, the per-shard step (``scan_topk`` at one
tile: the kernel, then ``merge_tiles`` over tiles x m candidates) at each of
``--tiles``, in turns, for the sharded programs' two scans (bf16 x 768, the
dense leg; int8 x 1024, the sketch leg), and the split kernel at tile 2048
with each of ``--slices`` row slices a tile in place of ``split_slices``'s
count (m ``--pool`` and m 4). Prints the card's name and power
limit; writes the rows to ``chiprun_out/torch_shard_scan.json`` when that
directory exists. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]


def ptxas_report(smoke) -> None:
    """``-Xptxas -v`` of the split kernel's source, and its dynamic shared
    memory (ring + lists) by query block and list length."""
    from cqs_tpu_torch.ops import _kernels

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "x.o"), str(_kernels.CSRC / "scan_loop_mma.cu")],
            capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        print(out.stdout + out.stderr, file=sys.stderr)
        raise SystemExit("nvcc failed")
    for line in (out.stdout + out.stderr).splitlines():
        if "ptxas info" in line and ("Compiling" in line or "Used" in line or "spill" in line):
            print(f"ptxas: {line.strip()}")
        elif "bytes stack frame" in line:
            print(f"ptxas: {line.strip()}")
    # the source's loop_smem_bytes: ring stages x (128 rows + QB queries) x
    # 128 bytes, and QB x (128 + L + 256 / QB) keys of 8 bytes
    for qb in (8, 16, 32):
        stages = 3 if qb >= 32 else 4
        for lg in (7, 8, 9):
            ring = stages * (128 * 128 + qb * 128)
            keys = qb * (128 + (1 << lg) + 256 // qb) * 8
            print(f"smem: QB {qb:2d}, L {1 << lg:3d}: ring {ring} + lists {keys} = "
                  f"{ring + keys} bytes ({(ring + keys) / 1024:.1f} KiB; "
                  f"{'two CTAs an SM' if 2 * (ring + keys + 1024) <= 228 * 1024 else 'one CTA'})")


def tile_sweep(torch, smoke, dev, seed: int, n: int, pool: int, tiles) -> list[dict]:
    """The per-shard step at each tile, in turns (each tile once in order,
    then once in reverse): the kernel alone, ``merge_tiles`` alone, and the
    two together, for the dense leg (bf16 x 768) and the sketch leg (int8 x
    1024). Each tile's step is held to the plain step first."""
    from cqs_tpu_torch.ops.topk import (LOOP, LOOP_I8, merge_tiles, scan_topk, split_slices,
                                        topk_plain)

    out = []
    for kernel, d in ((LOOP, 768), (LOOP_I8, 1024)):
        kind = kernel.kind
        gen = torch.Generator(device=dev).manual_seed(seed + 17 * n + d)
        index, q, mask = smoke.shard_inputs(torch, dev, gen, kind, n, d)
        want = topk_plain(index, q, pool, mask)
        res = {t: {"kernel": [], "merge": [], "step": []} for t in tiles}
        for t in tiles:
            smoke.same_topk(torch, index, q, mask,
                            scan_topk(index, q, pool, mask, tile_n=t, per_tile_k=pool), want,
                            f"tile {t} ({kind})", kind == "i8")
        for t in [*tiles, *reversed(tiles)]:
            tv, tr = kernel(index, q, mask, t, pool)
            res[t]["kernel"].append(smoke.cuda_ms(lambda: kernel(index, q, mask, t, pool), 20))
            res[t]["merge"].append(smoke.cuda_ms(lambda: merge_tiles(tv, tr, pool), 20))
            res[t]["step"].append(smoke.cuda_ms(
                lambda: scan_topk(index, q, pool, mask, tile_n=t, per_tile_k=pool), 20))
        for t in tiles:
            row = {"kind": kind, "n": n, "d": d, "tile": t, "m": pool,
                   "slices": split_slices(n, t, 1, pool),
                   **{f"{k}_ms": sum(v) / len(v) for k, v in res[t].items()}}
            out.append(row)
            print(f"tiles: {kind:4s} {n} x {d}, tile {t:5d} ({n // t} tiles x "
                  f"{row['slices']} slices), m {pool}: kernel {row['kernel_ms']:.4f} ms, "
                  f"merge_tiles over {n // t * pool} candidates {row['merge_ms']:.4f}, "
                  f"per-shard step {row['step_ms']:.4f}")
        del index, q, mask
        torch.cuda.empty_cache()
    return out


def slice_sweep(torch, smoke, dev, seed: int, n: int, pool: int, counts) -> list[dict]:
    """The split kernel at tile 2048 with each slice count (``split_slices``
    swapped for a constant here), at m ``pool`` and m 4, in turns; each
    count's output held to the plain twin first."""
    from cqs_tpu_torch.ops import topk

    real = topk.split_slices
    out = []
    try:
        for kernel, d in ((topk.LOOP_SPLIT, 768), (topk.LOOP_SPLIT_I8, 1024)):
            kind = kernel.kind
            gen = torch.Generator(device=dev).manual_seed(seed + 31 * n + d)
            index, q, mask = smoke.shard_inputs(torch, dev, gen, kind, n, d)
            cmp = smoke.compare_exact if kind == "i8" else smoke.compare_tiles
            res = {(c, m): [] for c in counts for m in (pool, 4)}
            for c in counts:
                topk.split_slices = lambda *a, c=c: c
                cmp(kernel, topk.scan_topk_plain_loop, index, q, mask, 2048, pool,
                    f"{kernel.name} slices {c}")
            for c in [*counts, *reversed(counts)]:
                topk.split_slices = lambda *a, c=c: c
                for m in (pool, 4):
                    res[(c, m)].append(smoke.cuda_ms(lambda: kernel(index, q, mask, 2048, m), 20))
            for c in counts:
                row = {"kind": kind, "n": n, "d": d, "slices": c,
                       "ms": sum(res[(c, pool)]) / 2, "m4_ms": sum(res[(c, 4)]) / 2}
                out.append(row)
                print(f"slices: {kind:4s} {n} x {d}, tile 2048, {c:2d} slices "
                      f"({n // 2048 * c} CTAs): m {pool} {row['ms']:.4f} ms, m 4 "
                      f"{row['m4_ms']:.4f} ms")
            del index, q, mask
    finally:
        topk.split_slices = real
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--pool", type=int, default=500)
    ap.add_argument("--tiles", default="2048,4096,8192,16384")
    ap.add_argument("--slices", default="1,2,4,8,16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_shard_scan: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HOME))
    spec = importlib.util.spec_from_file_location("chip_smoke", HOME / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cqs_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    if args.ptxas:
        ptxas_report(smoke)
    _kernels.load()
    print(f"build: nvcc {_kernels.build_seconds:.1f} s")
    dev = torch.device("cuda", 0)
    cases = smoke.check_loop_split(torch, dev, args.seed, "wide")
    print(f"check: split kernels exact against the loop twin at m 129-512, {cases} cases")
    report: dict = {"shard": {}}
    smoke.shard_kernel_times(torch, dev, args.seed, report, args.rows, args.pool)
    sweep = tile_sweep(torch, smoke, dev, args.seed, args.rows, args.pool,
                       [int(t) for t in args.tiles.split(",")])
    slices = slice_sweep(torch, smoke, dev, args.seed, args.rows, args.pool,
                         [int(c) for c in args.slices.split(",")])
    out_dir = HOME / "chiprun_out"
    if out_dir.is_dir():
        (out_dir / "torch_shard_scan.json").write_text(json.dumps(
            {"smi": smi, "wide_cases": cases, "kernels": report["shard"]["kernels"],
             "odd_shards": report["shard"]["odd_shards"], "tiles": sweep, "slices": slices},
            indent=1))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
