#!/usr/bin/env python3
"""A/B of two checkouts of the PyTorch/CUDA port on one card, in turns.

    python3 scripts/torch_ab.py --trees PARENT_DIR,CHANGE_DIR [--order abba]
                                [--rounds 5] [--sizes "3745:1,8;65536:64;1048576:1,128"]

Each turn is a fresh process run from one tree's root (so it imports that
tree's ``cqs_tpu_torch`` and builds its kernels), in the order given (``a``
the first tree, ``b`` the second; ``abba`` by default). For each corpus
size of ``--sizes`` (rows: batch sizes) a turn builds the workload of
``chip_smoke.py``'s scale phase (``scale_workload``, taken from the
checkout that holds this script, so both trees run the same one: a
synthetic index at hash-tier widths, seeded numpy data; 3,745 rows pad to
the 4,096 of this repository's own corpus, 65,536 rows is a daemon-sized
corpus whose batches scan with the loop kernels, 1,048,576 rows the large
corpus), and for the bf16, q8, sk8 and screened (int8 screen) programs at
each batch size records:

- wall time, CUDA events, median of ``--rounds`` windows;
- a digest of the result (fused scores and rows), so two trees that
  compute the same results show the same digests;
- after every wall time, device-busy time per call and its scan kernels
  (``torch.profiler``, 5 calls): B=1 is bound by the host's launches, so
  its wall time moves with the host while its device time does not.

Where the two trees' digests differ, it compares their results (each
tree's first turn): the share of equal rows, top-10 agreement, and the
largest difference of the fused and dense scores. Prints one JSON
object per turn and a summary (each tree's turns, their median and
quartiles); writes everything to ``chiprun_out/torch_ab.json`` when that
directory exists. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

SEED = 0
#: the checkout that holds this script: its chip_smoke.py defines the workload
HOME = Path(__file__).resolve().parents[1]
#: kernel names that are scans, in either tree
SCAN_KERNELS = ("scan_topk", "grouped_mma", "loop_split", "merge_slices")


def parse_sizes(text: str) -> dict[int, list[int]]:
    """ "3745:1,8;65536:64" -> {3745: [1, 8], 65536: [64]}"""
    out = {}
    for part in text.split(";"):
        n, batches = part.split(":")
        out[int(n)] = [int(x) for x in batches.split(",")]
    return out


def worker(rounds: int, sizes: dict[int, list[int]], dump: str | None) -> dict:
    """One turn, in the tree that is the current directory; ``dump`` names
    an .npz file for the results (fused, rows, dense leg)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from cqs_tpu_torch.ops import _kernels

    spec = importlib.util.spec_from_file_location("chip_smoke", HOME / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)
    _kernels.load()
    out = {"device": torch.cuda.get_device_name(0), "programs": {}, "digest": {},
           "profile": {}}
    progs = {}
    for n, batches in sizes.items():
        w = smoke.scale_workload(torch, dev, np.random.default_rng(SEED), n, max(batches))
        screened, _ = smoke.screened_program(torch, w, "int8")
        for name, fn in {**w.programs, "screened": screened}.items():
            for j in batches:
                progs[f"{name}_n{n}_b{j}"] = (lambda fn=fn, j=j: fn(0, j))
    results = {}
    for key, fn in progs.items():
        ms = [smoke.cuda_ms(fn, 20 if key.endswith("_b1") else 10) for _ in range(rounds)]
        out["programs"][key] = statistics.median(ms)
        res = [x.detach().cpu().contiguous().numpy() for x in fn()[:3]]
        h = hashlib.blake2b(digest_size=8)
        for x in res[:2]:
            h.update(x.tobytes())
        out["digest"][key] = h.hexdigest()
        for name, x in zip(("fused", "rows", "dense"), res):
            results[f"{key}/{name}"] = x
    if dump:
        np.savez(dump, **results)
    # the profiler last, after every wall time
    for key, fn in progs.items():
        busy, by_kernel, _, _ = smoke.device_busy(torch, fn, 5)
        out["profile"][key] = {"device_ms": busy, "kernels": len(by_kernel),
                               "scan_ms": {k: x for k, x in by_kernel.items()
                                           if any(s in k for s in SCAN_KERNELS)}}
    return out


def compare(a: str, b: str, keys) -> dict:
    """The two trees' results side by side, for each program key."""
    import numpy as np

    ra, rb = np.load(a), np.load(b)
    out = {}
    for key in keys:
        rows_a, rows_b = ra[f"{key}/rows"], rb[f"{key}/rows"]
        same = rows_a == rows_b
        top10 = np.mean([len(set(x[:10]) & set(y[:10])) / 10 for x, y in zip(rows_a, rows_b)])
        valid = ra[f"{key}/fused"] > -1e30
        out[key] = {
            "rows_equal_share": float(same.mean()), "top10_agreement": float(top10),
            "max_abs_fused_diff": float(np.abs(ra[f"{key}/fused"] - rb[f"{key}/fused"])[valid].max(
                initial=0.0)),
            "max_abs_dense_diff_same_rows": float(np.abs(
                ra[f"{key}/dense"] - rb[f"{key}/dense"])[same & valid].max(initial=0.0))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", help="two checkout roots, comma-separated")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--sizes", default="3745:1,8;65536:64;1048576:1,128",
                    help="corpus rows and their batch sizes: rows:b,b;rows:b")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.rounds, parse_sizes(args.sizes), args.dump)))
        return 0
    trees = [Path(p).resolve() for p in args.trees.split(",")]
    if len(trees) != 2 or not all((t / "cqs_tpu_torch").is_dir() for t in trees):
        raise SystemExit("--trees needs two checkout roots holding cqs_tpu_torch/")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    turns = []
    tmp = tempfile.mkdtemp(prefix="torch_ab_")
    dumps = {w: os.path.join(tmp, f"{w}.npz") for w in "ab"}
    for which in args.order:
        tree = trees["ab".index(which)]
        dump = [] if os.path.exists(dumps[which]) else ["--dump", dumps[which]]
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               "--rounds", str(args.rounds), "--sizes", args.sizes, *dump],
                              cwd=tree,
                              capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=str(tree)))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"torch_ab: the turn in {tree} failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"], rec["which"] = str(tree), which
        turns.append(rec)
        print(json.dumps({"which": which, "tree": str(tree), "programs": rec["programs"]}))
    def spread(xs):
        if len(xs) < 2:
            return f"{xs[0]:.4f}"
        q1, med, q3 = statistics.quantiles(xs, n=4)
        return f"median {med:.4f} (quartiles {q1:.4f}-{q3:.4f})"

    for which in "ab":
        mine = [r for r in turns if r["which"] == which]
        if not mine:
            continue
        series = {f"programs {k}": [r["programs"][k] for r in mine] for k in mine[0]["programs"]}
        series.update({f"device-busy {k}": [r["profile"][k]["device_ms"] for r in mine]
                       for k in mine[0]["profile"]})
        series.update({f"scans {k}": [sum(r["profile"][k]["scan_ms"].values()) for r in mine]
                       for k in mine[0]["profile"]})
        for k, xs in series.items():
            print(f"{which} {k}: {' / '.join(f'{x:.4f}' for x in xs)}; {spread(xs)}")
    same = all(r["digest"] == turns[0]["digest"] for r in turns)
    print(f"result digests equal across all turns: {same}")
    within = {w: all(r["digest"] == t["digest"] for r in turns for t in turns
                     if r["which"] == t["which"] == w) for w in "ab"}
    print(f"digests equal within each tree's turns: {within}")
    diff = {}
    if all(os.path.exists(p) for p in dumps.values()):
        first = {w: next(r for r in turns if r["which"] == w) for w in "ab"}
        keys = [k for k in first["a"]["digest"] if first["a"]["digest"][k] != first["b"]["digest"][k]]
        diff = compare(dumps["a"], dumps["b"], keys)
        for k in first["a"]["digest"]:
            print(f"{k}: " + ("digests equal" if k not in diff else ", ".join(
                f"{name} {x:.6g}" for name, x in diff[k].items())))
    shutil.rmtree(tmp, ignore_errors=True)
    out = Path("chiprun_out")
    if out.is_dir():
        (out / "torch_ab.json").write_text(json.dumps(
            {"smi": smi, "turns": turns, "differing_results": diff}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
