#!/usr/bin/env python3
"""A/B of two checkouts of the PyTorch/CUDA port on one card, in turns.

    python3 scripts/torch_ab.py --trees PARENT_DIR,CHANGE_DIR [--order abba]
                                [--rounds 5] [--batches 1,128]

Each turn is a fresh process run from one tree's root (so it imports that
tree's ``cqs_tpu_torch`` and builds its kernels), in the order given (``a``
the first tree, ``b`` the second; ``abba`` by default). A turn builds the
workload of ``chip_smoke.py``'s scale phase (``scale_workload``, taken from
the checkout that holds this script, so both trees run the same one: a
1,048,576-row synthetic index at hash-tier widths, seeded numpy data), then
times with CUDA events, median of ``--rounds`` windows, at each B of
``--batches`` (1 and 128 by default):

- the bf16, q8 and sk8 programs (as chip_smoke's scale phase calls them);
- the int8 x int8 grouped scan (``GROUPED_I8``) at the programs' shapes
  (x1024 tiles 2048 and 4096, x256 tile 2048; m 4), also at B=8 when B=1
  is asked for;
- device-busy time per call of each program, by kernel (``torch.profiler``,
  5 calls): B=1 is bound by the host's launches, so its wall time moves
  with the host while its device time does not;

and records a digest of the q8 and sk8 results (rows and scores), so two
trees that compute the same results show the same digests. Prints one JSON
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
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 0
#: the checkout that holds this script: its chip_smoke.py defines the workload
HOME = Path(__file__).resolve().parents[1]


def worker(rounds: int, batches: list[int]) -> dict:
    """One turn, in the tree that is the current directory."""
    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from cqs_tpu_torch.ops import _kernels
    from cqs_tpu_torch.ops.topk import GROUPED_I8

    spec = importlib.util.spec_from_file_location("chip_smoke", HOME / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)
    _kernels.load()
    w = smoke.scale_workload(torch, dev, np.random.default_rng(SEED))
    progs = {name: (lambda j, fn=fn: fn(0, j)) for name, fn in w.programs.items()}
    out = {"device": torch.cuda.get_device_name(0), "programs": {}, "kernel": {},
           "digest": {}, "profile": {}}
    for name, fn in progs.items():
        for j in batches:
            ms = [smoke.cuda_ms(lambda: fn(j), 20 if j == 1 else 10) for _ in range(rounds)]
            out["programs"][f"{name}_b{j}"] = statistics.median(ms)
    for name in ("q8", "sk8"):
        for j in batches:
            res = progs[name](j)
            torch.cuda.synchronize()
            h = hashlib.blake2b(digest_size=8)
            for x in res[:2]:
                h.update(x.detach().cpu().contiguous().numpy().tobytes())
            out["digest"][f"{name}_b{j}"] = h.hexdigest()

    # the scan alone at the programs' shapes: q8's sketch (x1024) and dense
    # (x256) scans at tile 2048, sk8's sketch scan at tile 4096
    for dd, tile in ((1024, 2048), (1024, 4096), (256, 2048)):
        index = w.sketch_i8 if dd == 1024 else w.dense_i8
        for j in sorted(set(batches) | ({8} if 1 in batches else set())):
            qq = torch.randint(-127, 128, (j, dd), device=dev, dtype=torch.int8,
                               generator=torch.Generator(device=dev).manual_seed(j))
            ms = [smoke.cuda_ms(lambda: GROUPED_I8(index, qq, w.dense.mask, tile, 4), 10)
                  for _ in range(rounds)]
            out["kernel"][f"x{dd}_tile{tile}_b{j}"] = statistics.median(ms)

    # device time per call by kernel (torch.profiler, 5 calls): B=1 is
    # bound by the host's launches, so its wall time varies with the host;
    # the device-busy time does not
    from torch.profiler import ProfilerActivity, profile
    for name, fn in progs.items():
        for j in batches:
            fn(j)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn(j)
                torch.cuda.synchronize()
            by_kernel = {}
            for e in prof.key_averages():
                dev_us = (getattr(e, "device_time_total", None)
                          or getattr(e, "cuda_time_total", 0))
                if getattr(getattr(e, "device_type", None), "name", "") == "CUDA" and dev_us:
                    by_kernel[e.key[:60]] = dev_us / 5 / 1e3
            scans = {k: x for k, x in by_kernel.items()
                     if "scan_topk" in k or "grouped_mma" in k}
            out["profile"][f"{name}_b{j}"] = {"device_ms": sum(by_kernel.values()),
                                              "scan_ms": scans, "kernels": len(by_kernel)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", help="two checkout roots, comma-separated")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--batches", default="1,128", help="batch sizes, comma-separated")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    batches = [int(x) for x in args.batches.split(",")]
    if args.worker:
        print(json.dumps(worker(args.rounds, batches)))
        return 0
    trees = [Path(p).resolve() for p in args.trees.split(",")]
    if len(trees) != 2 or not all((t / "cqs_tpu_torch").is_dir() for t in trees):
        raise SystemExit("--trees needs two checkout roots holding cqs_tpu_torch/")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    turns = []
    for which in args.order:
        tree = trees["ab".index(which)]
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               "--rounds", str(args.rounds), "--batches", args.batches], cwd=tree,
                              capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=str(tree)))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"torch_ab: the turn in {tree} failed")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["tree"], rec["which"] = str(tree), which
        turns.append(rec)
        print(json.dumps(rec))
    def spread(xs):
        if len(xs) < 2:
            return f"{xs[0]:.4f}"
        q1, med, q3 = statistics.quantiles(xs, n=4)
        return f"median {med:.4f} (quartiles {q1:.4f}-{q3:.4f})"

    for which in "ab":
        mine = [r for r in turns if r["which"] == which]
        if not mine:
            continue
        series = {f"{key} {k}": [r[key][k] for r in mine]
                  for key in ("programs", "kernel") for k in mine[0][key]}
        series.update({f"device-busy {k}": [r["profile"][k]["device_ms"] for r in mine]
                       for k in mine[0]["profile"]})
        for k, xs in series.items():
            print(f"{which} {k}: {' / '.join(f'{x:.4f}' for x in xs)}; {spread(xs)}")
    same = all(r["digest"] == turns[0]["digest"] for r in turns)
    print(f"q8/sk8 result digests equal across all turns: {same}")
    out = Path("chiprun_out")
    if out.is_dir():
        (out / "torch_ab.json").write_text(json.dumps({"smi": smi, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
