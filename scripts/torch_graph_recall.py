#!/usr/bin/env python3
"""R@10 of the port's graph ANN against exact, over several corpus draws, on one card.

    python3 scripts/torch_graph_recall.py [--seeds 0,1,2,3,4] [--queries 256]
                                          [--rows 1048576] [--dim 768]

For each seed, the corpus of ``chip_smoke.py``'s graph phase
(``graph_corpus``: 1,024 centers, 0.35 noise, L2 rows, bf16, made on the
card; queries a row plus 0.05 noise) gets its exact top-10 through the
split loop kernel, an NN-descent graph (degree 32, 8 rounds) and a beam
search at the default beam (640 at 1M rows) and at beams 512 and 1024 (the
points of ``scripts/validate_graph_1m.py``). It prints, per seed and beam,
R@10 over all queries and over the first 256, and how many queries found
none of their top-10 (the beam never reached their cluster): the spread of
those over seeds is what a single reading of 256 queries can show. It also
prints the share of each of 2,048 evenly spaced rows' true 32 nearest rows
(by the split kernel's exact scan) that its NN-descent list holds. Writes
the rows to ``chiprun_out/torch_graph_recall.json`` when that directory
exists. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HOME = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=768)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_graph_recall: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HOME))
    spec = importlib.util.spec_from_file_location("chip_smoke", HOME / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cqs_tpu_torch.index import graph
    from cqs_tpu_torch.ops import topk

    dev = torch.device("cuda", 0)
    n, d = args.rows, args.dim
    beams = ((min(max(64, graph.default_itopk(n)), n), max(4, int(1.6 * np.log2(n)))),
             (512, 32), (1024, 48))
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        mat, q = smoke.graph_corpus(torch, dev, seed, n, d, args.queries)
        mask = torch.ones(n, dtype=torch.int32, device=dev)
        gt = topk.scan_topk(mat, q, 10, mask, tile_n=2048, extraction="loop")[1].cpu().numpy()
        t0 = time.perf_counter()
        nbrs = graph.nn_descent_graph(mat, 32, rounds=8, mat_dev=mat, device=dev)
        row = {"seed": seed, "rows": n, "dim": d, "queries": args.queries,
               "nnd_s": time.perf_counter() - t0}
        probe = torch.arange(0, n, max(1, n // 2048), device=dev)[:2048]
        true = topk.scan_topk(mat, mat[probe], 33, mask, tile_n=2048,
                              extraction="loop")[1].cpu().numpy()
        ids = probe.cpu().numpy()
        row["lists_hold_true_32nn"] = float(np.mean(
            [len(set(true[i][true[i] != ids[i]][:32]) & set(nbrs[ids[i]])) / 32
             for i in range(len(ids))]))
        g = torch.from_numpy(nbrs.astype(np.int64)).to(dev)
        for beam, iters in beams:
            starts = torch.from_numpy(np.linspace(0, n - 1, beam).astype(np.int32)).to(dev)
            got = graph.graph_search(mat, g, mask, q, starts, 10, iters,
                                     max(8, beam // 16))[1].cpu().numpy()
            per = np.array([len(set(got[i]) & set(gt[i])) / 10 for i in range(args.queries)])
            row[f"beam_{beam}"] = {"iters": iters, "r_at_10": float(per.mean()),
                                   "r_at_10_first_256": float(per[:256].mean()),
                                   "queries_with_none": int((per == 0).sum())}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del mat, q, g, mask
        torch.cuda.empty_cache()
    smi = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    out = HOME / "chiprun_out"
    if out.is_dir():
        (out / "torch_graph_recall.json").write_text(json.dumps({"smi": smi, "rows": rows},
                                                                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
