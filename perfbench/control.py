"""Readings from which the limits of ``perfbench/limits/<workload>.json`` are
set: for each seed, one run of the cell's timed path at its own sizes (a
short window), its numbers compared, and the same numbers read off the
reference put in the program's place: in the configuration's precision
(bf16), in the control's (fp8), and with each fault planted
(``drivers/*.py::control_readings``). Each of those is judged by the cell's
limits as a run is (``control_correct``): the control and the faults have
to come out false. Not part of a benchmark run.

    python3 -m perfbench.control --workload <name> --seeds <n,n,...> --seconds <s> [--out <file>]

Each seed's readings are one JSON line on standard output (and in ``--out``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from perfbench import run  # noqa: E402


def judged(readings: dict, checks: dict) -> bool:
    """Whether ``readings`` pass the limits that a run's ``checks`` carry
    (the numbers that a reading has)."""
    return all(v <= checks[k]["limit"] for k, v in readings.items() if k in checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, outcome = run.run_cell(bench, args.workload, seed, args.seconds, False,
                                       torch.device("cuda", 0), t0, control=True)
        readings = outcome.record.get("control") or {}
        line = json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                           "checks": {k: v["value"] for k, v in result["checks"].items()},
                           "control_correct": {name: judged(r, result["checks"])
                                               for name, r in readings.items()},
                           "readings": readings,
                           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del result, outcome
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
