"""The benchmark of ``cqs_tpu_torch``: one run of one cell.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's NVIDIA cards.
``BENCHMARK.json`` names the cell's configuration and traffic; each is found
by that name under ``perfbench/``: ``configs/<config>.json`` (the sizes and
the reference's settings), ``traffic/<traffic>.json`` (the mix's parameters
and the driver, ``drivers/<driver>.py``, that generates and runs it),
``limits/<workload>.json`` (the limit of each number compared), and
``metrics/<metric>.py`` for each per-layer metric (a ``read(record)`` that
returns the number or None). The last line of standard output is the
result, as one JSON object; standard error ends with each number compared
beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names the run may not load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "cqs_tpu")


def set_cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic, limits) of ``workload``."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return (wl, load_json(ROOT / conf["file"]), load_json(BENCH / "traffic" / f"{wl['traffic']}.json"),
            load_json(BENCH / "limits" / f"{workload}.json"))


def end_to_end_of(bench: dict, workload: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer_of(bench: dict, workload: str) -> list[dict]:
    moved = {m["name"] for m in end_to_end_of(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float, faults=frozenset(), control: bool = False) -> tuple[dict, object]:
    """One run of ``workload`` on ``device``: (the result line's object,
    the driver's :class:`~perfbench.core.Outcome`)."""
    from perfbench.core import Cell

    wl, config, traffic, limits = cell_files(bench, workload)
    cell = Cell(workload=workload, config=config, traffic=traffic, limits=limits, seed=seed,
                seconds=seconds, trace=trace, device=device, t0=t0, faults=frozenset(faults),
                control=control)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    try:
        out = driver.run(cell)
    finally:
        cell.cleanup()
    metrics = {}
    if not trace:
        for m in end_to_end_of(bench, workload):
            value, unit = out.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    else:
        for m in per_layer_of(bench, workload):
            value = reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": {}}
    if out.trace:
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return result, out


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = cell_files(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"perfbench: {wl['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           device, T0)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": wl["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    if out.trace:
        result["device"].update(busy_s=out.trace["busy_s"], window_s=out.trace["window_s"])
    result["checks"] = checks
    print(f"card: {card_line()}", file=sys.stderr)
    print(f"correct: {result['correct']} (attempted {out.attempted}, failed {out.failed})",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
