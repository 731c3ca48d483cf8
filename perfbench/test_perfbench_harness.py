"""The harness on the CPU, in a copy of the benchmark: a configuration, two
traffic mixes and a per-layer metric added as new files and
``BENCHMARK.json`` entries run without an edit to any file already there;
each fault planted in the timed path turns ``correct`` false; nothing loads
JAX or the JAX package; a run without a card, or without the program,
prints no result."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

TINY_INDEX = {"name": "tiny-bert", "preset": "cqs-mini", "vocab_size": 32768, "hidden_size": 256,
              "num_hidden_layers": 4, "num_attention_heads": 8, "intermediate_size": 512,
              "max_position_embeddings": 128, "max_seq_len": 128, "pooling": "mean",
              "compute_dtype": "float32"}
TINY_TRAIN = {"name": "tiny-train", "hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 4, "intermediate_size": 64, "max_position_embeddings": 32,
              "compute_dtype": "float32"}
NEW_METRIC = '''"""Chunks an index iteration writes."""


def read(r: dict):
    if r.get("cell") != "index" or not r.get("iterations"):
        return None
    return r["chunks"] / r["iterations"]
'''
#: (workload, trace, faults) of each CPU run, and whether it must be correct
RUNS = [("tiny-bert.tiny-index", 0, (), True), ("tiny-bert.tiny-index", 1, (), True),
        ("tiny-train.tiny-train", 0, (), True), ("tiny-train.tiny-train", 1, (), True)]
FAULTS = [("tiny-bert.tiny-index", f) for f in ("token", "half_batch", "answer", "unchanged",
                                                "enriched_nl")] + \
         [("tiny-train.tiny-train", f) for f in ("token", "half_batch", "unchanged")]
DRIVE = """
import json, sys, time, torch
from perfbench import run
bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
for workload, trace, faults, _ in json.loads(sys.argv[1]):
    result, _ = run.run_cell(bench, workload, 2**31 + 17, 1.0, bool(trace), torch.device("cpu"),
                             time.perf_counter(), faults)
    print(json.dumps({"workload": workload, "trace": trace, "faults": faults, **result}))
print(json.dumps({"forbidden": run.forbidden_loaded()}))
"""


def _hashes(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _env(pythonpath: str) -> dict:
    env = dict(os.environ, PYTHONPATH=pythonpath)
    env["TMPDIR"] = env.get("TMPDIR", "/tmp")
    return env


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A copy of the benchmark with the tiny cells added as files, and the
    lines its runs printed."""
    d = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", d / "BENCHMARK.json")
    shutil.copytree(BENCH, d / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _hashes(d / "perfbench")
    pb = d / "perfbench"
    base = json.loads((pb / "configs" / "bge-large.json").read_text())
    (pb / "configs" / "tiny-bert.json").write_text(json.dumps({**base, **TINY_INDEX}))
    base = json.loads((pb / "configs" / "minilm-l6.json").read_text())
    (pb / "configs" / "tiny-train.json").write_text(json.dumps({**base, **TINY_TRAIN}))
    t = json.loads((pb / "traffic" / "index.json").read_text())
    t.update(files_per_iteration=3, base_files=6, check_sample=64, traced_iterations=1)
    (pb / "traffic" / "tiny-index.json").write_text(json.dumps(t))
    t = json.loads((pb / "traffic" / "train.json").read_text())
    t.update(batch=8, seq_len=32, pool_pairs=64, traced_steps=2)
    (pb / "traffic" / "tiny-train.json").write_text(json.dumps(t))
    (pb / "limits" / "tiny-bert.tiny-index.json").write_text(json.dumps(
        {"vec_gap": 1e-4, "chunk_mismatch": 0, "nl_mismatch": 0, "missing_vectors": 0}))
    (pb / "limits" / "tiny-train.tiny-train.json").write_text(json.dumps(
        {"loss_gap": 1e-4, "grad_gap_med": 1e-3, "delta_gap_med": 1e-3, "window_loss_gap": 1e-4,
         "window_delta_gap_med": 1e-3, "nonfinite": 0}))
    (pb / "metrics" / "chunks_per_iteration.tiny.py").write_text(NEW_METRIC)
    b = json.loads((d / "BENCHMARK.json").read_text())
    for name, src in (("tiny-bert", "tiny-bert"), ("tiny-train", "tiny-train")):
        b["configs"].append({"name": name, "source": "https://example.org/" + src,
                             "file": f"perfbench/configs/{name}.json", "reduced": [], "why": "a test"})
    b["workloads"] += [{"name": "tiny-bert.tiny-index", "config": "tiny-bert",
                        "traffic": "tiny-index", "chips": 1, "why": "a test"},
                       {"name": "tiny-train.tiny-train", "config": "tiny-train",
                        "traffic": "tiny-train", "chips": 1, "why": "a test"}]
    for m in b["end_to_end"] + b["per_layer"]:
        for old, new in (("bge-large.index", "tiny-bert.tiny-index"),
                         ("minilm-l6.train", "tiny-train.tiny-train")):
            if old in m.get("workloads", []):
                m["workloads"].append(new)
    b["per_layer"].append({"name": "chunks_per_iteration.tiny", "unit": "chunks",
                           "better": "higher", "source": "program_counter", "layer": "index pipeline",
                           "moves": "index_chunks_per_s", "workloads": ["tiny-bert.tiny-index"]})
    (d / "BENCHMARK.json").write_text(json.dumps(b))
    runs = RUNS + [(w, 0, [f], False) for w, f in FAULTS]
    p = subprocess.run([sys.executable, "-c", DRIVE, json.dumps(runs)], cwd=d, capture_output=True,
                       text=True, env=_env(f"{d}:{ROOT}"), timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    return {"dir": d, "before": before, "lines": lines}


def _line(copy, workload, trace=0, faults=()):
    return next(x for x in copy["lines"] if x.get("workload") == workload
                and x["trace"] == trace and x["faults"] == list(faults))


@pytest.mark.parametrize("workload,metrics", [
    ("tiny-bert.tiny-index", {"index_chunks_per_s", "setup_s"}),
    ("tiny-train.tiny-train", {"train_pairs_per_s", "train_step_p95_ms", "setup_s"})])
def test_added_cells_run_correct_with_their_end_to_end_metrics(copy, workload, metrics):
    line = _line(copy, workload)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == metrics
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("workload,metrics", [
    ("tiny-bert.tiny-index", {"host_ms_per_chunk.index", "pad_share.index", "mfu.index",
                              "idle_share.index", "chunks_per_iteration.tiny"}),
    ("tiny-train.tiny-train", {"host_prep_ms.train", "mfu.train", "idle_share.train"})])
def test_traced_runs_read_the_per_layer_metrics(copy, workload, metrics):
    line = _line(copy, workload, trace=1)
    assert line["correct"] is True
    # no card here: the matrix products' device time is nothing, so their
    # roofline reader finds nothing to read and is left out
    assert set(line["metrics"]) == metrics
    assert "breakdown" in line and list(line)[-1] == "checks"


def test_no_existing_file_was_edited(copy):
    after = _hashes(copy["dir"] / "perfbench")
    assert {k: after[k] for k in copy["before"]} == copy["before"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(copy, workload, fault):
    assert _line(copy, workload, faults=[fault])["correct"] is False


def test_nothing_loads_jax_or_the_jax_package(copy):
    assert copy["lines"][-1] == {"forbidden": []}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from perfbench import run

    monkeypatch.setitem(sys.modules, "cqs_tpu_torch_probe.x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert "cqs_tpu" not in run.forbidden_loaded() and "jax" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "cqs_tpu.models", sys)
    assert "cqs_tpu" in run.forbidden_loaded()


def test_a_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "bge-large.index",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=_env(str(ROOT)), timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_copy_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time, json, torch; from perfbench import run; "
            "b = json.loads((run.ROOT / 'BENCHMARK.json').read_text()); "
            "print(run.run_cell(b, 'bge-large.index', 1, 1.0, False, torch.device('cpu'), "
            "time.perf_counter()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                       env=_env(str(tmp_path)), timeout=300)
    assert p.returncode != 0 and p.stdout == ""
