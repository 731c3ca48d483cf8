"""Each cell of ``BENCHMARK.json`` through the benchmark's command on an
NVIDIA card, with a short window: it exits 0 and its result is correct.
Skips without a card (``python -m pytest perfbench -m card`` on the card's
machine)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", workload,
                        "--seed", "2147483713", "--seconds", "5", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
