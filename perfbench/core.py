"""What the harness hands a driver (:class:`Cell`) and what a driver hands
back (:class:`Outcome`)."""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    #: ``time.perf_counter()`` at the start of the process: set-up counts from it
    t0: float
    #: faults planted in the timed path (the checks' tests), by name
    faults: frozenset = field(default_factory=frozenset)
    #: also read the control and the faults planted in the reference, into
    #: ``Outcome.record["control"]`` (``perfbench/control.py``; never in a
    #: benchmark run)
    control: bool = False

    def log(self, msg: str) -> None:
        print(f"[perfbench {time.perf_counter() - self.t0:9.3f} s] {msg}", file=sys.stderr,
              flush=True)

    @contextlib.contextmanager
    def step(self, what: str):
        """A set-up or check step, printed with its seconds on standard error."""
        t = time.perf_counter()
        self.log(f"{what} ...")
        yield
        self.log(f"{what}: {time.perf_counter() - t:.3f} s")

    def workdir(self) -> Path:
        """An empty directory of this workload's under ``TMPDIR``."""
        d = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "perfbench" / self.workload
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        return d

    def cleanup(self) -> None:
        d = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "perfbench" / self.workload
        shutil.rmtree(d, ignore_errors=True)


@dataclass
class Outcome:
    attempted: int
    failed: int
    #: end-to-end candidates: name -> (value, unit)
    e2e: dict
    #: what the per-layer readers read (``perfbench/metrics/*.py``)
    record: dict
    #: the numbers compared: name -> (value, limit); a run is correct when
    #: every value is at most its limit
    checks: dict
    memory_peak_bytes: int
    #: ``perfbench/trace.py::traced``'s reduction, in a traced run
    trace: dict | None = None

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values()) and self.failed == 0
