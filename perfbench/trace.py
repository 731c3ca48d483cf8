"""The benchmark's own spans around calls into the program, and the reduction
of ``torch.profiler`` traces of a short window to device busy time, idle gaps,
the kernels that took the most device time, and the device time of the
matrix-product operators.

Two traces are taken, one after the other. The first records host operators
and device activity over a short stretch: only the device time of the
operators in :data:`GEMM_OPS` is read from it, since recording every host
operator slows a launch-bound host by half or more. The second records device
activity alone: busy time, idle gaps and kernels are read from it. Its idle
gaps are named after the innermost of the benchmark's spans the host was in
at the gap's middle; the spans are put on the trace's clock (the wall clock,
``time.time_ns``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

#: operators whose kernels are the linear layers' matrix products: the
#: forward's ``addmm`` and the backward's ``mm``
GEMM_OPS = ("aten::addmm", "aten::mm")


class Spans:
    """Host-clock totals by name; while ``marks`` is a list, each span's
    wall-clock interval is appended to it."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.count: dict[str, int] = defaultdict(int)
        self.marks: list | None = None

    @contextlib.contextmanager
    def __call__(self, name: str):
        w0, t0 = time.time_ns(), time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.count[name] += 1
            if self.marks is not None:
                self.marks.append((w0, time.time_ns(), name))


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _self_device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def gemm_seconds(fn, sync) -> float:
    """The device seconds of :data:`GEMM_OPS`' kernels while ``fn()`` runs
    (host and device activity traced)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum(_self_device_us(e) for e in prof.key_averages() if e.key in GEMM_OPS) / 1e6


def device_window(fn, spans: Spans, sync, exclude: tuple = ()) -> dict:
    """Trace the device's activity while ``fn()`` runs (ended by
    ``sync()``): ``window_s``, ``busy_s`` (the union of device activity in
    the window), ``device_ops`` (the ten kernels with the most device time)
    and ``idle_gaps`` (idle time by the span the host was in, the ten
    largest), each as ``[name, seconds]``. The time inside spans named in
    ``exclude`` (the benchmark's own work between calls into the program)
    is not part of the window: its idle gaps are dropped, and
    ``window_s`` is shortened by it."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    spans.marks = []
    try:
        # the CPU's activity stands in where there is no card (the CPU tests)
        acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            w0 = time.time_ns()
            fn()
            sync()
            w1 = time.time_ns()
        marks = spans.marks
    finally:
        spans.marks = None
    start = prof.profiler.kineto_results.trace_start_ns()

    def rel(ns: int) -> float:
        return (ns - start) / 1e3
    a0, a1 = rel(w0), rel(w1)
    dev, by_name = [], defaultdict(float)
    for e in prof.events():
        if not _is_device(e):
            continue
        a, b = max(float(e.time_range.start), a0), min(float(e.time_range.end), a1)
        if b > a:
            dev.append((a, b))
            by_name[e.name] += (b - a) / 1e6
    dev.sort()
    merged: list[list[float]] = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e6
    spans_us = sorted((rel(m0), rel(m1), name) for m0, m1, name in marks)
    cut = [(max(m0, a0), min(m1, a1)) for m0, m1, name in spans_us if name in exclude]
    cut = [(m0, m1) for m0, m1 in cut if m1 > m0]
    gaps, at = defaultdict(lambda: [0.0, 0]), a0
    for a, b in merged + [[a1, a1]]:
        if a > at:
            # the gap's parts outside the left-out spans, each named by the
            # span the host was in at its middle
            parts, p0 = [], at
            for m0, m1 in cut:
                if m1 > p0 and m0 < a:
                    parts.append((p0, max(p0, m0)))
                    p0 = max(p0, m1)
            parts.append((p0, a))
            for g0, g1 in parts:
                if g1 > g0:
                    mid = (g0 + g1) / 2
                    inside = [m for m in spans_us if m[0] <= mid <= m[1]]
                    label = min(inside, key=lambda m: m[1] - m[0])[2] if inside else "outside spans"
                    gaps[label][0] += (g1 - g0) / 1e6
                    gaps[label][1] += 1
        at = max(at, b)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:10]
    return {"window_s": (a1 - a0 - sum(m1 - m0 for m0, m1 in cut)) / 1e6, "busy_s": busy,
            "device_ops": [[name[:160], s] for name, s in top],
            "idle_gaps": [[f"{label} ({n} gaps)", s] for label, (s, n) in idle]}
