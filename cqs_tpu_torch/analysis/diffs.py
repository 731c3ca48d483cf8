"""Unified-diff analysis: impact-diff, review, CI gate.

Reference analogs: ``parse_unified_diff`` (``src/diff_parse.rs``), diff impact
(``src/impact/diff.rs`` — map hunks to functions, risk + test suggestions),
``review_diff`` (``src/review.rs``), and the ``cqs ci`` gate
(``src/ci.rs`` — High/Medium/Off thresholds with exit codes).
"""

from __future__ import annotations

import re
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

from cqs_tpu_torch.analysis.callgraph import CallGraph, analyze_impact, find_dead_code
from cqs_tpu_torch.store import Store

_DIFF_FILE = re.compile(r"^\+\+\+ (?:b/)?(.+)$")
_HUNK = re.compile(r"^@@ -\d+(?:,\d+)? \+(\d+)(?:,(\d+))? @@")


@dataclass
class DiffHunk:
    path: str
    start: int          # 1-based line in the new file
    count: int

    @property
    def end(self) -> int:
        return self.start + max(self.count - 1, 0)


def parse_unified_diff(text: str) -> list[DiffHunk]:
    hunks: list[DiffHunk] = []
    current: str | None = None
    for line in text.splitlines():
        m = _DIFF_FILE.match(line)
        if m:
            current = m.group(1).strip()
            if current == "/dev/null":
                current = None
            continue
        m = _HUNK.match(line)
        if m and current:
            start = int(m.group(1))
            count = int(m.group(2) or 1)
            hunks.append(DiffHunk(path=current, start=start, count=count))
    return hunks


def git_diff(root: Path, base: str | None = None) -> str:
    args = ["git", "-C", str(root), "diff", "--unified=0"]
    if base:
        args.append(base)
    try:
        out = subprocess.run(args, capture_output=True, text=True, timeout=30)
        return out.stdout
    except (subprocess.SubprocessError, OSError):
        return ""


@dataclass
class TouchedFunction:
    name: str
    origin: str
    line_start: int
    risk: str
    callers: int
    tests: list[str]


@dataclass
class DiffImpactReport:
    touched: list[TouchedFunction] = field(default_factory=list)
    unmapped_hunks: int = 0

    @property
    def max_risk(self) -> str:
        order = {"High": 2, "Medium": 1, "Low": 0}
        if not self.touched:
            return "Low"
        return max((t.risk for t in self.touched), key=lambda r: order[r])

    def as_dict(self) -> dict:
        return {
            "max_risk": self.max_risk,
            "unmapped_hunks": self.unmapped_hunks,
            "touched": [
                {"name": t.name, "origin": t.origin, "line_start": t.line_start,
                 "risk": t.risk, "callers": t.callers, "suggested_tests": t.tests}
                for t in self.touched],
        }


def impact_of_diff(store: Store, diff_text: str) -> DiffImpactReport:
    """Map diff hunks to indexed chunks and aggregate impact."""
    report = DiffImpactReport()
    graph = CallGraph.for_store(store)
    seen: set[str] = set()
    for hunk in parse_unified_diff(diff_text):
        rows = [r for r in store.iter_chunks(
            "origin = ? AND line_start <= ? AND line_end >= ?",
            (hunk.path, hunk.end, hunk.start))
            if r.chunk_type in ("function", "method", "test")]
        if not rows:
            report.unmapped_hunks += 1
            continue
        for row in rows:
            if row.id in seen:
                continue
            seen.add(row.id)
            rep = analyze_impact(store, row.name, graph=graph)
            if rep is None:
                continue
            report.touched.append(TouchedFunction(
                name=row.qualified_name, origin=row.origin, line_start=row.line_start,
                risk=rep.risk, callers=len(rep.callers),
                tests=[t.qualified_name for t in rep.affected_tests][:10]))
    return report


@dataclass
class ReviewFinding:
    kind: str          # risk | dead_in_diff | no_tests | large_function
    message: str
    origin: str
    line_start: int


def review_diff(store: Store, diff_text: str) -> dict:
    """Diff review: impact summary + findings (dead code touched, functions
    with no covering tests, oversized changes)."""
    impact = impact_of_diff(store, diff_text)
    findings: list[ReviewFinding] = []
    dead_names = {d["name"] for d in find_dead_code(store)}
    for t in impact.touched:
        if t.risk == "High":
            findings.append(ReviewFinding(
                "risk", f"{t.name} has {t.callers} transitive callers (High risk)",
                t.origin, t.line_start))
        if not t.tests and t.risk != "Low":
            findings.append(ReviewFinding(
                "no_tests", f"{t.name} changed with no covering tests found",
                t.origin, t.line_start))
        if t.name in dead_names:
            findings.append(ReviewFinding(
                "dead_in_diff", f"{t.name} appears to be dead code — verify before editing",
                t.origin, t.line_start))
    return {
        "impact": impact.as_dict(),
        "findings": [{"kind": f.kind, "message": f.message, "origin": f.origin,
                      "line_start": f.line_start} for f in findings],
    }


#: CI gate thresholds (ref: src/ci.rs exit codes).
CI_EXIT_OK = 0
CI_EXIT_RISK = 3


def ci_gate(store: Store, diff_text: str, threshold: str = "High") -> tuple[int, dict]:
    """Gate a diff on impact risk. ``threshold``: 'High' fails only on High,
    'Medium' fails on Medium+, 'Off' never fails."""
    report = impact_of_diff(store, diff_text)
    data = report.as_dict()
    if threshold == "Off":
        return CI_EXIT_OK, data
    order = {"Low": 0, "Medium": 1, "High": 2}
    if order[report.max_risk] >= order.get(threshold, 2):
        data["gate"] = f"FAIL: max risk {report.max_risk} >= threshold {threshold}"
        return CI_EXIT_RISK, data
    data["gate"] = "PASS"
    return CI_EXIT_OK, data
