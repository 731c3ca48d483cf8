"""Project file enumeration with ignore rules and DoS rails.

Reference analog: ``enumerate_files_iter`` (``src/lib.rs:806``) — gitignore +
``.cqsignore`` walk with hidden-file/size caps, depth and file-count rails,
worktree skip, streaming iterator. We implement gitignore-subset matching
(enough for real repos: blank/comment lines, ``!`` negation, dir-only
patterns, ``*``/``**`` globs, anchored vs unanchored) without external deps.
"""

from __future__ import annotations

import fnmatch
import os
import re
from pathlib import Path
from typing import Iterator

from cqs_tpu_torch.config import Limits, limits as default_limits

IGNORE_FILENAMES = (".gitignore", ".cqstignore", ".cqsignore")

_ALWAYS_SKIP_DIRS = {
    ".git", ".hg", ".svn", ".cqs-tpu", ".cqs", "__pycache__", "node_modules",
    ".venv", "venv", "target", ".mypy_cache", ".pytest_cache", ".ruff_cache",
    ".tox", ".eggs", "dist", "build",
}


class _Pattern:
    __slots__ = ("regex", "negated", "dir_only")

    def __init__(self, line: str):
        self.negated = line.startswith("!")
        if self.negated:
            line = line[1:]
        self.dir_only = line.endswith("/")
        line = line.rstrip("/")
        anchored = line.startswith("/") or "/" in line[:-1].replace("**", "")
        line = line.lstrip("/")
        self.regex = self._compile(line, anchored)

    @staticmethod
    def _compile(pat: str, anchored: bool) -> re.Pattern:
        # Translate a gitignore glob into a regex over the path relative to
        # the ignore file's directory.
        out = []
        i = 0
        while i < len(pat):
            c = pat[i]
            if c == "*":
                if pat[i : i + 2] == "**":
                    out.append(".*")
                    i += 2
                    if i < len(pat) and pat[i] == "/":
                        i += 1
                    continue
                out.append("[^/]*")
            elif c == "?":
                out.append("[^/]")
            elif c == "[":
                j = pat.find("]", i)
                if j == -1:
                    out.append(re.escape(c))
                else:
                    out.append(pat[i : j + 1])
                    i = j
            else:
                out.append(re.escape(c))
            i += 1
        body = "".join(out)
        prefix = "" if anchored else "(?:.*/)?"
        return re.compile(f"^{prefix}{body}(?:/.*)?$")

    def matches(self, rel: str, is_dir: bool) -> bool:
        if self.dir_only and not is_dir:
            # dir-only patterns still match files *under* the dir via the
            # (?:/.*)$ suffix; a direct file match requires is_dir
            return bool(self.regex.match(rel)) and "/" in rel
        return bool(self.regex.match(rel))


def _load_patterns(dirpath: Path) -> list[_Pattern]:
    pats: list[_Pattern] = []
    for name in IGNORE_FILENAMES:
        f = dirpath / name
        if f.is_file():
            try:
                for line in f.read_text(errors="replace").splitlines():
                    line = line.rstrip()
                    if not line or line.lstrip().startswith("#"):
                        continue
                    pats.append(_Pattern(line))
            except OSError:
                pass
    return pats


def _is_ignored(rel: str, is_dir: bool, stack: list[tuple[str, list[_Pattern]]]) -> bool:
    # Later (deeper) ignore files take precedence; within a file, last match wins.
    decision = False
    for base, pats in stack:
        sub = rel[len(base):].lstrip("/") if base and rel.startswith(base) else rel
        for p in pats:
            if p.matches(sub, is_dir):
                decision = not p.negated
    return decision


def _looks_binary(sample: bytes) -> bool:
    return b"\x00" in sample


def enumerate_files(
    root: str | Path,
    lim: Limits | None = None,
    extra_ignore: list[str] | None = None,
) -> Iterator[Path]:
    """Stream indexable files under ``root`` honoring ignore rules, size and
    count caps. Yields absolute paths in deterministic (sorted) order."""
    lim = lim or default_limits
    root = Path(root).resolve()
    max_bytes = lim.max_file_bytes
    max_files = lim.max_files
    max_depth = lim.max_walk_depth
    yielded = 0

    extra = [_Pattern(p) for p in (extra_ignore or [])]
    root_stack: list[tuple[str, list[_Pattern]]] = [("", _load_patterns(root) + extra)]

    def walk(d: Path, depth: int, stack: list[tuple[str, list[_Pattern]]]) -> Iterator[Path]:
        nonlocal yielded
        if depth > max_depth or yielded >= max_files:
            return
        try:
            entries = sorted(os.scandir(d), key=lambda e: e.name)
        except OSError:
            return
        subpats = _load_patterns(d) if d != root else []
        if subpats:
            rel_base = str(d.relative_to(root))
            stack = stack + [(rel_base if rel_base != "." else "", subpats)]
        for e in entries:
            if yielded >= max_files:
                return
            name = e.name
            rel = str(Path(e.path).relative_to(root))
            try:
                if e.is_dir(follow_symlinks=False):
                    if name in _ALWAYS_SKIP_DIRS or name.startswith("."):
                        continue
                    if _is_ignored(rel, True, stack):
                        continue
                    yield from walk(Path(e.path), depth + 1, stack)
                elif e.is_file(follow_symlinks=False):
                    if name.startswith("."):
                        continue
                    st = e.stat()
                    if st.st_size > max_bytes or st.st_size == 0:
                        continue
                    if _is_ignored(rel, False, stack):
                        continue
                    with open(e.path, "rb") as f:
                        if _looks_binary(f.read(512)):
                            continue
                    yielded += 1
                    yield Path(e.path)
            except OSError:
                continue

    yield from walk(root, 0, root_stack)
