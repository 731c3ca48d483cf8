"""Cross-project registry + external reference indexes.

Reference analogs: ``ProjectRegistry`` (``src/project.rs`` — named projects
for cross-project search/trace/impact) and ``src/reference.rs`` (``cqs ref
add`` — external read-only ref indexes, ``--ref``-scoped search).

Registry file: ``~/.local/share/cqs-tpu/projects.json`` —
``{"projects": {name: {"root": ..., "added_at": ...}}, "refs": {...}}``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

from cqs_tpu_torch.config import INDEX_DIRNAME


def registry_path() -> Path:
    base = os.environ.get("XDG_DATA_HOME") or os.path.expanduser("~/.local/share")
    return Path(base) / "cqs-tpu" / "projects.json"


def _load() -> dict:
    p = registry_path()
    if p.is_file():
        try:
            return json.loads(p.read_text())
        except json.JSONDecodeError:
            pass
    return {"projects": {}, "refs": {}}


def _save(data: dict) -> None:
    p = registry_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(data, indent=1))
    tmp.rename(p)


def add_project(name: str, root: str | Path, kind: str = "projects") -> None:
    root = Path(root).resolve()
    if not (root / INDEX_DIRNAME).is_dir():
        raise FileNotFoundError(f"{root} has no {INDEX_DIRNAME} index — run `cqs-tpu index` there first")
    data = _load()
    data.setdefault(kind, {})[name] = {"root": str(root), "added_at": time.time()}
    _save(data)


def remove_project(name: str, kind: str = "projects") -> bool:
    data = _load()
    existed = name in data.get(kind, {})
    data.get(kind, {}).pop(name, None)
    _save(data)
    return existed


def list_projects(kind: str = "projects") -> dict[str, str]:
    return {name: rec["root"] for name, rec in _load().get(kind, {}).items()}


def resolve_project(name: str) -> Path | None:
    for kind in ("projects", "refs"):
        rec = _load().get(kind, {}).get(name)
        if rec:
            return Path(rec["root"])
    return None


def open_project_engine(name: str, *, device: str | torch.device):
    """Open a registered project's store + engine (read-only search scope)
    on ``device``, the caller's: never a device of its own choosing."""
    root = resolve_project(name)
    if root is None:
        return None
    from cqs_tpu_torch.cli.context import CommandContext

    ctx = CommandContext.create(str(root), device=device)
    return ctx


def cross_project_search(names: list[str], query: str, limit: int = 10, *,
                         device: str | torch.device) -> list[dict]:
    """Search several registered projects, merge by score with a project tag."""
    merged: list[dict] = []
    for name in names:
        ctx = open_project_engine(name, device=device)
        if ctx is None:
            continue
        try:
            res = ctx.engine.search(query, limit=limit)
            for h in res.hits:
                d = h.to_dict()
                d["project"] = name
                merged.append(d)
        finally:
            ctx.close()
    merged.sort(key=lambda d: -d["score"])
    return merged[:limit]
