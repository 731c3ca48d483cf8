"""Doc writer: LLM-drafted doc comments as STAGED patches.

Reference analog: ``src/doc_writer/`` (the ``--improve-docs`` pass) — find
chunks with missing/thin docs, draft doc comments with the LLM provider, and
stage them as a unified diff for human review (never applied directly; the
validation layer screens every draft).
"""

from __future__ import annotations

from pathlib import Path

from cqs_tpu_torch.llm.provider import LLMProvider, LLMRequest
from cqs_tpu_torch.llm.summaries import validate_llm_output
from cqs_tpu_torch.store import Store

DOC_SYSTEM = (
    "You write one documentation comment for the given function. Reply with "
    "ONLY the comment text (no comment markers, no code, 1-3 sentences): what "
    "it does, key parameters, and what it returns.")

_COMMENT_STYLE = {
    "python": ('    """', '"""', "docstring"),
    "rust": ("/// ", "", "line"),
    "go": ("// ", "", "line"),
    "javascript": ("/** ", " */", "block"),
    "typescript": ("/** ", " */", "block"),
    "java": ("/** ", " */", "block"),
    "c": ("/* ", " */", "block"),
    "cpp": ("// ", "", "line"),
}


def _format_doc(language: str, text: str, indent: str) -> list[str]:
    style = _COMMENT_STYLE.get(language)
    if style is None:
        return [f"{indent}// {text}"]
    open_m, close_m, kind = style
    if kind == "docstring":
        return [f'{indent}"""{text}"""']
    if kind == "line":
        prefix = open_m.strip() + " "
        return [f"{indent}{prefix}{line}" for line in _wrap(text, 72)]
    lines = [f"{indent}/**"]
    lines += [f"{indent} * {line}" for line in _wrap(text, 70)]
    lines.append(f"{indent} */")
    return lines


def _wrap(text: str, width: int) -> list[str]:
    words = text.split()
    out, cur = [], ""
    for w in words:
        if len(cur) + len(w) + 1 > width and cur:
            out.append(cur)
            cur = w
        else:
            cur = f"{cur} {w}".strip()
    if cur:
        out.append(cur)
    return out or [""]


def improve_docs(store: Store, provider: LLMProvider, root: Path,
                 max_chunks: int = 50) -> tuple[str, int]:
    """Draft docs for undocumented callables -> (unified diff, count)."""
    todo = [r for r in store.iter_chunks(
        "chunk_type IN ('function','method') AND doc = '' AND is_test = 0")][:max_chunks]
    if not todo:
        return "", 0
    reqs = [LLMRequest(custom_id=r.id, system=DOC_SYSTEM,
                       prompt=f"Language: {r.language}\n\n{r.body[:2500]}",
                       max_tokens=160) for r in todo]
    results = provider.complete_batch(reqs)
    patches: list[str] = []
    count = 0
    by_file: dict[str, list] = {}
    for r in todo:
        text = validate_llm_output(results.get(r.id, ""))
        if text:
            by_file.setdefault(r.origin, []).append((r, text))
    for origin, items in sorted(by_file.items()):
        src = root / origin
        if not src.exists():
            continue
        lines = src.read_text(errors="replace").splitlines()
        items.sort(key=lambda it: it[0].line_start)
        hunks = []
        for r, text in items:
            decl_idx = r.line_start - 1
            if decl_idx >= len(lines):
                continue
            indent = lines[decl_idx][: len(lines[decl_idx]) - len(lines[decl_idx].lstrip())]
            if r.language == "python":
                # docstring goes AFTER the def line
                insert_at = decl_idx + 1
                body_indent = indent + "    "
                doc_lines = _format_doc(r.language, text, body_indent)
            else:
                insert_at = decl_idx
                doc_lines = _format_doc(r.language, text, indent)
            hunks.append((insert_at, doc_lines))
            count += 1
        if not hunks:
            continue
        patch = [f"--- a/{origin}", f"+++ b/{origin}"]
        for insert_at, doc_lines in hunks:
            ctx_line = lines[insert_at] if insert_at < len(lines) else ""
            patch.append(f"@@ -{insert_at + 1},1 +{insert_at + 1},{1 + len(doc_lines)} @@")
            for dl in doc_lines:
                patch.append("+" + dl)
            patch.append(" " + ctx_line)
        patches.append("\n".join(patch))
    return "\n".join(patches) + ("\n" if patches else ""), count
