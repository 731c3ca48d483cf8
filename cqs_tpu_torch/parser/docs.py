"""Markdown / plaintext / config-file chunkers.

Reference analogs: the Markdown heading parser (``src/parser/markdown/``),
multi-grammar injection (fenced code blocks parse with their tagged
language's grammar and emit code chunks — how a Rust snippet in a design doc
becomes a searchable ``struct`` chunk), and config handling. Markdown files
chunk into heading-delimited SECTION chunks named by the bare heading text;
config files chunk into top-level tables/keys.
"""

from __future__ import annotations

import re

from cqs_tpu_torch.parser.types import Chunk, ChunkType, ParseResult

_FENCE_OPEN = re.compile(r"^(```+|~~~+)\s*([A-Za-z0-9+#._-]*)\s*$")

_FENCE_LANG_ALIASES = {
    "rs": "rust", "py": "python", "js": "javascript", "ts": "typescript",
    "golang": "go", "c++": "cpp", "cs": "csharp", "sh": "shell",
    "bash": "shell", "zsh": "shell", "rb": "ruby", "kt": "kotlin",
}


def _inject_code_fences(origin: str, lines: list[str], result: ParseResult) -> None:
    """Parse fenced code blocks with their tagged language and emit their
    chunks at document line offsets (the injection pass)."""
    from cqs_tpu_torch.parser.registry import get_language

    i = 0
    while i < len(lines):
        m = _FENCE_OPEN.match(lines[i])
        if not m or not m.group(2):
            i += 1
            continue
        fence, tag = m.group(1), m.group(2).lower()
        close = None
        for j in range(i + 1, len(lines)):
            if lines[j].strip().startswith(fence[:3]):
                close = j
                break
        if close is None:
            break
        lang_name = _FENCE_LANG_ALIASES.get(tag, tag)
        lang = get_language(lang_name)
        if lang is not None and lang.style in ("brace", "python", "end") and close - i > 2:
            from cqs_tpu_torch.parser import parse_text

            block = "\n".join(lines[i + 1 : close])
            try:
                sub = parse_text(origin, block, lang, bodyless_members=False)
            except Exception:
                sub = None
            if sub is not None:
                for c in sub.chunks:
                    c.line_start += i + 1
                    c.line_end += i + 1
                    result.chunks.append(c)
        i = close + 1

_HEADING = re.compile(r"^(#{1,6})\s+(.+?)\s*#*\s*$")
_SETEXT = re.compile(r"^(=+|-+)\s*$")
_FENCE = re.compile(r"^(```|~~~)")


def parse_markdown(origin: str, text: str) -> ParseResult:
    result = ParseResult(origin=origin, language="markdown")
    lines = text.splitlines()
    # find headings (outside code fences)
    headings: list[tuple[int, int, str]] = []  # (line_idx, level, title)
    in_fence = False
    for i, ln in enumerate(lines):
        if _FENCE.match(ln):
            in_fence = not in_fence
            continue
        if in_fence:
            continue
        m = _HEADING.match(ln)
        if m:
            headings.append((i, len(m.group(1)), m.group(2)))
        elif i + 1 < len(lines) and ln.strip() and _SETEXT.match(lines[i + 1]) and not _HEADING.match(ln):
            level = 1 if lines[i + 1].lstrip().startswith("=") else 2
            headings.append((i, level, ln.strip()))

    if not headings:
        if text.strip():
            result.chunks.append(Chunk(
                origin=origin, name=origin.rsplit("/", 1)[-1], chunk_type=ChunkType.SECTION,
                language="markdown", line_start=1, line_end=len(lines), body=text,
                signature=lines[0][:120] if lines else "",
            ))
        return result

    # preamble before the first heading
    first = headings[0][0]
    if first > 0 and "\n".join(lines[:first]).strip():
        result.chunks.append(Chunk(
            origin=origin, name="(preamble)", chunk_type=ChunkType.SECTION,
            language="markdown", line_start=1, line_end=first, body="\n".join(lines[:first]),
        ))

    # each heading's section runs to the next heading of equal-or-higher level
    path: list[tuple[int, str]] = []
    for idx, (line_idx, level, title) in enumerate(headings):
        while path and path[-1][0] >= level:
            path.pop()
        path.append((level, title))
        end = len(lines)
        for nline, nlevel, _ in headings[idx + 1:]:
            if nlevel <= level:
                end = nline
                break
        else:
            end = len(lines)
        # actually: section body extends to the NEXT heading of any level for
        # leaf granularity; the heading-path name keeps hierarchy context
        next_any = headings[idx + 1][0] if idx + 1 < len(headings) else len(lines)
        body = "\n".join(lines[line_idx:next_any])
        if not body.strip():
            continue
        # Name = bare heading text (gold-parity with the reference's markdown
        # parser); the heading path provides hierarchy via parent_name and
        # lands in the NL through the signature.
        heading_path = " > ".join(t for _, t in path)
        result.chunks.append(Chunk(
            origin=origin, name=title, chunk_type=ChunkType.SECTION,
            language="markdown", line_start=line_idx + 1, line_end=next_any,
            body=body, signature=heading_path,
            parent_name=path[-2][1] if len(path) > 1 else None,
        ))
    _inject_code_fences(origin, lines, result)
    result.chunks.sort(key=lambda c: (c.line_start, c.line_end))
    return result


_TOML_TABLE = re.compile(r"^\s*\[+([^\]]+)\]+\s*$")
_YAML_TOP = re.compile(r"^([A-Za-z_][A-Za-z0-9_.-]*)\s*:")
_INI_SECTION = re.compile(r"^\s*\[([^\]]+)\]\s*$")


def parse_config(origin: str, text: str) -> ParseResult:
    result = ParseResult(origin=origin, language="config")
    lines = text.splitlines()
    lower = origin.lower()
    marks: list[tuple[int, str]] = []
    if lower.endswith(".toml") or lower.endswith((".ini", ".cfg")):
        pat = _TOML_TABLE if lower.endswith(".toml") else _INI_SECTION
        for i, ln in enumerate(lines):
            m = pat.match(ln)
            if m:
                marks.append((i, m.group(1).strip()))
    elif lower.endswith((".yaml", ".yml")):
        for i, ln in enumerate(lines):
            m = _YAML_TOP.match(ln)
            if m:
                marks.append((i, m.group(1)))

    if not marks:
        if text.strip():
            result.chunks.append(Chunk(
                origin=origin, name=origin.rsplit("/", 1)[-1], chunk_type=ChunkType.CONFIG,
                language="config", line_start=1, line_end=len(lines), body=text,
            ))
        return result

    if marks[0][0] > 0 and "\n".join(lines[: marks[0][0]]).strip():
        result.chunks.append(Chunk(
            origin=origin, name="(top)", chunk_type=ChunkType.CONFIG, language="config",
            line_start=1, line_end=marks[0][0], body="\n".join(lines[: marks[0][0]]),
        ))
    for idx, (line_idx, name) in enumerate(marks):
        end = marks[idx + 1][0] if idx + 1 < len(marks) else len(lines)
        body = "\n".join(lines[line_idx:end])
        if body.strip():
            result.chunks.append(Chunk(
                origin=origin, name=name, chunk_type=ChunkType.CONFIG, language="config",
                line_start=line_idx + 1, line_end=end, body=body,
            ))
    return result


# ---------------------------------------------------------------------------
# LaTeX: sectioning commands as headings (ref: languages.rs latex def — the
# reference chunks \section-family commands via tree-sitter-latex)
# ---------------------------------------------------------------------------

_LATEX_HEADING = re.compile(
    r"^[ \t]*\\(part|chapter|section|subsection|subsubsection|paragraph)\*?"
    r"\s*(?:\[[^\]]*\])?\s*\{([^}]*)\}")
_LATEX_LEVEL = {"part": 1, "chapter": 1, "section": 2, "subsection": 3,
                "subsubsection": 4, "paragraph": 5}


def parse_latex(origin: str, text: str) -> ParseResult:
    """LaTeX sectioning -> SECTION chunks, same leaf-granularity slicing as
    markdown (each section runs to the next sectioning command)."""
    result = ParseResult(origin=origin, language="latex")
    lines = text.splitlines()
    headings: list[tuple[int, int, str]] = []
    for i, ln in enumerate(lines):
        m = _LATEX_HEADING.match(ln)
        if m:
            headings.append((i, _LATEX_LEVEL[m.group(1)], m.group(2).strip()))

    if not headings:
        if text.strip():
            result.chunks.append(Chunk(
                origin=origin, name=origin.rsplit("/", 1)[-1],
                chunk_type=ChunkType.SECTION, language="latex",
                line_start=1, line_end=len(lines), body=text,
                signature=lines[0][:120] if lines else ""))
        return result

    first = headings[0][0]
    if first > 0 and "\n".join(lines[:first]).strip():
        result.chunks.append(Chunk(
            origin=origin, name="(preamble)", chunk_type=ChunkType.SECTION,
            language="latex", line_start=1, line_end=first,
            body="\n".join(lines[:first])))
    path: list[tuple[int, str]] = []
    for idx, (line_idx, level, title) in enumerate(headings):
        while path and path[-1][0] >= level:
            path.pop()
        path.append((level, title))
        next_any = headings[idx + 1][0] if idx + 1 < len(headings) else len(lines)
        body = "\n".join(lines[line_idx:next_any])
        if not body.strip():
            continue
        result.chunks.append(Chunk(
            origin=origin, name=title, chunk_type=ChunkType.SECTION,
            language="latex", line_start=line_idx + 1, line_end=next_any,
            body=body, signature=" > ".join(t for _, t in path),
            parent_name=path[-2][1] if len(path) > 1 else None))
    result.chunks.sort(key=lambda c: (c.line_start, c.line_end))
    return result


# ---------------------------------------------------------------------------
# XML: depth-1 elements as CONFIG chunks (ref: languages.rs xml def)
# ---------------------------------------------------------------------------

_XML_TOKEN = re.compile(
    r"<!--.*?-->|<!\[CDATA\[.*?\]\]>|<[!?][^>]*>|"
    r"<(/?)([A-Za-z_][\w.:\-]*)((?:[^>\"']|\"[^\"]*\"|'[^']*')*?)(/?)>",
    re.S)
_XML_NAME_ATTR = re.compile(r"\b(?:name|id|key)\s*=\s*[\"']([^\"']+)[\"']")


def parse_xml(origin: str, text: str) -> ParseResult:
    """Generic XML: each child of the document root becomes a CONFIG chunk
    named ``tag`` or ``tag:nameattr``. Comments/CDATA/PIs are skipped; an
    unparseable or flat document falls back to one whole-file chunk."""
    result = ParseResult(origin=origin, language="xml")
    lines = text.splitlines()
    line_of = [0]
    pos = 0
    for ln in lines:
        pos += len(ln) + 1
        line_of.append(pos)

    def lineno(p: int) -> int:
        import bisect
        return bisect.bisect_right(line_of, p)

    depth = 0
    open_at: tuple[int, str] | None = None  # (start_pos, display_name) at depth 1
    for m in _XML_TOKEN.finditer(text):
        if m.group(2) is None:
            continue  # comment / CDATA / PI / doctype
        closing, tag, attrs, selfclose = m.group(1), m.group(2), m.group(3) or "", m.group(4)
        if closing:
            depth -= 1
            if depth == 1 and open_at is not None:
                start, name = open_at
                result.chunks.append(Chunk(
                    origin=origin, name=name, chunk_type=ChunkType.CONFIG,
                    language="xml", line_start=lineno(start),
                    line_end=lineno(m.end() - 1),
                    body=text[start:m.end()]))
                open_at = None
            continue
        if selfclose:
            if depth == 1:
                nm = _XML_NAME_ATTR.search(attrs)
                result.chunks.append(Chunk(
                    origin=origin, name=f"{tag}:{nm.group(1)}" if nm else tag,
                    chunk_type=ChunkType.CONFIG, language="xml",
                    line_start=lineno(m.start()), line_end=lineno(m.end() - 1),
                    body=m.group(0)))
            continue
        depth += 1
        if depth == 2 and open_at is None:
            nm = _XML_NAME_ATTR.search(attrs)
            open_at = (m.start(), f"{tag}:{nm.group(1)}" if nm else tag)

    if not result.chunks and text.strip():
        result.chunks.append(Chunk(
            origin=origin, name=origin.rsplit("/", 1)[-1],
            chunk_type=ChunkType.CONFIG, language="xml",
            line_start=1, line_end=len(lines), body=text))
    return result
