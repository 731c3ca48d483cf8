"""Web-template and PLC-XML parsers.

Reference analogs: multi-grammar injection for HTML -> JS/CSS, Vue, Svelte,
Razor (``src/parser/``), the ASPX delegating parser (``src/parser/aspx.rs``),
and the L5X/L5K PLC XML parser (``src/parser/l5x.rs`` — Rockwell ladder-logic
programs: controllers, programs, routines, rungs, tags).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

from cqs_tpu_torch.parser.types import Chunk, ChunkType, ParseResult

_SCRIPT_RE = re.compile(
    r"<script[^>]*(?:lang=[\"']?(?P<lang>[a-z]+)[\"']?)?[^>]*>(?P<body>.*?)</script>",
    re.S | re.I)
_STYLE_RE = re.compile(r"<style[^>]*>(?P<body>.*?)</style>", re.S | re.I)
_TEMPLATE_RE = re.compile(r"<template[^>]*>(?P<body>.*?)</template>", re.S | re.I)
_ID_RE = re.compile(r"(?:id|name)\s*=\s*[\"']([A-Za-z_][\w-]*)[\"']")


def _line_of_pos(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def parse_html_like(origin: str, text: str, framework: str) -> ParseResult:
    """HTML / Vue / Svelte / ASPX / Razor: inject embedded <script> blocks
    into the JS/TS parser; emit template/style section chunks."""
    from cqs_tpu_torch.parser import parse_text
    from cqs_tpu_torch.parser.registry import get_language

    result = ParseResult(origin=origin, language=framework)
    for m in _SCRIPT_RE.finditer(text):
        body = m.group("body")
        if not body.strip():
            continue
        lang_tag = (m.group("lang") or "").lower()
        lang = get_language("typescript" if lang_tag in ("ts", "typescript")
                            else "javascript")
        start_line = _line_of_pos(text, m.start("body"))
        try:
            sub = parse_text(origin, body, lang)
        except Exception:
            continue
        for c in sub.chunks:
            c.line_start += start_line - 1
            c.line_end += start_line - 1
            result.chunks.append(c)
    for m in _TEMPLATE_RE.finditer(text):
        body = m.group("body")
        if body.strip():
            start = _line_of_pos(text, m.start())
            result.chunks.append(Chunk(
                origin=origin, name="(template)", chunk_type=ChunkType.SECTION,
                language=framework, line_start=start,
                line_end=_line_of_pos(text, m.end()), body=body.strip()[:4000]))
    # named top-level elements (forms/controls — the ASPX signal)
    if framework in ("aspx", "html", "razor"):
        seen = set()
        for m in _ID_RE.finditer(text):
            name = m.group(1)
            if name in seen or len(seen) > 50:
                continue
            seen.add(name)
    result.chunks.sort(key=lambda c: (c.line_start, c.line_end))
    return result


# ---------------------------------------------------------------------------
# L5X (Rockwell PLC)
# ---------------------------------------------------------------------------

def parse_l5x(origin: str, text: str) -> ParseResult:
    """L5X: controllers -> programs -> routines (chunks) with rung text as the
    body; AOIs and tags as type-ish chunks."""
    result = ParseResult(origin=origin, language="l5x")
    try:
        root = ET.fromstring(text)
    except ET.ParseError as e:
        result.errors.append(f"XML: {e}")
        return result

    line_counter = [1]

    def add(name, ctype, body, parent=None):
        body = (body or "").strip() or name
        n_lines = body.count("\n") + 1
        start = line_counter[0]
        line_counter[0] += n_lines
        result.chunks.append(Chunk(
            origin=origin, name=name, chunk_type=ctype, language="l5x",
            line_start=start, line_end=start + n_lines - 1,
            body=body[:8000], parent_name=parent))

    for prog in root.iter("Program"):
        pname = prog.get("Name", "program")
        for routine in prog.iter("Routine"):
            rname = routine.get("Name", "routine")
            rungs = []
            for rung in routine.iter("Rung"):
                rtext = rung.findtext("Text") or ""
                comment = rung.findtext("Comment") or ""
                if comment:
                    rungs.append(f"// {comment.strip()}")
                if rtext.strip():
                    rungs.append(rtext.strip())
            for st in routine.iter("STContent"):
                for line in st.iter("Line"):
                    if line.text and line.text.strip():
                        rungs.append(line.text.strip())
            add(rname, ChunkType.FUNCTION, "\n".join(rungs), parent=pname)
    for aoi in root.iter("AddOnInstructionDefinition"):
        name = aoi.get("Name", "aoi")
        desc = aoi.findtext("Description") or ""
        add(name, ChunkType.STRUCT, desc)
    for tag in root.iter("Tag"):
        name = tag.get("Name")
        dtype = tag.get("DataType", "")
        desc = tag.findtext("Description") or ""
        if name and (desc or dtype not in ("DINT", "BOOL", "REAL", "INT", "")):
            add(name, ChunkType.CONST, f"{dtype} {desc}".strip())
    return result
