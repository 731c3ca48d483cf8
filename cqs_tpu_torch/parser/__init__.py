"""Parser facade: per-language dispatch with a wall-clock timeout guard.

Reference analog: ``Parser::parse_file`` / ``parse_with_timeout``
(``src/parser/mod.rs:1-40``). Dispatches on file extension through the
language registry to the Python AST parser, the generic masked-source engine,
or the markdown/config chunkers.
"""

from __future__ import annotations

import concurrent.futures
import threading
from pathlib import Path

from cqs_tpu_torch.config import Limits, limits as default_limits
from cqs_tpu_torch.parser.docs import parse_config, parse_markdown
from cqs_tpu_torch.parser.generic import parse_generic
from cqs_tpu_torch.parser.python_ast import parse_python
from cqs_tpu_torch.parser.registry import LanguageDef, all_languages, get_language, language_for_path  # noqa: F401
from cqs_tpu_torch.parser.types import (  # noqa: F401
    PARSER_VERSION, CallSite, Chunk, ChunkType, EdgeKind, ParseResult, TypeRef,
)

_POOL: concurrent.futures.ThreadPoolExecutor | None = None
_POOL_LOCK = threading.Lock()


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="cqst-parse")
        return _POOL


def parse_text(origin: str, text: str, lang: LanguageDef,
               bodyless_members: bool = True) -> ParseResult:
    """``bodyless_members=False`` suppresses the single-line TRAIT-member
    fallback — markdown code-fence injection uses it: a quoted interface
    snippet in a doc is a quotation, not a declaration of this corpus
    (same rationale as not indexing quote!{} macro templates), and the r4
    gate measured the doc-fence decls flipping a near-tie query."""
    if lang.style == "python":
        return parse_python(origin, text)
    if lang.style == "markdown":
        return parse_markdown(origin, text)
    if lang.style == "config":
        return parse_config(origin, text)
    if lang.style == "latex":
        from cqs_tpu_torch.parser.docs import parse_latex

        return parse_latex(origin, text)
    if lang.style == "xml":
        from cqs_tpu_torch.parser.docs import parse_xml

        return parse_xml(origin, text)
    if lang.style == "web":
        from cqs_tpu_torch.parser.web import parse_html_like

        return parse_html_like(origin, text, lang.name)
    if lang.style == "l5x":
        from cqs_tpu_torch.parser.web import parse_l5x

        return parse_l5x(origin, text)
    return parse_generic(origin, text, lang, bodyless_members=bodyless_members)


def parse_file(path: str | Path, root: str | Path | None = None,
               lim: Limits | None = None) -> ParseResult | None:
    """Parse one file into chunks, or None for unsupported extensions.

    Runs under a wall-clock timeout (``parse_timeout_s``) so a pathological
    file can't stall the index pipeline (ref: parse_with_timeout).
    """
    lim = lim or default_limits
    path = Path(path)
    lang = language_for_path(str(path))
    if lang is None:
        return None
    origin = str(path.relative_to(root)) if root else str(path)
    try:
        text = path.read_text(encoding="utf-8", errors="replace")
    except OSError as e:
        return ParseResult(origin=origin, language=lang.name, errors=[str(e)])

    fut = _pool().submit(parse_text, origin, text, lang)
    try:
        return fut.result(timeout=lim.parse_timeout_s)
    except concurrent.futures.TimeoutError:
        fut.cancel()
        return ParseResult(origin=origin, language=lang.name,
                           errors=[f"parse timeout after {lim.parse_timeout_s}s"])
    except Exception as e:  # parser bug should not kill the pipeline
        return ParseResult(origin=origin, language=lang.name,
                           errors=[f"{type(e).__name__}: {e}"])
