"""Generic masked-source parser engine for brace- and end-delimited languages.

Reference analog: the tree-sitter extraction in ``src/parser/chunk.rs`` and
``src/parser/calls.rs``. Instead of grammar trees we use a two-phase scheme
that is robust across C-family syntaxes:

1. **Masking** — one linear scan replaces string literal and comment *contents*
   with spaces (newlines preserved), producing a same-length shadow text where
   braces and identifiers can be matched without false positives. Comment text
   is retained per-line for doc-comment extraction.
2. **Declaration scan** — the language's :class:`DeclPattern` regexes run over
   the masked text; each hit's block extent is found by brace counting (or
   ``do/def..end`` keyword counting for Ruby/Lua), containers recurse for
   methods, and calls/type-refs are extracted from the masked body slice.
"""

from __future__ import annotations

import re

from cqs_tpu_torch.parser.registry import DeclPattern, LanguageDef
from cqs_tpu_torch.parser.types import CallSite, Chunk, ChunkType, EdgeKind, ParseResult, TypeRef

# the optional ::<...> arm is Rust turbofish (`size_of::<f32>()`,
# `.parse::<u64>()` — 0.4% of reference-corpus call edges, audit_calls_rust
# r5); greedy [^;{}()]* + '>' right before '(' covers nested generics
# (`size_of::<Vec<u8>>()`) and cannot fire in other languages
_CALL_RE = re.compile(r"(?:(?P<recv>[A-Za-z_][A-Za-z0-9_]*)\s*(?:\.|::|->)\s*)?(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*(?:::\s*<[^;{}()]{0,80}>)?\s*\(")

# Control-flow words that can look like `name(...) {` inside a class body but
# are never methods. Narrower than LanguageDef.keywords (which blocks common
# accessor names like `get`/`set` that ARE legitimate method names).
_MEMBER_BLOCKLIST = frozenset(
    "if else for while do switch case catch return constructor super function new throw try finally".split()
)
_MACRO_RE = re.compile(r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)!\s*[\(\[\{]")
_TYPE_RE = re.compile(r"\b(?P<name>[A-Z][A-Za-z0-9_]*)\b")
_CHAR_LITERAL = re.compile(r"'(\\.|[^'\\\n])'")


def _at_word_start(text: str, i: int) -> bool:
    """True when text[i] begins a token (not the tail of an identifier) —
    guards the raw-string opener check against e.g. ``var_r"`` lookalikes."""
    if i == 0:
        return True
    prev = text[i - 1]
    return not (prev.isalnum() or prev == "_")


def mask_source(text: str, lang: LanguageDef) -> tuple[str, dict[int, str]]:
    """Blank out string/comment contents; return (masked, comment_text_by_line).

    The masked text has identical length and line structure. Line comments are
    preserved in the returned map so doc extraction can read them.
    """
    n = len(text)
    out = list(text)
    comments: dict[int, str] = {}
    line = 0
    i = 0
    lc = lang.line_comment
    bc = lang.block_comment
    delims = lang.string_delims
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        # line comment
        if lc and text.startswith(lc, i):
            j = text.find("\n", i)
            if j == -1:
                j = n
            comments.setdefault(line, text[i:j])
            for k in range(i, j):
                out[k] = " "
            i = j
            continue
        # block comment
        if bc and text.startswith(bc[0], i):
            j = text.find(bc[1], i + len(bc[0]))
            j = n if j == -1 else j + len(bc[1])
            seg_line = line
            seg_start = i
            for k in range(i, j):
                if text[k] == "\n":
                    comments.setdefault(seg_line, text[seg_start:k])
                    seg_line += 1
                    seg_start = k + 1
                    line += 1
                else:
                    out[k] = " "
            comments.setdefault(seg_line, text[seg_start:j])
            i = j
            continue
        # raw string (rust r"...", r#"..."#, r##"..."##): no escapes, spans
        # lines, may contain quotes/braces — the #1 source of phantom decls
        # and runaway extents in real Rust (test fixtures embedding code)
        if lang.raw_string and c == lang.raw_string[0] and _at_word_start(text, i):
            j = i + 1
            hashes = 0
            while j < n and text[j] == "#":
                hashes += 1
                j += 1
            if j < n and text[j] == '"':
                closer = '"' + "#" * hashes
                end = text.find(closer, j + 1)
                end = n if end == -1 else end + len(closer)
                for k in range(j + 1, max(j + 1, end - len(closer))):
                    if out[k] != "\n":
                        out[k] = " "
                line += text.count("\n", i, end)
                i = end
                continue
        # string literal
        if c == "'" and lang.single_quote_char_only:
            # mask only a well-formed char literal; a bare ' is a lifetime
            m_char = _CHAR_LITERAL.match(text, i)
            if m_char:
                for k in range(i + 1, m_char.end() - 1):
                    out[k] = " "
                i = m_char.end()
            else:
                i += 1
            continue
        if c in delims:
            # triple-quoted (python-style) handled by len-3 check
            if text.startswith(c * 3, i):
                j = text.find(c * 3, i + 3)
                j = n if j == -1 else j + 3
            else:
                # multi-line-capable delims (rust plain ", go/js backtick)
                # don't stop at newline — but cap the span and fall back to
                # single-line when unterminated, so one syntax error can't
                # swallow the rest of the file
                multiline = c in lang.multiline_delims
                j = i + 1
                while j < n:
                    if text[j] == "\\" and c != "`":
                        j += 2
                        continue
                    if text[j] == c:
                        j += 1
                        break
                    if text[j] == "\n" and not multiline:
                        j += 1
                        break
                    j += 1
                if multiline and (j >= n or text.count("\n", i, j) > 400):
                    # unterminated or absurdly long: treat as single-line
                    j = text.find("\n", i)
                    j = n if j == -1 else j + 1
            for k in range(i + 1, min(j, n) - 1):
                if out[k] != "\n":
                    out[k] = " "
            line += text.count("\n", i, min(j, n))
            i = j
            continue
        i += 1
    return "".join(out), comments


def _line_starts(text: str) -> list[int]:
    starts = [0]
    for m in re.finditer("\n", text):
        starts.append(m.end())
    return starts


def _line_of(pos: int, starts: list[int]) -> int:
    """0-based line index containing byte offset pos."""
    lo, hi = 0, len(starts) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if starts[mid] <= pos:
            lo = mid
        else:
            hi = mid - 1
    return lo


def find_brace_block(masked: str, open_pos: int) -> int:
    """Given the index of a ``{``, return the index just past its matching
    ``}`` (or end of text)."""
    depth = 0
    for i in range(open_pos, len(masked)):
        c = masked[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
    return len(masked)


_END_OPENERS = re.compile(
    r"^\s*(?:def|class|module|if|unless|while|until|for|begin|case|do)\b|\bdo\s*(?:\|[^|]*\|)?\s*$"
)
_LUA_OPENERS = re.compile(r"\b(?:function|if|while|for|do|repeat)\b")
_END_RE = re.compile(r"^\s*end\b|\bend\s*$")


def find_end_block(masked_lines: list[str], start_line: int, lang: LanguageDef) -> int:
    """For ``end``-delimited languages: return the last line index (inclusive)
    of the block opened at ``start_line``.

    ``end_suspend_open/close`` (e.g. VB.NET ``Interface``/``End Interface``)
    mark regions whose member declarations are BODYLESS: a ``Sub`` inside an
    Interface has no ``End Sub``, so counting it as an opener left the depth
    permanently unbalanced and every block after the interface ran to EOF."""
    depth = 0
    suspend = 0
    sus_open = sus_close = None
    if lang.end_suspend_open:
        sus_open = re.compile(lang.end_suspend_open, re.I)
        sus_close = re.compile(lang.end_suspend_close, re.I)
    if lang.end_openers:
        opener = _custom_end_res(lang)[0]
        closer = _custom_end_res(lang)[1]
    else:
        opener = _LUA_OPENERS if lang.name == "lua" else _END_OPENERS
        closer = _END_RE
    for i in range(start_line, len(masked_lines)):
        ln = masked_lines[i]
        if lang.name == "lua":
            depth += len(opener.findall(ln))
            depth -= len(re.findall(r"\bend\b", ln))
            depth -= len(re.findall(r"\buntil\b", ln))
        elif sus_open is not None and sus_open.search(ln):
            suspend += 1
            depth += 1
        elif sus_close is not None and sus_close.search(ln):
            suspend = max(0, suspend - 1)
            depth -= 1
        elif suspend > 0:
            pass      # bodyless member declarations inside the suspended region
        else:
            if opener.search(ln):
                depth += 1
            if closer.search(ln):
                depth -= 1
        if depth <= 0 and i >= start_line:
            return i
    return len(masked_lines) - 1


def find_offside_block(masked_lines: list[str], decl_line: int,
                       name: str | None = None) -> int:
    """Offside-rule extent (Elm/Haskell-style, indentation-form Sass): the
    block opened by a column-0 declaration runs until the next non-blank
    column-0 line — EXCEPT a column-0 line beginning with the same ``name``
    (a type signature followed by its definition, or multi-equation function
    clauses), which continues the block."""
    last = decl_line
    for i in range(decl_line + 1, len(masked_lines)):
        ln = masked_lines[i]
        if not ln.strip():
            continue
        if ln[0] not in " \t":
            first = re.match(r"[A-Za-z_][\w']*", ln)
            if not (name and first and first.group(0) == name):
                break
        last = i
    return last


_CUSTOM_END_CACHE: dict[str, tuple[re.Pattern, re.Pattern]] = {}


def _custom_end_res(lang: LanguageDef) -> tuple[re.Pattern, re.Pattern]:
    got = _CUSTOM_END_CACHE.get(lang.name)
    if got is None:
        got = (re.compile(lang.end_openers, re.I), re.compile(lang.end_close, re.I))
        _CUSTOM_END_CACHE[lang.name] = got
    return got


def extract_calls(masked_body: str, body_start_line: int, lang: LanguageDef,
                  self_name: str) -> list[CallSite]:
    calls: list[CallSite] = []
    seen: set[tuple[str, int]] = set()
    offset_starts = _line_starts(masked_body)
    # languages with a precise reserved-word list use it; the coarse
    # cross-language union otherwise (see LanguageDef.call_keywords)
    blocked = lang.call_keywords if lang.call_keywords is not None else lang.keywords
    for m in _CALL_RE.finditer(masked_body):
        name = m.group("name")
        recv = m.group("recv")
        # self-name suppression kills the def-line's own signature mention
        # and bare recursion — but a RECEIVER call that happens to share the
        # caller's name (``ap.parse_args()`` inside ``def parse_args``,
        # ``super().__init__()``) is a real outgoing edge (r4 call audit:
        # every python recall miss was this shape)
        if name in blocked or (name == self_name and not recv):
            continue
        if len(name) <= 1:
            continue
        # `fn name(` is a nested-fn DECLARATION, not a call (audit_calls_rust:
        # the decl-site phantom class)
        if lang.name == "rust" and re.search(r"\bfn\s*$", masked_body[max(0, m.start() - 12):m.start()]):
            continue
        line = body_start_line + _line_of(m.start(), offset_starts)
        key = (name, line)
        if key in seen:
            continue
        seen.add(key)
        kind = EdgeKind.METHOD_CALL if recv else EdgeKind.CALL
        calls.append(CallSite(callee=name, line=line + 1, kind=kind, receiver=recv))
    if lang.name == "rust":
        for m in _MACRO_RE.finditer(masked_body):
            name = m.group("name")
            if name in blocked or name == "macro_rules":
                continue
            line = body_start_line + _line_of(m.start(), offset_starts)
            key = (name + "!", line)
            if key not in seen:
                seen.add(key)
                calls.append(CallSite(callee=name, line=line + 1, kind=EdgeKind.MACRO))
    return calls


def extract_type_refs(signature: str, lang: LanguageDef, line: int) -> list[TypeRef]:
    refs = []
    seen = set()
    for m in _TYPE_RE.finditer(signature):
        name = m.group("name")
        if name in lang.common_types or name in seen or name in lang.keywords:
            continue
        seen.add(name)
        refs.append(TypeRef(name=name, line=line, role="use"))
    return refs


def collect_doc(lines: list[str], comments: dict[int, str], decl_line: int,
                lang: LanguageDef) -> str:
    """Walk upward from the declaration collecting contiguous comment lines."""
    doc_parts: list[str] = []
    i = decl_line - 1
    while i >= 0:
        raw = comments.get(i)
        if raw is None:
            stripped = lines[i].strip()
            if stripped == "" and doc_parts:
                break
            if stripped == "":
                i -= 1
                continue
            # attribute/annotation lines don't break doc contiguity
            if stripped.startswith(("#[", "@", "[")):
                i -= 1
                continue
            break
        text = raw.strip()
        prefixes = sorted({lang.line_comment, *lang.doc_prefixes} - {""}, key=len, reverse=True)
        for p in prefixes:
            if text.startswith(p):
                text = text[len(p):]
                break
        if lang.block_comment:
            text = text.replace(lang.block_comment[0], "").replace(lang.block_comment[1], "")
            text = text.lstrip("*").strip()
        doc_parts.append(text.strip())
        i -= 1
    doc_parts.reverse()
    return " ".join(p for p in doc_parts if p).strip()


def _is_test(name: str, attrs_above: list[str], origin: str, lang: LanguageDef) -> bool:
    lower = name.lower()
    if any(lower.startswith(p.lower()) or lower.endswith(p.lower()) for p in lang.test_name_patterns if p):
        return True
    for attr in attrs_above:
        if any(pat in attr for pat in lang.test_attr_patterns):
            return True
    base = origin.lower()
    return "/tests/" in base or base.startswith("tests/") or base.endswith(("_test" + _ext(origin), ".test" + _ext(origin), ".spec" + _ext(origin)))


def _ext(path: str) -> str:
    dot = path.rfind(".")
    return path[dot:] if dot >= 0 else ""


def _toplevel_semicolon(gap: str) -> bool:
    """True when the header→brace gap holds a STATEMENT semicolon.

    A `;` nested in brackets is part of the signature, not a statement
    boundary — Rust array types carry one (`-> [u8; 32]`,
    `x: &[u8; 32]`), and the old flat ``gap.count(";")`` dropped every
    such function (found by audit-extraction on the reference corpus:
    worktree_overlay.rs fingerprint/content_digest/transient_error_sentinel,
    ref src/worktree_overlay.rs:974)."""
    depth = 0
    for ch in gap:
        if ch in "([<":
            depth += 1
        elif ch in ")]>":
            depth = max(0, depth - 1)
        elif ch == ";" and depth == 0:
            return True
    return False


def parse_generic(origin: str, text: str, lang: LanguageDef,
                  bodyless_members: bool = True) -> ParseResult:
    result = ParseResult(origin=origin, language=lang.name)
    masked, comments = mask_source(text, lang)
    lines = text.splitlines()
    masked_lines = masked.splitlines()
    starts = _line_starts(masked)

    claimed: list[tuple[int, int]] = []   # (start_line, end_line) of emitted chunks

    def covered(ls: int) -> bool:
        return any(a <= ls <= b for a, b in claimed)

    def block_extent(m: re.Match, decl: DeclPattern, region_end: int) -> tuple[int, int, int] | None:
        """Return (decl_line, end_line, block_end_pos) for a decl match."""
        decl_line = _line_of(m.start(), starts)
        if lang.style == "end":
            end_line = find_end_block(masked_lines, decl_line, lang)
            pos = starts[end_line] + len(masked_lines[end_line]) if end_line < len(starts) else len(masked)
            return decl_line, end_line, pos
        if lang.style == "offside":
            try:
                nm = m.group("name")
            except (IndexError, KeyError):
                nm = None
            end_line = find_offside_block(masked_lines, decl_line, nm)
            pos = starts[end_line] + len(masked_lines[end_line]) if end_line < len(starts) else len(masked)
            return decl_line, end_line, pos
        if decl.chunk_type in (ChunkType.CONST, ChunkType.TYPE_ALIAS):
            semi = masked.find(";", m.start(), region_end)
            nl2 = masked.find("\n", m.end())
            stop = semi if semi != -1 else (nl2 if nl2 != -1 else len(masked))
            pos = stop + 1
        else:
            brace = masked.find("{", m.start(), region_end)
            gap = masked[m.end():brace] if brace != -1 else ""
            # Expression-bodied function (kotlin `fun pop(): T? = ...`,
            # scala `def f(x: Int) = x + 1`): a depth-0 `=` after the
            # signature parens close, with no same-line `{`, means any later
            # brace belongs to a sibling — the decl ends at its own line.
            # (C++ default args `f(int x = 3)` sit at depth>0; Allman-style
            # next-line braces have no depth-0 `=`.)  r4 extraction audit:
            # sample.kt lost 4 of 10 decls to this.
            expr_body = False
            if decl.chunk_type in (ChunkType.FUNCTION, ChunkType.METHOD):
                nl = masked.find("\n", m.end())
                hdr_end = nl if nl != -1 else len(masked)
                if brace == -1 or brace > hdr_end:
                    depth = 0
                    closed = False   # a ')' must precede the '=': generic
                    # defaults (`fn f<T = U>(x)`) carry a depth-0 '=' BEFORE
                    # the param list (angle brackets aren't tracked) and are
                    # not expression bodies — gate on the params having closed
                    for ch in masked[m.end():hdr_end]:
                        if ch == "(":
                            depth += 1
                        elif ch == ")":
                            depth -= 1
                            closed = depth == 0
                        elif ch == "=" and depth == 0 and closed:
                            expr_body = True
                            break
            # Stolen-sibling brace: the nearest `{` can open the NEXT decl's
            # body (`fun publish(t: String)\n    fun flush() {}` — interface
            # member with no body followed by one with). If a new declaration
            # starts between this signature's end and the brace, the brace is
            # not ours (r5 long-tail audit: kotlin interface members swallowed
            # their brace-owning siblings). Decl patterns are ^-anchored, so
            # multi-line headers (C Allman braces, Java `throws` clauses,
            # C++ base-class lists) don't false-positive.
            stolen = False
            if brace != -1 and not expr_body and "\n" in gap:
                for d2 in lang.decls:
                    m2 = d2.regex.search(gap)
                    if m2 is not None:
                        stolen = True
                        break
            if brace == -1 or expr_body or stolen or _toplevel_semicolon(gap):
                # No block of its own (arrow fn body / expression decl): end at
                # the statement boundary when the pattern allows it.
                if not (decl.statement_ok or expr_body):
                    return None
                # statement decl: extend to the terminating `;` (SQL CREATE,
                # arrow-function statements), else end of line
                semi = masked.find(";", m.end(), region_end)
                stop = semi if semi != -1 else masked.find("\n", m.end())
                if stop == -1:
                    stop = len(masked)
                pos = stop + 1
            else:
                pos = find_brace_block(masked, brace)
        end_line = _line_of(min(pos - 1, len(masked) - 1), starts)
        return decl_line, end_line, pos

    def emit(m: re.Match, decl: DeclPattern, extent: tuple[int, int, int],
             parent_name: str | None, inside_container: bool) -> Chunk | None:
        decl_line, end_line, block_end_pos = extent
        name = m.group("name")
        if not name or (decl.member_only and name in _MEMBER_BLOCKLIST):
            return None
        body = "\n".join(lines[decl_line : end_line + 1])
        if not body.strip():
            return None
        sig_line = lines[decl_line].strip() if decl_line < len(lines) else ""
        # multiline headers: extend until the paren balance closes (capped) —
        # a rustfmt-wrapped fn or a CREATE TABLE keeps its parameter/column
        # list in the signature (7.3% of refcorpus signatures ended at the
        # open paren before this; the sig_boost and FTS meta never saw the
        # params, e.g. 'pub fn new(' vs 'pub fn new(stores: Vec<NamedStore>)')
        depth = sig_line.count("(") - sig_line.count(")")
        j = decl_line
        while (depth > 0 and j + 1 <= end_line and j - decl_line < 20
               and len(sig_line) < 800):
            j += 1
            nxt = lines[j].strip()
            sig_line += " " + nxt
            depth += nxt.count("(") - nxt.count(")")
        sig_line = " ".join(sig_line.split())
        attrs_above = [lines[i].strip() for i in range(max(0, decl_line - 3), decl_line)]
        ct = decl.chunk_type
        # Go-style receiver methods: func (s *Server) Run(...)
        recv = None
        try:
            recv = m.group("recv")
        except (IndexError, KeyError):
            pass
        if recv:
            tm = _TYPE_RE.search(recv)
            if tm:
                parent_name = tm.group("name")
            ct = ChunkType.METHOD
        elif inside_container and ct == ChunkType.FUNCTION:
            ct = ChunkType.METHOD
        is_test = ct.is_callable and _is_test(name, attrs_above, origin, lang)
        if is_test and ct in (ChunkType.FUNCTION, ChunkType.METHOD):
            ct = ChunkType.TEST
        ret = None
        if decl.return_group:
            try:
                ret = (m.group(decl.return_group) or "").strip() or None
            except (IndexError, KeyError):
                ret = None
        if ret is None and "->" in sig_line:
            ret = sig_line.split("->", 1)[1].split("{")[0].strip().rstrip(";").strip() or None
        chunk = Chunk(
            origin=origin,
            name=name,
            chunk_type=ct,
            language=lang.name,
            line_start=decl_line + 1,
            line_end=end_line + 1,
            body=body,
            signature=sig_line.rstrip("{").strip(),
            doc=collect_doc(lines, comments, decl_line, lang),
            parent_name=parent_name,
            return_type=ret,
            is_test=is_test,
        )
        if ct.is_callable or ct == ChunkType.MACRO:
            body_slice = masked[m.end():block_end_pos]
            chunk.calls = extract_calls(body_slice, _line_of(m.end(), starts), lang, name)
        chunk.type_refs = extract_type_refs(chunk.signature, lang, chunk.line_start)
        # Containers claim only their header line — their bodies are scanned
        # recursively so methods inside still get emitted.
        claimed.append((decl_line, decl_line if decl.container else end_line))
        result.chunks.append(chunk)
        return chunk

    def scan(region_start: int, region_end: int, parent_name: str | None,
             inside_container: bool, container_ct: ChunkType | None = None) -> None:
        """Scan masked[region_start:region_end]: containers first (recursing
        into their bodies), then leaf declarations outside container spans."""
        container_spans: list[tuple[int, int]] = []   # byte ranges of containers
        for decl in lang.decls:
            if not decl.container:
                continue
            for m in decl.regex.finditer(masked, region_start, region_end):
                if any(a <= m.start() < b for a, b in container_spans):
                    continue   # nested containers handled by recursion
                extent = block_extent(m, decl, region_end)
                if extent is None:
                    continue
                decl_line, end_line, block_end_pos = extent
                if covered(decl_line):
                    continue
                chunk = emit(m, decl, extent, parent_name, inside_container)
                if chunk is None:
                    continue
                container_spans.append((m.start(), block_end_pos))
                if lang.style == "end":
                    inner_start = starts[min(decl_line + 1, len(starts) - 1)]
                    scan(inner_start, block_end_pos, chunk.name, True,
                         container_ct=chunk.chunk_type)
                else:
                    brace = masked.find("{", m.start(), block_end_pos)
                    if brace != -1:
                        scan(brace + 1, block_end_pos - 1, chunk.name, True,
                             container_ct=chunk.chunk_type)

        for decl in lang.decls:
            if decl.container or (decl.member_only and not inside_container):
                continue
            for m in decl.regex.finditer(masked, region_start, region_end):
                if any(a <= m.start() < b for a, b in container_spans):
                    continue
                extent = block_extent(m, decl, region_end)
                if extent is None:
                    # bodyless TRAIT members, brace style (kotlin/java-like
                    # `interface { fun get(key: String): String? }`): no `=`
                    # and no own brace in the container region — the decl is
                    # its own single line (r4 extraction audit: interface
                    # methods were dropped entirely)
                    # ...or an explicitly-abstract bodyless member in a class
                    # (php `abstract protected function x(): mixed;`, java/c#
                    # abstract methods). C/C++ prototypes carry no `abstract`
                    # keyword and stay deliberately unchunked.
                    if (bodyless_members
                            and (container_ct == ChunkType.TRAIT
                                 or (container_ct == ChunkType.CLASS
                                     and "abstract" in m.group(0)))
                            and decl.chunk_type
                            in (ChunkType.FUNCTION, ChunkType.METHOD)):
                        dl = _line_of(m.start(), starts)
                        extent = (dl, dl, starts[dl] + len(masked_lines[dl]))
                    else:
                        continue
                # bodyless members: an end-style TRAIT container (VB.NET
                # Interface) holds declarations with no End terminator — a
                # member's extent is its own declaration line
                elif (lang.style == "end" and container_ct == ChunkType.TRAIT
                        and decl.chunk_type in (ChunkType.FUNCTION, ChunkType.METHOD)):
                    dl = extent[0]
                    extent = (dl, dl, starts[dl] + len(masked_lines[dl]))
                if covered(extent[0]):
                    continue
                emit(m, decl, extent, parent_name, inside_container)

    scan(0, len(masked), None, False)
    result.chunks.sort(key=lambda c: (c.line_start, c.line_end))
    return result
