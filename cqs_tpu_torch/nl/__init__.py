"""Natural-language description generation — the text that gets embedded.

Reference analog: ``src/nl/mod.rs`` (``generate_nl_with_call_context_and_summary``
at src/nl/mod.rs:44, template generation at :202, seq-len-scaled budgets at
:199-226). Code -> NL -> embed is the recall-critical transform: descriptions
combine the tokenized name, chunk-type human name, signature, return type,
parent type, body keywords, and doc comment; the second (enrichment) pass
folds in caller/callee names with a doc-frequency stopword filter, and
optional LLM summaries / HyDE queries.

Two NL variants exist per chunk (the reference's adaptive dual-index design,
schema v18): the *base* NL (template only) and the *enriched* NL (call-graph
context + summary). They embed into separate dense indexes; the router picks
per query category.
"""

from __future__ import annotations

import functools
import re as _re
from collections import Counter
from dataclasses import dataclass, field

from cqs_tpu_torch.config import Limits, limits as default_limits
from cqs_tpu_torch.parser.types import Chunk, ChunkType
from cqs_tpu_torch.utils.text import content_words, tokenize_identifier

#: Rough chars-per-token budget multiplier: NL budget scales with the model's
#: sequence length so long-sequence models (gemma 2048, qwen3 4096) use their
#: capacity (ref: src/nl/mod.rs:199-226).
_CHARS_PER_TOKEN = 4


@dataclass
class CallContext:
    """Call-graph context for the enrichment pass."""

    callers: list[str] = field(default_factory=list)
    callees: list[str] = field(default_factory=list)


def _body_keywords(chunk: Chunk, max_words: int) -> list[str]:
    """Most-frequent distinctive words from the body, excluding the name's own
    tokens (they're already present)."""
    own = set(tokenize_identifier(chunk.name))
    counts = Counter(w for w in content_words(chunk.body) if w not in own)
    return [w for w, _ in counts.most_common(max_words)]


#: Path components that carry no module signal (ref: extract_file_context,
#: src/nl/mod.rs:443 — skip dirs + generic filename stems).
_PATH_SKIP = frozenset({
    "src", "lib", ".", "test", "tests", "spec", "specs", "fixtures",
    "fixture", "testdata", "internal", "pkg", "cmd", "app", "eval", "bench",
    "benches", "examples", "example", "vendor", "third_party"})
_GENERIC_STEMS = frozenset({
    "mod", "index", "lib", "main", "utils", "helpers", "common", "types",
    "config", "constants", "init", "__init__"})


def file_context(origin: str) -> str:
    """Module-context words from the file path: strip scaffolding dirs and
    generic filename stems, tokenize the rest ('src/store/call_graph.rs' ->
    'store call graph'). Ref: src/nl/mod.rs:443-516 — module discrimination
    is part of the embedded text, so 'store' queries land in store files."""
    comps = [c for c in origin.split("/") if c and c not in _PATH_SKIP]
    if not comps:
        return ""
    words: list[str] = []
    for i, c in enumerate(comps):
        if i == len(comps) - 1:
            stem = c.rsplit(".", 1)[0]
            if stem in _GENERIC_STEMS:
                continue
            c = stem
        words.extend(tokenize_identifier(c))
    return " ".join(words)


#: Field declarations inside a type body: `name: Type`, `name = value`,
#: `Type name;` — one identifier per line-start after visibility noise.
_FIELD_RE = _re.compile(
    r"^\s*(?:pub(?:\([^)]*\))?\s+|public\s+|private\s+|protected\s+|readonly\s+"
    r"|static\s+|final\s+|var\s+|let\s+|const\s+|optional\s+)*"
    r"([a-zA-Z_]\w*)\s*(?::(?!:)|=[^=]|\?\s*:)", _re.M)
_METHOD_RE = _re.compile(
    r"^\s*(?:pub(?:\([^)]*\))?\s+|public\s+|private\s+|protected\s+|static\s+"
    r"|async\s+|override\s+)*(?:def|fn|func|function)\s+([a-zA-Z_]\w*)\s*[(<]", _re.M)
_METHOD_BRACE_RE = _re.compile(
    r"^\s*(?:public\s+|private\s+|protected\s+|static\s+|async\s+|override\s+)+"
    r"[\w<>\[\],. ]*?([a-zA-Z_]\w*)\s*\([^;]*\)\s*\{", _re.M)

_FIELD_STOP = frozenset({
    "if", "else", "for", "while", "return", "match", "switch", "case",
    "type", "impl", "use", "mod", "import", "from", "package", "self",
    "this", "super", "new", "where", "derive"})


def field_names(body: str, max_fields: int = 12) -> list[str]:
    """Field identifiers of a type declaration body (struct/class/enum) —
    'struct with a capacity field' must reach the struct chunk even when the
    field name never appears in doc or signature (ref: extract_field_names,
    src/nl/fields.rs). Regex altitude matches the parser's own engine."""
    out: list[str] = []
    seen: set[str] = set()
    for m in _FIELD_RE.finditer(body):
        name = m.group(1)
        if name in _FIELD_STOP or name in seen:
            continue
        seen.add(name)
        out.append(" ".join(tokenize_identifier(name)) or name)
        if len(out) >= max_fields:
            break
    return out


def member_method_names(body: str, max_methods: int = 10) -> list[str]:
    """Member method identifiers inside a class/struct/trait body — queries
    name the capability ('cache with an evict method'); the method chunks
    exist separately but the TYPE chunk must also carry them (ref:
    extract_member_method_names, src/nl/fields.rs)."""
    out: list[str] = []
    seen: set[str] = set()
    for rx in (_METHOD_RE, _METHOD_BRACE_RE):
        for m in rx.finditer(body):
            name = m.group(1)
            if name in _FIELD_STOP or name in seen:
                continue
            seen.add(name)
            out.append(" ".join(tokenize_identifier(name)) or name)
            if len(out) >= max_methods:
                return out
    return out


def params_nl(signature: str) -> str | None:
    """Tokenized parameter words from the signature — camelCase/snake_case
    params split into query-shaped words ('Takes parameters: retry count,
    base delay'); raw signatures only match exact spellings (ref:
    extract_params_nl, src/nl/mod.rs:389)."""
    start, end = signature.find("("), signature.rfind(")")
    if start < 0 or end <= start:
        return None
    inner = signature[start + 1 : end]
    if not inner.strip():
        return None
    parts = []
    for p in inner.split(","):
        words = [w for w in tokenize_identifier(p)
                 if w not in ("self", "mut", "this", "cls")]
        if words:
            parts.append(" ".join(words))
    return "takes " + ", ".join(parts) if parts else None


#: Constructor-shaped method names across languages (ref: the Constructor
#: chunk type's phrasing, src/nl/mod.rs:293-303)
_CTOR_NAMES = frozenset({"__init__", "new", "constructor", "init", "ctor"})

#: Chunk types whose body is a type declaration (fields/methods extraction)
_TYPE_CHUNKS = (ChunkType.CLASS, ChunkType.STRUCT, ChunkType.ENUM,
                ChunkType.TRAIT)


def generate_nl(chunk: Chunk, max_seq_len: int = 512,
                lim: Limits | None = None) -> str:
    """Base NL template (no call context): the production 'Compact' template.

    Shape: ``<name words> <type human name>[ in <parent>]. [<module ctx>.]
    [constructor for <parent>.] <signature>. [takes <params>.]
    [Returns <ret>.] [<doc>.] [Fields: ...] [Methods: ...]
    Keywords: <body words>.``

    Feature layers mirror the reference template
    (src/nl/mod.rs:199-385): file context, constructor phrasing, tokenized
    params, type-body fields/methods. Each is individually disableable via
    ``nl_extra_layers`` (opt-in: filecontext/params/fields/methods/ctor)
    so recall deltas bisect per layer.
    """
    lim = lim or default_limits
    if not chunk.name and not chunk.doc and not chunk.signature:
        # degenerate chunk: the path is the only discriminator (ref guard,
        # src/nl/mod.rs:243-249) — checked BEFORE the head template, which
        # otherwise always contributes at least the chunk-type human name
        return chunk.origin or "(unnamed)"
    enabled = {l.strip() for l in (lim.nl_extra_layers or "").split(",") if l.strip()}
    budget = max_seq_len * _CHARS_PER_TOKEN
    name_words = " ".join(tokenize_identifier(chunk.name)) or chunk.name
    parts: list[str] = []

    # per-language human-name override (a SQL struct is a "table" — queries
    # say "table"/"schema", never "struct"; ref: StoredProc/table vocabulary)
    from cqs_tpu_torch.parser.registry import get_language

    lang_def = get_language(chunk.language) if chunk.language else None
    human = (lang_def.human_names.get(chunk.chunk_type) if lang_def else None) \
        or chunk.chunk_type.human
    head = f"{name_words} {human}"
    if chunk.parent_name:
        head += f" in {' '.join(tokenize_identifier(chunk.parent_name))}"
    if chunk.language and chunk.chunk_type not in (ChunkType.SECTION, ChunkType.CONFIG):
        head += f" ({chunk.language})"
    parts.append(head)

    if "filecontext" in enabled and chunk.chunk_type not in (
            ChunkType.SECTION, ChunkType.CONFIG):
        fc = file_context(chunk.origin)
        # skip when redundant with the name/parent tokens already present
        if fc and not set(fc.split()) <= set(head.lower().split()):
            parts.append(f"in {fc}")

    if ("ctor" in enabled
            and chunk.chunk_type is ChunkType.METHOD and chunk.parent_name
            and chunk.name.rsplit(".", 1)[-1] in _CTOR_NAMES):
        parts.append("constructor for "
                     + " ".join(tokenize_identifier(chunk.parent_name)))

    if chunk.signature and chunk.signature != chunk.name:
        parts.append(chunk.signature)
        if "params" in enabled and chunk.chunk_type.is_callable:
            p = params_nl(chunk.signature)
            if p:
                parts.append(p)
    if chunk.return_type:
        parts.append(f"returns {' '.join(tokenize_identifier(chunk.return_type)) or chunk.return_type}")
    if chunk.doc:
        doc = chunk.doc.strip()
        parts.append(doc[: budget // 2])

    if chunk.chunk_type in _TYPE_CHUNKS:
        if "fields" in enabled:
            fl = field_names(chunk.body)
            if fl:
                parts.append("fields: " + ", ".join(fl))
        if "methods" in enabled:
            ml = member_method_names(chunk.body)
            if ml:
                parts.append("methods: " + ", ".join(ml))

    if chunk.chunk_type in (ChunkType.SECTION, ChunkType.CONFIG):
        # doc-like chunks: the body IS the content — include a prefix directly
        parts.append(chunk.body[: budget - sum(len(p) for p in parts)])
    else:
        # (a fuller body-token stream was measured recall-neutral on the
        # reference corpus and slightly negative on dev behavioral — the
        # top-16 keyword budget stands)
        kw = _body_keywords(chunk, max_words=16)
        if kw:
            parts.append("keywords: " + " ".join(kw))

    out = ". ".join(p.strip().rstrip(".") for p in parts if p.strip())
    return out[:budget]


@functools.lru_cache(maxsize=1 << 16)
def _name_words(name: str) -> str:
    """A caller's or callee's name as words. Cached: the enrichment pass
    names the same few hundred functions in every row that calls them."""
    return " ".join(tokenize_identifier(name))


def generate_nl_enriched(
    chunk: Chunk | None,
    ctx: CallContext,
    callee_doc_freq: dict[str, float] | None = None,
    summary: str | None = None,
    hyde: str | None = None,
    max_seq_len: int = 512,
    lim: Limits | None = None,
    *,
    base: str | None = None,
) -> str:
    """Enriched NL: base + call-graph context + optional summary/HyDE.

    Callers are the strongest discrimination signal and always included (up to
    ``nl_max_callers``); callees appearing in more than ``callee_df_cutoff``
    of chunks are utilities (log/unwrap/format) and filtered out. An LLM
    summary, when present, is PREPENDED for maximum embedding weight; HyDE
    queries are appended (ref: src/nl/mod.rs:44-120).

    ``base``, when non-empty, is the chunk's base NL as ``generate_nl(chunk,
    max_seq_len)`` gives it (the index pipeline's stored ``nl_base``);
    ``chunk`` is then not read and may be None.
    """
    lim = lim or default_limits
    skipped = set((lim.disable_enrichment or "").split(","))
    base = base or generate_nl(chunk, max_seq_len)
    extras: list[str] = []
    callee_doc_freq = callee_doc_freq or {}

    if ctx.callers and "callgraph" not in skipped:
        words = [_name_words(c) for c in ctx.callers[: lim.nl_max_callers]]
        words = [w for w in words if w]
        if words:
            extras.append("Called by: " + ", ".join(words))
    if ctx.callees and "callgraph" not in skipped:
        cutoff = lim.callee_df_cutoff
        kept = [c for c in ctx.callees if callee_doc_freq.get(c, 0.0) < cutoff]
        words = [_name_words(c) for c in kept[: lim.nl_max_callees]]
        words = [w for w in words if w]
        if words:
            extras.append("Calls: " + ", ".join(words))

    nl = base if not extras else f"{base}. {'. '.join(extras)}"
    if summary and "summary" not in skipped:
        nl = f"{summary} {nl}"
    if hyde and "hyde" not in skipped:
        nl = f"{nl}. Queries: {hyde}"
    return nl[: max_seq_len * _CHARS_PER_TOKEN]


def compute_callee_doc_freq(all_chunks_calls: list[list[str]]) -> dict[str, float]:
    """Document frequency of each callee name across chunks — callees above
    the cutoff are treated as utilities and excluded from NL."""
    n = max(1, len(all_chunks_calls))
    df: Counter[str] = Counter()
    for calls in all_chunks_calls:
        for name in set(calls):
            df[name] += 1
    return {name: count / n for name, count in df.items()}
