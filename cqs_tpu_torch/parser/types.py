"""Core ingest data types: chunks, call sites, type refs, parse results.

Reference analog: ``src/parser/chunk.rs`` (Chunk + ChunkType + the
``PARSER_VERSION`` drift stamp at src/parser/chunk.rs:67) and
``src/parser/calls.rs`` (call-site extraction with edge kinds).

Chunk IDs are content-addressed as ``{path}:{line_start}:{content_hash}`` —
this is the coherence invariant the reference's loom model pins
(CONTENT-FIDELITY, ``src/cli/watch/reconcile_interleaving_model.rs``): a
chunk id can never refer to different content, so index/store races degrade
to stale-but-consistent results, never wrong-content results.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from cqs_tpu_torch.utils.hashing import canonical_hash, content_hash

#: Bumped whenever chunk extraction changes shape; rows stamped with an older
#: version are requeued for reindex (ref: parser-version drift, schema v21/v31).
PARSER_VERSION = 13  # v13: long-tail decl audit fixes (r5 fixture corpus):
# stolen-sibling-brace extents (a bodyless interface member no longer
# swallows the next member's body), abstract bodyless class members, Go
# generics (func F[T ...]), C#/Java records + sealed types + struct/enum
# containers + generic/one-line methods, Kotlin override/operator/infix
# fun + sealed interface + bodyless data-class decls, PHP backed enums +
# abstract methods, Swift mutating funcs + non-public extensions.
# v12: Rust call extraction uses the TRUE reserved-word
# blocklist (call_keywords) — Vec::new()/.len()/.map()/format!/assert! are
# real edges now (the shared C/Go/Swift keyword union ate 24% of reference-
# corpus Rust call edges, audit_calls_rust r5); `match (tuple)` phantoms and
# nested-`fn name(` decl sites are excluded.
# v11: expression-bodied fns (kotlin/scala `= expr`) and
# brace-style interface body-less members now index; receiver calls sharing
# the caller's name (`ap.parse_args()` in `def parse_args`) keep their edge.


class ChunkType(str, enum.Enum):
    """Kinds of extracted chunks, with human names used in NL generation."""

    FUNCTION = "function"
    METHOD = "method"
    CLASS = "class"
    STRUCT = "struct"
    ENUM = "enum"
    TRAIT = "trait"          # trait / interface / protocol
    IMPL = "impl"
    MODULE = "module"
    CONST = "const"
    TYPE_ALIAS = "type_alias"
    MACRO = "macro"
    TEST = "test"
    SECTION = "section"      # markdown / doc heading section
    CONFIG = "config"        # config-file top-level table/object
    WINDOW = "window"        # token-window slice of an oversized parent chunk

    @property
    def human(self) -> str:
        return _HUMAN_NAMES[self]

    @property
    def is_callable(self) -> bool:
        return self in (ChunkType.FUNCTION, ChunkType.METHOD, ChunkType.TEST)

    @property
    def is_code(self) -> bool:
        """Code chunk (callable or type/const/impl definition) vs prose/
        config/module scaffolding. Mirrors the reference's ChunkClass
        (src/language/mod.rs:806-843): Section/Module/ConfigKey are NonCode
        and excluded from DEFAULT search (``--include-docs`` searches all).
        Windows inherit their parent's class at mask-build time."""
        return self not in _NON_CODE

    @property
    def is_type(self) -> bool:
        return self in (ChunkType.CLASS, ChunkType.STRUCT, ChunkType.ENUM,
                        ChunkType.TRAIT, ChunkType.TYPE_ALIAS)


#: Non-code chunk classes (WINDOW is neither: it inherits its parent's class,
#: resolved wherever windows are classified — mask build, leg resolution)
_NON_CODE = frozenset({ChunkType.SECTION, ChunkType.MODULE, ChunkType.CONFIG})

#: SQL literal of the non-code chunk_type values (window rows resolve through
#: their parent before this check — see SearchEngine._code_mask)
NON_CODE_TYPES = tuple(t.value for t in _NON_CODE)

_HUMAN_NAMES = {
    ChunkType.FUNCTION: "function",
    ChunkType.METHOD: "method",
    ChunkType.CLASS: "class",
    ChunkType.STRUCT: "struct",
    ChunkType.ENUM: "enum",
    ChunkType.TRAIT: "interface",
    ChunkType.IMPL: "implementation block",
    ChunkType.MODULE: "module",
    ChunkType.CONST: "constant",
    ChunkType.TYPE_ALIAS: "type alias",
    ChunkType.MACRO: "macro",
    ChunkType.TEST: "test function",
    ChunkType.SECTION: "documentation section",
    ChunkType.CONFIG: "configuration block",
    ChunkType.WINDOW: "code window",
}


class EdgeKind(str, enum.Enum):
    """Provenance of a call edge (ref: src/parser/calls.rs edge kinds)."""

    CALL = "call"                    # direct syntactic call
    METHOD_CALL = "method_call"      # receiver.method(...)
    MACRO = "macro_heuristic"        # macro!/decorator-style invocation
    FN_POINTER = "fn_pointer"        # bare function reference passed around
    DOC_REFERENCE = "doc_reference"  # name mentioned in a doc comment


@dataclass
class CallSite:
    """One outgoing call from a chunk. ``callee`` is the bare name; resolution
    to a target chunk happens at store level (name-resolved adjacency)."""

    callee: str
    line: int
    kind: EdgeKind = EdgeKind.CALL
    receiver: str | None = None      # e.g. the `foo` in foo.bar()


@dataclass
class TypeRef:
    """A type name referenced by a chunk (param/return/field position)."""

    name: str
    line: int
    role: str = "use"                # use | param | return | field | extends


@dataclass
class Chunk:
    """One indexable unit of code or documentation."""

    origin: str                      # path relative to project root
    name: str
    chunk_type: ChunkType
    language: str
    line_start: int                  # 1-based, inclusive
    line_end: int                    # 1-based, inclusive
    body: str                        # exact source slice
    signature: str = ""              # first-line declaration, cleaned
    doc: str = ""                    # leading doc comment / docstring
    parent_name: str | None = None   # enclosing class/struct/module name
    return_type: str | None = None
    is_test: bool = False
    calls: list[CallSite] = field(default_factory=list)
    type_refs: list[TypeRef] = field(default_factory=list)
    parent_id: str | None = None     # for WINDOW chunks: the parent chunk id
    window_idx: int | None = None

    _hash: str | None = None
    _canon: str | None = None

    @property
    def body_hash(self) -> str:
        if self._hash is None:
            self._hash = content_hash(self.body)
        return self._hash

    @property
    def canonical(self) -> str:
        if self._canon is None:
            self._canon = canonical_hash(self.body)
        return self._canon

    @property
    def id(self) -> str:
        """Content-addressed chunk id (the CONTENT-FIDELITY invariant)."""
        return f"{self.origin}:{self.line_start}:{self.body_hash}"

    @property
    def qualified_name(self) -> str:
        return f"{self.parent_name}.{self.name}" if self.parent_name else self.name


@dataclass
class ParseResult:
    """Everything extracted from one file."""

    origin: str
    language: str
    chunks: list[Chunk] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
