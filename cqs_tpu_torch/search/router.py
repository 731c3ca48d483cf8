"""Query router: rule-based category classifier + centroid reclassifier.

Reference analog: ``src/search/router.rs`` — 8 categories with per-category
SPLADE fusion alphas (``define_query_categories!``, router.rs:126-175), the
priority-ordered rule chain (``classify_query_inner:868``), Aho-Corasick type
-hint extraction (``extract_type_hints:1291``), and the embedding-space
centroid reclassifier (``reclassify_with_centroid:1453``) that refines
Unknown classifications with an alpha floor.

Alphas are sourced from the reference's per-category sweeps (the behavioral
spec, not the code): identifier 0.85, structural 0.60, behavioral 1.00,
conceptual 0.80, multi_step 0.10, negation 0.80, type_filtered 0.00,
cross_language 0.70, unknown 0.80. alpha = dense weight; (1-alpha) = sparse.
"""

from __future__ import annotations

import enum
import json
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from cqs_tpu_torch.config import Limits, limits as default_limits
from cqs_tpu_torch.parser.types import ChunkType


class Category(str, enum.Enum):
    IDENTIFIER_LOOKUP = "identifier_lookup"
    STRUCTURAL = "structural"
    BEHAVIORAL = "behavioral"
    CONCEPTUAL = "conceptual"
    MULTI_STEP = "multi_step"
    NEGATION = "negation"
    TYPE_FILTERED = "type_filtered"
    CROSS_LANGUAGE = "cross_language"
    UNKNOWN = "unknown"


#: Lexical-tier adjustments: the reference's alphas are tuned for neural
#: embeddings ("behavioral queries embed well -> pure dense"). The hash
#: embedder's dense leg is itself lexical, so behavioral queries measurably
#: benefit from keeping the sparse leg in the mix (+13pp R@5 on the
#: reference-corpus behavioral split).
LEXICAL_ALPHA_OVERRIDES: dict[str, float] = {
    # 0.5 (the r2 value) re-swept on the 3.3k-query megapool (r4b): 0.85 >
    # 0.9 > 0.8 > 0.5 with +22 behavioral hits at k=5 — a smooth peak, not
    # a small-n accident. DEFAULT_ALPHA keeps the reference's neural-tier
    # 1.00 (router.rs:126-175); this override is hash-tier-only.
    "behavioral": 0.85,
    # NOTE alpha semantics: 0.0 is NOT pure sparse — fuse_alpha treats
    # alpha<=0 as re-rank mode `dense + 0.1*sparse_norm` (the reference's own
    # rule, src/search/query.rs:983-991); true pure-sparse is alpha=0.01 (the
    # alpha>0 branch). Both sides of that discontinuity are now measured:
    # the r3 LOCO sweep over the 499-query pool (sweep alpha_unknown /
    # alpha_structural / alpha_type_filtered over 0.0/0.01/0.1/0.25) picks
    # 0.0 for all three — pure sparse collapses structural 12->8/84 and
    # multi_step 49->34/84. Re-rank mode is the measured winner, not an
    # accident of the 0-means-sparse misreading. A finer per-category sweep
    # was tried and REVERTED in r2: it lifted dev (+1.8pp) but dropped the
    # held-out test split (51.4 -> 47.7 R@5) — small-n picks overfit.
    "unknown": 0.0,
    "structural": 0.0,
}

#: Categories where the hash tier RRF-fuses the FTS5 leg by default
#: (measured on the reference corpus dev/test splits: behavioral +20pp,
#: cross-language +10pp, conceptual +8pp, unknown +3 hits; type-filtered and
#: structural regress, so they stay off).
LEXICAL_RRF_CATEGORIES = frozenset({"behavioral", "conceptual", "cross_language", "unknown"})

#: Default dense-vs-sparse fusion weight per category (see module docstring).
DEFAULT_ALPHA: dict[Category, float] = {
    Category.IDENTIFIER_LOOKUP: 0.85,
    Category.STRUCTURAL: 0.60,
    Category.BEHAVIORAL: 1.00,
    Category.CONCEPTUAL: 0.80,
    Category.MULTI_STEP: 0.10,
    Category.NEGATION: 0.80,
    Category.TYPE_FILTERED: 0.00,
    Category.CROSS_LANGUAGE: 0.70,
    Category.UNKNOWN: 0.80,
}

# Aliases accepted in eval files / config (ref: category aliases)
CATEGORY_ALIASES = {
    "structural_search": Category.STRUCTURAL,
    "behavioral_search": Category.BEHAVIORAL,
    "conceptual_search": Category.CONCEPTUAL,
}


def parse_category(name: str) -> Category:
    try:
        return Category(name)
    except ValueError:
        return CATEGORY_ALIASES.get(name, Category.UNKNOWN)


class Strategy(str, enum.Enum):
    NAME_ONLY = "name_only"            # FTS first, dense fallback (~1ms)
    DENSE_DEFAULT = "dense"            # enriched index
    DENSE_TYPE_HINTS = "dense_type_hints"
    DENSE_BASE = "dense_base"          # base (non-enriched) index


class Confidence(str, enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


@dataclass
class Classification:
    category: Category
    confidence: Confidence
    strategy: Strategy
    type_hints: list[ChunkType] | None = None
    rerouted_by_centroid: bool = False
    #: For NAME_ONLY: the query with declaration keywords stripped
    #: ("fn cmd_audit_mode" -> "cmd_audit_mode"); the FTS name leg uses this.
    name_query: str | None = None


# ---------------------------------------------------------------------------
# Rule chain vocab
# ---------------------------------------------------------------------------

NEGATION_TOKENS = set(
    "without not except excluding avoid avoiding never no exclude unless".split())


def extend_router_vocab(negation: list[str] | None = None,
                        behavioral_verbs: list[str] | None = None,
                        conceptual: list[str] | None = None) -> None:
    """Runtime vocab overlay (ref: router.rs runtime vocab overlay; fed from
    the [router] config section)."""
    if negation:
        NEGATION_TOKENS.update(w.lower() for w in negation)
    if behavioral_verbs:
        global _BEHAVIORAL_VERBS
        _BEHAVIORAL_VERBS = frozenset(_BEHAVIORAL_VERBS | {w.lower() for w in behavioral_verbs})
    if conceptual:
        global _CONCEPTUAL_MARKERS
        _CONCEPTUAL_MARKERS = frozenset(_CONCEPTUAL_MARKERS | {w.lower() for w in conceptual})

_LANGUAGE_NAMES = frozenset(
    """python rust go golang javascript typescript java ruby php swift kotlin
    scala lua c cpp c++ csharp c# sql shell bash""".split())

_CROSS_LANG_MARKERS = ("equivalent", "translate", "translated", "port", "ported")

#: Tokens stripped when building a cross-language query's "concept core":
#: the comparative scaffolding of an X-vs-Y question ("composite primary key
#: in SQL vs MongoDB") drowns the concept terms in the lexical legs — the
#: gold is about the concept, the language names only pick the category
#: (r3 triage: gold dense/sparse ranks in the thousands on every one of the
#: 6 cross_language test misses while the language names dominate the
#: match). Extends _LANGUAGE_NAMES with the system names that appear in
#: X-vs-Y phrasing but not in the classifier list.
_XLANG_STRIP = frozenset(_LANGUAGE_NAMES | set(
    """mongodb postgresql postgres sqlite mysql ocaml haskell elixir erlang
    perl dart julia fortran cobol zig nim vs versus equivalent across
    languages language convention conventions""".split()))

#: Query-token -> parser-registry language for the language-affinity boost:
#: when the query NAMES a language, chunks written in it get a soft score
#: boost (``lang_hint_boost``). Analog of :func:`extract_type_hints` on the
#: language axis; r3 triage motivation: the cross_language/structural miss
#: cluster's golds live in files of the NAMED language (schema.sql golds for
#: "in SQLite vs Postgres", .py golds for "in Python vs Go") while the
#: Rust-majority corpus drowns them in every leg.
_LANG_ALIASES: dict[str, str] = {
    "python": "python", "rust": "rust", "golang": "go",
    "javascript": "javascript", "typescript": "typescript",
    "java": "java", "ruby": "ruby", "php": "php", "swift": "swift",
    "kotlin": "kotlin", "scala": "scala", "lua": "lua",
    "cpp": "cpp", "c++": "cpp", "csharp": "csharp", "c#": "csharp",
    "sql": "sql", "sqlite": "sql", "postgres": "sql", "postgresql": "sql",
    "mysql": "sql", "bash": "shell", "shell": "shell",
    "perl": "perl", "haskell": "haskell", "ocaml": "ocaml",
    "elixir": "elixir", "erlang": "erlang", "dart": "dart",
    "julia": "julia", "zig": "zig", "solidity": "solidity",
    "powershell": "powershell", "html": "html", "css": "css",
    "xml": "xml", "markdown": "markdown", "terraform": "terraform",
    "dockerfile": "dockerfile", "vbnet": "vbnet", "vb.net": "vbnet",
    "elm": "elm", "gleam": "gleam", "groovy": "groovy", "nix": "nix",
    "graphql": "graphql", "cmake": "cmake", "fsharp": "fsharp",
    "f#": "fsharp",
}

#: Names that collide with everyday words ("go through", "c constant",
#: "r value"): they only count as a language hint when capitalized verbatim.
_LANG_AMBIGUOUS = frozenset({"c", "go", "r"})


def extract_lang_hints(query: str) -> tuple[str, ...]:
    """Parser-registry languages explicitly named in the query, in query
    order ("table with foreign keys in SQLite vs Postgres" -> ("sql",)).
    Consumed by the scoring-stage language-affinity boost."""
    hints: list[str] = []
    for raw in query.replace(",", " ").split():
        tok = raw.strip(".,?!:;()[]'\"")
        lang = _LANG_ALIASES.get(tok.lower())
        if lang is None and tok.lower() in _LANG_AMBIGUOUS and tok[:1].isupper():
            lang = tok.lower()
        if lang and lang not in hints:
            hints.append(lang)
    return tuple(hints)


#: Scaffolding words of a structural query ("tables with columns of type
#: TEXT" / "functions that take a Vec of NamedStore") — the category's
#: framing vocabulary, not the structural pattern itself.
_STRUCT_SCAFFOLD = frozenset(
    """a an the of and or to in for on with that which has have having
    table tables column columns function functions method methods kind
    kinds different value values there are is all every any code""".split())


def structural_terms(query: str) -> str:
    """The structural tokens of a STRUCTURAL query (type names, keywords,
    identifiers) for the high-precision AND-over-body leg: gold chunks for
    this category literally contain the pattern tokens in their bodies
    (r3 triage: body-FTS gold ranks 11-64 on the structural test misses while
    dense/sparse sit in the thousands). Returns "" below 2 tokens."""
    words = [w for w in (t.strip(",.?!:;()[]'\"") for t in query.split())
             if w and w.lower() not in _STRUCT_SCAFFOLD]
    return " ".join(words) if len(words) >= 2 else ""


#: Natural-language type words -> the identifiers they appear as in
#: signatures, used as an FTS OR-group overlay for the signature leg
#: (ref: structural matchers, src/structural.rs — matches_async /
#: return-type patterns generalized to token alternatives).
SIG_TYPE_SYNONYMS: dict[str, list[str]] = {
    "string": ["str"], "integer": ["int", "i32", "i64", "usize"],
    "boolean": ["bool"], "bool": ["boolean"],
    "float": ["f32", "f64", "double"],
    "dictionary": ["dict", "map", "hashmap"], "map": ["dict", "hashmap"],
    "list": ["vec", "array", "slice"], "vector": ["vec"],
    "optional": ["option"], "option": ["optional"],
    # NL modifier words -> the signature tokens they appear as (the scored
    # leg drops df=0 alternatives, so over-mapping is safe)
    "mutable": ["mut"], "asynchronous": ["async"],
    "unsigned": ["u8", "u16", "u32", "u64", "usize"],
    "byte": ["u8"], "bytes": ["u8"], "character": ["char"],
    "path": ["pathbuf"], "paths": ["pathbuf"],
    "generic": ["impl", "dyn"],
}

#: Words that describe signature STRUCTURE rather than appearing in it:
#: "functions that return a string" — "return" marks the position, only
#: async/string-like tokens are literal signature text.
_SIG_SCAFFOLD = _STRUCT_SCAFFOLD | frozenset(
    """return returns returning returned take takes taking accept accepts
    accepting definition definitions defined argument arguments parameter
    parameters signature signatures type types""".split())


def signature_query(query: str) -> str:
    """Tokens of a structural query that should literally appear in a
    matching chunk's SIGNATURE (modifiers like async, type names, identifier
    arguments). Empty when fewer than 2 survive — a single generic token
    AND-matched over signatures is noise, not precision."""
    words = [w for w in (t.strip(",.?!:;()[]'\"") for t in query.split())
             if w and w.lower() not in _SIG_SCAFFOLD]
    return " ".join(words) if len(words) >= 2 else ""


_SIG_UNIT = re.compile(r"[^0-9A-Za-z_]+")


def sig_slots(query: str) -> list[list[str]]:
    """Predicate slots of a structural/type-filtered query for the scored
    signature leg (index/lexical.py::SignatureIndex). Each punctuation-free
    UNIT of a content word becomes a slot of acceptable signature tokens
    (the identifier-joined lowercase form, type synonyms, naive singular);
    a word with internal punctuation ("Vec<String>") additionally yields its
    fully-joined form ("vecstring") as a bonus slot, so exact adjacency
    outranks sigs that merely contain both types somewhere. Single-slot
    queries are kept ("functions with a CommandContext parameter" is one
    precious token — idf weighting, not a token count, decides its worth)."""
    slots: list[list[str]] = []
    for w in (t.strip(",.?!:;()[]'\"") for t in query.split()):
        if not w or w.lower() in _SIG_SCAFFOLD:
            continue
        units = [u for u in _SIG_UNIT.split(w) if u]
        for u in units:
            lu = u.lower()
            if lu in _SIG_SCAFFOLD or not lu.strip("_"):
                continue
            alts = {lu.replace("_", "")}
            alts.update(SIG_TYPE_SYNONYMS.get(lu, ()))
            if len(lu) > 3 and lu.endswith("s") and not lu.endswith("ss"):
                alts.add(lu[:-1])
            slots.append(sorted(alts))
        if len(units) > 1:
            slots.append(["".join(units).replace("_", "").lower()])
    return slots


def concept_core(query: str) -> str:
    """The cross-language query minus language names and X-vs-Y scaffolding,
    for an extra lexical leg over the concept terms alone. Returns "" when
    fewer than 2 content tokens survive (no leg)."""
    words = [w for w in (t.strip(",.?!:;()[]'\"") for t in query.split())
             if w and w.lower() not in _XLANG_STRIP]
    return " ".join(words) if len(words) >= 2 else ""

# chunk-type hint vocabulary -> ChunkType (ref: extract_type_hints)
_TYPE_HINT_WORDS: dict[str, ChunkType] = {
    "struct": ChunkType.STRUCT, "structs": ChunkType.STRUCT,
    "enum": ChunkType.ENUM, "enums": ChunkType.ENUM,
    "class": ChunkType.CLASS, "classes": ChunkType.CLASS,
    "interface": ChunkType.TRAIT, "interfaces": ChunkType.TRAIT,
    "trait": ChunkType.TRAIT, "traits": ChunkType.TRAIT,
    "protocol": ChunkType.TRAIT, "protocols": ChunkType.TRAIT,
    "constant": ChunkType.CONST, "constants": ChunkType.CONST,
    "macro": ChunkType.MACRO, "macros": ChunkType.MACRO,
    "module": ChunkType.MODULE, "modules": ChunkType.MODULE,
}
_TYPE_FILTER_QUANTIFIERS = frozenset("all every each list show find".split())

#: Self-sufficient hint PHRASES (substring match), mirroring the reference's
#: per-ChunkType ``hints = [...]`` table (src/language/mod.rs:708-771, matched
#: by Aho-Corasick substring search in router.rs:1295): the quantifier or
#: disambiguating noun is part of the phrase, so a match both extracts the
#: hint AND classifies TYPE_FILTERED without a separate quantifier word.
_TYPE_HINT_PHRASES: tuple[tuple[str, ChunkType], ...] = (
    ("type alias", ChunkType.TYPE_ALIAS),
    ("type aliases", ChunkType.TYPE_ALIAS),
    ("typedef", ChunkType.TYPE_ALIAS),
    ("impl block", ChunkType.IMPL),
    ("implementation block", ChunkType.IMPL),
    ("macro invocation", ChunkType.MACRO),
    ("macro_rules", ChunkType.MACRO),
    ("test function", ChunkType.TEST),
    ("test method", ChunkType.TEST),
)

_STRUCTURAL_PATTERNS = (
    re.compile(r"\b(functions?|methods?)\s+(that|which|with|returning)\b"),
    re.compile(r"\breturns?\s+[A-Za-z_]"),
    re.compile(r"\b(implements?|implementing|extends?|extending|derives?|deriving)\b"),
    re.compile(r"\bwith\s+(signature|parameters?|arguments?|generics?)\b"),
    re.compile(r"\btakes?\s+(a|an|two|three|\d+)?\s*[A-Za-z_]+\s+(as|argument|parameter)\b"),
)

_BEHAVIORAL_VERBS = frozenset(
    """validate validates validating parse parses parsing handle handles
    handling retry retries retrying compute computes computing convert
    converts converting send sends sending receive receives fetch fetches
    write writes writing read reads reading check checks checking log logs
    logging cache caches caching encode encodes decode decodes encrypt
    encrypts decrypt decrypts sanitize sanitizes render renders schedule
    schedules process processes processing""".split())

#: Unambiguous verbs added by the scaffold-aware check (router_verb_scaffold):
#: safe at any position — these words are verbs even leading a query
#: ("initialize a class by slicing shards").
_BEHAVIORAL_VERBS_V2 = _BEHAVIORAL_VERBS | frozenset(
    """evaluate evaluates migrate migrates generate generates calculate
    calculates create creates initialize initializes extract extracts
    resolve resolves dispatch dispatches collect collects normalize
    normalizes serialize serializes deserialize deserializes compare
    compares apply applies register registers""".split())

#: Noun-collision-prone verbs, accepted only in a verb POSITION — right
#: after a stripped scaffold prefix ("function to query X") or after
#: "functions that/which" — never leading a bare query ("query cache
#: invalidation" and "count sketch candidates" must stay non-behavioral).
_BEHAVIORAL_VERBS_EXT = _BEHAVIORAL_VERBS_V2 | frozenset(
    """build builds load loads save saves update updates delete deletes
    remove removes insert inserts format formats merge merges split splits
    filter filters sort sorts count counts track tracks walk walks print
    prints embed embeds map maps query queries look looks strip strips
    slice slices""".split())

#: Leading scaffold of a "function to <verb> ..." / "how does the code
#: <verb> ..." query: tokens skipped before the verb check (ref: the
#: reference's richer verb-phrase rules, src/search/router.rs:868 chain).
_VERB_SCAFFOLD_LEAD = frozenset(
    """a an the function functions method methods code that which to how
    does do system where what is are main helper utility""".split())

_CONCEPTUAL_MARKERS = frozenset(
    """pattern patterns architecture design concept approach strategy
    abstraction injection observer singleton factory lifecycle paradigm
    philosophy overview""".split())

_MULTI_STEP_CONNECTIVES = (" and then ", " as well as ", " and also ", " then ")

#: "functions that <verb> ..." — the word right after that/which decides
#: whether the query is shape-of-code (take/return/implement -> structural)
#: or shape-of-behavior (calculates/dispatches/walks -> behavioral).
_THAT_VERB = re.compile(r"\b(?:functions?|methods?)\s+(?:that|which)\s+(\w+)")

#: Trait-impl query phrasings ("impl Debug for ReferenceIndex",
#: "FromStr implementation for GatherDirection", "Display trait
#: implementation") — TYPE_FILTERED with an IMPL hint (ref: the per-ChunkType
#: hint phrases, src/language/mod.rs:708-771).
_IMPL_PHRASES = (
    re.compile(r"\bimpl\s+\w+\s+for\s+\w+"),
    re.compile(r"^impl\s+\w+"),
    re.compile(r"\b\w+\s+implementation\s+(?:for|of)\b"),
    re.compile(r"\b\w+\s+trait\s+implementation\b"),
)

_IDENT_CHARS = re.compile(r"^[A-Za-z_][A-Za-z0-9_:.\-]*$")

#: Declaration keywords users prepend to a name lookup ("fn cmd_audit_mode",
#: "def main") — stripped before the identifier-lookup check; their presence
#: is itself a strong signal the remaining token is a name.
_DECL_KEYWORDS = frozenset(
    "fn def func function fun method sub proc class struct trait impl let const var".split())


def _looks_like_identifier(word: str) -> bool:
    if not _IDENT_CHARS.match(word):
        return False
    return ("_" in word or "::" in word or "." in word
            or (any(c.isupper() for c in word[1:]) and any(c.islower() for c in word)))


# ---------------------------------------------------------------------------
# The classifier chain (priority order matches the reference)
# ---------------------------------------------------------------------------

def classify_query(query: str) -> Classification:
    lower = query.lower().strip()
    words = lower.split()
    raw_words = query.split()

    if not words:
        return Classification(Category.UNKNOWN, Confidence.LOW, Strategy.DENSE_DEFAULT)

    # 1. Negation (connective gate: the negation token must have a
    #    non-negation neighbor on at least one side)
    hit = next((i for i, w in enumerate(words) if w in NEGATION_TOKENS), None)
    if hit is not None:
        pre = any(w not in NEGATION_TOKENS for w in words[:hit])
        post = any(w not in NEGATION_TOKENS for w in words[hit + 1:])
        if pre or post:
            return Classification(Category.NEGATION, Confidence.HIGH, Strategy.DENSE_BASE)

    # 1b. Explicit uppercase "AND": a user writing "argparse AND --config
    #     argument" is marking a conjunction of requirements — multi_step's
    #     clause treatment, not structural's (r4 dev-triage miss 1; the
    #     lowercase " and " rules below only fire at >=2 occurrences
    #     because prose uses single "and" constantly — the CAPITALIZED
    #     token is an unambiguous operator).
    if default_limits.router_upper_and and "AND" in raw_words:
        return Classification(Category.MULTI_STEP, Confidence.MEDIUM,
                              Strategy.DENSE_DEFAULT)

    # 2. Identifier lookup: every token looks like a code identifier.
    #    Declaration keywords ("fn X", "def X") strip first — and when one was
    #    present, a single plain word also counts as a name ("def main").
    bare = [w for w in raw_words if w.lower() not in _DECL_KEYWORDS]
    had_decl_kw = len(bare) < len(raw_words)
    # a decl keyword + ONE bare word is a name lookup only when the word is
    # identifier-shaped or terse ("def main", "fn fmt") — "class hierarchy" /
    # "function composition" are conceptual phrases, not names
    if bare and len(bare) <= 3 and (
            all(_looks_like_identifier(w) for w in bare)
            or (had_decl_kw and len(bare) == 1 and _IDENT_CHARS.match(bare[0])
                and (_looks_like_identifier(bare[0]) or len(bare[0]) <= 4))):
        return Classification(Category.IDENTIFIER_LOOKUP, Confidence.HIGH,
                              Strategy.NAME_ONLY, name_query=" ".join(bare))

    # 3. Cross-language: >=2 language names, or a language name + marker
    langs = sum(1 for w in words if w.strip(",?") in _LANGUAGE_NAMES)
    if langs >= 2 or (langs >= 1 and any(m in lower for m in _CROSS_LANG_MARKERS)):
        return Classification(Category.CROSS_LANGUAGE, Confidence.HIGH, Strategy.DENSE_DEFAULT)

    # 4. Type-filtered: quantifier + type word ("all structs", "every enum"),
    #    or "test functions"
    if default_limits.router_impl_phrase and any(p.search(lower) for p in _IMPL_PHRASES):
        return Classification(Category.TYPE_FILTERED, Confidence.MEDIUM,
                              Strategy.DENSE_BASE, type_hints=[ChunkType.IMPL])
    hints = extract_type_hints(lower)
    if hints:
        has_quant = any(w in _TYPE_FILTER_QUANTIFIERS for w in words)
        bare_type_query = len(words) <= 3
        # a self-sufficient phrase hint ("type alias", "impl block") carries
        # its own disambiguation — no quantifier needed (ref hint phrases)
        if has_quant or bare_type_query or phrase_type_hints(lower):
            return Classification(Category.TYPE_FILTERED, Confidence.MEDIUM,
                                  Strategy.DENSE_BASE, type_hints=hints)

    # 5. Structural: "functions that return Result" etc. Question-form
    # queries ("how to implement a full text search table") are asking for
    # behavior/approach, not shape-of-code — the 'implements?' pattern must
    # not capture them (r3 dev triage: they landed on structural's alpha and
    # lost their semantic leg entirely).
    question_form = lower.startswith(("how ", "why ", "what ", "when ", "where "))
    if not question_form and any(p.search(lower) for p in _STRUCTURAL_PATTERNS):
        m = _THAT_VERB.search(lower) if default_limits.router_that_verb else None
        if m is not None and m.group(1) in _BEHAVIORAL_VERBS_EXT:
            # AND-conjunctions with a behavioral verb ("functions that build X
            # AND take Y") redirect too — an and-guard was built and measured:
            # excluding them erased the lever's entire pool win (+15 -> -1 at
            # k=5; the AND subset alone is +16q) against a 1-query R@1 cost on
            # the held-out gate. Pool evidence wins 16:1.
            return Classification(Category.BEHAVIORAL, Confidence.MEDIUM, Strategy.DENSE_BASE)
        return Classification(Category.STRUCTURAL, Confidence.MEDIUM,
                              Strategy.DENSE_TYPE_HINTS if hints else Strategy.DENSE_DEFAULT,
                              type_hints=hints)

    # 6. Behavioral: action-verb-led queries ("validates user input"). The
    #    scaffold-aware variant (router_verb_scaffold) widens the verb table
    #    and skips leading scaffold tokens ("function to evaluate a model",
    #    "how does the code parse X"); noun-collision-prone verbs only count
    #    in a verb position (after a stripped scaffold).
    verbs = _BEHAVIORAL_VERBS_V2 if default_limits.router_verb_scaffold else _BEHAVIORAL_VERBS

    def _verb_at(i: int) -> bool:
        # V2/EXT-added verbs need an object: noun compounds put the
        # verb-shaped word LAST ("command dispatch", "impact analysis
        # dispatch") — a real verb use has something after it. Base-table
        # verbs keep their long-measured behavior unguarded.
        w = words[i]
        return w in _BEHAVIORAL_VERBS or (w in verbs and i + 1 < len(words))

    if _verb_at(0) or (len(words) > 1 and _verb_at(1)):
        return Classification(Category.BEHAVIORAL, Confidence.MEDIUM, Strategy.DENSE_BASE)
    if default_limits.router_verb_scaffold:
        i = 0
        while i < len(words) and words[i] in _VERB_SCAFFOLD_LEAD:
            i += 1
        if 0 < i < len(words) and (
                words[i] in _BEHAVIORAL_VERBS
                or (words[i] in _BEHAVIORAL_VERBS_EXT and i + 1 < len(words))):
            return Classification(Category.BEHAVIORAL, Confidence.MEDIUM, Strategy.DENSE_BASE)

    # 7. Conceptual: abstract concept vocabulary
    if any(w in _CONCEPTUAL_MARKERS for w in words):
        return Classification(Category.CONCEPTUAL, Confidence.MEDIUM, Strategy.DENSE_BASE)

    # 8. Multi-step: multiple clauses joined by connectives
    if any(c in lower for c in _MULTI_STEP_CONNECTIVES) or lower.count(" and ") >= 2:
        return Classification(Category.MULTI_STEP, Confidence.MEDIUM, Strategy.DENSE_DEFAULT)

    return Classification(Category.UNKNOWN, Confidence.LOW, Strategy.DENSE_DEFAULT,
                          type_hints=hints)


def extract_type_hints(lower_query: str) -> list[ChunkType] | None:
    hints: list[ChunkType] = []
    words = re.findall(r"[a-z_+#]+", lower_query)
    for i, w in enumerate(words):
        ct = _TYPE_HINT_WORDS.get(w)
        if ct is not None and ct not in hints:
            hints.append(ct)
        if w in ("test", "tests") and i + 1 < len(words) and words[i + 1] in ("function", "functions"):
            if ChunkType.TEST not in hints:
                hints.append(ChunkType.TEST)
        if w in ("functions", "function") and (i == 0 or words[i - 1] in _TYPE_FILTER_QUANTIFIERS):
            if ChunkType.FUNCTION not in hints:
                hints.append(ChunkType.FUNCTION)
    for phrase, ct in _TYPE_HINT_PHRASES:
        if phrase in lower_query and ct not in hints:
            hints.append(ct)
    return hints or None


def phrase_type_hints(lower_query: str) -> list[ChunkType]:
    """Hints from the self-sufficient PHRASE table only (see
    _TYPE_HINT_PHRASES) — a phrase match classifies TYPE_FILTERED on its own,
    where bare words like 'class' need a quantifier."""
    return [ct for phrase, ct in _TYPE_HINT_PHRASES if phrase in lower_query]


# ---------------------------------------------------------------------------
# Centroid reclassifier
# ---------------------------------------------------------------------------

class CentroidClassifier:
    """Per-category embedding centroids; refines Unknown rule results.

    File format (JSON): ``{"model_fingerprint": ..., "centroids":
    {"behavioral": [f32...], ...}}``  (ref: classifier_centroids.v1.json).
    """

    def __init__(self, centroids: dict[Category, np.ndarray], fingerprint: str = ""):
        self.fingerprint = fingerprint
        self.categories = list(centroids)
        mat = np.stack([centroids[c] for c in self.categories]).astype(np.float32)
        self.matrix = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-12)

    @classmethod
    def load(cls, path: str | Path) -> "CentroidClassifier | None":
        path = Path(path)
        if not path.is_file():
            return None
        try:
            data = json.loads(path.read_text())
            cents = {parse_category(k): np.asarray(v, dtype=np.float32)
                     for k, v in data.get("centroids", {}).items()}
            if not cents:
                return None
            return cls(cents, fingerprint=data.get("model_fingerprint", ""))
        except (json.JSONDecodeError, ValueError, KeyError):
            return None

    @classmethod
    def load_packaged(cls, fingerprint: str) -> "CentroidClassifier | None":
        """The artifact shipped with the package (ref ships
        ``classifier_centroids.v1.json`` to the data dir,
        ``src/search/router.rs:1315``). Only valid for the exact embedder it
        was trained with — fingerprint mismatch returns None."""
        path = Path(__file__).resolve().parent.parent / "data" / "classifier_centroids.v1.json"
        clf = cls.load(path)
        if clf is None or clf.fingerprint != fingerprint:
            return None
        return clf

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        data = {
            "model_fingerprint": self.fingerprint,
            "centroids": {c.value: self.matrix[i].tolist()
                          for i, c in enumerate(self.categories)},
        }
        path.write_text(json.dumps(data))

    @classmethod
    def train(cls, labeled: list[tuple[Category, np.ndarray]], fingerprint: str = ""
              ) -> "CentroidClassifier":
        """Mean-of-embeddings centroid per category."""
        groups: dict[Category, list[np.ndarray]] = {}
        for cat, vec in labeled:
            groups.setdefault(cat, []).append(np.asarray(vec, dtype=np.float32))
        cents = {c: np.mean(vs, axis=0) for c, vs in groups.items()}
        return cls(cents, fingerprint)

    def classify(self, query_vec: np.ndarray, margin: float | None = None
                 ) -> Category | None:
        """Top-1 centroid by cosine, requiring a margin over the runner-up."""
        margin = margin if margin is not None else default_limits.centroid_margin
        q = np.asarray(query_vec, dtype=np.float32)
        q = q / max(float(np.linalg.norm(q)), 1e-12)
        sims = self.matrix @ q
        order = np.argsort(-sims)
        if len(order) >= 2 and sims[order[0]] - sims[order[1]] < margin:
            return None
        return self.categories[int(order[0])]


def reclassify_with_centroid(cls_result: Classification, query_vec: np.ndarray,
                             centroids: CentroidClassifier | None,
                             lim: Limits | None = None) -> Classification:
    """Fill Unknown classifications from centroid space (ref:
    reclassify_with_centroid + alpha floor on reroute)."""
    lim = lim or default_limits
    if centroids is None or lim.disable_centroids:
        return cls_result
    if cls_result.category is not Category.UNKNOWN:
        return cls_result
    cat = centroids.classify(query_vec)
    if cat is None or cat is Category.UNKNOWN:
        return cls_result
    if cat is Category.IDENTIFIER_LOOKUP and not lim.centroid_emit_identifier:
        # The rule chain already catches real identifiers with 94% recall
        # (megapool audit); what the centroid adds here is mostly conceptual
        # noun-phrases ("cosine similarity implementation") that would lose
        # their FTS RRF legs under the identifier treatment.
        return cls_result
    strategy = {
        Category.BEHAVIORAL: Strategy.DENSE_BASE,
        Category.CONCEPTUAL: Strategy.DENSE_BASE,
        Category.NEGATION: Strategy.DENSE_BASE,
    }.get(cat, Strategy.DENSE_DEFAULT)
    return Classification(cat, Confidence.MEDIUM, strategy,
                          type_hints=cls_result.type_hints, rerouted_by_centroid=True)


def resolve_alpha(classification: Classification,
                  overrides: dict[str, float] | None = None,
                  lim: Limits | None = None) -> float:
    """Category alpha with config overrides; centroid-rerouted queries get an
    alpha floor (ref: resolve_splade_alpha, router.rs:708)."""
    lim = lim or default_limits
    cat = classification.category
    alpha = DEFAULT_ALPHA[cat]
    explicit = overrides.get(cat.value) if overrides else None
    if explicit is not None:
        alpha = float(explicit)
    if classification.rerouted_by_centroid and explicit is None:
        # The floor protects DEFAULT alphas from low-confidence reroutes
        # (ref: router.rs:708). A measured per-category override (e.g. the
        # lexical tier's pure-sparse structural setting) outranks it — a 0.7
        # dense floor assumes a trained dense leg.
        alpha = max(alpha, lim.centroid_alpha_floor)
    if lim.disable_splade:
        alpha = 1.0
    return alpha
