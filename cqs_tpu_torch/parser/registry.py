"""Declarative language registry.

Reference analog: ``LanguageDef`` + ``REGISTRY`` (``src/language/mod.rs:287-400,
1290``) — per-language grammar hooks, extensions, chunk/call/type queries,
test patterns, and stopword/common-type lists, consumed by the parser engine.

The reference drives tree-sitter queries; our engine is a masked-source
regex + block-matching parser (Python uses the stdlib ``ast`` module instead).
Each :class:`LanguageDef` declares *what* a declaration looks like; the engine
in ``generic.py`` handles comments/strings, block extents, nesting, doc
comments, calls and type refs uniformly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from cqs_tpu_torch.parser.types import ChunkType


@dataclass(frozen=True)
class DeclPattern:
    """One declaration shape: a compiled regex with a ``name`` group, the
    chunk type it produces, and whether it can contain nested methods."""

    regex: re.Pattern
    chunk_type: ChunkType
    container: bool = False          # can hold method children
    return_group: str | None = None  # regex group holding a return type
    member_only: bool = False        # only matched inside a container body
    statement_ok: bool = False       # may end at `;`/newline instead of a brace block


def _d(pattern: str, ct: ChunkType, container: bool = False, ret: str | None = None,
       member_only: bool = False, statement_ok: bool = False) -> DeclPattern:
    return DeclPattern(re.compile(pattern, re.M), ct, container, ret, member_only, statement_ok)


@dataclass(frozen=True)
class LanguageDef:
    name: str
    extensions: tuple[str, ...]
    style: str                        # brace | end | python | markdown | config
    decls: tuple[DeclPattern, ...] = ()
    line_comment: str = "//"
    doc_prefixes: tuple[str, ...] = ("///", "/**", "*", "//!")
    block_comment: tuple[str, str] | None = ("/*", "*/")
    string_delims: tuple[str, ...] = ('"', "'")
    raw_string: str | None = None     # e.g. rust r#"
    #: delims whose literals legally span lines (rust plain ", go/js backtick)
    multiline_delims: tuple[str, ...] = ()
    #: `'` only opens well-formed char literals ('a', '\n'); bare `'` is a
    #: lifetime (Rust) / rune prefix and must NOT open a string mask.
    single_quote_char_only: bool = False
    #: For ``end``-style languages whose block delimiters aren't the Ruby-ish
    #: defaults (VB.NET's ``End Sub``, Structured Text's ``END_FUNCTION``):
    #: regex strings for block openers and closers, counted per line.
    end_openers: str | None = None
    end_close: str | None = None
    #: Regions whose member declarations are BODYLESS (VB.NET Interface:
    #: a member Sub has no End Sub) — openers/closers inside are not counted.
    end_suspend_open: str | None = None
    end_suspend_close: str | None = None
    keywords: frozenset = frozenset()
    test_name_patterns: tuple[str, ...] = ("test_", "_test")
    test_attr_patterns: tuple[str, ...] = ()   # attribute/decorator lines marking tests
    common_types: frozenset = frozenset()      # stdlib types excluded from type edges
    entry_points: tuple[str, ...] = ("main",)
    #: substrings marking HTTP/RPC endpoint declarations (ref: LanguageDef
    #: endpoint markers) — matched against chunk bodies by `onboard`
    endpoint_markers: tuple[str, ...] = ()
    #: per-language human-name overrides for NL generation: a SQL "struct"
    #: is a *table* to anyone querying it ("sqlite schema", "table named X")
    human_names: dict = field(default_factory=dict)
    #: Call-site blocklist override. `keywords` is a coarse cross-language
    #: union that blocks names that are REAL callees elsewhere (Rust's
    #: `Vec::new()`, `.len()`, `format!` were all eaten by the C/Go/Swift
    #: entries — measured 24% call-edge recall loss on the reference corpus,
    #: audit_calls_rust r5). When set, extract_calls uses this instead.
    call_keywords: frozenset | None = None


# True Rust reserved words (2021 edition + reserved): the precise call-site
# blocklist for Rust — anything outside this set can legally name a fn/method/
# macro. `match (tuple)` parens made the coarse list's omission of `match` a
# phantom-edge source too (audit_calls_rust).
_RUST_RESERVED = frozenset(
    """as break const continue crate dyn else enum extern false fn for if impl
    in let loop match mod move mut pub ref return self Self static struct super
    trait true type unsafe use where while async await union macro yield try
    box abstract become do final macro_rules override priv typeof unsized
    virtual""".split())

# Shared keyword sets (used to filter false-positive "calls")
_C_KEYWORDS = frozenset(
    """if else for while do switch case return break continue goto sizeof typeof
    new delete throw try catch finally default static const void int char float
    double long short unsigned signed struct union enum typedef class public
    private protected virtual override template typename using namespace
    operator this true false null nullptr assert defined alignof decltype
    and or not await async yield in of instanceof function let var super
    with match loop unsafe move ref mut impl fn pub use mod crate self Self
    where dyn box println print panic assert_eq assert_ne vec format write
    writeln type interface package import export from extends implements
    readonly declare abstract get set require module defer go select chan map
    range len cap make append copy close print println string bool byte rune
    error int8 int16 int32 int64 uint uint8 uint16 uint32 uint64 float32
    float64 complex64 complex128 uintptr panic recover elif lambda pass raise
    global nonlocal del except is None True False then end local repeat until
    nil next redo retry ensure rescue begin unless when fun val out inout
    init deinit guard extension protocol subscript typealias associatedtype
    lazy weak strong final open sealed data object companion constructor
    suspend inline noinline reified annotation tailrec expect actual""".split()
)

_REGISTRY: dict[str, LanguageDef] = {}
_BY_EXT: dict[str, LanguageDef] = {}


def register(lang: LanguageDef) -> LanguageDef:
    _REGISTRY[lang.name] = lang
    for ext in lang.extensions:
        _BY_EXT[ext] = lang
    return lang


def get_language(name: str) -> LanguageDef | None:
    return _REGISTRY.get(name)


def language_for_path(path: str) -> LanguageDef | None:
    p = str(path).lower()
    best: LanguageDef | None = None
    best_len = 0
    for ext, lang in _BY_EXT.items():
        # longest suffix wins: "cmakelists.txt" beats ".txt"
        if p.endswith(ext) and len(ext) > best_len:
            best, best_len = lang, len(ext)
    return best


def all_languages() -> list[LanguageDef]:
    return list(_REGISTRY.values())


# ---------------------------------------------------------------------------
# Language definitions
# ---------------------------------------------------------------------------

_IDENT = r"[A-Za-z_][A-Za-z0-9_]*"

register(LanguageDef(
    name="python",
    extensions=(".py", ".pyi"),
    style="python",
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=None,
    keywords=_C_KEYWORDS,
    test_name_patterns=("test_",),
    test_attr_patterns=("@pytest", "@unittest"),
    common_types=frozenset("str int float bool list dict set tuple bytes object Any Optional Union List Dict Set Tuple".split()),
    entry_points=("main", "__main__", "cli", "app"),
    endpoint_markers=("@app.route", "@app.get", "@app.post", "@router.get", "@router.post", "@api_view", "path(", "url("),
))

register(LanguageDef(
    name="rust",
    single_quote_char_only=True,
    extensions=(".rs",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:pub(?:\([^)]*\))?\s+)?(?:async\s+)?(?:unsafe\s+)?(?:extern\s+\"[^\"]*\"\s+)?fn\s+(?P<name>{_IDENT})", ChunkType.FUNCTION, ret="ret"),
        _d(rf"^[ \t]*(?:pub(?:\([^)]*\))?\s+)?struct\s+(?P<name>{_IDENT})", ChunkType.STRUCT, statement_ok=True),
        _d(rf"^[ \t]*(?:pub(?:\([^)]*\))?\s+)?enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
        _d(rf"^[ \t]*(?:pub(?:\([^)]*\))?\s+)?(?:unsafe\s+)?trait\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*impl(?:\s*<[^>]*>)?\s+(?:(?P<trait>[A-Za-z_][A-Za-z0-9_:<>, ]*?)\s+for\s+)?(?P<name>{_IDENT})", ChunkType.IMPL, container=True),
        _d(rf"^[ \t]*(?:pub(?:\([^)]*\))?\s+)?mod\s+(?P<name>{_IDENT})\s*\{{", ChunkType.MODULE, container=True),
        _d(rf"^[ \t]*(?:pub(?:\([^)]*\))?\s+)?(?:const|static)\s+(?P<name>{_IDENT})\s*:", ChunkType.CONST),
        _d(rf"^[ \t]*(?:pub(?:\([^)]*\))?\s+)?type\s+(?P<name>{_IDENT})\s*=", ChunkType.TYPE_ALIAS),
        _d(rf"^[ \t]*macro_rules!\s+(?P<name>{_IDENT})", ChunkType.MACRO),
    ),
    doc_prefixes=("///", "//!"),
    raw_string='r"',
    multiline_delims=('"',),
    keywords=_C_KEYWORDS,
    call_keywords=_RUST_RESERVED,
    test_attr_patterns=("#[test]", "#[tokio::test]", "#[rstest"),
    common_types=frozenset("String Vec Option Result Box Rc Arc HashMap HashSet BTreeMap BTreeSet Cow PathBuf Path str u8 u16 u32 u64 i8 i16 i32 i64 f32 f64 usize isize bool char Self".split()),
    endpoint_markers=("#[get(", "#[post(", "#[put(", "#[delete(", ".route(", "Router::new"),
))

register(LanguageDef(
    name="go",
    single_quote_char_only=True,
    extensions=(".go",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*func\s+(?:\((?P<recv>[^)]*)\)\s+)?(?P<name>{_IDENT})\s*(?:\[[^\]]*\])?\s*\(", ChunkType.FUNCTION),
        _d(rf"^[ \t]*type\s+(?P<name>{_IDENT})(?:\[[^\]]*\])?\s+struct\b", ChunkType.STRUCT),
        _d(rf"^[ \t]*type\s+(?P<name>{_IDENT})(?:\[[^\]]*\])?\s+interface\b", ChunkType.TRAIT),
        _d(rf"^[ \t]*type\s+(?P<name>{_IDENT})\s+(?!struct|interface)\S", ChunkType.TYPE_ALIAS),
        _d(rf"^[ \t]*(?:const|var)\s+(?P<name>{_IDENT})\s*=", ChunkType.CONST),
    ),
    doc_prefixes=("//",),
    string_delims=('"', "'", "`"),
    multiline_delims=("`",),
    keywords=_C_KEYWORDS,
    test_name_patterns=("Test", "Benchmark", "Fuzz"),
    common_types=frozenset("string int int64 error bool byte rune float64 map chan".split()),
    endpoint_markers=("HandleFunc(", ".Handle(", ".GET(", ".POST(", ".PUT("),
    entry_points=("main", "init"),
))

_JS_DECLS = (
    _d(rf"^[ \t]*(?:export\s+)?(?:default\s+)?(?:async\s+)?function\s*\*?\s*(?P<name>{_IDENT})", ChunkType.FUNCTION),
    _d(rf"^[ \t]*(?:export\s+)?(?:default\s+)?(?:abstract\s+)?class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
    _d(rf"^[ \t]*(?:export\s+)?(?:const|let|var)\s+(?P<name>{_IDENT})\s*=\s*(?:async\s*)?(?:\([^)]*\)|{_IDENT})\s*=>", ChunkType.FUNCTION, statement_ok=True),
    _d(rf"^[ \t]*(?:export\s+)?(?:const|let|var)\s+(?P<name>{_IDENT})\s*=\s*(?:async\s+)?function\b", ChunkType.FUNCTION),
    # bare class methods: `async get(id) { ... }` — container scope only
    _d(rf"^[ \t]*(?:public\s+|private\s+|protected\s+|static\s+|async\s+|get\s+|set\s+|\*\s*)*(?P<name>[A-Za-z_$][A-Za-z0-9_$]*)\s*\([^)]*\)\s*(?::[^{{;]+)?\{{", ChunkType.METHOD, member_only=True),
    _d(rf"^[ \t]*(?:export\s+)?interface\s+(?P<name>{_IDENT})", ChunkType.TRAIT),
    _d(rf"^[ \t]*(?:export\s+)?enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
    _d(rf"^[ \t]*(?:export\s+)?type\s+(?P<name>{_IDENT})\s*=", ChunkType.TYPE_ALIAS),
)

register(LanguageDef(
    name="javascript",
    extensions=(".js", ".jsx", ".mjs", ".cjs"),
    style="brace",
    decls=_JS_DECLS,
    string_delims=('"', "'", "`"),
    multiline_delims=("`",),
    keywords=_C_KEYWORDS,
    test_name_patterns=("test", "spec"),
    common_types=frozenset("String Number Boolean Object Array Promise Map Set".split()),
    entry_points=("main", "index", "handler", "start"),
    endpoint_markers=("app.get(", "app.post(", "app.put(", "router.get(", "router.post(", "createServer"),
))

register(LanguageDef(
    name="typescript",
    extensions=(".ts", ".tsx", ".mts", ".cts"),
    style="brace",
    decls=_JS_DECLS,
    string_delims=('"', "'", "`"),
    multiline_delims=("`",),
    keywords=_C_KEYWORDS,
    test_name_patterns=("test", "spec"),
    common_types=frozenset("string number boolean object any unknown never void Promise Array Map Set Record Partial".split()),
    entry_points=("main", "index", "handler", "bootstrap"),
    endpoint_markers=("app.get(", "app.post(", "router.get(", "router.post(", "@Get(", "@Post(", "@Controller"),
))

register(LanguageDef(
    name="java",
    single_quote_char_only=True,
    extensions=(".java",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:public\s+|private\s+|protected\s+)?(?:static\s+)?(?:final\s+|abstract\s+|sealed\s+|non-sealed\s+)*class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|protected\s+)?(?:sealed\s+|non-sealed\s+)?interface\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|protected\s+)?enum\s+(?P<name>{_IDENT})", ChunkType.ENUM, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|protected\s+)?(?:static\s+|final\s+)*record\s+(?P<name>{_IDENT})\s*[(<]", ChunkType.CLASS, container=True, statement_ok=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|protected\s+)?(?:static\s+|final\s+|synchronized\s+|native\s+|abstract\s+|default\s+)*(?:<[^<>]*(?:<[^<>]*>[^<>]*)*>\s+)?(?P<ret>[A-Za-z_][A-Za-z0-9_.<>\[\], ]*)\s+(?P<name>{_IDENT})\s*\((?:[^;]*?$|[^()]*\)\s*[;{{])", ChunkType.METHOD, ret="ret"),
    ),
    keywords=_C_KEYWORDS,
    test_attr_patterns=("@Test", "@ParameterizedTest"),
    common_types=frozenset("String Integer Long Double Float Boolean Object List Map Set ArrayList HashMap void int long double float boolean byte short char".split()),
    endpoint_markers=("@GetMapping", "@PostMapping", "@RequestMapping", "@Path("),
))

register(LanguageDef(
    name="c",
    single_quote_char_only=True,
    extensions=(".c", ".h"),
    style="brace",
    decls=(
        _d(rf"^(?:static\s+|inline\s+|extern\s+)*(?P<ret>{_IDENT}[A-Za-z0-9_* ]*?)\s+\*?(?P<name>{_IDENT})\s*\([^;]*\)\s*\{{", ChunkType.FUNCTION, ret="ret"),
        _d(rf"^[ \t]*(?:typedef\s+)?struct\s+(?P<name>{_IDENT})\s*\{{", ChunkType.STRUCT),
        _d(rf"^[ \t]*(?:typedef\s+)?enum\s+(?P<name>{_IDENT})\s*\{{", ChunkType.ENUM),
        _d(rf"^[ \t]*#define\s+(?P<name>{_IDENT})\(", ChunkType.MACRO),
    ),
    keywords=_C_KEYWORDS,
    common_types=frozenset("int char float double void long short unsigned size_t uint8_t uint16_t uint32_t uint64_t int8_t int16_t int32_t int64_t bool FILE".split()),
))

register(LanguageDef(
    name="cpp",
    single_quote_char_only=True,
    extensions=(".cc", ".cpp", ".cxx", ".hpp", ".hh", ".hxx", ".cu", ".cuh"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:template\s*<[^>]*>\s*)?(?:class|struct)\s+(?P<name>{_IDENT})\s*(?::[^{{;]*)?\{{", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*enum\s+(?:class\s+)?(?P<name>{_IDENT})", ChunkType.ENUM),
        _d(rf"^[ \t]*namespace\s+(?P<name>{_IDENT})\s*\{{", ChunkType.MODULE, container=True),
        _d(rf"^(?:[A-Za-z_][A-Za-z0-9_:<>,&* ]*?)\s+(?P<name>{_IDENT}(?:::{_IDENT})?)\s*\([^;]*\)\s*(?:const\s*)?(?:noexcept\s*)?(?:->\s*[^{{;]+)?\{{", ChunkType.FUNCTION),
        _d(rf"^[ \t]*using\s+(?P<name>{_IDENT})\s*=", ChunkType.TYPE_ALIAS),
        _d(rf"^[ \t]*#define\s+(?P<name>{_IDENT})\(", ChunkType.MACRO),
    ),
    keywords=_C_KEYWORDS,
    common_types=frozenset("int char float double void long bool size_t string vector map set unique_ptr shared_ptr std".split()),
))

register(LanguageDef(
    name="csharp",
    single_quote_char_only=True,
    extensions=(".cs",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:\[[^\]]*\]\s*)*(?:public\s+|private\s+|protected\s+|internal\s+)*(?:static\s+|sealed\s+|abstract\s+|partial\s+)*class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+)*interface\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+)*(?:static\s+|sealed\s+|abstract\s+|partial\s+|readonly\s+|ref\s+)*(?:record\s+(?:struct\s+|class\s+)?|struct\s+)(?P<name>{_IDENT})", ChunkType.STRUCT, container=True, statement_ok=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+)*enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
        _d(rf"^[ \t]*(?:public\s+|private\s+|protected\s+|internal\s+)+(?:static\s+|async\s+|virtual\s+|override\s+|sealed\s+|partial\s+)*(?P<ret>[A-Za-z_][A-Za-z0-9_.<>\[\], ]*)\s+(?P<name>{_IDENT})\s*\(", ChunkType.METHOD, ret="ret"),
    ),
    keywords=_C_KEYWORDS,
    test_attr_patterns=("[Test]", "[Fact]", "[Theory]"),
    common_types=frozenset("string int long double bool object void var List Dictionary Task".split()),
    entry_points=("Main",),
    endpoint_markers=("[HttpGet", "[HttpPost", "[Route", "MapGet(", "MapPost("),
))

register(LanguageDef(
    name="ruby",
    extensions=(".rb", ".rake"),
    style="end",
    decls=(
        _d(rf"^[ \t]*def\s+(?:self\.)?(?P<name>{_IDENT}[?!]?)", ChunkType.FUNCTION),
        _d(rf"^[ \t]*class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*module\s+(?P<name>{_IDENT})", ChunkType.MODULE, container=True),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=("=begin", "=end"),
    keywords=_C_KEYWORDS,
    test_name_patterns=("test_",),
))

register(LanguageDef(
    name="lua",
    extensions=(".lua",),
    style="end",
    decls=(
        _d(rf"^[ \t]*(?:local\s+)?function\s+(?P<name>{_IDENT}(?:[.:]{_IDENT})*)", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:local\s+)?(?P<name>{_IDENT})\s*=\s*function\b", ChunkType.FUNCTION),
    ),
    line_comment="--",
    doc_prefixes=("--",),
    block_comment=("--[[", "]]"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="php",
    extensions=(".php",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:(?:abstract|final|public|private|protected|static)\s+)*function\s+&?(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:abstract\s+|final\s+)?class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*interface\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*trait\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*(?:final\s+)?enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
    ),
    line_comment="//",
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="swift",
    single_quote_char_only=True,
    extensions=(".swift",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+|open\s+|fileprivate\s+)?(?:static\s+|final\s+|override\s+|mutating\s+|nonmutating\s+|class\s+|convenience\s+|required\s+)*func\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:public\s+|open\s+)?(?:final\s+)?class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+|fileprivate\s+)?struct\s+(?P<name>{_IDENT})", ChunkType.STRUCT, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+)?(?:indirect\s+)?enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+)?protocol\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+|fileprivate\s+)?extension\s+(?P<name>{_IDENT})", ChunkType.IMPL, container=True),
    ),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="kotlin",
    single_quote_char_only=True,
    extensions=(".kt", ".kts"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+|protected\s+)?(?:suspend\s+|inline\s+|tailrec\s+|override\s+|abstract\s+|open\s+|operator\s+|infix\s+|external\s+|final\s+)*fun\s+(?:<[^>]+>\s+)?(?:{_IDENT}(?:<[^>]*>)?\.)?(?P<name>{_IDENT})(?!\s+interface)", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+)?(?:data\s+|sealed\s+|open\s+|abstract\s+|inner\s+|value\s+)*class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True, statement_ok=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+|internal\s+)?(?:sealed\s+|fun\s+)?interface\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*(?:public\s+|private\s+)?(?:companion\s+)?object\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True, statement_ok=True),
        _d(rf"^[ \t]*enum\s+class\s+(?P<name>{_IDENT})", ChunkType.ENUM),
    ),
    keywords=_C_KEYWORDS,
    test_attr_patterns=("@Test",),
))

register(LanguageDef(
    name="scala",
    single_quote_char_only=True,
    extensions=(".scala",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:private\s+|protected\s+)?def\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:case\s+)?class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*(?:case\s+)?object\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*trait\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
    ),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="shell",
    extensions=(".sh", ".bash", ".zsh"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:function\s+)?(?P<name>{_IDENT})\s*\(\)\s*\{{", ChunkType.FUNCTION),
        _d(rf"^[ \t]*function\s+(?P<name>{_IDENT})\s*\{{", ChunkType.FUNCTION),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=None,
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="markdown",
    extensions=(".md", ".markdown", ".mdx", ".rst", ".txt"),
    style="markdown",
    line_comment="",
    block_comment=None,
))

register(LanguageDef(
    name="config",
    extensions=(".toml", ".yaml", ".yml", ".json", ".ini", ".cfg"),
    style="config",
    line_comment="#",
    block_comment=None,
))

register(LanguageDef(
    name="html",
    extensions=(".html", ".htm", ".vue", ".svelte"),
    style="web",
    line_comment="",
    block_comment=("<!--", "-->"),
))

register(LanguageDef(
    name="aspx",
    extensions=(".aspx", ".ascx", ".cshtml", ".razor"),
    style="web",
    line_comment="",
    block_comment=("<!--", "-->"),
))

register(LanguageDef(
    name="l5x",
    extensions=(".l5x", ".l5k"),
    style="l5x",
    line_comment="",
    block_comment=None,
))

register(LanguageDef(
    name="sql",
    extensions=(".sql",),
    style="brace",
    decls=(
        # DDL kinds split so NL speaks the user's vocabulary: a table/view/
        # index/trigger chunk's head word is "table" (human_names override,
        # the dominant query surface form — "sqlite schema", "table named X");
        # stored functions/procedures are real callables (ref: StoredProc)
        _d(r"^[ \t]*CREATE\s+(?:OR\s+REPLACE\s+)?(?:TEMP(?:ORARY)?\s+)?(?:FUNCTION|PROCEDURE)\s+(?:IF\s+NOT\s+EXISTS\s+)?[\"`]?(?P<name>[A-Za-z_][A-Za-z0-9_.]*)", ChunkType.FUNCTION, statement_ok=True),
        _d(r"^[ \t]*CREATE\s+(?:OR\s+REPLACE\s+)?(?:VIRTUAL\s+)?(?:TEMP(?:ORARY)?\s+)?(?:UNIQUE\s+)?(?:TABLE|VIEW|INDEX|TRIGGER)\s+(?:IF\s+NOT\s+EXISTS\s+)?[\"`]?(?P<name>[A-Za-z_][A-Za-z0-9_.]*)", ChunkType.STRUCT, statement_ok=True),
    ),
    line_comment="--",
    doc_prefixes=("--",),
    keywords=_C_KEYWORDS,
    human_names={ChunkType.STRUCT: "table"},
))


# ---------------------------------------------------------------------------
# Extended language coverage (wave 2)
# ---------------------------------------------------------------------------

register(LanguageDef(
    name="perl",
    extensions=(".pl", ".pm"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*sub\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*package\s+(?P<name>[A-Za-z_][A-Za-z0-9_:]*)\s*;", ChunkType.MODULE, statement_ok=True),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=("=pod", "=cut"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="elixir",
    extensions=(".ex", ".exs"),
    style="end",
    decls=(
        _d(rf"^[ \t]*defp?\s+(?P<name>{_IDENT}[?!]?)", ChunkType.FUNCTION),
        _d(rf"^[ \t]*defmodule\s+(?P<name>[A-Za-z_][A-Za-z0-9_.]*)", ChunkType.MODULE, container=True),
    ),
    line_comment="#",
    doc_prefixes=("#", "@doc", "@moduledoc"),
    block_comment=None,
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="erlang",
    extensions=(".erl", ".hrl"),
    style="brace",
    decls=(
        _d(rf"^(?P<name>[a-z][A-Za-z0-9_]*)\s*\([^)]*\)\s*->", ChunkType.FUNCTION, statement_ok=True),
        _d(rf"^-module\((?P<name>{_IDENT})\)", ChunkType.MODULE, statement_ok=True),
    ),
    line_comment="%",
    doc_prefixes=("%%", "%"),
    block_comment=None,
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="haskell",
    extensions=(".hs",),
    style="brace",
    decls=(
        _d(rf"^(?P<name>[a-z][A-Za-z0-9_']*)\s*::", ChunkType.FUNCTION, statement_ok=True),
        _d(rf"^data\s+(?P<name>[A-Z][A-Za-z0-9_']*)", ChunkType.STRUCT, statement_ok=True),
        _d(rf"^newtype\s+(?P<name>[A-Z][A-Za-z0-9_']*)", ChunkType.TYPE_ALIAS, statement_ok=True),
        _d(rf"^class\s+(?:[A-Za-z ]+=>\s*)?(?P<name>[A-Z][A-Za-z0-9_']*)", ChunkType.TRAIT, statement_ok=True),
        _d(rf"^module\s+(?P<name>[A-Z][A-Za-z0-9_.']*)", ChunkType.MODULE, statement_ok=True),
    ),
    line_comment="--",
    doc_prefixes=("--", "-- |"),
    block_comment=("{-", "-}"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="zig",
    extensions=(".zig",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:pub\s+)?(?:export\s+)?fn\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:pub\s+)?const\s+(?P<name>{_IDENT})\s*=\s*struct\b", ChunkType.STRUCT),
        _d(rf"^[ \t]*(?:pub\s+)?const\s+(?P<name>{_IDENT})\s*=\s*enum\b", ChunkType.ENUM),
        _d(rf"^[ \t]*(?:pub\s+)?const\s+(?P<name>{_IDENT})\s*=", ChunkType.CONST, statement_ok=True),
    ),
    single_quote_char_only=True,
    doc_prefixes=("///", "//!"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="dart",
    extensions=(".dart",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:abstract\s+)?class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*(?:Future<[^>]*>|void|int|double|String|bool|{_IDENT}<[^>]*>|{_IDENT})\??\s+(?P<name>{_IDENT})\s*\([^;]*\)\s*(?:async\s*)?\{{", ChunkType.FUNCTION),
        _d(rf"^[ \t]*enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
        _d(rf"^[ \t]*mixin\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
    ),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="julia",
    extensions=(".jl",),
    style="end",
    decls=(
        _d(rf"^[ \t]*function\s+(?P<name>{_IDENT}[!]?)", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:mutable\s+)?struct\s+(?P<name>{_IDENT})", ChunkType.STRUCT),
        _d(rf"^[ \t]*module\s+(?P<name>{_IDENT})", ChunkType.MODULE, container=True),
        _d(rf"^[ \t]*macro\s+(?P<name>{_IDENT})", ChunkType.MACRO),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=("#=", "=#"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="r",
    extensions=(".r", ".R"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?P<name>[A-Za-z._][A-Za-z0-9._]*)\s*(?:<-|=)\s*function\s*\(", ChunkType.FUNCTION),
    ),
    line_comment="#",
    doc_prefixes=("#'", "#"),
    block_comment=None,
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="groovy",
    extensions=(".groovy", ".gradle"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:def|void|String|int|boolean)\s+(?P<name>{_IDENT})\s*\(", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:abstract\s+)?class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*task\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
    ),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="objc",
    extensions=(".m", ".mm"),
    style="brace",
    decls=(
        _d(r"^[ \t]*[-+]\s*\([^)]+\)\s*(?P<name>[A-Za-z_][A-Za-z0-9_]*)", ChunkType.METHOD),
        _d(rf"^@interface\s+(?P<name>{_IDENT})", ChunkType.CLASS, statement_ok=True),
        _d(rf"^@implementation\s+(?P<name>{_IDENT})", ChunkType.IMPL, container=True),
        _d(rf"^@protocol\s+(?P<name>{_IDENT})", ChunkType.TRAIT, statement_ok=True),
    ),
    single_quote_char_only=True,
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="ocaml",
    extensions=(".ml", ".mli"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*let\s+(?:rec\s+)?(?P<name>[a-z_][A-Za-z0-9_']*)", ChunkType.FUNCTION, statement_ok=True),
        _d(rf"^[ \t]*type\s+(?P<name>[a-z_][A-Za-z0-9_']*)", ChunkType.TYPE_ALIAS, statement_ok=True),
        _d(rf"^[ \t]*module\s+(?P<name>[A-Z][A-Za-z0-9_']*)", ChunkType.MODULE, statement_ok=True),
    ),
    line_comment="",
    doc_prefixes=("(**",),
    block_comment=("(*", "*)"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="fsharp",
    extensions=(".fs", ".fsx"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*let\s+(?:rec\s+)?(?P<name>[a-z_][A-Za-z0-9_']*)", ChunkType.FUNCTION, statement_ok=True),
        _d(rf"^[ \t]*type\s+(?P<name>{_IDENT})", ChunkType.TYPE_ALIAS, statement_ok=True),
        _d(rf"^[ \t]*module\s+(?P<name>[A-Za-z_][A-Za-z0-9_.]*)", ChunkType.MODULE, statement_ok=True),
    ),
    line_comment="//",
    block_comment=("(*", "*)"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="powershell",
    extensions=(".ps1", ".psm1"),
    style="brace",
    decls=(
        _d(r"^[ \t]*function\s+(?P<name>[A-Za-z_][A-Za-z0-9_-]*)", ChunkType.FUNCTION),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=("<#", "#>"),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="proto",
    extensions=(".proto",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*message\s+(?P<name>{_IDENT})", ChunkType.STRUCT, container=True),
        _d(rf"^[ \t]*service\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
        _d(rf"^[ \t]*rpc\s+(?P<name>{_IDENT})", ChunkType.METHOD, member_only=True, statement_ok=True),
    ),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="graphql",
    extensions=(".graphql", ".gql"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*type\s+(?P<name>{_IDENT})", ChunkType.STRUCT),
        _d(rf"^[ \t]*interface\s+(?P<name>{_IDENT})", ChunkType.TRAIT),
        _d(rf"^[ \t]*enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
        _d(rf"^[ \t]*input\s+(?P<name>{_IDENT})", ChunkType.STRUCT),
        _d(rf"^[ \t]*(?:query|mutation|subscription)\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=None,
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="terraform",
    extensions=(".tf", ".hcl"),
    style="brace",
    # HCL block names live inside quotes; leave double-quoted strings
    # unmasked so decl names survive (interpolation braces are balanced)
    string_delims=("'",),
    decls=(
        _d(r'^[ \t]*resource\s+"(?P<kind>[^"]+)"\s+"(?P<name>[^"]+)"', ChunkType.CONFIG),
        _d(r'^[ \t]*module\s+"(?P<name>[^"]+)"', ChunkType.MODULE),
        _d(r'^[ \t]*variable\s+"(?P<name>[^"]+)"', ChunkType.CONST),
        _d(r'^[ \t]*output\s+"(?P<name>[^"]+)"', ChunkType.CONST),
        _d(r"^[ \t]*locals\s*\{", ChunkType.CONFIG),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="dockerfile",
    extensions=("dockerfile", ".dockerfile"),
    style="config",
    line_comment="#",
    block_comment=None,
))

register(LanguageDef(
    name="cmake",
    extensions=("cmakelists.txt", ".cmake"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:function|macro)\s*\(\s*(?P<name>{_IDENT})", ChunkType.FUNCTION, statement_ok=True),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=None,
    keywords=_C_KEYWORDS,
))

register(LanguageDef(
    name="makefile",
    extensions=("makefile", ".mk"),
    style="brace",
    decls=(
        _d(r"^(?P<name>[A-Za-z_][A-Za-z0-9_.-]*)\s*:(?!=)", ChunkType.FUNCTION, statement_ok=True),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=None,
    keywords=_C_KEYWORDS,
))


# ---------------------------------------------------------------------------
# Extended language coverage (wave 3) — closing the SURVEY §2 54-language
# inventory (ref: src/language/languages.rs defs for cuda/glsl/solidity/
# gleam/nix/elm/css/vbnet/structured_text/latex/xml)
# ---------------------------------------------------------------------------

register(LanguageDef(
    name="cuda",
    single_quote_char_only=True,
    extensions=(".cu", ".cuh"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:template\s*<[^>]*>\s*)?(?:__global__|__device__|__host__)[_\w\s]*?\b(?P<ret>{_IDENT}[A-Za-z0-9_*<> ]*?)\s+\*?(?P<name>{_IDENT})\s*\([^;]*\)\s*\{{", ChunkType.FUNCTION, ret="ret"),
        _d(rf"^(?:static\s+|inline\s+|extern\s+)*(?P<ret>{_IDENT}[A-Za-z0-9_*<> ]*?)\s+\*?(?P<name>{_IDENT})\s*\([^;]*\)\s*\{{", ChunkType.FUNCTION, ret="ret"),
        _d(rf"^[ \t]*(?:typedef\s+)?struct\s+(?P<name>{_IDENT})\s*\{{", ChunkType.STRUCT),
        _d(rf"^[ \t]*class\s+(?P<name>{_IDENT})[^;{{]*\{{", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*#define\s+(?P<name>{_IDENT})\(", ChunkType.MACRO),
    ),
    keywords=_C_KEYWORDS | frozenset("__global__ __device__ __host__ __shared__ __syncthreads blockIdx threadIdx blockDim gridDim".split()),
    common_types=frozenset("int char float double void dim3 size_t cudaError_t cudaStream_t".split()),
))

register(LanguageDef(
    name="glsl",
    single_quote_char_only=True,
    extensions=(".glsl", ".vert", ".frag", ".comp", ".geom", ".tesc", ".tese"),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?P<ret>{_IDENT}[A-Za-z0-9_ ]*?)\s+(?P<name>{_IDENT})\s*\([^;]*\)\s*\{{", ChunkType.FUNCTION, ret="ret"),
        _d(rf"^[ \t]*struct\s+(?P<name>{_IDENT})\s*\{{", ChunkType.STRUCT),
    ),
    keywords=_C_KEYWORDS | frozenset("uniform varying attribute layout in out inout vec2 vec3 vec4 mat3 mat4 sampler2D texture discard".split()),
    common_types=frozenset("void float int bool vec2 vec3 vec4 ivec2 ivec3 ivec4 mat2 mat3 mat4".split()),
))

register(LanguageDef(
    name="solidity",
    extensions=(".sol",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:abstract\s+)?contract\s+(?P<name>{_IDENT})[^{{]*\{{", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*interface\s+(?P<name>{_IDENT})[^{{]*\{{", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*library\s+(?P<name>{_IDENT})[^{{]*\{{", ChunkType.MODULE, container=True),
        _d(rf"^[ \t]*function\s+(?P<name>{_IDENT})\s*\(", ChunkType.FUNCTION, statement_ok=True),
        _d(rf"^[ \t]*modifier\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*event\s+(?P<name>{_IDENT})\s*\(", ChunkType.TYPE_ALIAS, statement_ok=True),
        _d(rf"^[ \t]*struct\s+(?P<name>{_IDENT})\s*\{{", ChunkType.STRUCT),
        _d(rf"^[ \t]*enum\s+(?P<name>{_IDENT})\s*\{{", ChunkType.ENUM),
    ),
    line_comment="//",
    doc_prefixes=("///", "/**", "*"),
    keywords=_C_KEYWORDS | frozenset("pragma solidity memory storage calldata payable view pure external internal emit require revert mapping address".split()),
))

register(LanguageDef(
    name="gleam",
    extensions=(".gleam",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?:pub\s+)?fn\s+(?P<name>{_IDENT})\s*\(", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:pub\s+)?(?:opaque\s+)?type\s+(?P<name>{_IDENT})", ChunkType.STRUCT, statement_ok=True),
        _d(rf"^[ \t]*(?:pub\s+)?const\s+(?P<name>{_IDENT})", ChunkType.CONST),
    ),
    line_comment="//",
    doc_prefixes=("///", "////"),
    block_comment=None,
    keywords=_C_KEYWORDS | frozenset("fn pub let assert case todo panic opaque".split()),
))

register(LanguageDef(
    name="nix",
    extensions=(".nix",),
    style="brace",
    decls=(
        _d(rf"^[ \t]*(?P<name>[A-Za-z_][A-Za-z0-9_'.-]*)\s*=\s*\{{", ChunkType.CONFIG),
        _d(rf"^[ \t]*(?P<name>[A-Za-z_][A-Za-z0-9_'.-]*)\s*=\s*(?:\{{[^}}]*\}}:|[A-Za-z_][A-Za-z0-9_]*:)", ChunkType.FUNCTION, statement_ok=True),
    ),
    line_comment="#",
    doc_prefixes=("#",),
    block_comment=("/*", "*/"),
    keywords=_C_KEYWORDS | frozenset("let in rec with inherit import mkDerivation".split()),
))

register(LanguageDef(
    name="elm",
    extensions=(".elm",),
    style="offside",
    decls=(
        _d(rf"^(?P<name>[a-z][A-Za-z0-9_]*)\s*:", ChunkType.FUNCTION, statement_ok=True),
        _d(rf"^type\s+alias\s+(?P<name>[A-Z][A-Za-z0-9_]*)", ChunkType.TYPE_ALIAS, statement_ok=True),
        _d(rf"^type\s+(?!alias\b)(?P<name>[A-Z][A-Za-z0-9_]*)", ChunkType.STRUCT, statement_ok=True),
        _d(rf"^module\s+(?P<name>[A-Z][A-Za-z0-9_.]*)", ChunkType.MODULE, statement_ok=True),
    ),
    line_comment="--",
    doc_prefixes=("--", "{-|"),
    block_comment=("{-", "-}"),
    keywords=_C_KEYWORDS | frozenset("let in case of port exposing".split()),
))

register(LanguageDef(
    # indentation-form Sass: no braces/semicolons — offside extents
    name="sass",
    extensions=(".sass",),
    style="offside",
    decls=(
        _d(r"^=(?P<name>[\w-]+)", ChunkType.FUNCTION, statement_ok=True),
        _d(r"^[ \t]*@mixin\s+(?P<name>[\w-]+)", ChunkType.FUNCTION, statement_ok=True),
        _d(r"^[ \t]*@function\s+(?P<name>[\w-]+)", ChunkType.FUNCTION, statement_ok=True),
        _d(r"^(?P<name>[.#%][\w-][^\n]{0,70}?)\s*$", ChunkType.CONFIG, statement_ok=True),
    ),
    line_comment="//",
    doc_prefixes=("//",),
    block_comment=None,
    keywords=frozenset(),
    test_name_patterns=(),
))

register(LanguageDef(
    name="css",
    extensions=(".css", ".scss", ".less"),
    style="brace",
    decls=(
        _d(r"^[ \t]*@(?:media|keyframes|supports|layer)\s*(?P<name>[^{;\n]{0,70})\s*\{", ChunkType.CONFIG, container=True),
        _d(r"^(?P<name>[.#:\[\w][^{};\n]{0,70}?)\s*\{", ChunkType.CONFIG),
        _d(r"^[ \t]*@mixin\s+(?P<name>[\w-]+)", ChunkType.FUNCTION),
        _d(r"^[ \t]*@function\s+(?P<name>[\w-]+)", ChunkType.FUNCTION),
    ),
    line_comment="//",
    doc_prefixes=("/*", "//"),
    keywords=frozenset(),
    test_name_patterns=(),
))

register(LanguageDef(
    name="vbnet",
    extensions=(".vb",),
    style="end",
    end_suspend_open=r"^\s*(?:(?:Public|Private|Friend)\s+)*Interface\b",
    end_suspend_close=r"^\s*End\s+Interface\b",
    end_openers=r"^\s*(?:(?:Public|Private|Protected|Friend|Shared|Partial|Overrides|Overridable|MustInherit|NotInheritable|Async|Iterator|ReadOnly|Default)\s+)*(?:Sub|Function|Class|Module|Structure|Interface|Enum|Namespace|Property|Operator)\b",
    end_close=r"^\s*End\s+(?:Sub|Function|Class|Module|Structure|Interface|Enum|Namespace|Property|Operator)\b",
    decls=(
        _d(rf"^[ \t]*(?:(?:Public|Private|Protected|Friend|Shared|Partial|Overrides|Overridable|Async|Iterator)\s+)*Sub\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:(?:Public|Private|Protected|Friend|Shared|Partial|Overrides|Overridable|Async|Iterator)\s+)*Function\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*(?:(?:Public|Private|Protected|Friend|Partial|MustInherit|NotInheritable)\s+)*Class\s+(?P<name>{_IDENT})", ChunkType.CLASS, container=True),
        _d(rf"^[ \t]*(?:(?:Public|Private|Friend)\s+)*Module\s+(?P<name>{_IDENT})", ChunkType.MODULE, container=True),
        _d(rf"^[ \t]*(?:(?:Public|Private|Friend)\s+)*Structure\s+(?P<name>{_IDENT})", ChunkType.STRUCT, container=True),
        _d(rf"^[ \t]*(?:(?:Public|Private|Friend)\s+)*Interface\s+(?P<name>{_IDENT})", ChunkType.TRAIT, container=True),
        _d(rf"^[ \t]*(?:(?:Public|Private|Friend)\s+)*Enum\s+(?P<name>{_IDENT})", ChunkType.ENUM),
    ),
    line_comment="'",
    doc_prefixes=("'''", "'"),
    block_comment=None,
    string_delims=('"',),
    keywords=_C_KEYWORDS | frozenset("Dim As End If Then Else ElseIf While Wend For Next Each Step Exit Return Nothing True False New Me MyBase Imports Inherits Implements Handles AddressOf ByVal ByRef Optional".split()),
    test_name_patterns=("Test", "_Test"),
    test_attr_patterns=("<TestMethod", "<Fact", "<Test"),
))

register(LanguageDef(
    name="structured_text",
    extensions=(".st", ".iecst"),
    style="end",
    end_openers=r"^\s*(?:FUNCTION_BLOCK|FUNCTION|PROGRAM|TYPE|STRUCT|VAR(?:_\w+)?|IF|FOR|WHILE|CASE|REPEAT)\b",
    end_close=r"\bEND_(?:FUNCTION_BLOCK|FUNCTION|PROGRAM|TYPE|STRUCT|VAR|IF|FOR|WHILE|CASE|REPEAT)\b",
    decls=(
        _d(rf"^[ \t]*FUNCTION_BLOCK\s+(?P<name>{_IDENT})", ChunkType.CLASS),
        _d(rf"^[ \t]*FUNCTION\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*PROGRAM\s+(?P<name>{_IDENT})", ChunkType.FUNCTION),
        _d(rf"^[ \t]*TYPE\s+(?P<name>{_IDENT})", ChunkType.STRUCT),
    ),
    line_comment="//",
    doc_prefixes=("//", "(*"),
    block_comment=("(*", "*)"),
    string_delims=("'",),
    keywords=_C_KEYWORDS | frozenset("VAR VAR_INPUT VAR_OUTPUT VAR_IN_OUT VAR_GLOBAL END_VAR IF THEN ELSIF END_IF FOR TO BY DO END_FOR WHILE END_WHILE CASE OF END_CASE REPEAT UNTIL END_REPEAT TRUE FALSE AND OR NOT XOR MOD RETURN EXIT".split()),
))

register(LanguageDef(
    name="latex",
    extensions=(".tex", ".ltx", ".sty", ".cls"),
    style="latex",
    line_comment="%",
    block_comment=None,
))

register(LanguageDef(
    name="xml",
    extensions=(".xml", ".xsd", ".xslt", ".xsl", ".xaml", ".svg", ".plist", ".csproj", ".vbproj", ".pom"),
    style="xml",
    line_comment="",
    block_comment=("<!--", "-->"),
))
