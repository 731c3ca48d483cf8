"""Python parser built on the stdlib ``ast`` module.

Reference analog: the tree-sitter Python grammar path in ``src/parser/``.
Using the real compiler's AST gives exact chunk extents, docstrings, call
sites (including attribute calls), decorators, and annotation-derived type
refs — higher fidelity than any regex engine.
"""

from __future__ import annotations

import ast

from cqs_tpu_torch.parser.registry import get_language
from cqs_tpu_torch.parser.types import CallSite, Chunk, ChunkType, EdgeKind, ParseResult, TypeRef


def _name_of(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        return _name_of(node.func)
    if isinstance(node, ast.Subscript):
        return _name_of(node.value)
    return None


def _receiver_of(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return node.value.id
    return None


class _CallCollector(ast.NodeVisitor):
    def __init__(self, self_name: str):
        self.calls: list[CallSite] = []
        self._seen: set[tuple[str, int]] = set()
        self._self_name = self_name

    def visit_Call(self, node: ast.Call) -> None:
        name = _name_of(node.func)
        # self-name suppression covers bare recursion only: a RECEIVER call
        # sharing the caller's name (`ap.parse_args()` inside `def
        # parse_args`, `super().__init__()`) is a real outgoing edge — the
        # r4 ast cross-audit found every python recall miss was this shape
        if name and (name != self._self_name
                     or isinstance(node.func, ast.Attribute)):
            key = (name, node.lineno)
            if key not in self._seen:
                self._seen.add(key)
                recv = _receiver_of(node.func)
                kind = EdgeKind.METHOD_CALL if isinstance(node.func, ast.Attribute) else EdgeKind.CALL
                self.calls.append(CallSite(callee=name, line=node.lineno, kind=kind, receiver=recv))
        self.generic_visit(node)

    # bare function references passed as arguments (fn_pointer edges)
    def visit_Name(self, node: ast.Name) -> None:  # noqa: N802
        self.generic_visit(node)


def _annotation_types(node: ast.AST, out: list[TypeRef], line: int, common: frozenset) -> None:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id not in common and sub.id[:1].isupper():
            out.append(TypeRef(name=sub.id, line=line, role="param"))


def _decorator_names(node) -> list[str]:
    names = []
    for d in getattr(node, "decorator_list", []):
        n = _name_of(d)
        if n:
            names.append(n)
    return names


def _fn_chunk(node, origin: str, source_lines: list[str], parent: str | None,
              common: frozenset) -> Chunk:
    name = node.name
    decorators = _decorator_names(node)
    # include decorator lines in the chunk span
    deco_start = min((d.lineno for d in node.decorator_list), default=node.lineno)
    line_start, line_end = deco_start, node.end_lineno or node.lineno
    body = "\n".join(source_lines[line_start - 1 : line_end])
    is_test = name.startswith("test_") or any("pytest" in d or "unittest" in d for d in decorators)
    ct = ChunkType.TEST if is_test else (ChunkType.METHOD if parent else ChunkType.FUNCTION)

    def _arg_text(a: ast.arg) -> str:
        if a.annotation is not None:
            try:
                return f"{a.arg}: {ast.unparse(a.annotation)}"
            except Exception:
                pass
        return a.arg

    # Keep the signature faithful to the source: async prefix and parameter
    # annotations are structural signals ("async methods that return a
    # string" matches on them — the signature-precision leg and the
    # reference's structural matchers, src/structural.rs, depend on it).
    args = [_arg_text(a)
            for a in (node.args.posonlyargs + node.args.args + node.args.kwonlyargs)
            if a.arg not in ("self", "cls")]
    ret = None
    if node.returns is not None:
        try:
            ret = ast.unparse(node.returns)
        except Exception:
            ret = None
    prefix = "async def" if isinstance(node, ast.AsyncFunctionDef) else "def"
    sig = f"{prefix} {name}({', '.join(args)})" + (f" -> {ret}" if ret else "")

    chunk = Chunk(
        origin=origin, name=name, chunk_type=ct, language="python",
        line_start=line_start, line_end=line_end, body=body,
        signature=sig, doc=ast.get_docstring(node) or "",
        parent_name=parent, return_type=ret, is_test=is_test,
    )
    collector = _CallCollector(name)
    for stmt in node.body:
        collector.visit(stmt)
    chunk.calls = collector.calls
    refs: list[TypeRef] = []
    for a in node.args.args + node.args.kwonlyargs:
        if a.annotation is not None:
            _annotation_types(a.annotation, refs, node.lineno, common)
    if node.returns is not None:
        _annotation_types(node.returns, refs, node.lineno, common)
    seen = set()
    chunk.type_refs = [r for r in refs if not (r.name in seen or seen.add(r.name))]
    return chunk


def parse_python(origin: str, text: str) -> ParseResult:
    result = ParseResult(origin=origin, language="python")
    lang = get_language("python")
    common = lang.common_types if lang else frozenset()
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        result.errors.append(f"SyntaxError: {e}")
        return result
    source_lines = text.splitlines()

    def walk_body(body, parent: str | None):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                result.chunks.append(_fn_chunk(node, origin, source_lines, parent, common))
                # nested functions become their own chunks with parent attribution
                inner = [n for n in node.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
                if inner:
                    walk_body(inner, node.name)
            elif isinstance(node, ast.ClassDef):
                line_start = min((d.lineno for d in node.decorator_list), default=node.lineno)
                line_end = node.end_lineno or node.lineno
                bases = [b for b in (_name_of(b) for b in node.bases) if b]
                sig = f"class {node.name}" + (f"({', '.join(bases)})" if bases else "")
                chunk = Chunk(
                    origin=origin, name=node.name, chunk_type=ChunkType.CLASS,
                    language="python", line_start=line_start, line_end=line_end,
                    body="\n".join(source_lines[line_start - 1 : line_end]),
                    signature=sig, doc=ast.get_docstring(node) or "",
                    parent_name=parent,
                )
                chunk.type_refs = [TypeRef(name=b, line=node.lineno, role="extends")
                                   for b in bases if b not in common]
                result.chunks.append(chunk)
                walk_body(node.body, node.name)
            elif isinstance(node, ast.Assign) and parent is None:
                # module-level constants (UPPER_CASE names)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id.isupper() and len(tgt.id) > 1:
                        result.chunks.append(Chunk(
                            origin=origin, name=tgt.id, chunk_type=ChunkType.CONST,
                            language="python", line_start=node.lineno,
                            line_end=node.end_lineno or node.lineno,
                            body="\n".join(source_lines[node.lineno - 1 : node.end_lineno or node.lineno]),
                            signature=source_lines[node.lineno - 1].strip()[:120],
                        ))

    walk_body(tree.body, None)
    result.chunks.sort(key=lambda c: (c.line_start, c.line_end))
    return result
