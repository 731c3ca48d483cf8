"""The repository generator of the ``index_repo`` driver: each iteration
writes new Python and Markdown files, and keeps a manifest of every function
and section it wrote, against which the stored chunks are checked.

Parameters come from the traffic file (``perfbench/traffic/*.json``):

- ``files_per_iteration``, ``python_share``: files an iteration writes, and
  the share of them that are Python (the rest Markdown);
- ``base_files``: the repository that set-up indexes, as its first
  ``base_files / files_per_iteration`` iterations; later iterations are
  pulls, which call the base's functions and join no pool of callees;
- ``functions_per_file`` [lo, hi]; ``function_lines`` {median, sigma, cap}:
  a function's length in lines, lognormal; ``doc_share`` and ``doc_lines``
  [lo, hi]: the share of functions with a docstring, and its lines;
  ``calls_per_function`` [lo, hi]: calls to functions of earlier files of
  the base;
- ``sections_per_markdown`` [lo, hi], ``section_words`` [lo, hi];
- ``vocabulary``, ``zipf_s``: the identifier vocabulary and its Zipf
  exponent.

Sizes come from the shape stream and words from the content stream
(``perfbench/textgen.py``), so every seed writes as many lines, functions
and words as every other, with other words, in another order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from perfbench.textgen import Words, content_rng, shape_rng


@dataclass(frozen=True)
class Item:
    """One function or section the generator wrote, as a parser reads it."""
    origin: str
    name: str
    kind: str                 # function | section
    line_start: int
    line_end: int
    #: ``def name(args)``, or a section's heading path (``Top > Sub``)
    signature: str
    #: a function's docstring as ``ast.get_docstring`` cleans it, or ""
    doc: str
    #: the item's lines, ``line_start`` to ``line_end``
    body: str
    #: the functions it calls, in the order of its lines
    calls: tuple = ()
    #: a section's enclosing heading, or ""
    parent: str = ""


@dataclass
class File:
    origin: str
    text: str
    items: list[Item]


class RepoGenerator:
    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.seed = seed
        self.words = Words(seed, int(traffic["vocabulary"]), float(traffic["zipf_s"]))
        #: the iterations that make up the base repository
        self.base_iterations = int(traffic["base_files"]) // int(traffic["files_per_iteration"])
        #: functions of the base's files written so far: the pool of callees
        self.functions: list[str] = []
        self._names: set[str] = set()

    # -- shapes ------------------------------------------------------------

    def _shapes(self, it: int) -> list[dict]:
        t = self.t
        rng = shape_rng(it)
        n = int(t["files_per_iteration"])
        n_py = int(round(n * float(t["python_share"])))
        shapes = []
        for k in range(n):
            if k < n_py:
                lo, hi = t["functions_per_file"]
                nf = int(rng.integers(lo, hi + 1))
                fl = t["function_lines"]
                lines = np.exp(rng.normal(np.log(fl["median"]), fl["sigma"], size=nf))
                lines = np.clip(np.rint(lines), 3, fl["cap"]).astype(int)
                has_doc = rng.random(nf) < float(t["doc_share"])
                dlo, dhi = t["doc_lines"]
                doc = np.where(has_doc, rng.integers(dlo, dhi + 1, size=nf), 0)
                clo, chi = t["calls_per_function"]
                calls = rng.integers(clo, chi + 1, size=nf)
                shapes.append({"kind": "py", "lines": lines.tolist(), "doc": doc.tolist(),
                               "calls": calls.tolist()})
            else:
                lo, hi = t["sections_per_markdown"]
                ns = int(rng.integers(lo, hi + 1))
                wlo, whi = t["section_words"]
                shapes.append({"kind": "md",
                               "words": rng.integers(wlo, whi + 1, size=ns).tolist()})
        return shapes

    # -- content -----------------------------------------------------------

    def _name(self, rng) -> str:
        parts = self.words.draw(rng, int(rng.integers(2, 4)))
        name = "_".join(parts)
        while name in self._names:
            name += "_" + self.words.draw(rng, 1)[0]
        self._names.add(name)
        return name

    def _sentence(self, rng, lo: int = 6, hi: int = 14) -> str:
        s = self.words.text(rng, int(rng.integers(lo, hi + 1)))
        return s[0].upper() + s[1:]

    def _python(self, rng, origin: str, shape: dict, pool: bool) -> File:
        lines = [f'"""{self._sentence(rng)}."""', "import os"]
        items: list[Item] = []
        made: list[str] = []
        for n_lines, n_doc, n_calls in zip(shape["lines"], shape["doc"], shape["calls"]):
            lines += ["", ""]
            name = self._name(rng)
            start = len(lines) + 1
            # distinct names: a repeated argument does not parse
            args = ", ".join(dict.fromkeys(self.words.draw(rng, int(rng.integers(0, 4)))))
            lines.append(f"def {name}({args}):")
            doc = []
            if n_doc:
                doc = [self._sentence(rng) + "." for _ in range(n_doc)]
                if n_doc == 1:
                    lines.append(f'    """{doc[0]}"""')
                else:
                    lines.append(f'    """{doc[0]}')
                    lines += ["    " + d for d in doc[1:]]
                    lines.append('    """')
            # statements before the return line
            body = max(0, n_lines - (len(lines) - start + 1) - 1)
            calls = min(int(n_calls), body) if self.functions else 0
            call_at = set(rng.choice(body, size=calls, replace=False).tolist()) if calls else set()
            b = 0
            called = []
            while b < body:
                v, a, c = self.words.draw(rng, 3)
                if b in call_at:
                    callee = self.functions[int(rng.integers(len(self.functions)))]
                    called.append(callee)
                    lines.append(f"    {v} = {callee}({a}, {c})")
                    b += 1
                elif b + 1 < body and b + 1 not in call_at and rng.random() < 0.2:
                    k = int(rng.integers(100))
                    lines += [f"    if {v} > {k}:", f"        {v} = {a} - {k}"]
                    b += 2
                else:
                    lines.append(f"    {v} = {a}_{c} + {int(rng.integers(1000))}")
                    b += 1
            lines.append(f"    return {self.words.draw(rng, 1)[0]}")
            items.append(Item(origin, name, "function", start, len(lines), f"def {name}({args})",
                              "\n".join(doc), "\n".join(lines[start - 1:]), tuple(called)))
            made.append(name)
        if pool:
            self.functions.extend(made)
        return File(origin, "\n".join(lines) + "\n", items)

    def _markdown(self, rng, origin: str, shape: dict) -> File:
        lines: list[str] = []
        items: list[Item] = []
        top = ""
        for si, n_words in enumerate(shape["words"]):
            head = " ".join(w.capitalize() for w in self.words.draw(rng, int(rng.integers(2, 5))))
            start = len(lines) + 1
            lines.append(("# " if si == 0 else "## ") + head)
            words = self.words.draw(rng, n_words)
            for p0 in range(0, n_words, 48):
                lines.append("")
                para = words[p0:p0 + 48]
                lines += [" ".join(para[i:i + 12]) for i in range(0, len(para), 12)]
            lines.append("")
            top = top or head
            items.append(Item(origin, head, "section", start, len(lines),
                              f"{top} > {head}" if si else head, "", "\n".join(lines[start - 1:]),
                              parent=top if si else ""))
        return File(origin, "\n".join(lines) + "\n", items)

    def iteration(self, it: int) -> list[File]:
        """The files of iteration ``it``, in the order they are written.
        Iterations are drawn in order: the base's first."""
        shapes = self._shapes(it)
        rng = content_rng(self.seed, it, 1)
        order = rng.permutation(len(shapes))
        out = []
        for pos, k in enumerate(order.tolist()):
            shape = shapes[k]
            stem = self.words.draw(rng, 1)[0]
            if shape["kind"] == "py":
                out.append(self._python(rng, f"pkg{it:04d}/m{pos:02d}_{stem}.py", shape,
                                        it < self.base_iterations))
            else:
                out.append(self._markdown(rng, f"docs{it:04d}/d{pos:02d}_{stem}.md", shape))
        return out

    def base(self) -> list[File]:
        """The files of the base repository."""
        return [f for it in range(self.base_iterations) for f in self.iteration(it)]
