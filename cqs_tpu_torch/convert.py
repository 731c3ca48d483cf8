"""Document conversion: HTML (and gated PDF) -> cleaned Markdown for indexing.

Reference analog: ``src/convert/`` — PDF via pymupdf4llm, HTML via
fast_html2md, CHM via 7z, WebHelp. Here HTML conversion is stdlib
(html.parser); PDF conversion gates on an optional pymupdf install.
"""

from __future__ import annotations

import re
from html.parser import HTMLParser
from pathlib import Path


class _Html2Md(HTMLParser):
    _BLOCK = {"p", "div", "section", "article", "br", "li", "tr"}
    _SKIP = {"script", "style", "nav", "footer", "header", "noscript", "svg"}

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.out: list[str] = []
        self._skip_depth = 0
        self._href: str | None = None
        self._list_depth = 0
        self._pre = False

    def handle_starttag(self, tag, attrs):
        if tag in self._SKIP:
            self._skip_depth += 1
            return
        if self._skip_depth:
            return
        if tag in ("h1", "h2", "h3", "h4", "h5", "h6"):
            self.out.append("\n\n" + "#" * int(tag[1]) + " ")
        elif tag == "a":
            self._href = dict(attrs).get("href")
            self.out.append("[")
        elif tag in ("strong", "b"):
            self.out.append("**")
        elif tag in ("em", "i"):
            self.out.append("*")
        elif tag == "code" and not self._pre:
            self.out.append("`")
        elif tag == "pre":
            self._pre = True
            self.out.append("\n\n```\n")
        elif tag in ("ul", "ol"):
            self._list_depth += 1
        elif tag == "li":
            self.out.append("\n" + "  " * max(self._list_depth - 1, 0) + "- ")
        elif tag in self._BLOCK:
            self.out.append("\n\n")

    def handle_endtag(self, tag):
        if tag in self._SKIP:
            self._skip_depth = max(0, self._skip_depth - 1)
            return
        if self._skip_depth:
            return
        if tag == "a":
            href = self._href or ""
            self.out.append(f"]({href})" if href else "]")
            self._href = None
        elif tag in ("strong", "b"):
            self.out.append("**")
        elif tag in ("em", "i"):
            self.out.append("*")
        elif tag == "code" and not self._pre:
            self.out.append("`")
        elif tag == "pre":
            self._pre = False
            self.out.append("\n```\n\n")
        elif tag in ("ul", "ol"):
            self._list_depth = max(0, self._list_depth - 1)
        elif tag in ("h1", "h2", "h3", "h4", "h5", "h6", *self._BLOCK):
            self.out.append("\n")

    def handle_data(self, data):
        if self._skip_depth:
            return
        self.out.append(data if self._pre else re.sub(r"[ \t]+", " ", data))


def html_to_markdown(html: str) -> str:
    p = _Html2Md()
    try:
        p.feed(html)
    except Exception:
        pass
    text = "".join(p.out)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip() + "\n"


def pdf_to_markdown(path: str | Path) -> str | None:
    """PDF conversion: pymupdf when installed (best layout fidelity), else
    the from-scratch pure-Python extractor (``cqs_tpu/pdf.py`` — xref-free
    object scan, Flate streams, Tj/TJ text ops, ToUnicode CMaps). Returns
    None only for encrypted / image-only documents."""
    try:
        import fitz  # pymupdf

        doc = fitz.open(str(path))
        return "\n\n".join(page.get_text("text") for page in doc)
    except ImportError:
        pass
    from cqs_tpu_torch.pdf import pdf_to_text

    return pdf_to_text(path)


def convert_file(src: str | Path, out_dir: str | Path) -> Path | None:
    """Convert one document to ``<out_dir>/<stem>.md``; None if unsupported."""
    src = Path(src)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = src.suffix.lower()
    if suffix in (".html", ".htm", ".xhtml"):
        md = html_to_markdown(src.read_text(errors="replace"))
    elif suffix == ".pdf":
        md = pdf_to_markdown(src)
        if md is None:
            return None
    elif suffix == ".chm":
        from cqs_tpu_torch.chm import chm_to_markdown

        md = chm_to_markdown(src)
    else:
        return None
    out = out_dir / (src.stem + ".md")
    out.write_text(md)
    return out
