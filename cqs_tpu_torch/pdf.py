"""Pure-Python PDF text extraction — no external tools.

Reference analog: ``src/convert/`` shells out to pymupdf4llm for PDF →
Markdown. Like ``chm.py`` (from-scratch ITSF/LZX), this removes the external
dependency: a self-contained reader for the common case — classic xref or
scan-recovered objects, FlateDecode streams (stdlib zlib), BT/ET text blocks
with Tj/TJ/'/" operators, and ToUnicode CMaps (bfchar/bfrange) for subset
fonts. Not a full ISO 32000 implementation; unknown filters and encrypted
documents return None so callers can gate.
"""

from __future__ import annotations

import re
import zlib
from pathlib import Path

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b(.*?)endobj", re.S)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.S)
_NAME_FILTER_RE = re.compile(rb"/Filter\s*(?:\[\s*)?/(\w+)")
_TOUNI_RE = re.compile(rb"/ToUnicode\s+(\d+)\s+\d+\s+R")
_FONT_RES_RE = re.compile(rb"/(F[\w.]*|TT\d+|C2_\d+)\s+(\d+)\s+\d+\s+R")
_BFCHAR_RE = re.compile(rb"beginbfchar(.*?)endbfchar", re.S)
_BFRANGE_RE = re.compile(rb"beginbfrange(.*?)endbfrange", re.S)
_HEX_RE = re.compile(rb"<([0-9A-Fa-f]+)>")


def _decode_stream(raw: bytes, dict_bytes: bytes) -> bytes | None:
    m = _NAME_FILTER_RE.search(dict_bytes)
    if m is None:
        return raw
    filt = m.group(1)
    if filt == b"FlateDecode":
        try:
            return zlib.decompress(raw)
        except zlib.error:
            # some writers pad the stream; try trimming trailing whitespace
            try:
                return zlib.decompressobj().decompress(raw)
            except zlib.error:
                return None
    if filt in (b"ASCIIHexDecode",):
        try:
            return bytes.fromhex(raw.replace(b">", b"").decode("ascii", "ignore")
                                 .replace("\n", "").replace("\r", "").replace(" ", ""))
        except ValueError:
            return None
    return None      # unsupported filter (DCT/JPX are images anyway)


def _parse_tounicode(cmap: bytes) -> dict[int, str]:
    """bfchar/bfrange → code→text mapping (UTF-16BE targets)."""
    out: dict[int, str] = {}

    def utf16(h: bytes) -> str:
        try:
            return bytes.fromhex(h.decode()).decode("utf-16-be", "ignore")
        except ValueError:
            return ""

    for block in _BFCHAR_RE.findall(cmap):
        hexes = _HEX_RE.findall(block)
        for src, dst in zip(hexes[0::2], hexes[1::2]):
            out[int(src, 16)] = utf16(dst)
    for block in _BFRANGE_RE.findall(cmap):
        toks = _HEX_RE.findall(block)
        for i in range(0, len(toks) - 2, 3):
            lo_i, hi_i = int(toks[i], 16), int(toks[i + 1], 16)
            base_i = int(toks[i + 2], 16)
            width = max(4, len(toks[i + 2]))
            for c in range(lo_i, min(hi_i, lo_i + 0xFFFF) + 1):
                out[c] = utf16(f"{base_i + (c - lo_i):0{width}x}".encode())
    return out


_STR_TOKEN = re.compile(
    rb"\((?:\\.|[^\\()])*\)"      # literal string (with escapes)
    rb"|<[0-9A-Fa-f\s]*>"         # hex string
    rb"|\[(?:\\.|[^\]])*\]"       # TJ array
    rb"|/(?:[^\s/<>()\[\]]+)"     # name (font selection)
    rb"|[A-Za-z'\"]+\*?")         # operator


def _unescape_literal(b: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(b):
        c = b[i]
        if c == 0x5C and i + 1 < len(b):       # backslash
            n = b[i + 1]
            simple = {0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12,
                      0x28: 40, 0x29: 41, 0x5C: 92}
            if n in simple:
                out.append(simple[n])
                i += 2
                continue
            if 0x30 <= n <= 0x37:              # octal escape
                oct_digits = b[i + 1: i + 4]
                j = 0
                while j < len(oct_digits) and 0x30 <= oct_digits[j] <= 0x37:
                    j += 1
                out.append(int(oct_digits[:j], 8) & 0xFF)
                i += 1 + j
                continue
            i += 1                              # line continuation etc.
            continue
        out.append(c)
        i += 1
    return bytes(out)


def _string_to_text(tok: bytes, cmap: dict[int, str] | None) -> str:
    if tok.startswith(b"("):
        raw = _unescape_literal(tok[1:-1])
        if cmap:
            # single-byte codes through the CMap when present
            return "".join(cmap.get(c, chr(c) if 32 <= c < 127 else "") for c in raw)
        return raw.decode("latin-1", "ignore")
    if tok.startswith(b"<"):
        h = re.sub(rb"\s", b"", tok[1:-1])
        if len(h) % 2:
            h += b"0"
        data = bytes.fromhex(h.decode())
        if cmap:
            # try 2-byte codes first (CID fonts), fall back to 1-byte
            if all(int.from_bytes(data[i:i+2], "big") in cmap
                   for i in range(0, len(data) - 1, 2)) and len(data) >= 2:
                return "".join(cmap.get(int.from_bytes(data[i:i+2], "big"), "")
                               for i in range(0, len(data) - 1, 2))
            return "".join(cmap.get(c, "") for c in data)
        return data.decode("latin-1", "ignore")
    return ""


def _extract_text_ops(content: bytes, font_cmaps: dict[bytes, dict[int, str]]) -> str:
    """Walk BT/ET text blocks; honor Tj / TJ / ' / \" and font switches."""
    parts: list[str] = []
    cur_cmap: dict[int, str] | None = None
    pending: list[bytes] = []
    for m in _STR_TOKEN.finditer(content):
        tok = m.group(0)
        if tok.startswith(b"/"):
            pending = [tok[1:]]
            continue
        if tok.startswith(b"(") or tok.startswith(b"<") or tok.startswith(b"["):
            pending.append(tok)
            continue
        op = tok
        if op == b"Tf" and pending and not pending[0].startswith(b"("):
            cur_cmap = font_cmaps.get(pending[0])
            pending = []
        elif op in (b"Tj", b"'", b'"'):
            strs = [t for t in pending if t.startswith(b"(") or t.startswith(b"<")]
            for t in strs:
                parts.append(_string_to_text(t, cur_cmap))
            if op in (b"'", b'"'):
                parts.append("\n")
            pending = []
        elif op == b"TJ":
            arrs = [t for t in pending if t.startswith(b"[")]
            for arr in arrs:
                for t in re.findall(rb"\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]*>", arr):
                    parts.append(_string_to_text(t, cur_cmap))
            pending = []
        elif op in (b"Td", b"TD", b"T*"):
            parts.append("\n")
            pending = []
        elif op in (b"BT", b"ET"):
            parts.append("\n")
            pending = []
        else:
            pending = []
    text = "".join(parts)
    text = re.sub(r"[ \t]+", " ", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()


def pdf_to_text(path: str | Path) -> str | None:
    """Extract plain text from a PDF. Returns None when the file is encrypted
    or no text could be decoded (image-only scans, exotic filters)."""
    data = Path(path).read_bytes()
    if not data.startswith(b"%PDF"):
        return None
    if b"/Encrypt" in data[:4096] or re.search(rb"/Encrypt\s+\d+\s+\d+\s+R", data):
        return None
    objects: dict[int, bytes] = {}
    for m in _OBJ_RE.finditer(data):
        objects[int(m.group(1))] = m.group(3)

    # ToUnicode CMaps per font object id
    cmap_of_obj: dict[int, dict[int, str]] = {}
    for num, body in objects.items():
        tm = _TOUNI_RE.search(body)
        if tm is None:
            continue
        target = objects.get(int(tm.group(1)))
        if target is None:
            continue
        sm = _STREAM_RE.search(target)
        if sm is None:
            continue
        decoded = _decode_stream(sm.group(1), target)
        if decoded:
            cmap_of_obj[num] = _parse_tounicode(decoded)

    texts: list[str] = []
    for num, body in objects.items():
        sm = _STREAM_RE.search(body)
        if sm is None:
            continue
        head = body[: sm.start()]
        if b"/Image" in head or b"/FontFile" in head or b"/Metadata" in head:
            continue
        decoded = _decode_stream(sm.group(1), head)
        if not decoded or b"BT" not in decoded:
            continue
        # font resource name -> cmap for this content stream: resolve via any
        # page dict that references both this stream and font objects
        font_cmaps: dict[bytes, dict[int, str]] = {}
        for page_body in objects.values():
            if f"{num} 0 R".encode() in page_body and b"/Font" in page_body:
                for fname, fobj in _FONT_RES_RE.findall(page_body):
                    if int(fobj) in cmap_of_obj:
                        font_cmaps[fname] = cmap_of_obj[int(fobj)]
        if not font_cmaps and len(cmap_of_obj) == 1:
            only = next(iter(cmap_of_obj.values()))
            font_cmaps = {b"*": only}
            # apply as default when no font switch matches
            t = _extract_text_ops(decoded, {})
            if not t.strip():
                t = _extract_text_ops(decoded, {b"*": only})
            if t:
                texts.append(t)
            continue
        t = _extract_text_ops(decoded, font_cmaps)
        if t:
            texts.append(t)
    out = "\n\n".join(texts).strip()
    return out or None
