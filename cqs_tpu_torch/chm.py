"""Pure-Python CHM (ITSF) reader with a from-scratch LZX decompressor.

Reference analog: ``src/convert/chm.rs`` — the reference shells out to ``7z``
for extraction (and errors when it's absent). Here the container and the
LZX compression are decoded in-process, so CHM conversion has zero external
dependencies.

Format summary (the unofficial CHM format documentation + MS-PATCH LZX spec):

- ITSF header -> two header sections; section 1 is the ITSP directory made of
  4 KB PMGL listing chunks whose entries are (name, content-section, offset,
  length) with big-endian 7-bit varints (ENCINT).
- Content section 0 is stored raw at ``content_offset``; section 1
  (``::DataSpace/Storage/MSCompressed``) is one LZX stream, cut into
  0x8000-byte frames with a ResetTable of compressed offsets; at every
  ``reset_interval`` frames the decoder state resets completely (trees,
  repeat offsets, header bit) and the bitstream restarts 16-bit-aligned at
  the recorded offset.
- LZX bitstream: 16-bit little-endian words, bits consumed MSB-first.
  Blocks: verbatim (1), aligned-offset (2), uncompressed (3). Main/length
  Huffman trees are delta-coded by a 20-symbol pretree.
"""

from __future__ import annotations

import struct
from pathlib import Path


class ChmError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Bit reader (16-bit LE words, MSB-first within each word)
# ---------------------------------------------------------------------------

class _Bits:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0          # byte position of the next 16-bit word
        self.buf = 0          # bit buffer (left-aligned semantics via count)
        self.n = 0            # bits available in buf

    def _fill(self):
        while self.n <= 16:
            if self.pos + 1 < len(self.data):
                w = self.data[self.pos] | (self.data[self.pos + 1] << 8)
            elif self.pos < len(self.data):
                w = self.data[self.pos]
            else:
                w = 0
            self.pos += 2
            self.buf = (self.buf << 16) | w
            self.n += 16

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        if self.n < k:
            self._fill()
        self.n -= k
        v = (self.buf >> self.n) & ((1 << k) - 1)
        self.buf &= (1 << self.n) - 1
        return v

    def align16(self):
        """Drop to a 16-bit boundary; if already aligned, skip a full word
        (the uncompressed-block padding rule)."""
        drop = self.n % 16
        if drop == 0:
            drop = 16
        self.read(drop)

    def read_bytes(self, k: int) -> bytes:
        """Byte-aligned raw copy (caller must have align16()'d). Consumes from
        the underlying array, bypassing the bit buffer."""
        start = self.pos - self.n // 8
        out = self.data[start:start + k]
        self.pos = start + k
        self.buf = 0
        self.n = 0
        return out


# ---------------------------------------------------------------------------
# Canonical Huffman
# ---------------------------------------------------------------------------

def _huff_table(lengths: list[int]) -> dict[tuple[int, int], int]:
    """(code_len, code) -> symbol, canonical assignment in symbol order."""
    table: dict[tuple[int, int], int] = {}
    code = 0
    for ln in range(1, 17):
        for sym, l in enumerate(lengths):
            if l == ln:
                table[(ln, code)] = sym
                code += 1
        code <<= 1
    return table


def _huff_decode(bits: _Bits, table: dict[tuple[int, int], int]) -> int:
    code = 0
    for ln in range(1, 17):
        code = (code << 1) | bits.read(1)
        sym = table.get((ln, code))
        if sym is not None:
            return sym
    raise ChmError("bad Huffman code in LZX stream")


def _read_lengths(bits: _Bits, prev: list[int], first: int, last: int) -> None:
    """Delta-decode tree lengths [first, last) against ``prev`` in place
    (20-symbol pretree; 17/18 zero runs, 19 repeat)."""
    pre = [bits.read(4) for _ in range(20)]
    pretree = _huff_table(pre)
    i = first
    while i < last:
        z = _huff_decode(bits, pretree)
        if z == 17:
            run = 4 + bits.read(4)
            for _ in range(run):
                if i < last:
                    prev[i] = 0
                    i += 1
        elif z == 18:
            run = 20 + bits.read(5)
            for _ in range(run):
                if i < last:
                    prev[i] = 0
                    i += 1
        elif z == 19:
            run = 4 + bits.read(1)
            z2 = _huff_decode(bits, pretree)
            val = (prev[i] - z2) % 17
            for _ in range(run):
                if i < last:
                    prev[i] = val
                    i += 1
        else:
            prev[i] = (prev[i] - z) % 17
            i += 1


# ---------------------------------------------------------------------------
# LZX stream decoder
# ---------------------------------------------------------------------------

def _position_slots(window_bits: int) -> int:
    return {15: 30, 16: 32, 17: 34, 18: 36, 19: 38, 20: 42, 21: 50}[window_bits]


def _pos_tables(num_slots: int) -> tuple[list[int], list[int]]:
    extra = [0] * num_slots
    base = [0] * num_slots
    b = 0
    for s in range(num_slots):
        e = 0 if s < 4 else min((s - 2) >> 1, 17)
        extra[s] = e
        base[s] = b
        b += 1 << e
    return extra, base


def lzx_decompress(data: bytes, out_len: int, window_bits: int,
                   base_pos: int = 0, total_len: int | None = None) -> bytes:
    """Decode one LZX stream (fresh state) producing ``out_len`` bytes.

    ``base_pos``/``total_len``: when the stream is one reset span of a larger
    file, the E8 CALL translation needs FILE-absolute positions (the spec's
    "current location" is absolute, and the final 10 bytes of the whole file
    are exempt — not 10 bytes per span)."""
    bits = _Bits(data)
    num_slots = _position_slots(window_bits)
    extra_bits, pos_base = _pos_tables(num_slots)
    main_len = [0] * (256 + 8 * num_slots)
    length_len = [0] * 249
    R = [1, 1, 1]
    out = bytearray()

    intel_size = 0
    if bits.read(1):
        intel_size = (bits.read(16) << 16) | bits.read(16)

    while len(out) < out_len:
        btype = bits.read(3)
        size = (bits.read(8) << 16) | bits.read(16)
        if btype == 3:                                 # uncompressed
            bits.align16()
            raw = bits.read_bytes(12)
            R = [struct.unpack("<I", raw[i:i + 4])[0] for i in (0, 4, 8)]
            out += bits.read_bytes(size)
            if size % 2:
                bits.read_bytes(1)
            continue
        if btype == 2:                                 # aligned offset tree
            aligned = [bits.read(3) for _ in range(8)]
            aligned_tbl = _huff_table(aligned)
        elif btype != 1:
            raise ChmError(f"bad LZX block type {btype}")
        _read_lengths(bits, main_len, 0, 256)
        _read_lengths(bits, main_len, 256, len(main_len))
        main_tbl = _huff_table(main_len)
        _read_lengths(bits, length_len, 0, 249)
        len_tbl = _huff_table(length_len)

        end = len(out) + size
        while len(out) < end:
            sym = _huff_decode(bits, main_tbl)
            if sym < 256:
                out.append(sym)
                continue
            sym -= 256
            slot = sym >> 3
            match_len = (sym & 7) + 2
            if (sym & 7) == 7:
                match_len += _huff_decode(bits, len_tbl)
            if slot == 0:
                offset = R[0]
            elif slot == 1:
                offset = R[1]
                R[0], R[1] = R[1], R[0]
            elif slot == 2:
                offset = R[2]
                R[0], R[2] = R[2], R[0]
            else:
                e = extra_bits[slot]
                if btype == 2 and e >= 3:
                    formatted = pos_base[slot] + (bits.read(e - 3) << 3) \
                        + _huff_decode(bits, aligned_tbl)
                else:
                    formatted = pos_base[slot] + bits.read(e)
                offset = formatted - 2
                R[2], R[1], R[0] = R[1], R[0], offset
            if offset <= 0 or offset > len(out):
                raise ChmError("LZX match offset out of range")
            for _ in range(match_len):
                out.append(out[-offset])

    file_len = total_len if total_len is not None else base_pos + out_len
    if intel_size and file_len > 10:
        out = _undo_e8(out, intel_size, base_pos, file_len)
    return bytes(out[:out_len])


def _undo_e8(buf: bytearray, intel_size: int, base_pos: int = 0,
             file_len: int | None = None) -> bytearray:
    """Reverse the x86 CALL (E8) absolute->relative translation, per 32 KB
    frame, using FILE-absolute instruction positions (``base_pos`` is this
    buffer's uncompressed start offset; the final 10 bytes of the whole file
    are never translated)."""
    n = len(buf)
    if file_len is None:
        file_len = base_pos + n
    frame = 0
    while frame < n:
        i = frame
        stop = max(frame, min(frame + 0x8000, file_len - 10 - base_pos, n))
        while i < stop:
            if buf[i] == 0xE8:
                cur = base_pos + i
                abs_off = struct.unpack("<i", buf[i + 1:i + 5])[0]
                if -cur <= abs_off < intel_size:
                    rel = abs_off - cur if abs_off >= 0 else abs_off + intel_size
                    buf[i + 1:i + 5] = struct.pack("<I", rel & 0xFFFFFFFF)
                i += 5
            else:
                i += 1
        frame += 0x8000
    return buf


# ---------------------------------------------------------------------------
# ITSF container
# ---------------------------------------------------------------------------

def _encint(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    while True:
        b = data[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            return v, pos


class ChmFile:
    """Parsed CHM: ``entries`` maps names -> (section, offset, length)."""

    RESET_TABLE = ("::DataSpace/Storage/MSCompressed/Transform/"
                   "{7FC28940-9D31-11D0-9B27-00A0C91E9C7C}/"
                   "InstanceData/ResetTable")
    CONTROL = "::DataSpace/Storage/MSCompressed/ControlData"
    CONTENT = "::DataSpace/Storage/MSCompressed/Content"

    def __init__(self, path: str | Path):
        self.raw = Path(path).read_bytes()
        if self.raw[:4] != b"ITSF":
            raise ChmError("not a CHM file (missing ITSF signature)")
        version = struct.unpack_from("<I", self.raw, 4)[0]
        _s0off, _s0len, sec1_off, sec1_len = struct.unpack_from("<QQQQ", self.raw, 0x38)
        if version >= 3:
            self.content_offset = struct.unpack_from("<Q", self.raw, 0x58)[0]
        else:
            self.content_offset = sec1_off + sec1_len
        # ITSP directory
        if self.raw[sec1_off:sec1_off + 4] != b"ITSP":
            raise ChmError("missing ITSP directory header")
        hdr_len = struct.unpack_from("<I", self.raw, sec1_off + 8)[0]
        chunk_size = struct.unpack_from("<I", self.raw, sec1_off + 0x10)[0]
        num_chunks = struct.unpack_from("<I", self.raw, sec1_off + 0x2C)[0]
        self.entries: dict[str, tuple[int, int, int]] = {}
        base = sec1_off + hdr_len
        for c in range(num_chunks):
            chunk = self.raw[base + c * chunk_size: base + (c + 1) * chunk_size]
            if chunk[:4] != b"PMGL":
                continue
            quickref = struct.unpack_from("<I", chunk, 4)[0]
            pos, limit = 0x14, chunk_size - quickref
            while pos < limit:
                nlen, pos = _encint(chunk, pos)
                if nlen == 0 or pos + nlen > limit:
                    break
                name = chunk[pos:pos + nlen].decode("utf-8", "replace")
                pos += nlen
                section, pos = _encint(chunk, pos)
                offset, pos = _encint(chunk, pos)
                length, pos = _encint(chunk, pos)
                self.entries[name] = (section, offset, length)
        self._decompressed: bytes | None = None

    def names(self) -> list[str]:
        return [n for n in self.entries if not n.startswith("::") and n not in ("/",)]

    def read(self, name: str) -> bytes:
        section, offset, length = self.entries[name]
        if section == 0:
            start = self.content_offset + offset
            return self.raw[start:start + length]
        blob = self._mscompressed()
        return blob[offset:offset + length]

    # -- LZX section -------------------------------------------------------

    def _raw_section0(self, name: str) -> bytes:
        section, offset, length = self.entries[name]
        if section != 0:
            raise ChmError(f"{name} must live in the uncompressed section")
        start = self.content_offset + offset
        return self.raw[start:start + length]

    def _mscompressed(self) -> bytes:
        if self._decompressed is not None:
            return self._decompressed
        if self.CONTENT not in self.entries:
            raise ChmError("no MSCompressed content section")
        control = self._raw_section0(self.CONTROL)
        if control[4:8] != b"LZXC":
            raise ChmError("unsupported compression (not LZXC)")
        lzxc_version = struct.unpack_from("<I", control, 8)[0]
        reset_interval = struct.unpack_from("<I", control, 12)[0]
        window = struct.unpack_from("<I", control, 16)[0]
        if lzxc_version == 2:
            reset_interval *= 0x8000
            window *= 0x8000
        window_bits = max(15, min(21, (window).bit_length() - 1))

        rt = self._raw_section0(self.RESET_TABLE)
        num_entries = struct.unpack_from("<I", rt, 4)[0]
        header_len = struct.unpack_from("<I", rt, 12)[0]
        uncomp_len = struct.unpack_from("<Q", rt, 16)[0]
        block_len = struct.unpack_from("<Q", rt, 32)[0] or 0x8000
        offsets = [struct.unpack_from("<Q", rt, header_len + 8 * i)[0]
                   for i in range(num_entries)]

        comp = self.read(self.CONTENT)
        frames_per_reset = max(1, reset_interval // block_len)
        out = bytearray()
        # Each reset span is an independent LZX stream starting 16-bit-aligned
        # at the recorded compressed offset.
        for fi in range(0, num_entries, frames_per_reset):
            span_unc = min(frames_per_reset * block_len, uncomp_len - fi * block_len)
            if span_unc <= 0:
                break
            start = offsets[fi]
            end = offsets[fi + frames_per_reset] if fi + frames_per_reset < num_entries else len(comp)
            out += lzx_decompress(comp[start:end], span_unc, window_bits,
                                  base_pos=fi * block_len, total_len=uncomp_len)
        self._decompressed = bytes(out[:uncomp_len])
        return self._decompressed


def chm_to_markdown(path: str | Path) -> str:
    """Extract a CHM and merge its HTML topics into one Markdown document
    (ref: chm_to_markdown, src/convert/chm.rs:19 — same output shape, no
    external extractor needed)."""
    from cqs_tpu_torch.convert import html_to_markdown

    chm = ChmFile(path)
    parts: list[str] = []
    for name in sorted(chm.names()):
        if not name.lower().endswith((".htm", ".html")):
            continue
        html = chm.read(name).decode("utf-8", "replace")
        md = html_to_markdown(html)
        if md.strip():
            parts.append(f"<!-- page: {name} -->\n\n{md}")
    if not parts:
        raise ChmError("no HTML topics found in CHM")
    return "\n\n---\n\n".join(parts) + "\n"
