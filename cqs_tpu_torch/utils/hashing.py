"""Content hashing and file fingerprints.

Reference analog: blake3 content hashes on chunk rows and the per-origin
``(mtime, size, blake3)`` staleness fingerprint (``src/store/chunks/staleness.rs``,
``src/schema.sql:8-27``), plus the canonical (comment/whitespace-normalized)
hash used for embedding reuse on formatting-only edits (schema v28,
``src/schema.sql:29-33``). We use blake2b (stdlib) as the hash primitive.
"""

from __future__ import annotations

import hashlib
import os
import re
from dataclasses import dataclass
from pathlib import Path

_HASH_LEN = 16  # 128-bit hex digests — plenty for content addressing


def content_hash(data: bytes | str) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8", errors="replace")
    return hashlib.blake2b(data, digest_size=_HASH_LEN).hexdigest()


# Line comments for the common language families. Block comments are handled
# structurally (/* */ and triple-quoted strings are left alone — stripping
# them risks mangling string literals; line-level normalization captures the
# dominant "formatting-only edit" reuse case).
_LINE_COMMENT = re.compile(r"(//|#|--|;;)[^\n]*")
_WS = re.compile(r"\s+")


def canonicalize(code: str) -> str:
    """Normalize code for the embedding-reuse hash: strip line comments,
    collapse all whitespace runs to single spaces, trim."""
    no_comments = _LINE_COMMENT.sub("", code)
    return _WS.sub(" ", no_comments).strip()


def canonical_hash(code: str) -> str:
    """Hash of the comment/whitespace-normalized body. Two chunks with equal
    canonical hashes embed identically, so the pipeline reuses the stored
    embedding instead of re-running the model."""
    return content_hash(canonicalize(code))


@dataclass(frozen=True)
class Fingerprint:
    """Per-file staleness fingerprint: cheap fields first (mtime, size) so the
    expensive content hash only runs when they differ."""

    mtime_ns: int
    size: int
    digest: str

    def matches_stat(self, st: os.stat_result) -> bool:
        return self.mtime_ns == st.st_mtime_ns and self.size == st.st_size


def fingerprint_file(path: str | Path, data: bytes | None = None) -> Fingerprint:
    st = os.stat(path)
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    return Fingerprint(mtime_ns=st.st_mtime_ns, size=st.st_size, digest=content_hash(data))
