"""Index artifact stamps + checksums.

Reference analog: HNSW ``StoreStamp`` + blake3 checksum persistence
(``src/hnsw/persist.rs:141,481``), the CAGRA JSON sidecar (``src/cagra.rs:
20-40``), and the SPLADE binary header (``src/splade/index.rs:35-50``): every
persisted index validates (model fingerprint, dim, chunk count, store
generation, content checksum) at load and FALLS BACK TO REBUILD on any
mismatch — corruption can cost a rebuild, never wrong results.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass

FORMAT_VERSION = 1


@dataclass(frozen=True)
class Stamp:
    model_fingerprint: str
    dim: int
    chunk_count: int
    generation: int
    kind: str = "dense"            # dense | dense_base | splade | graph
    format_version: int = FORMAT_VERSION

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Stamp":
        d = json.loads(s)
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})

    def matches(self, other: "Stamp") -> bool:
        return self == other


def checksum(*arrays) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


class StampMismatch(Exception):
    """Persisted index doesn't match the live store — rebuild required."""
