"""Storage layer: SQLite metadata store, caches, slots."""

from cqs_tpu_torch.store.cache import EmbeddingCache, QueryCache  # noqa: F401
from cqs_tpu_torch.store.slots import (  # noqa: F401
    DEFAULT_SLOT, delete_slot, list_slots, promote_slot, resolve_slot, slot_dir,
)
from cqs_tpu_torch.store.store import ChunkRow, Store  # noqa: F401
