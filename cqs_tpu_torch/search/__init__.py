"""Search: the device program and the engine's solo search path."""

from cqs_tpu_torch.search.engine import SearchEngine, SearchHit, SearchResult  # noqa: F401
