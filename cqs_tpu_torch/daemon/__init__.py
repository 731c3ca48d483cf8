"""Serving: the query micro-batcher (the socket server is not ported yet)."""
