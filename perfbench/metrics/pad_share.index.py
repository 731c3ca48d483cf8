"""Padded positions over all positions handed to ``Embedder._forward``, in %."""


def read(r: dict):
    if r.get("cell") != "index" or not r.get("positions"):
        return None
    return 100.0 * (1.0 - r["real_positions"] / r["positions"])
