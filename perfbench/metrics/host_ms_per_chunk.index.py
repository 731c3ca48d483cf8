"""Host milliseconds a chunk: the window's index time outside the benchmark's
spans around ``Embedder._forward`` (each ends in a copy to the host), over
the chunks indexed."""


def read(r: dict):
    if r.get("cell") != "index" or not r.get("chunks") or "forward_s" not in r:
        return None
    return (r["window_s"] - r["forward_s"]) / r["chunks"] * 1e3
