"""The traced window's share, in %, in which no device activity ran."""


def read(r: dict):
    t = r.get("trace")
    if r.get("cell") != "train" or not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
