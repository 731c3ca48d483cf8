"""The device time of the operators launched inside the program's ``moe``
spans, over that of the operators launched inside its ``forward`` spans, in
one profiled pull, in %."""


def read(r: dict):
    t = r.get("trace")
    if r.get("cell") != "index" or not t or not t.get("forward_device_s") \
            or "moe_device_s" not in t:
        return None
    return 100.0 * t["moe_device_s"] / t["forward_device_s"]
