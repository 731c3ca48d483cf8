"""Milliseconds a step spends drawing and tokenizing its batch on the host (the
benchmark's span around the feed of ``cmd_train``'s ``run_stage``)."""


def read(r: dict):
    if r.get("cell") != "train" or not r.get("steps"):
        return None
    return r["host_prep_s"] / r["steps"] * 1e3
