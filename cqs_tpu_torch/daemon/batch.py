"""Batch mode: JSONL request loop on stdin with pipeline fan-out syntax.

Reference analog: ``src/cli/batch/mod.rs`` — JSONL stdin loop over a
persistent store + lazy embedder, and the pipeline syntax
``search "x" | callers | test-map`` that fans each stage's results into the
next command (``batch/pipeline.rs``).
"""

from __future__ import annotations

import json
import shlex

from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.daemon.dispatch import BatchContext


def parse_pipeline(line: str) -> list[tuple[str, dict]]:
    """Parse ``search "x" -k 5 | callers | test-map`` into stages."""
    stages = []
    for seg in line.split("|"):
        toks = shlex.split(seg.strip())
        if not toks:
            continue
        cmd = toks[0]
        args: dict = {}
        positional = []
        i = 1
        while i < len(toks):
            t = toks[i]
            if t in ("-k", "--limit"):
                args["limit"] = int(toks[i + 1]); i += 2
            elif t == "--lang":
                args["lang"] = toks[i + 1]; i += 2
            elif t == "--filter":
                args["filter"] = toks[i + 1]; i += 2
            elif t == "--depth":
                args["depth"] = int(toks[i + 1]); i += 2
            else:
                positional.append(t); i += 1
        if cmd in ("search", "gather"):
            if positional:
                args["query"] = " ".join(positional)
        elif cmd == "trace":
            if len(positional) >= 2:
                args["src"], args["dst"] = positional[0], positional[1]
        elif positional:
            args["name"] = positional[0]
        stages.append((cmd, args))
    return stages


def _result_names(results) -> list[str]:
    """Pull chunk names out of a stage's results for fan-out."""
    names: list[str] = []
    if isinstance(results, list):
        for r in results:
            if isinstance(r, dict):
                n = r.get("name")
                if n:
                    names.append(str(n).split(".")[-1].split("#w")[0])
    elif isinstance(results, dict):
        for key in ("callers", "results"):
            sub = results.get(key)
            if isinstance(sub, list):
                names.extend(_result_names(sub))
    seen = set()
    return [n for n in names if not (n in seen or seen.add(n))]


def run_pipeline(bctx: BatchContext, stages: list[tuple[str, dict]]) -> dict:
    if not stages:
        return {"error": "empty pipeline", "code": 2}
    resp = bctx.dispatch(*stages[0])
    for cmd, args in stages[1:]:
        if "error" in resp:
            return resp
        names = _result_names(resp.get("results"))
        fanned = []
        for name in names[:25]:
            sub = bctx.dispatch(cmd, {**args, "name": name})
            fanned.append({"input": name, **{k: sub[k] for k in ("results", "error")
                                             if k in sub}})
        resp = {"ok": True, "command": cmd, "results": fanned, "fanned_from": len(names)}
    return resp


def run_batch_loop(ctx: CommandContext, stdin, stdout) -> int:
    bctx = BatchContext(ctx)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            if line.startswith("{"):
                req = json.loads(line)
                if "pipeline" in req:
                    resp = run_pipeline(bctx, [(s["command"], s.get("args", {}))
                                               for s in req["pipeline"]])
                else:
                    resp = bctx.dispatch(req.get("command", ""), req.get("args", {}) or {})
            else:
                resp = run_pipeline(bctx, parse_pipeline(line))
        except json.JSONDecodeError as e:
            resp = {"error": f"bad json: {e}", "code": 2}
        stdout.write(json.dumps(resp, separators=(",", ":")) + "\n")
        stdout.flush()
    return 0
