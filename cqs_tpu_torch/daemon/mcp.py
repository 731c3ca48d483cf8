"""MCP stdio server: JSON-RPC bridge over the shared dispatch table.

Reference analog: ``serve_stdio`` (``src/cli/mcp/bridge.rs:39``) — NDJSON
JSON-RPC on stdio with initialize/tools-list/tools-call lifecycle and ~30
read tools. The reference relays to a daemon socket; we serve from the shared
BatchContext directly (and through the socket when a daemon is live, keeping
the bridge thin).
"""

from __future__ import annotations

import json
import sys

from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.daemon.dispatch import BatchContext

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "cqs-tpu", "version": "0.1.0"}


def _tool(name: str, description: str, properties: dict, required: list[str]) -> dict:
    return {
        "name": name,
        "description": description,
        "inputSchema": {"type": "object", "properties": properties,
                        "required": required},
    }


_STR = {"type": "string"}
_INT = {"type": "integer"}

TOOLS: list[dict] = [
    _tool("cqs_search", "Semantic hybrid code search over the indexed project. "
          "Searches code chunks by default; set include_docs to also search "
          "markdown sections / config entries.",
          {"query": _STR, "limit": _INT, "lang": _STR, "filter": _STR,
           "include_docs": {"type": "boolean"}}, ["query"]),
    _tool("cqs_callers", "List functions that call the named function.",
          {"name": _STR}, ["name"]),
    _tool("cqs_callees", "List functions the named function calls.",
          {"name": _STR}, ["name"]),
    _tool("cqs_impact", "Transitive impact (callers, affected tests, risk) of changing a function.",
          {"name": _STR, "depth": _INT}, ["name"]),
    _tool("cqs_trace", "Shortest call path between two functions.",
          {"src": _STR, "dst": _STR}, ["src", "dst"]),
    _tool("cqs_test_map", "Tests that exercise the named function.",
          {"name": _STR}, ["name"]),
    _tool("cqs_dead", "Likely-dead (never-called) functions.", {}, []),
    _tool("cqs_gather", "Assemble reading context for a topic (search + call-graph expansion).",
          {"query": _STR, "depth": _INT, "limit": _INT}, ["query"]),
    _tool("cqs_read", "Read a chunk's source by name.", {"name": _STR}, ["name"]),
    _tool("cqs_similar", "Chunks similar to the named chunk.",
          {"name": _STR, "limit": _INT}, ["name"]),
    _tool("cqs_stats", "Index statistics.", {}, []),
    _tool("cqs_status", "Index freshness status.", {}, []),
    _tool("cqs_notes", "List notes attached to chunks.", {"target": _STR}, []),
    _tool("cqs_scout", "Pre-investigation dashboard for a topic.",
          {"query": _STR, "limit": _INT}, ["query"]),
    _tool("cqs_task", "Full task brief: scout + reading order + impact + placement.",
          {"description": _STR}, ["description"]),
    _tool("cqs_onboard", "Repository onboarding tour.", {}, []),
    _tool("cqs_where", "Suggest where new functionality should live.",
          {"description": _STR}, ["description"]),
    _tool("cqs_related", "Functions related to the named one (shared callees/callers/types).",
          {"name": _STR, "limit": _INT}, ["name"]),
    _tool("cqs_suggest", "Refactor suggestions (long functions, high fan-out, duplicates).",
          {}, []),
    _tool("cqs_plan", "Task description -> template + checklist + starting points.",
          {"description": _STR}, ["description"]),
    _tool("cqs_kind", "Classify a bare name: function/type/const/module.",
          {"name": _STR}, ["name"]),
    _tool("cqs_health", "Composite index health report.", {}, []),
    _tool("cqs_structural", "Structural anti-pattern scan (error swallowing etc.).",
          {"pattern": _STR}, []),
    _tool("cqs_review", "Review a unified diff (impact + findings).",
          {"diff": _STR, "base": _STR}, []),
    _tool("cqs_impact_diff", "Impact analysis of a unified diff.",
          {"diff": _STR, "base": _STR}, []),
    _tool("cqs_explain", "Why did a chunk rank (or not) for a query: per-leg scores + boosts.",
          {"query": _STR, "name": _STR}, ["query", "name"]),
    _tool("cqs_deps", "Chunks referencing the named type.", {"name": _STR}, ["name"]),
    _tool("cqs_neighbors", "Chunks adjacent to the named one in its file.",
          {"name": _STR}, ["name"]),
    _tool("cqs_drift", "Doc-vs-code drift report (stale documentation).", {}, []),
    _tool("cqs_dead_code", "Alias of cqs_dead: likely-dead (never-called) functions.",
          {}, []),
]

#: Mutation tools: exposed only when CQST_MCP_MUTATIONS=1 (ref: 4 env-gated
#: mutation tools, src/cli/mcp/mod.rs:38-58).
MUTATION_TOOLS: list[dict] = [
    _tool("cqs_note_add", "Attach a note to a chunk or path.",
          {"target": _STR, "text": _STR, "sentiment": _STR}, ["target", "text"]),
    _tool("cqs_note_update", "Update an existing note's text/sentiment by id.",
          {"id": {"type": "integer"}, "text": _STR, "sentiment": _STR}, ["id", "text"]),
    _tool("cqs_note_remove", "Delete a note by id.",
          {"id": {"type": "integer"}}, ["id"]),
    _tool("cqs_index", "Fire-and-forget reindex of the project (returns immediately).",
          {"force": {"type": "boolean"}}, []),
    _tool("cqs_refresh", "Reload the daemon's device indexes from the store.", {}, []),
]

def _active_tools() -> list[dict]:
    import os

    tools = list(TOOLS)
    if os.environ.get("CQST_MCP_MUTATIONS") in ("1", "true"):
        tools += MUTATION_TOOLS
    return tools


_TOOL_TO_COMMAND = {t["name"]: t["name"][4:].replace("_", "-")
                    for t in TOOLS + MUTATION_TOOLS}
_TOOL_TO_COMMAND["cqs_test_map"] = "test-map"
_TOOL_TO_COMMAND["cqs_impact_diff"] = "impact-diff"
_TOOL_TO_COMMAND["cqs_note_add"] = "note"
_TOOL_TO_COMMAND["cqs_dead_code"] = "dead"


def serve_stdio(ctx: CommandContext) -> int:
    bctx = BatchContext(ctx)
    out = sys.stdout

    def reply(msg_id, result=None, error=None):
        resp = {"jsonrpc": "2.0", "id": msg_id}
        if error is not None:
            resp["error"] = error
        else:
            resp["result"] = result
        out.write(json.dumps(resp, separators=(",", ":")) + "\n")
        out.flush()

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        method = msg.get("method", "")
        msg_id = msg.get("id")
        params = msg.get("params", {}) or {}

        if method == "initialize":
            reply(msg_id, {
                "protocolVersion": params.get("protocolVersion", PROTOCOL_VERSION),
                "capabilities": {"tools": {}},
                "serverInfo": SERVER_INFO,
            })
        elif method in ("notifications/initialized", "initialized"):
            continue
        elif method == "tools/list":
            reply(msg_id, {"tools": _active_tools()})
        elif method == "tools/call":
            name = params.get("name", "")
            active = {t["name"] for t in _active_tools()}
            command = _TOOL_TO_COMMAND.get(name) if name in active else None
            if command is None:
                reply(msg_id, error={"code": -32602, "message": f"unknown tool {name}"})
                continue
            resp = bctx.dispatch(command, params.get("arguments", {}) or {})
            if "error" in resp:
                reply(msg_id, {
                    "content": [{"type": "text", "text": resp["error"]}],
                    "isError": True,
                })
            else:
                reply(msg_id, {
                    "content": [{"type": "text",
                                 "text": json.dumps(resp.get("results"), indent=1)}],
                })
        elif method == "ping":
            reply(msg_id, {})
        elif msg_id is not None:
            reply(msg_id, error={"code": -32601, "message": f"unknown method {method}"})
    return 0
