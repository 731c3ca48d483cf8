"""CLI entry point: ``python -m cqs_tpu_torch <command>`` and
``python -m cqs_tpu_torch "query" [--json] [--device cuda|cpu]``.

Port of ``cqs_tpu/cli/main.py``: the parser with the reference's flags for
every one of its commands, the bare-query default (a first argument that
is not a command is a search query), and the dispatch that forwards the
read commands to a live daemon (``daemon/client.py::FORWARDABLE``) before
it runs them in-process; a search with a flag the daemon's request does not
carry (``LOCAL_SEARCH_FLAGS``) runs in-process, where the reference's CLI
forwards it without the flag. The handlers are in ``cli/commands.py``
(``HANDLERS``). ``--device`` defaults to ``cuda`` and fails loudly where there is no
GPU; ``--device cpu`` runs the plain scans and trains on the CPU. A daemon
answers on the device it was started on, whatever ``--device`` the
forwarding CLI was given.
"""

from __future__ import annotations

import argparse
import json
import sys

from cqs_tpu_torch.cli.commands import HANDLERS
from cqs_tpu_torch.cli.envelope import emit, envelope
from cqs_tpu_torch.utils.trace import configure as configure_tracing

#: the reference CLI's commands (cqs_tpu/cli/main.py KNOWN_COMMANDS)
REFERENCE_COMMANDS = {
    "init", "index", "search", "callers", "callees", "deps", "impact", "trace",
    "dead", "test-map", "read", "similar", "stats", "status", "eval", "note",
    "notes", "slot", "gather", "gc", "model", "watch", "batch", "mcp", "ping",
    "scout", "task", "onboard", "where", "related", "suggest", "plan", "kind",
    "review", "impact-diff", "ci", "affected", "health", "structural", "drift",
    "diff", "serve", "sweep", "ablate", "label-queries", "train-data", "train",
    "train-distill", "train-reranker", "train-centroids", "summaries", "doctor",
    "telemetry", "chat", "completions", "project", "ref", "convert", "embed-2d",
    "export-model", "audit-mode", "audit-extraction", "hook", "explain", "context",
    "blame", "reconstruct", "stale", "neighbors", "refresh", "improve-docs",
    "brief", "cache",
}
#: what the port serves: every reference command
PORTED_COMMANDS = set(HANDLERS)
_VALUE_FLAGS = {"--slot", "--path", "--device"}
#: ``search`` flags that ``daemon/client.py::translate_args`` leaves out of a
#: daemon's request: a search that sets one runs in-process
LOCAL_SEARCH_FLAGS = ("worktree", "projects", "rrf", "budget", "include_docs", "types",
                      "exclude_types", "name_only", "no_demote", "pattern", "expand_parent")


def search_stays_local(args) -> bool:
    """True for a search that a daemon would answer without one of its
    flags (``--threshold 0`` is a flag too)."""
    return args.threshold is not None or any(getattr(args, f) for f in LOCAL_SEARCH_FLAGS)


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    # SUPPRESS defaults: the flags are parented onto the root parser and every
    # subparser, and a concrete default in a subparser would overwrite a
    # root-level value; main() fills the effective defaults
    common.add_argument("--json", action="store_true", default=argparse.SUPPRESS,
                        help="JSON envelope output")
    common.add_argument("--slot", default=argparse.SUPPRESS, help="index slot to use")
    common.add_argument("--path", default=argparse.SUPPRESS,
                        help="project root (default: auto-detect)")
    common.add_argument("--device", default=argparse.SUPPRESS,
                        help="torch device: cuda (default) or cpu")
    common.add_argument("-v", "--verbose", action="count", default=argparse.SUPPRESS)

    p = argparse.ArgumentParser(
        prog="cqs-tpu-torch", parents=[common],
        description="Hybrid code search on PyTorch/CUDA: index, search, call-graph "
                    "reads, agent context and diff commands, the eval gate, a warm "
                    "query daemon, the embedder's trainers and LLM enrichment.")
    _orig_sub = p.add_subparsers(dest="command")

    class _Sub:
        """add_parser shim that threads the common flags into every
        subcommand, so ``stats --json`` works flag-after-command."""

        def add_parser(self, *a, **kw):
            kw.setdefault("parents", [common])
            return _orig_sub.add_parser(*a, **kw)

    sub = _Sub()
    sub.add_parser("init", help="initialize a project index directory")
    sp = sub.add_parser("index", help="build or update the index")
    sp.add_argument("--force", action="store_true", help="reindex everything")
    sp.add_argument("--no-enrich", action="store_true",
                    help="skip the call-graph enrichment pass")
    sp = sub.add_parser("search", help="search (also the bare default)")
    sp.add_argument("query")
    sp.add_argument("-k", "--limit", type=int, default=10)
    sp.add_argument("--worktree", action="store_true",
                    help="overlay uncommitted edits (ephemeral delta index)")
    sp.add_argument("--project", action="append", dest="projects",
                    help="search a registered project instead (repeatable)")
    sp.add_argument("--lang", help="language filter")
    sp.add_argument("--filter", dest="path_filter", help="path glob filter")
    sp.add_argument("--alpha", type=float, help="override fusion alpha")
    sp.add_argument("--rerank", action="store_true",
                    help="cross-encoder rerank of the top pool (opt-in; [reranker] model_path)")
    sp.add_argument("--rrf", action="store_true", help="RRF-fuse with the FTS leg")
    sp.add_argument("--body", action="store_true", help="include chunk bodies")
    sp.add_argument("--budget", type=int, default=0,
                    help="pack result bodies into a token budget (0 = off)")
    sp.add_argument("--include-docs", action="store_true",
                    help="include section/module/config chunks")
    sp.add_argument("--type", action="append", dest="types", metavar="CHUNK_TYPE")
    sp.add_argument("--exclude-type", action="append", dest="exclude_types",
                    metavar="CHUNK_TYPE")
    sp.add_argument("--name-only", action="store_true",
                    help="FTS name lookup only (skip the hybrid pipeline)")
    sp.add_argument("--threshold", type=float, default=None,
                    help="cosine floor (score_threshold knob)")
    sp.add_argument("--no-demote", action="store_true",
                    help="disable test/vendored/data/doc demotions")
    sp.add_argument("--pattern", choices=["builder", "error_swallow", "async",
                                          "mutex", "unsafe", "recursion"],
                    help="structural pattern filter on results (3x over-fetch)")
    sp.add_argument("--expand-parent", action="store_true",
                    help="attach containing type/module context (small-to-big)")

    sp = sub.add_parser("callers", help="who calls this function")
    sp.add_argument("name")
    sp = sub.add_parser("callees", help="what this function calls")
    sp.add_argument("name")
    sp = sub.add_parser("deps", help="chunks referencing a type")
    sp.add_argument("name")
    sp = sub.add_parser("impact", help="transitive impact of changing a function")
    sp.add_argument("name")
    sp.add_argument("--depth", type=int, default=None)
    sp.add_argument("--mermaid", action="store_true", help="render as a mermaid flowchart")
    sp = sub.add_parser("trace", help="shortest call path between two functions")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.add_argument("--mermaid", action="store_true", help="render as a mermaid flowchart")
    sub.add_parser("dead", help="likely-dead code report")
    sp = sub.add_parser("test-map", help="tests covering a function")
    sp.add_argument("name")
    sp = sub.add_parser("explain", help="why did this chunk rank for this query?")
    sp.add_argument("query")
    sp.add_argument("name")
    sp = sub.add_parser("context", help="chunk plus surrounding file context")
    sp.add_argument("name")
    sp.add_argument("--lines", type=int, default=10)
    sp = sub.add_parser("blame", help="git blame summary for a chunk")
    sp.add_argument("name")
    sp = sub.add_parser("reconstruct", help="reassemble a file from its indexed chunks")
    sp.add_argument("origin")
    sub.add_parser("stale", help="files whose index entries are out of date")
    sp = sub.add_parser("neighbors", help="chunks adjacent to the named one in its file")
    sp.add_argument("name")
    sp = sub.add_parser("read", help="print a chunk by name or id")
    sp.add_argument("name")
    sp = sub.add_parser("similar", help="chunks similar to a given chunk")
    sp.add_argument("name")
    sp.add_argument("-k", "--limit", type=int, default=10)
    sp = sub.add_parser("eval", help="run the retrieval eval gate")
    sp.add_argument("queries", help="path to a v3-format eval JSON")
    sp.add_argument("--baseline", help="saved report to diff against")
    sp.add_argument("--save", help="write the report JSON here")
    sp.add_argument("--rerank", action="store_true",
                    help="cross-encoder rerank over the top pool (needs reranker weights)")
    sp.add_argument("--triage", metavar="OUT",
                    help="per-query leg triage (dense/sparse/FTS gold ranks) -> JSON")
    sp.add_argument("--category", help="triage only this labeled category")
    sp = sub.add_parser("note", help="attach a note to a chunk/path")
    sp.add_argument("target")
    sp.add_argument("text")
    sp.add_argument("--sentiment", default="neutral",
                    choices=["positive", "negative", "neutral", "warning", "todo"])
    sp = sub.add_parser("notes", help="list notes")
    sp.add_argument("target", nargs="?")
    sp = sub.add_parser("slot", help="manage index slots")
    sp.add_argument("action", choices=["list", "promote", "delete"])
    sp.add_argument("name", nargs="?")
    sp = sub.add_parser("gather", help="assemble reading context for a topic")
    sp.add_argument("query")
    sp.add_argument("--depth", type=int, default=2)
    sp.add_argument("-k", "--limit", type=int, default=20)
    sp.add_argument("--budget", type=int, default=0,
                    help="pack bodies into a token budget (0 = off)")
    sp.add_argument("--direction", choices=["both", "callees", "callers"],
                    default="both", help="call-graph expansion direction")
    sp.add_argument("--seed-limit", type=int, default=None,
                    help="max search hits seeding the walk (default limit/2)")
    sp.add_argument("--seed-threshold", type=float, default=0.0,
                    help="min seed score (0 = off)")
    sp.add_argument("--decay", type=float, default=0.6, help="per-hop score decay factor")

    sp = sub.add_parser("scout", help="pre-investigation dashboard for a topic")
    sp.add_argument("query")
    sp = sub.add_parser("task", help="full task brief: scout+gather+impact+placement")
    sp.add_argument("description")
    sp = sub.add_parser("onboard", help="repo tour, or a guided concept tour")
    sp.add_argument("concept", nargs="?", default=None,
                    help="concept to tour (entry point -> call chain -> "
                         "callers -> types -> tests); omit for the repo tour")
    sp.add_argument("--depth", type=int, default=3, help="callee BFS depth")
    sp.add_argument("--direction", choices=("callees", "callers", "both"),
                    default="callees",
                    help="which call-graph side gets the full-depth BFS "
                         "(the other side walks one hop)")
    sp = sub.add_parser("where", help="suggest where new functionality should live")
    sp.add_argument("description")
    sp = sub.add_parser("related", help="functions related to the named one")
    sp.add_argument("name")
    sp.add_argument("-k", "--limit", type=int, default=10)
    sub.add_parser("suggest", help="refactor suggestions")
    sp = sub.add_parser("plan", help="task description -> template + checklist")
    sp.add_argument("description")
    sp = sub.add_parser("kind", help="classify a bare name (function/type/const/module)")
    sp.add_argument("name")

    sp = sub.add_parser("review", help="review the current git diff")
    sp.add_argument("--base", help="git base ref (default: working tree diff)")
    sp.add_argument("--diff-file", help="read a unified diff from a file instead of git")
    sp = sub.add_parser("impact-diff", help="impact analysis of the current git diff")
    sp.add_argument("--base")
    sp.add_argument("--diff-file")
    sp = sub.add_parser("ci", help="CI gate on diff impact risk (exit 3 on breach)")
    sp.add_argument("--base")
    sp.add_argument("--diff-file")
    sp.add_argument("--threshold", default="High", choices=["High", "Medium", "Off"])
    sp = sub.add_parser("affected", help="tests affected by the current git diff")
    sp.add_argument("--base")
    sp.add_argument("--diff-file")

    sub.add_parser("health", help="composite index health report")
    sp = sub.add_parser("structural", help="structural anti-pattern scan")
    sp.add_argument("--pattern", help="only this pattern (e.g. error_swallow)")
    sub.add_parser("drift", help="doc-vs-code drift report")
    sp = sub.add_parser("diff", help="semantic diff vs another indexed slot")
    sp.add_argument("other_slot")

    sp = sub.add_parser("project", help="cross-project registry")
    sp.add_argument("action", choices=["add", "list", "remove"])
    sp.add_argument("name", nargs="?")
    sp.add_argument("root", nargs="?")
    sp = sub.add_parser("ref", help="external read-only reference indexes")
    sp.add_argument("action", choices=["add", "list", "remove"])
    sp.add_argument("name", nargs="?")
    sp.add_argument("root", nargs="?")
    sub.add_parser("gc", help="drop orphaned rows and rebuild artifacts")
    sub.add_parser("model", help="list embedding model presets")

    sub.add_parser("stats", help="index statistics")
    sp = sub.add_parser("status", help="index freshness status")
    sp.add_argument("--watch", action="store_true", help="include daemon ops snapshot")
    sp.add_argument("--wait", action="store_true",
                    help="block until the daemon reports fresh")
    sp.add_argument("--timeout", type=float, default=60.0)

    sp = sub.add_parser("watch", help="watch daemon: incremental reindex + query server")
    sp.add_argument("--serve", action="store_true", help="expose the query socket")
    sp.add_argument("--once", action="store_true", help="one reconcile pass, then exit")
    sub.add_parser("batch", help="JSONL request loop on stdin")
    sub.add_parser("mcp", help="MCP stdio server")
    sub.add_parser("ping", help="check whether a daemon is live")
    sub.add_parser("refresh", help="ask a live daemon to reload its indexes")
    sp = sub.add_parser("serve", help="local HTTP API + web UI")
    sp.add_argument("--port", type=int, default=7777)
    sp.add_argument("--host", default="127.0.0.1")
    sp = sub.add_parser("sweep", help="LOCO sweep of one knob over a labeled query pool")
    sp.add_argument("knob", help="knob name (e.g. fts_df_cutoff)")
    sp.add_argument("values", nargs="+", help="values to sweep")
    sp.add_argument("--pool", nargs="+", required=True, help="labeled v3-format JSONs")
    sp.add_argument("--exclude", nargs="*", default=[], help="held-out gate splits")
    sp.add_argument("-k", type=int, default=5)
    sp.add_argument("--save", help="write the sweep table JSON here")
    sp = sub.add_parser("ablate", help="disable each shipped recall lever in turn, re-eval")
    sp.add_argument("queries", help="v3-format eval split JSON")
    sp.add_argument("--levers", help="comma list of knob[=off_value] overriding the built-in set")
    sp.add_argument("--save", help="write the ablation table JSON here")
    sp = sub.add_parser("label-queries", help="build candidate pools and dual-judge label them")
    sp.add_argument("queries", help="text file with one query per line, or a v3 JSON")
    sp.add_argument("--out", default="labeled.v3.json")
    sp.add_argument("--pool-out", help="also write the raw candidate pools here")
    sp.add_argument("-k", type=int, default=10)
    sp.add_argument("--mock", action="store_true",
                    help="use mock judges (plumbing test; no LLM provider)")
    sp = sub.add_parser("embed-2d", help="compute 2-D projection coords for the cluster view")
    sp.add_argument("--method", default="auto", choices=["auto", "pca", "umap"])
    sp = sub.add_parser("train-data", help="mine (query, positive, negatives) pairs")
    sp.add_argument("--out", default="train_pairs.jsonl")
    sp.add_argument("--source", choices=["git", "store", "both", "labeled", "callgraph", "all"],
                    default="both")
    sp.add_argument("--max", type=int, default=2000)
    sp.add_argument("--labeled", nargs="*", default=[],
                    help="v3-format labeled query JSONs (query -> gold) to mine")
    sp.add_argument("--exclude", nargs="*", default=[],
                    help="held-out split JSONs whose queries must NOT train")
    sp.add_argument("--engine-negatives", type=int, default=0, metavar="K",
                    help="replace mined negatives with the engine's own top-K "
                         "non-gold results per query (serving-order hard "
                         "negatives)")
    sp = sub.add_parser("train", help="contrastive fine-tune on mined pairs")
    sp.add_argument("pairs", help="train_pairs.jsonl from train-data")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--family", choices=["bert", "hybrid"], default="bert",
                    help="hybrid = frozen hash leg + learned BERT leg (wide-and-deep)")
    sp.add_argument("--finetune", help="second-stage pairs (e.g. labeled queries)")
    sp.add_argument("--finetune-steps", type=int, default=0)
    sp.add_argument("--finetune-lr", type=float, default=0.0)
    sp.add_argument("--out", default="finetuned", help="output checkpoint dir")
    sp.add_argument("--batch", type=int, default=0,
                    help="global batch (in-batch negatives); 0 = config default")
    sp.add_argument("--lr", type=float, default=0.0, help="learning rate; 0 = default")
    sp.add_argument("--seq-len", type=int, default=0, help="train sequence length")
    sp.add_argument("--hidden-size", type=int, default=0)
    sp.add_argument("--num-layers", type=int, default=0)
    sp.add_argument("--intermediate-size", type=int, default=0)
    sp.add_argument("--no-hard-negatives", dest="hard_negatives",
                    action="store_false", default=True)
    sp.add_argument("--negatives-per", type=int, default=1,
                    help="hard negatives per pair per step (softmax columns)")
    sp.add_argument("--query-prefix", default="q: ",
                    help="query-side prefix trained in and stamped into the "
                         "checkpoint (serving applies it automatically)")
    sp.add_argument("--doc-prefix", default="d: ",
                    help="document-side prefix (see --query-prefix)")
    sp.add_argument("--eval-every", type=int, default=0, metavar="N",
                    help="nonzero: print a retrieval-rank probe (gold rank "
                         "among all probe positives) at each stage boundary; "
                         "probe set = --finetune pairs if given else the "
                         "train pairs")

    sp = sub.add_parser("train-distill", help="distill the fused ordering into a dense student")
    sp.add_argument("--labels", default=".cqs-tpu/distill_labels.jsonl",
                    help="teacher label JSONL (generated on first run)")
    sp.add_argument("--pool", nargs="+", default=[], help="labeled query JSONs to mine")
    sp.add_argument("--exclude", nargs="*", default=[], help="held-out splits to exclude")
    sp.add_argument("--relabel", action="store_true", help="regenerate teacher labels")
    sp.add_argument("--labels-only", action="store_true", help="stop after the teacher pass")
    sp.add_argument("-k", type=int, default=32, help="teacher top-k per query")
    sp.add_argument("--cands", type=int, default=16, help="candidates per training example")
    sp.add_argument("--steps", type=int, default=500)
    sp.add_argument("--batch", type=int, default=0)
    sp.add_argument("--lr", type=float, default=0.0)
    sp.add_argument("--seq-len", type=int, default=0, dest="seq_len")
    sp.add_argument("--hidden-size", type=int, default=0, dest="hidden_size")
    sp.add_argument("--num-layers", type=int, default=0, dest="num_layers")
    sp.add_argument("--intermediate-size", type=int, default=0, dest="intermediate_size")
    sp.add_argument("--temperature", type=float, default=0.0)
    sp.add_argument("--teacher-temp", type=float, default=0.05, dest="teacher_temp")
    sp.add_argument("--out", default=".cqs-tpu/distilled")
    sp.add_argument("--resume", action="store_true",
                    help="continue from an existing --out/params.pkl")
    sp.add_argument("--gate", nargs="*", default=[],
                    help="held-out gate split JSONs: student-only R@k probe after training")

    sp = sub.add_parser("train-reranker", help="pairwise cross-encoder training on mined pairs")
    sp.add_argument("pairs")
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--batch", type=int, default=32)
    sp.add_argument("--lr", type=float, default=0.0)
    sp.add_argument("--seq-len", type=int, default=0, dest="seq_len")
    sp.add_argument("--hidden-size", type=int, default=0)
    sp.add_argument("--num-layers", type=int, default=0)
    sp.add_argument("--intermediate-size", type=int, default=0)
    sp.add_argument("--init", help="warm-start from a previous reranker checkpoint")
    sp.add_argument("--out", default="reranker_ckpt")

    sp = sub.add_parser("train-centroids", help="train query-category centroids from labeled queries")
    sp.add_argument("queries", nargs="+", help="v3-format eval JSONs with categories")
    sp = sub.add_parser("improve-docs", help="LLM-drafted doc comments as a staged patch")
    sp.add_argument("--out", default="improve_docs.patch")
    sp.add_argument("--max", type=int, default=50)
    sp = sub.add_parser("summaries", help="LLM summary/HyDE enrichment pass")
    sp.add_argument("--max", type=int, default=0, help="cap chunks (0 = all)")
    sp.add_argument("--no-hyde", action="store_true")
    sp = sub.add_parser("convert", help="convert HTML/PDF/CHM docs to markdown for indexing")
    sp.add_argument("src", nargs="+")
    sp.add_argument("--out", default="converted_docs")
    sp = sub.add_parser("export-model", help="export the active embedder config + params")
    sp.add_argument("--out", default="exported_model")
    sub.add_parser("audit-mode", help="print effective config, knobs and env overrides")
    sp = sub.add_parser("hook", help="install the git pre-push CI-gate hook")
    sp.add_argument("--uninstall", action="store_true")
    sp = sub.add_parser("audit-extraction", help="parser fidelity audit vs an independent scanner")
    sp.add_argument("--calls", action="store_true",
                    help="python call-edge precision/recall vs the ast module")
    sp.add_argument("--save", help="write the report JSON here")
    sp = sub.add_parser("brief", help="one-line-per-function summary for a file")
    sp.add_argument("file", help="file path as stored in the index (e.g. src/lib.rs)")
    sp = sub.add_parser("cache", help="manage the embeddings cache")
    csub = sp.add_subparsers(dest="cache_cmd", required=True)
    c = csub.add_parser("stats", help="entries, size, models", parents=[common])
    c.add_argument("--per-model", action="store_true", help="per-model entry counts and bytes")
    c = csub.add_parser("clear", help="delete all cached embeddings", parents=[common])
    c.add_argument("--model", help="only this model fingerprint")
    c = csub.add_parser("prune", help="drop entries older than DAYS, or one model's",
                        parents=[common])
    c.add_argument("days", nargs="?", type=float, default=None)
    c.add_argument("--model", help="drop every entry for this model fingerprint")
    csub.add_parser("compact", help="VACUUM the cache DB", parents=[common])
    sub.add_parser("doctor", help="environment, device and index diagnostics")
    sp = sub.add_parser("telemetry", help="render the telemetry log")
    sp.add_argument("--mine", action="store_true",
                    help="extract zero/low-result queries as eval candidates")
    sub.add_parser("chat", help="interactive REPL over the batch grammar")
    sp = sub.add_parser("completions", help="print shell completions")
    sp.add_argument("shell", choices=["bash", "zsh"], nargs="?", default="bash")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _VALUE_FLAGS:
            i += 2
            continue
        if a.startswith("-"):
            i += 1
            continue
        if a not in REFERENCE_COMMANDS:
            argv = argv[:i] + ["search"] + argv[i:]
        break
    args = build_parser().parse_args(argv)
    for k, v in (("json", False), ("slot", None), ("path", None), ("verbose", 0),
                 ("device", "cuda")):
        if not hasattr(args, k):
            setattr(args, k, v)
    configure_tracing(args.verbose)
    if not args.command:
        build_parser().print_help()
        return 0
    try:
        return dispatch(args)
    except BrokenPipeError:
        return 0


def dispatch(args) -> int:
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.daemon.client import FORWARDABLE, request, translate_args

    handler = HANDLERS[args.command]
    ctx = CommandContext.create(args.path, args.slot, device=args.device)
    try:
        # read commands go to a live daemon first: its warm handles beat an
        # in-process cold start; without one (or on an error answer) the
        # command runs here. A search with a flag the daemon's request does
        # not carry (--worktree: this worktree's overlay; --rrf, --pattern,
        # ...) stays here, or the daemon would answer another search
        if args.command in FORWARDABLE and not (args.command == "search"
                                                and search_stays_local(args)):
            resp = request(ctx.index_dir, args.command, translate_args(args.command, args))
            if resp is not None and "error" not in resp:
                if args.json:
                    emit(envelope(args.command, resp.get("results"),
                                  meta={"daemon": True,
                                        "elapsed_ms": resp.get("elapsed_ms")}), True)
                else:
                    _render_forwarded(args.command, resp)
                return 0
        return handler(ctx, args)
    finally:
        ctx.close()


def _render_forwarded(command: str, resp: dict) -> None:
    """Human rendering for daemon-forwarded responses."""
    results = resp.get("results")
    if command == "search" and isinstance(results, list):
        for h in results:
            print(f"{h.get('score', 0):6.3f}  {h.get('origin')}:{h.get('line_start')}  "
                  f"{h.get('name')}  [{h.get('chunk_type')}]")
        if not results:
            print("(no results)")
        print(f"# daemon {resp.get('elapsed_ms')} ms", file=sys.stderr)
        return
    json.dump(results, sys.stdout, indent=1)
    sys.stdout.write("\n")
