"""A deterministic OpenAI-compatible chat server on 127.0.0.1, for running the
LLM commands (``summaries``, ``improve-docs``, ``label-queries``) with no
model and no network: every reply is made from the request's messages alone,
so two runs over one index get the same answers, whichever package asks.

    python -m cqs_tpu_torch.llm.stub --port 8099    # serves until Ctrl+C
    CQST_LLM_BASE_URL=http://127.0.0.1:8099 python -m cqs_tpu_torch summaries --device cpu

Replies, by the system prompt of ``llm/summaries.py``, ``llm/doc_writer.py``
and ``eval/labeling.py``: a one-sentence summary naming the chunk, three
HyDE queries, a doc comment, or a judge's verdict (the candidate whose name
shares the most words with the query; ``NONE`` when none shares one). The
chunk's name is the prompt's ``Function:`` line, else the first declaration
in its code.
"""

from __future__ import annotations

import argparse
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_DECL = re.compile(r"\b(?:def|fn|func|function|class|struct|trait|impl)\s+(\w+)")
_CANDIDATE = re.compile(r"^\[(\d+)\] \S+ (\S+) — ", re.M)


def _words(text: str) -> set[str]:
    text = re.sub(r"([a-z])([A-Z])", r"\1 \2", text)
    return {w.lower() for w in re.split(r"[^A-Za-z0-9]+", text) if len(w) > 2}


def reply(system: str, prompt: str) -> str:
    """The stub's answer to one chat request."""
    m = re.search(r"^Function: (\S+)", prompt, re.M) or _DECL.search(prompt)
    name = m.group(1) if m else "this code"
    if "summarize code" in system:
        return f"{name} is summarized here: it does the work its name says for its callers."
    if "search queries" in system:
        return f"where is {name} | how does {name} work | code that calls {name}"
    if "documentation comment" in system:
        return f"Handles {name.replace('_', ' ')} and returns its result."
    query = prompt.split("\n\n", 2)[1] if prompt.count("\n\n") >= 2 else prompt
    best, best_n = None, 0
    for idx, cand in _CANDIDATE.findall(prompt):
        n = len(_words(cand) & _words(query))
        if n > best_n:
            best, best_n = idx, n
    return best if best is not None else "NONE"


class _Handler(BaseHTTPRequestHandler):
    def do_POST(self):
        if self.path != "/v1/chat/completions":
            self.send_error(404)
            return
        body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
        msgs = body.get("messages", [])
        system = "\n".join(m["content"] for m in msgs if m.get("role") == "system")
        prompt = "\n".join(m["content"] for m in msgs if m.get("role") == "user")
        data = json.dumps({"choices": [{"message": {
            "role": "assistant", "content": reply(system, prompt)}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


def start(port: int = 0) -> tuple[ThreadingHTTPServer, str]:
    """Serve on 127.0.0.1 from a daemon thread: (server, base URL). Stop it
    with ``server.shutdown(); server.server_close()``."""
    srv = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=0, help="0 = any free port")
    srv, url = start(ap.parse_args().port)
    print(url, flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
