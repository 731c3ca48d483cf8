"""The port's slice end to end on the CPU: index -> search -> batched serve,
against the JAX package on the same fixture project.

Tolerances: hit ids and order identical; hit scores within 1e-5."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from cqs_tpu.cli.context import CommandContext as JContext
from cqs_tpu.pipeline import run_index_pipeline as j_index
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.main import main
from cqs_tpu_torch.daemon.batcher import QueryBatcher
from cqs_tpu_torch.models.convert import embedder_params_from_jax
from cqs_tpu_torch.pipeline import run_index_pipeline

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
QUERIES = ["validate token", "retry with exponential backoff", "session store",
           "decode jwt", "check expiry timestamp", "backoff delay",
           "authentication helpers", "revoke an active session"]


def _hits(res):
    return [(h.row.id, h.score) for h in res.hits]


def _assert_same_hits(port, ref):
    assert [i for i, _ in port] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(port, ref):
        assert abs(a - b) <= 1e-5


def _jax_search(root, queries):
    ctx = JContext.create(str(root))
    try:
        return {q: _hits(ctx.engine.search(q)) for q in queries}
    finally:
        ctx.close()


def _port_search(root, queries):
    ctx = CommandContext.create(str(root), device="cpu")
    try:
        return {q: _hits(ctx.engine.search(q)) for q in queries}
    finally:
        ctx.close()


def test_both_packages_index_and_search_alike(tmp_project):
    # each package indexes its own copy; the port's embedder carries the JAX
    # table (embedder_params_from_jax), so stored embeddings agree to f32
    port_root = tmp_project.parent / "port_copy"
    shutil.copytree(tmp_project, port_root)
    jctx = JContext.create(str(tmp_project))
    ctx = CommandContext.create(str(port_root), device="cpu")
    try:
        j_index(jctx.root, jctx.store, jctx.embedder, jctx._maybe_splade(), config=jctx.config)
        jctx.embedder._ensure_model()
        ctx.embedder.load_params(embedder_params_from_jax(
            {"table": np.asarray(jctx.embedder._params["table"])}))
        stats = run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                                   config=ctx.config)
        assert stats.chunks_upserted > 10 and stats.sparse_encoded == stats.chunks_upserted
        ref = {q: _hits(jctx.engine.search(q)) for q in QUERIES}
        port = {q: _hits(ctx.engine.search(q)) for q in QUERIES}
    finally:
        jctx.close()
        ctx.close()
    for q in QUERIES:
        assert port[q], q
        _assert_same_hits(port[q], ref[q])


def test_port_searches_jax_built_slot(tmp_project):
    ctx = JContext.create(str(tmp_project))
    try:
        j_index(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(), config=ctx.config)
        _ = ctx.engine                     # writes dense/dense_base/splade npz + stamps
    finally:
        ctx.close()
    slot = next((tmp_project / ".cqs-tpu").rglob("splade.npz")).parent
    mtimes = {p.name: p.stat().st_mtime_ns for p in slot.glob("*.npz")}
    assert {"dense.npz", "splade.npz"} <= set(mtimes)
    port = _port_search(tmp_project, QUERIES)
    # the port loaded the JAX package's artifacts (stamps matched: no rebuild)
    assert {p.name: p.stat().st_mtime_ns for p in slot.glob("*.npz")} == mtimes
    ref = _jax_search(tmp_project, QUERIES)
    for q in QUERIES:
        _assert_same_hits(port[q], ref[q])


def test_cli_search_json_and_unported(tmp_project, capsys):
    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert main(["validate token", "--path", str(tmp_project), "--device", "cpu",
                 "--json", "-k", "3"]) == 0
    env = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert env["command"] == "search" and 0 < len(env["results"]) <= 3
    assert env["_meta"]["device"] == "cpu"
    assert main(["callers", "validate_token", "--path", str(tmp_project)]) == 2
    assert "not yet ported" in capsys.readouterr().err


def test_cuda_default_fails_loudly_without_gpu(tmp_project):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["index", "--path", str(tmp_project)])


def test_batcher_batched_equals_solo(tmp_project):
    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    solo = _port_search(tmp_project, QUERIES[:5])
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    batcher = QueryBatcher(ctx.engine)
    try:
        batcher.pause()
        futs = [batcher.submit(q) for q in QUERIES[:5]]
        batcher.resume()
        results = [f.result(timeout=60) for f in futs]
    finally:
        batcher.stop()
        ctx.close()
    # one dispatch window; it runs one device batch per target dense index
    # (structural queries serve from the base index, as on the solo path)
    assert batcher.stats["fused"] == 5 and batcher.stats["solo"] == 0
    assert batcher.stats["batches"] in (1, 2)
    assert not batcher._thread.is_alive()
    for q, res in zip(QUERIES[:5], results):
        assert res.strategy.endswith("+batched")
        _assert_same_hits(_hits(res), solo[q])


@pytest.mark.parametrize("block_jax", [True, False])
def test_no_jax_subprocess(tmp_project, block_jax):
    # blocked: a machine without JAX; not blocked: JAX installed, as on the
    # card's machine, where the port must still never import it
    block = 'sys.modules["jax"] = sys.modules["flax"] = sys.modules["optax"] = None'
    code = textwrap.dedent(f"""
        import sys
        {block if block_jax else ""}
        import torch
        torch.set_num_threads(1)
        from cqs_tpu_torch.cli.main import main
        root = {str(tmp_project)!r}
        assert main(["index", "--path", root, "--device", "cpu"]) == 0
        assert main(["validate token", "--path", root, "--device", "cpu", "--json"]) == 0
        loaded = [m for m, v in sys.modules.items()
                  if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")]
        assert not loaded, loaded
        print("NO_JAX_OK")
    """)
    if not block_jax:
        # the reference package still resolves its package-level names
        code += "from cqs_tpu.search import SearchEngine; print(SearchEngine.__name__)\n"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert '"command":"search"' in proc.stdout
    assert block_jax or "SearchEngine" in proc.stdout
