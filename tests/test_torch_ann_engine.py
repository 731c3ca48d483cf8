"""The port's engine with the ANN tier (``index_kind`` graph and tiered), the
worktree overlay and ``embed-2d``, against the JAX package on the fixture
project, on the CPU. Both packages index a copy of the project each (the
port's embedder carries the JAX hash table, so the stored embeddings agree),
then the same queries, file mutations and refreshes go through both.

Tolerances: hit ids and order identical, hit scores within 1e-5; refresh
outcome dicts, tier id lists and graph neighbor lists equal; the port's
batched (``QueryBatcher``) hits equal to its solo hits bit for bit; 2-D
coordinates within 1e-4 of the reference's up to one sign per axis (a
singular vector's sign is arbitrary, and the reference's already depends on
its backend)."""

import numpy as np
import pytest
import torch

from cqs_tpu.ops.project2d import pca_2d as j_pca_2d, store_projection as j_store_projection
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.main import main
from cqs_tpu_torch.daemon.batcher import QueryBatcher
from cqs_tpu_torch.index import GraphIndex, TieredIndex
from cqs_tpu_torch.ops.project2d import pca_2d, store_projection
from cqs_tpu_torch.search.engine import SearchEngine
from cqs_tpu_torch.search.router import Category
from test_torch_refresh import NEW_MODULE, _Pair, _mutate
from test_torch_slice import QUERIES, _assert_same_hits, _hits, same_tokenizer_path  # noqa: F401

torch.set_num_threads(1)
DENSE_QUERIES = QUERIES + ["frobnicate widget", "calibrate pressure gauge"]
#: every category's alpha at 1: each query is dense-only, the ANN's case
ALPHA_ONE = {f"CQST_ALPHA_{c.value.upper()}": "1.0" for c in Category}


@pytest.fixture
def ann_calls(monkeypatch):
    """Counts the port's ANN-branch answers."""
    calls = {"n": 0}
    orig = SearchEngine._ann_query

    def counted(self, *a, **kw):
        out = orig(self, *a, **kw)
        calls["n"] += out is not None
        return out

    monkeypatch.setattr(SearchEngine, "_ann_query", counted)
    return calls


def _dense_hits(engine, queries=DENSE_QUERIES):
    return {q: _hits(engine.search(q, alpha_override=1.0)) for q in queries}


def _assert_same_dense_hits(pair, queries=DENSE_QUERIES):
    port, ref = _dense_hits(pair.ctx.engine, queries), _dense_hits(pair.jctx.engine, queries)
    for q in queries:
        _assert_same_hits(port[q], ref[q])
    return port


@pytest.mark.parametrize("kind,cls", [("graph", GraphIndex), ("tiered", TieredIndex)])
def test_ann_engine_matches_reference(tmp_project, monkeypatch, ann_calls, kind, cls):
    monkeypatch.setenv("CQST_INDEX_KIND", kind)
    pair = _Pair(tmp_project)
    try:
        eng = pair.ctx.engine
        assert isinstance(eng.ann, cls) and eng.ann.count == pair.jctx.engine.ann.count
        base = eng.ann if kind == "graph" else eng.ann.base
        jbase = pair.jctx.engine.ann if kind == "graph" else pair.jctx.engine.ann.base
        assert base.ids == jbase.ids
        np.testing.assert_array_equal(base._neighbors, jbase._neighbors)
        port = _assert_same_dense_hits(pair)
        assert ann_calls["n"] > 0
        # at the fixture's size the beam holds every row: the ANN's answer is
        # the exact dense-only program's on the same dense index
        ann, eng.ann, eng._result_cache = eng.ann, None, {}
        calls = ann_calls["n"]
        for q, hits in _dense_hits(eng).items():
            _assert_same_hits(port[q], hits)
        assert ann_calls["n"] == calls
        eng.ann = ann
    finally:
        pair.close()


@pytest.mark.parametrize("kind", ["graph", "tiered"])
def test_batched_equals_solo_through_the_ann(tmp_project, monkeypatch, ann_calls, kind):
    monkeypatch.setenv("CQST_INDEX_KIND", kind)
    for k, v in ALPHA_ONE.items():
        monkeypatch.setenv(k, v)
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        from cqs_tpu_torch.pipeline import run_index_pipeline

        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        eng = ctx.engine
        solo = {q: _hits(eng.search(q)) for q in QUERIES}
        n_solo = ann_calls["n"]
        assert n_solo > 0
        eng._result_cache = {}
        batcher = QueryBatcher(eng)
        try:
            batcher.pause()
            futs = [batcher.submit(q) for q in QUERIES]
            batcher.resume()
            batched = [f.result(timeout=60) for f in futs]
        finally:
            batcher.stop()
        assert batcher.stats["fused"] == 0 and ann_calls["n"] == 2 * n_solo
        for q, res in zip(QUERIES, batched):
            assert _hits(res) == solo[q], q
    finally:
        ctx.close()


def test_tiered_refresh_matches_reference_step_by_step(tmp_project, monkeypatch, ann_calls):
    monkeypatch.setenv("CQST_INDEX_KIND", "tiered")
    pair = _Pair(tmp_project)
    try:
        port, ref = pair.ctx.engine, pair.jctx.engine
        base0 = port.ann.base
        _mutate(pair.j_root)
        _mutate(pair.t_root)
        pair.reindex()
        got, want = pair.refresh()
        assert got == want and "appended" in got
        # no rebuild: the same base with its rows tombstoned, the new rows in
        # the delta
        assert port.ann.base is base0
        assert port.ann.delta.ids == ref.ann.delta.ids and port.ann.delta_count > 0
        assert port.ann._removed_base == ref.ann._removed_base != set()
        np.testing.assert_array_equal(port.ann.base.mask.numpy(), np.asarray(ref.ann.base.mask))
        assert port.ann.count == ref.ann.count
        hits = _assert_same_dense_hits(pair)
        # the added file is found from the delta tier before any rebuild
        top = port.search("frobnicate widget", alpha_override=1.0).hits[0].row
        assert top.name == "frobnicate_widget" and top.id in port.ann.delta.ids
        assert "frobnicate" in NEW_MODULE and hits["frobnicate widget"]
        assert pair.refresh() == ({"unchanged": True}, {"unchanged": True})
    finally:
        pair.close()


def test_graph_refresh_rebuilds_the_graph_like_the_reference(tmp_project, monkeypatch):
    monkeypatch.setenv("CQST_INDEX_KIND", "graph")
    pair = _Pair(tmp_project)
    try:
        port, ref = pair.ctx.engine, pair.jctx.engine
        old, gen = port.ann, port.index_generation
        _mutate(pair.j_root)
        _mutate(pair.t_root)
        pair.reindex()
        got, want = pair.refresh()
        assert got == want
        assert port.ann is not old and port.index_generation == gen + 1
        assert port.ann.ids == ref.ann.ids == [c for c in port.dense.ids if c]
        np.testing.assert_array_equal(port.ann._neighbors, ref.ann._neighbors)
        _assert_same_dense_hits(pair)
    finally:
        pair.close()


EDITED_AUTH = '''"""Authentication helpers."""

def rotate_signing_keys(keyring):
    """Rotate every signing key in the keyring and record the epoch."""
    return keyring
'''


def test_worktree_overlay_matches_reference(tmp_project):
    pair = _Pair(tmp_project)
    try:
        for root in (pair.j_root, pair.t_root):
            (root / "src" / "auth.py").write_text(EDITED_AUTH)
        for q in ["rotate signing keys", "validate token"] + QUERIES[:4]:
            port = pair.ctx.engine.search(q, use_overlay=True)
            ref = pair.jctx.engine.search(q, use_overlay=True)
            _assert_same_hits(_hits(port), _hits(ref))
            assert port.meta["worktree_overlay"] == ref.meta["worktree_overlay"] == 1
            # the stale rows of the edited file are masked
            assert "validate_token" not in [h.row.name for h in port.hits]
        top = pair.ctx.engine.search("rotate signing keys", use_overlay=True).hits[0].row
        assert top.name == "rotate_signing_keys" and top.rowid == -1
        # without the overlay the index still serves the committed content
        plain = pair.ctx.engine.search("validate token")
        assert "validate_token" in [h.row.name for h in plain.hits]
    finally:
        pair.close()


def test_worktree_flag_through_the_cli(tmp_project, capsys):
    import json

    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    (tmp_project / "src" / "auth.py").write_text(EDITED_AUTH)
    capsys.readouterr()
    assert main(["search", "rotate signing keys", "--worktree", "--json",
                 "--path", str(tmp_project), "--device", "cpu"]) == 0
    names = [h["name"] for h in json.loads(capsys.readouterr().out.strip().splitlines()[-1])["results"]]
    assert names[0] == "rotate_signing_keys" and "validate_token" not in names
    assert main(["search", "validate token", "--json",
                 "--path", str(tmp_project), "--device", "cpu"]) == 0
    names = [h["name"] for h in json.loads(capsys.readouterr().out.strip().splitlines()[-1])["results"]]
    assert "validate_token" in names


def _same_up_to_axis_sign(got: np.ndarray, want: np.ndarray, atol: float = 1e-4) -> None:
    assert got.shape == want.shape
    for axis in range(got.shape[1]):
        sign = 1.0 if np.dot(got[:, axis], want[:, axis]) >= 0 else -1.0
        np.testing.assert_allclose(sign * got[:, axis], want[:, axis], rtol=0, atol=atol)


@pytest.mark.parametrize("n,d,seed", [(50, 8, 0), (300, 64, 1), (1000, 256, 2)])
def test_pca_2d_matches_reference_up_to_sign(n, d, seed):
    rng = np.random.default_rng(seed)
    # two leading directions well apart from each other and from the rest:
    # the axes are well defined
    scale = np.ones(d)
    scale[:2] = (8.0, 4.0)
    mat = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    got = pca_2d(mat, device="cpu")
    assert got.dtype == np.float32
    _same_up_to_axis_sign(got, np.asarray(j_pca_2d(mat)))


def test_embed_2d_matches_reference(tmp_project, capsys):
    pair = _Pair(tmp_project)
    try:
        assert store_projection(pair.ctx.store, method="pca", device="cpu") == \
            j_store_projection(pair.jctx.store, method="pca")
        sql = "SELECT id, umap_x, umap_y FROM chunks WHERE umap_x IS NOT NULL ORDER BY id"
        got = pair.ctx.store.db.execute(sql).fetchall()
        want = pair.jctx.store.db.execute(sql).fetchall()
        assert [r[0] for r in got] == [r[0] for r in want] and got
        _same_up_to_axis_sign(np.array([r[1:] for r in got]), np.array([r[1:] for r in want]))
    finally:
        pair.close()
    # the command itself, which exited 2 before it was ported
    capsys.readouterr()
    assert main(["embed-2d", "--path", str(pair.t_root), "--device", "cpu"]) == 0
    assert "projected" in capsys.readouterr().out
