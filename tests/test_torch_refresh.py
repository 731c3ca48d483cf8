"""``SearchEngine.refresh_incremental`` in the port against the JAX package:
the same file mutations under both, then the outcome dict, the index arrays
and the search hits compared; and the port's identity-keyed caches across a
refresh.

Tolerances: outcome dicts, id lists, digests, capacities and masks equal;
bf16 matrices and sketches bit for bit; term ids and weights equal; hit ids
and order identical, hit scores within 1e-5."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cqs_tpu.cli.context import CommandContext as JContext
from cqs_tpu.pipeline import run_index_pipeline as j_index
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.models.convert import embedder_params_from_jax
from cqs_tpu_torch.pipeline import run_index_pipeline
from cqs_tpu_torch.search.program import fold_sketch, pack_terms, quantize_sketch, quantize_unit
from test_torch_slice import QUERIES, _assert_same_hits, _hits, same_tokenizer_path  # noqa: F401

torch.set_num_threads(1)

NEW_MODULE = '''"""Widget helpers."""

def frobnicate_widget(widget):
    """Frobnicate the widget until it is calibrated."""
    return calibrate_gauge(widget)

def calibrate_gauge(gauge):
    """Calibrate a pressure gauge against its reference."""
    return gauge
'''
MANY_FUNCTIONS = "".join(
    f'def helper_{i}(x):\n    """Helper number {i} scales its input."""\n    return x * {i}\n\n'
    for i in range(6))
STEP_QUERIES = QUERIES + ["frobnicate widget", "calibrate pressure gauge"]


def _mutate(root: Path) -> None:
    """Add a file, edit one (a chunk's id changes with its body) and delete
    one."""
    (root / "src" / "widgets.py").write_text(NEW_MODULE)
    auth = root / "src" / "auth.py"
    auth.write_text(auth.read_text().replace(
        'return token.split(".")', 'return token.strip().split(".")'))
    (root / "src" / "retry.rs").unlink()


def _bits(x) -> np.ndarray:
    """A bf16 array of either package as its raw 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _assert_same_indexes(port, ref) -> None:
    for name in ("dense", "dense_base"):
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if p is None:
            continue
        assert p.ids == r.ids and p.ids_digest == r.ids_digest, name
        assert p.capacity == r.capacity and p.count == r.count, name
        np.testing.assert_array_equal(_bits(p.matrix), _bits(r.matrix), err_msg=name)
        np.testing.assert_array_equal(p.mask.numpy(), np.asarray(r.mask), err_msg=name)
    p, r = port.sparse, ref.sparse
    assert p.ids == r.ids and p.ids_digest == r.ids_digest and p.capacity == r.capacity
    np.testing.assert_array_equal(p.doc_ids.numpy(), np.asarray(r.doc_ids))
    np.testing.assert_array_equal(p.doc_w.numpy(), np.asarray(r.doc_w))
    np.testing.assert_array_equal(_bits(p.sketch), _bits(r.sketch))
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(r.mask))
    assert port._row_of == ref._row_of


class _Pair:
    """One project under each package, indexed, with a live engine each."""

    def __init__(self, tmp_project: Path):
        self.j_root = tmp_project
        self.t_root = tmp_project.parent / f"{tmp_project.name}_port"
        shutil.copytree(tmp_project, self.t_root)
        self.jctx = JContext.create(str(self.j_root))
        self.ctx = CommandContext.create(str(self.t_root), device="cpu")
        # the port's embedder carries the JAX table, so stored embeddings agree
        self.jctx.embedder._ensure_model()
        self.ctx.embedder.load_params(embedder_params_from_jax(
            {"table": np.asarray(self.jctx.embedder._params["table"])}))
        self.reindex()
        _ = self.jctx.engine, self.ctx.engine

    def reindex(self) -> None:
        j, t = self.jctx, self.ctx
        j_index(j.root, j.store, j.embedder, j._maybe_splade(), config=j.config)
        run_index_pipeline(t.root, t.store, t.embedder, t._maybe_splade(), config=t.config)

    def refresh(self) -> tuple[dict, dict]:
        return self.ctx.engine.refresh_incremental(), self.jctx.engine.refresh_incremental()

    def assert_alike(self, queries=STEP_QUERIES) -> None:
        _assert_same_indexes(self.ctx.engine, self.jctx.engine)
        for q in queries:
            _assert_same_hits(_hits(self.ctx.engine.search(q)), _hits(self.jctx.engine.search(q)))

    def close(self) -> None:
        self.jctx.close()
        self.ctx.close()


def test_refresh_matches_reference_step_by_step(tmp_project, monkeypatch):
    pair = _Pair(tmp_project)
    try:
        pair.assert_alike(QUERIES)
        assert pair.refresh() == ({"unchanged": True}, {"unchanged": True})

        # add, edit, delete: appended into headroom, tombstoned in place
        count0 = pair.ctx.engine.dense.count
        for root in (pair.j_root, pair.t_root):
            _mutate(root)
        pair.reindex()
        port, ref = pair.refresh()
        assert port == ref and port["appended"] >= 3 and port["tombstoned"] >= 3, (port, ref)
        eng = pair.ctx.engine
        assert eng.dense.count == count0 + port["appended"]
        assert eng.dense.ids.count("") == port["tombstoned"]
        pair.assert_alike()
        top = [h.row.name for h in eng.search("frobnicate widget").hits]
        assert top and top[0] == "frobnicate_widget"
        assert not any(h.row.origin == "src/retry.rs"
                       for h in eng.search("retry with exponential backoff").hits)

        # more changes than rebuild_threshold: rebuilt from the store
        monkeypatch.setenv("CQST_REBUILD_THRESHOLD", "4")
        for root in (pair.j_root, pair.t_root):
            (root / "src" / "helpers.py").write_text(MANY_FUNCTIONS)
        pair.reindex()
        port, ref = pair.refresh()
        assert port == ref and port["rebuilt"] is True and port["changes"] > 4, (port, ref)
        assert "" not in pair.ctx.engine.dense.ids          # tombstones reclaimed
        pair.assert_alike()
        monkeypatch.delenv("CQST_REBUILD_THRESHOLD")

        # a sparse index that fell out of step with the dense one: the
        # alignment guard rebuilds
        doomed = {pair.ctx.engine.sparse.ids[0]}
        assert pair.ctx.engine.sparse.remove(doomed) == pair.jctx.engine.sparse.remove(doomed) == 1
        for root in (pair.j_root, pair.t_root):
            (root / "src" / "one_more.py").write_text(
                'def one_more_thing(x):\n    """One more thing to index."""\n    return x\n')
        pair.reindex()
        port, ref = pair.refresh()
        assert port == ref == {"rebuilt": True, "reason": "alignment"}
        pair.assert_alike()
    finally:
        pair.close()


def test_refresh_of_an_engine_without_indexes_builds_them(tmp_project):
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        from cqs_tpu_torch.search.engine import SearchEngine

        eng = SearchEngine(ctx.store, ctx.embedder, ctx._maybe_splade(),
                           slot_dir=ctx.slot_path, config=ctx.config, device="cpu")
        try:
            assert eng.refresh_incremental() == {"rebuilt": True}
            assert eng.dense.count > 10 and eng.search("validate token").hits
        finally:
            eng.close()
    finally:
        ctx.close()


KNOBS = {
    "bf16": {},
    "q8": {"CQST_SCAN_Q8": "1", "CQST_SCAN_Q8_MIN_ROWS": "1024"},
    "sk8": {"CQST_SCAN_Q8": "2", "CQST_SCAN_Q8_MIN_ROWS": "1024"},
    "screened": {"CQST_SCREEN_ENABLE": "1", "CQST_SCREEN_MIN_ROWS": "1024"},
    # the CPU engine's own route, the host mirror: its CSR postings, then
    # its sketch views, then its int8 view
    "mirror": {},
    "mirror-sketch": {"CQST_HOST_SPARSE_CSR": "0"},
    "mirror-q8": {"CQST_SCAN_Q8": "1", "CQST_SCAN_Q8_MIN_ROWS": "1024"},
}


@pytest.mark.parametrize("program", list(KNOBS))
def test_refreshed_engine_equals_fresh_engine(tmp_project, monkeypatch, program):
    # the caches keyed on tensor identity (dense_i8, sketch_i8, sketch_mini,
    # packed_terms, the device code mask; the host mirror's views) and the
    # result cache must all see the refresh: a warm engine answers as one
    # built from the store anew. The device programs run with host_mirror
    # off, as on a card
    for k, v in KNOBS[program].items():
        monkeypatch.setenv(k, v)
    mirror = program.startswith("mirror")
    warm = CommandContext.create(str(tmp_project), device="cpu")
    try:
        run_index_pipeline(warm.root, warm.store, warm.embedder, warm._maybe_splade(),
                           config=warm.config)
        eng = warm.engine
        eng.host_mirror = mirror
        before = {q: _hits(eng.search(q)) for q in STEP_QUERIES}     # fills every cache
        old = (eng.dense.matrix, eng.sparse.sketch, eng.sparse.doc_ids)
        _mutate(warm.root)
        run_index_pipeline(warm.root, warm.store, warm.embedder, warm._maybe_splade(),
                           config=warm.config)
        # between the store's change and the refresh a query still answers,
        # from the old rows (its result must not outlive the refresh)
        stale = _hits(eng.search("frobnicate widget"))
        assert "frobnicate_widget" not in [i.split(":")[0] for i, _ in stale]
        out = eng.refresh_incremental()
        assert out["appended"] >= 3 and out["tombstoned"] >= 3, out
        # mutations rebound new tensors; the old ones are untouched
        assert eng.dense.matrix is not old[0] and eng.sparse.sketch is not old[1]
        assert eng.sparse.doc_ids is not old[2]
        after = {q: _hits(eng.search(q)) for q in STEP_QUERIES}
        assert after["frobnicate widget"] != stale
        assert after["retry with exponential backoff"] != before["retry with exponential backoff"]

        # each derived array equals its derivation from the live tensors
        d, s = eng.dense, eng.sparse
        n0 = d.count - out["appended"]
        if program == "screened":
            # the int8 screen doubles as dense_i8: rows of the first upload
            # are quantized from the stored matrix, appended rows from their
            # f32 vectors, as the reference does
            assert d.dense_i8() is d.screen
            assert torch.equal(d.screen[:n0], quantize_unit(d.matrix[:n0]))
            want = np.clip(np.round(d._host[n0:] * 127.0), -127, 127).astype(np.int8)
            np.testing.assert_array_equal(d.screen[n0:d.count].numpy(), want)
        else:
            assert torch.equal(d.dense_i8(), quantize_unit(d.matrix))
        assert torch.equal(s.sketch_i8(), quantize_sketch(s.sketch))
        assert torch.equal(s.sketch_mini(eng.lim.screen_dim),
                           fold_sketch(s.sketch, eng.lim.screen_dim))
        assert torch.equal(s.packed_terms(), pack_terms(s.doc_ids, s.doc_w))
        if mirror:
            mat_h, mask_h = d.host_view()
            np.testing.assert_array_equal(mat_h, d.matrix.float().numpy())
            np.testing.assert_array_equal(mask_h, d.mask.numpy())
            np.testing.assert_array_equal(d.host_bf16(),
                                          d.matrix.view(torch.int16).numpy().view(np.uint16))
            np.testing.assert_array_equal(d.host_i8(), quantize_unit(d.matrix).numpy())
            ids_h, w_h, sk_h = s.host_view()
            np.testing.assert_array_equal(ids_h, s.doc_ids.numpy())
            np.testing.assert_array_equal(w_h, s.doc_w.numpy())
            np.testing.assert_array_equal(sk_h, s.sketch.float().numpy())
            indptr, post_rows, post_w = s.host_csr()
            assert indptr[-1] == len(post_rows) == int((s._host_w > 0).sum())
            assert post_rows.max() < s.count
        code = eng._code_mask(d)
        if code is not None:
            want = np.zeros(d.capacity, np.int32)
            want[: len(code)] = code
            assert torch.equal(eng._device_code_valid(d, code),
                               d.mask * torch.from_numpy(want))
    finally:
        warm.close()
    fresh = CommandContext.create(str(tmp_project), device="cpu")
    try:
        for f in fresh.slot_path.glob("*.npz"):      # build from the store, not from disk
            f.unlink()
        assert "" not in fresh.engine.dense.ids
        fresh.engine.host_mirror = mirror
        for q in STEP_QUERIES:
            _assert_same_hits(after[q], _hits(fresh.engine.search(q)))
    finally:
        fresh.close()


def test_append_uploads_only_the_new_rows(tmp_project, monkeypatch):
    # every host array the index code hands to the device goes through
    # torch.from_numpy: counted here, a refresh into headroom sends the new
    # rows and nothing else
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        eng = ctx.engine
        _mutate(ctx.root)
        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        base0 = eng.dense_base.count
        sent: list[int] = []
        from_numpy = torch.from_numpy
        monkeypatch.setattr(torch, "from_numpy", lambda a: (sent.append(a.nbytes), from_numpy(a))[1])
        out = eng.refresh_incremental()
        monkeypatch.undo()
        n, n_base, sp = out["appended"], eng.dense_base.count - base0, eng.sparse
        assert n >= 3 and n_base >= 1
        assert sum(sent) == ((n + n_base) * eng.dense.dim * 4
                             + n * (sp.T * 8 + sp.sketch_dim * 4))
        assert sum(sent) < eng.dense.capacity * eng.dense.dim * 4 // 8
    finally:
        ctx.close()


def test_refresh_racing_a_rebuild_appends_no_row_twice(tmp_project):
    # the watch loop's refresh has worked out its delta on the serving
    # indexes when the daemon's ``refresh`` handler, on another thread,
    # rebuilds and swaps them: the delta must not be applied to the new
    # indexes, which already hold those rows
    import threading

    from cqs_tpu_torch.daemon import BatchContext

    ctx = CommandContext.create(str(tmp_project), device="cpu")
    bctx = BatchContext(ctx)
    try:
        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        eng = ctx.engine
        _mutate(ctx.root)
        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        answers: list[dict] = []
        rebuilt = threading.Event()

        def rebuild():
            answers.append(bctx.dispatch("refresh", {}))
            rebuilt.set()

        other = threading.Thread(target=rebuild)
        read_db = eng.store._read_db

        class PausingDb:
            """The thread's read connection; the refresh's first read of the
            new rows' vectors, after its delta, lets the rebuild in."""

            def __init__(self, db):
                self.db = db

            def execute(self, sql, *args):
                if sql.startswith("SELECT id, embedding FROM chunks WHERE id IN"):
                    other.start()
                    rebuilt.wait(timeout=1.0)     # serialized: it cannot finish yet
                return self.db.execute(sql, *args)

            def __getattr__(self, name):
                return getattr(self.db, name)

        eng.store._read_db = lambda: PausingDb(read_db())
        try:
            out = eng.refresh_incremental()
        finally:
            del eng.store._read_db
        other.join(timeout=60)
        assert not other.is_alive() and answers[0].get("ok"), answers
        assert out["appended"] >= 3 and out["tombstoned"] >= 3, out
        want = sorted(cid for cid, in ctx.store.db.execute(
            "SELECT id FROM chunks WHERE embedding IS NOT NULL"))
        for index in (eng.dense, eng.sparse):
            assert sorted(c for c in index.ids if c) == want
        assert eng.sparse.ids_digest == eng.dense.ids_digest
        assert eng._row_of == eng.dense.row_of
        fresh_hits = _hits(eng.search("frobnicate widget"))
        assert fresh_hits and fresh_hits[0][0].startswith("src/widgets.py")
    finally:
        bctx.close()
        ctx.close()


def test_id_digests_are_never_cached_from_a_half_mutated_list():
    # a reader (the batcher compares digests on its own thread) races the
    # refresh's append/remove: whatever it caches, the digest read after the
    # mutations is that of the final id list, for both index kinds
    import hashlib
    import sys
    import threading

    from cqs_tpu_torch.index import DenseIndex, SpladeIndex, Stamp

    rng = np.random.default_rng(5)
    stamp = Stamp(model_fingerprint="t", dim=8, chunk_count=4, generation=0)
    ids = [f"r{i}" for i in range(4)]
    dense = DenseIndex(ids, rng.standard_normal((4, 8)).astype(np.float32), stamp,
                       device="cpu", pad_multiple=4096)
    sparse = SpladeIndex(ids, rng.integers(1, 50, (4, 4)).astype(np.int32),
                         np.ones((4, 4), np.float32), 64, stamp, device="cpu",
                         pad_multiple=4096, sketch_dim=16)
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            _ = dense.ids_digest, sparse.ids_digest, dense.row_of

    prior = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t = threading.Thread(target=reader)
    t.start()
    try:
        for step in range(200):
            new = [f"n{step}_{j}" for j in range(3)]
            dense.append(new, rng.standard_normal((3, 8)).astype(np.float32))
            sparse.append(new, rng.integers(1, 50, (3, 4)).astype(np.int32),
                          np.ones((3, 4), np.float32))
            doomed = {new[0], f"r{step % 4}"}
            dense.remove(doomed)
            sparse.remove(doomed)
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(prior)
    assert not t.is_alive()
    want = hashlib.blake2b("|".join(dense.ids).encode(), digest_size=16).hexdigest()
    assert dense.ids == sparse.ids
    assert dense.ids_digest == sparse.ids_digest == want
    assert dense.row_of == {cid: i for i, cid in enumerate(dense.ids) if cid}
