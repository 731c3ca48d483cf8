"""Mesh sharding of the port (``parallel/mesh.py``, ``parallel/sharded_hybrid.py``,
the engine's ``mesh_shards`` path) against the JAX package on the CPU.

The reference's classes run on the suite's 8-device virtual CPU mesh, the
port's on ``Mesh([cpu] * 8)`` (8 logical shards in one process), on the same
seeded numpy inputs.

Tolerances: rows equal on every slot whose fused score is above NEG/2, in
every mode (the int8 scans' integer sums and the bf16 products are exact,
and ties go to the lower row in both); fused scores, dense and sparse legs
within rtol 1e-5 / atol 1e-6 (they are f32 sums, taken in another order than
XLA's). The empty slots past a leg's valid rows follow the port's rule
(``sharded_hybrid.py``): as many of them as the reference has, each row
inside the reference's padded layout. The port at 1, 2, 4 and 8 shards:
identical outputs. Engines: hit ids and order identical, scores within 1e-5."""

import contextlib
import os

import numpy as np
import pytest
import torch

from cqs_tpu.index.dense import DenseIndex as JDense
from cqs_tpu.index.sparse import SpladeIndex as JSplade
from cqs_tpu.index.stamp import Stamp as JStamp
from cqs_tpu.parallel import ShardedDenseIndex as JShardedDense, make_2d_mesh as j2d
from cqs_tpu.parallel import make_mesh as jmesh
from cqs_tpu.parallel.sharded_hybrid import ShardedHybridIndex as JSharded
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.main import main
from cqs_tpu_torch.daemon.batcher import QueryBatcher
from cqs_tpu_torch.index import DenseIndex, SpladeIndex, Stamp
from cqs_tpu_torch.ops.fusion import NEG
from cqs_tpu_torch.ops.topk import loop_impl, shard_geometry
from cqs_tpu_torch.parallel import Mesh, ShardedDenseIndex, ShardedHybridIndex
from cqs_tpu_torch.parallel import make_2d_mesh, make_mesh
from cqs_tpu_torch.parallel import sharded_hybrid
from test_torch_refresh import _Pair, _mutate
from test_torch_slice import QUERIES, _assert_same_hits, _hits, same_tokenizer_path  # noqa: F401

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
N, D, T, V, S = 180, 16, 8, 256, 64
CTORS = ("init", "blocks", "indexes")
QROWS = (3, 77)
#: fixture-project queries the router sends to the hybrid program on the
#: dense index (category unknown, alpha 0.8), the sharded path; most of
#: test_torch_slice.QUERIES go to the base index at alpha 1 (behavioral)
HYBRID_QUERIES = ["session store", "authentication helpers", "revoke an active session",
                  "backoff delay", "token signing key", "jwt decoding"]


def _data():
    rng = np.random.default_rng(1234)
    mat = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(1, V, size=(N, T)).astype(np.int32)
    w = rng.random((N, T)).astype(np.float32)
    aux = (rng.random(N) < 0.6).astype(np.int32)          # a code-only-like filter
    return mat, ids, w, aux


MAT, IDS, W, AUX = _data()
NAMES = [f"c{i}" for i in range(N)]
NORMED = MAT / np.linalg.norm(MAT, axis=1, keepdims=True)


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _cpu_mesh(n: int = 8) -> Mesh:
    return Mesh([torch.device("cpu")] * n)


def _blocks(calls=None):
    def block_fn(lo, hi):
        assert 0 <= lo < hi <= N
        if calls is not None:
            calls.append((lo, hi))
        return MAT[lo:hi], IDS[lo:hi], W[lo:hi]
    return block_fn


def _build(pkg: str, ctor: str, mode: int, n_shards: int = 8):
    """One sharded index of either package: the reference's on the virtual
    8-device mesh, the port's on ``n_shards`` CPU shards. ``indexes``
    re-places a pair of single-device indexes padded to 1,024 rows (the q8
    placements need ``scan_q8_min_rows``, at least 1,024)."""
    ref = pkg == "ref"
    mesh = jmesh() if ref else _cpu_mesh(n_shards)
    cls = JSharded if ref else ShardedHybridIndex
    if ctor == "init":
        return cls(NAMES, MAT, IDS, W, V, mesh, sketch_dim=S, q8=mode)
    if ctor == "blocks":
        return cls.from_row_blocks(NAMES, V, mesh, _blocks(), N, D, T, sketch_dim=S, q8=mode)
    with _env(CQST_SCAN_Q8=str(mode), CQST_SCAN_Q8_MIN_ROWS="1024"):
        if ref:
            stamp = JStamp(model_fingerprint="t", dim=D, chunk_count=N, generation=0)
            dense = JDense(NAMES, MAT, stamp, pad_multiple=1024)
            sparse = JSplade(NAMES, IDS, W, V, stamp, pad_multiple=1024, sketch_dim=S)
        else:
            stamp = Stamp(model_fingerprint="t", dim=D, chunk_count=N, generation=0)
            dense = DenseIndex(NAMES, MAT, stamp, device="cpu", pad_multiple=1024)
            sparse = SpladeIndex(NAMES, IDS, W, V, stamp, device="cpu", pad_multiple=1024,
                                 sketch_dim=S)
        idx = cls.from_indexes(dense, sparse, mesh)
    assert idx.q8 == mode
    return idx


_CACHE: dict = {}


def _index(pkg: str, ctor: str, mode: int, n_shards: int = 8):
    key = (pkg, ctor, mode, n_shards)
    if key not in _CACHE:
        _CACHE[key] = _build(pkg, ctor, mode, n_shards)
    return _CACHE[key]


def _legs(idx, qrow: int, pool: int, aux):
    return idx.search_legs(NORMED[qrow], IDS[qrow], W[qrow], 0.7, pool, aux_mask=aux)


def _assert_legs(port, ref, padded: int):
    """The tolerance rule of the module docstring, on search_legs' four
    outputs."""
    live_p, live_r = port[0] > NEG / 2, ref[0] > NEG / 2
    np.testing.assert_array_equal(live_p, live_r)
    np.testing.assert_array_equal(port[1][live_p], ref[1][live_r])
    for p, r in zip(port[:1] + port[2:], ref[:1] + ref[2:]):
        np.testing.assert_allclose(p[live_p], r[live_r], rtol=RTOL, atol=ATOL)
    assert ((port[1] >= 0) & (port[1] < padded)).all()
    assert len(port[1]) == len(ref[1])


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("pool", ["below", "above"])
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("ctor", CTORS)
def test_search_legs_match_reference(ctor, mode, pool, aux):
    ref, port = _index("ref", ctor, mode), _index("port", ctor, mode)
    assert port.padded == ref.matrix.shape[0] and len(port.matrix) == 8
    # below: within one shard's rows; above: past them (and, with the
    # filter, past every valid row: the empty-slot rule is exercised)
    k = 10 if pool == "below" else 150
    assert (k < port.rows_per_shard) == (pool == "below")
    mask = AUX if aux else None
    for qrow in QROWS:
        got, want = _legs(port, qrow, k, mask), _legs(ref, qrow, k, mask)
        _assert_legs(got, want, port.padded)
        assert got[1][0] == qrow or (aux and not AUX[qrow])
    if aux and pool == "above":
        assert (got[0] <= NEG / 2).any()            # the empty slots were reached


def test_placements_match_reference():
    # the same blocks, masks and (host-quantized) int8 copies on each shard
    for ctor in ("init", "blocks"):
        for mode in (0, 1, 2):
            ref, port = _index("ref", ctor, mode), _index("port", ctor, mode)
            n_s = port.rows_per_shard
            for name in ("matrix", "sketch", "sketch_i8", "dense_i8", "mask"):
                p, r = getattr(port, name), getattr(ref, name, None)
                assert (p is None) == (r is None), (ctor, mode, name)
                if p is None:
                    continue
                got = torch.cat([t[:n_s] for t in p])
                if got.dtype == torch.bfloat16:
                    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                                  np.asarray(r).view(np.int16))
                else:
                    np.testing.assert_array_equal(got.numpy(), np.asarray(r))
                # padding rows past the shard's own are masked and zero
                assert all(not t[n_s:].any() for t in p)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_shard_count_invariance(mode):
    outs = {}
    for n_shards in (1, 2, 4, 8):
        idx = _index("port", "init", mode, n_shards)
        outs[n_shards] = [_legs(idx, q, k, a) for q in QROWS for k in (10, 150)
                          for a in (None, AUX)]
    for n_shards in (2, 4, 8):
        for got, want in zip(outs[n_shards], outs[1]):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_from_row_blocks_on_one_device():
    # the reference's callbacks get slice(None) on a 1-device mesh, so
    # _block(0, None) calls min(None, n); the port builds per shard
    with pytest.raises(TypeError):
        JSharded.from_row_blocks(NAMES, V, jmesh(1), _blocks(), N, D, T, sketch_dim=S, q8=0)
    one = ShardedHybridIndex.from_row_blocks(NAMES, V, _cpu_mesh(1), _blocks(), N, D, T,
                                             sketch_dim=S, q8=0)
    eight = _index("port", "init", 0)
    for qrow in QROWS:
        got, want = _legs(one, qrow, 150, AUX), _legs(eight, qrow, 150, AUX)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", [0, 1])
def test_block_fn_calls(mode):
    # the reference calls block_fn from each placement callback (4 a shard,
    # 5 with the int8 dense copy); the port once a shard; both read the same
    # strided sample for the int8 sketch scale
    ref_calls, port_calls = [], []
    JSharded.from_row_blocks(NAMES, V, jmesh(), _blocks(ref_calls), N, D, T, sketch_dim=S,
                             q8=mode)
    ShardedHybridIndex.from_row_blocks(NAMES, V, _cpu_mesh(), _blocks(port_calls), N, D, T,
                                       sketch_dim=S, q8=mode)
    n_s = -(-N // 64) * 64 // 8
    shard_calls = {(i * n_s, min((i + 1) * n_s, N)) for i in range(8)}
    samples = [c for c in port_calls if c not in shard_calls]
    assert sorted(c for c in port_calls if c in shard_calls) == sorted(shard_calls)
    assert (len(samples) > 0) == (mode > 0)
    assert [c for c in ref_calls if c not in shard_calls] == samples
    per_shard = (len(ref_calls) - len(samples)) / 8
    assert 4 <= per_shard <= 6 and per_shard == 4 + (mode == 1)


@pytest.mark.parametrize("k", [5, 190])
def test_sharded_dense_index_matches_reference(k):
    ref = JShardedDense(NAMES, MAT, jmesh())
    port = ShardedDenseIndex(NAMES, MAT, _cpu_mesh())
    assert port.padded == ref.matrix.shape[0] and len(port.matrix) == 8
    q = NORMED[[7, 42, 101]]
    (pv, pr), (rv, rr) = port.search(q, k), ref.search(q, k)
    assert pv.shape == rv.shape == (3, min(k, port.padded))
    live = rv > NEG / 2
    np.testing.assert_array_equal(pv > NEG / 2, live)
    np.testing.assert_array_equal(pr[live], rr[live])
    np.testing.assert_allclose(pv[live], rv[live], rtol=RTOL, atol=ATOL)
    assert (pr[:, 0] == [7, 42, 101]).all() and ((pr >= 0) & (pr < port.padded)).all()


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_match_reference(n):
    j1, t1 = jmesh(n), make_mesh(n, device="cpu")
    assert t1.size == j1.devices.size and t1.shape == dict(j1.shape)
    j2, t2 = j2d(n), make_2d_mesh(n, device="cpu")
    assert t2.size == j2.devices.size and t2.shape == dict(j2.shape)
    assert make_2d_mesh(n, dp=1, device="cpu").shape == dict(j2d(n, dp=1).shape)


def test_make_mesh_never_repeats_a_card():
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="cards"):
        make_mesh(visible + 1, device="cuda")
    # an explicit caller may repeat a device (logical shards on one card)
    assert Mesh(["cpu", "cpu"]).size == 2


@pytest.mark.parametrize("rows,pool,want", [
    (262144, 500, (262144, 2048, 500, "split")),      # the card's 1M rows / 4: LOOP_SPLIT
    (262144, 10, (262144, 2048, 10, "split")),
    (1024, 500, (1024, 1024, 500, "split")),          # a 4,096-row corpus over 4 shards
    (1024, 10, (1024, 1024, 10, "split")),
    (16, 500, (32, 32, 16, "template")),              # padded to 32 masked rows
    (16, 10, (32, 32, 10, "template")),
    (250000, 500, (251904, 2048, 500, "split")),      # padded to whole 2,048-row tiles
    (1250000, 500, (1251328, 2048, 500, "split")),    # docs/scale-10m.md: 10M over 8 chips
    (100000, 500, (100352, 2048, 500, "split")),
    (1026, 500, (2048, 2048, 500, "split")),          # the repository corpus over 4 shards
])
def test_shard_geometry(rows, pool, want):
    """The scan rows, tile and per-tile k of a shard, and the route
    ``loop_impl`` takes at them for either row kind."""
    n, tile, m = shard_geometry(rows, min(pool, rows))
    assert (n, tile, m) == want[:3]
    assert loop_impl("bf16", tile, m) == loop_impl("i8", tile, m) == want[3]


def test_shard_tiles_are_whole_and_tall():
    # a shard of 2,048 rows or more: tiles of 2,048, at most 2,047 padding
    # rows; a smaller one: one tile, the next power of two of at least 32
    # rows (from 128 rows a whole number of sub-tiles: the split kernel)
    for rows in [*range(1, 4200, 7), 65535, 65536, 65537, 250000, 262143, 1250000]:
        n, tile, m = shard_geometry(rows, min(500, rows))
        assert n >= rows and n % tile == 0 and shard_geometry(n, m) == (n, tile, m)
        if rows >= 2048:
            assert tile == 2048 and n - rows < 2048
        else:
            assert tile == n and n == max(32, 1 << (rows - 1).bit_length())
        assert (loop_impl("bf16", tile, m) == "split") == (rows > 64)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_shards_not_a_power_of_two(mode):
    # 4 shards of 1,000 rows (padded to 1,024 each) against 1 shard of 4,000
    # (padded to 4,096) and against the reference's 8-device mesh
    n = 4000
    rng = np.random.default_rng(99)
    mat = rng.normal(size=(n, D)).astype(np.float32)
    ids = rng.integers(1, V, size=(n, T)).astype(np.int32)
    w = rng.random((n, T)).astype(np.float32)
    names = [f"p{i}" for i in range(n)]
    four = ShardedHybridIndex(names, mat, ids, w, V, _cpu_mesh(4), sketch_dim=S, q8=mode)
    one = ShardedHybridIndex(names, mat, ids, w, V, _cpu_mesh(1), sketch_dim=S, q8=mode)
    ref = JSharded(names, mat, ids, w, V, jmesh(), sketch_dim=S, q8=mode)
    assert four.rows_per_shard == 1000 and four.matrix[0].shape[0] == 1024
    assert one.matrix[0].shape[0] == 4096
    qn = mat / np.linalg.norm(mat, axis=1, keepdims=True)
    for qrow in (5, 2999):
        for pool in (10, 500):
            args = (qn[qrow], ids[qrow], w[qrow], 0.7, pool)
            got, same = four.search_legs(*args), one.search_legs(*args)
            for g, x in zip(got, same):
                np.testing.assert_array_equal(g, x)
            _assert_legs(got, ref.search_legs(*args), four.padded)
            assert got[1][0] == qrow


# -- the engine ------------------------------------------------------------------

def _engine(tmp_project, mesh_shards: int):
    from cqs_tpu_torch.config import Limits
    from cqs_tpu_torch.models import Embedder, SpladeEncoder
    from cqs_tpu_torch.pipeline import run_index_pipeline
    from cqs_tpu_torch.search.engine import SearchEngine
    from cqs_tpu_torch.store import Store

    store = Store.open(tmp_project / ".cqs-tpu")
    embedder = Embedder("hash-tiny", device="cpu")
    splade = SpladeEncoder("splade-hash", device="cpu")
    run_index_pipeline(tmp_project, store, embedder, splade)
    engine = SearchEngine(store, embedder, splade,
                          slot_dir=tmp_project / ".cqs-tpu" / "slots" / "default",
                          lim=Limits({"mesh_shards": mesh_shards}), device="cpu")
    engine.load_or_build_indexes()
    return store, engine


@pytest.fixture
def sharded_calls(monkeypatch):
    calls = []
    real = sharded_hybrid.ShardedHybridIndex.search_legs

    def spy(self, *a, **kw):
        calls.append(kw.get("aux_mask") is not None)
        return real(self, *a, **kw)

    monkeypatch.setattr(sharded_hybrid.ShardedHybridIndex, "search_legs", spy)
    return calls


class TestEngineShardedServing:
    """``tests/test_parallel.py::TestEngineShardedServing`` on the port."""

    def test_sharded_engine_matches_single_device(self, tmp_project, sharded_calls):
        store, built = _engine(tmp_project, 0)

        def loaded(mesh_shards):
            # from the saved artifacts (fp16 rows), as a second process would
            eng = type(built)(store, built.embedder, built.splade,
                              slot_dir=tmp_project / ".cqs-tpu" / "slots" / "default",
                              lim=built.lim.with_overrides(mesh_shards=mesh_shards),
                              device="cpu")
            eng.load_or_build_indexes()
            return eng

        try:
            single = loaded(0)
            assert single.sharded is None
            r_single = {q: _hits(single.search(q, limit=5)) for q in HYBRID_QUERIES}
            assert not sharded_calls
            sharded = loaded(8)
            assert sharded.sharded is not None and sharded.sharded.mesh.size == 8
            assert sharded.sharded.ids is sharded.dense.ids
            for q in HYBRID_QUERIES:
                got = _hits(sharded.search(q, limit=5))
                assert got, q
                assert [i for i, _ in got] == [i for i, _ in r_single[q]], q
                np.testing.assert_allclose([x for _, x in got], [x for _, x in r_single[q]],
                                           atol=1e-5)
            # every query ran the sharded program, the code-only mask with it
            assert sharded_calls == [True] * len(HYBRID_QUERIES)
        finally:
            store.close()

    def test_sharded_survives_incremental_refresh(self, tmp_project):
        from cqs_tpu_torch.pipeline import run_index_pipeline

        store, engine = _engine(tmp_project, 8)
        try:
            before = engine.sharded
            assert before is not None
            (tmp_project / "src" / "new.py").write_text(
                "def rotate_keys():\n    \"\"\"Rotate signing keys.\"\"\"\n    return 1\n")
            run_index_pipeline(tmp_project, store, engine.embedder, engine.splade)
            assert engine.refresh_incremental()["appended"] >= 1
            assert engine.sharded is not None and engine.sharded is not before
            assert engine.sharded.ids is engine.dense.ids
            r = engine.search("rotate signing keys", limit=3)
            assert any("rotate_keys" in h.row.qualified_name for h in r.hits)
        finally:
            store.close()

    def test_no_mesh_on_one_device_or_missing_cards(self, tmp_project, monkeypatch, caplog):
        # -1 = every local device: the CPU's one, so no mesh (the reference
        # on one device); a mesh of more cards than exist fails in make_mesh
        # and the engine serves from one device with the reference's warning
        from cqs_tpu_torch.parallel import mesh

        store, engine = _engine(tmp_project, -1)
        try:
            assert engine.sharded is None
            real = mesh.make_mesh
            monkeypatch.setattr(mesh, "make_mesh", lambda n, **kw: real(
                torch.cuda.device_count() + 1, device="cuda"))
            engine.lim = engine.lim.with_overrides(mesh_shards=4)
            with caplog.at_level("WARNING"):
                engine.load_or_build_indexes()
            assert engine.sharded is None
            assert any("mesh sharding unavailable" in r.getMessage() for r in caplog.records)
            assert engine.search("session store", limit=5).hits
        finally:
            store.close()


def test_sharded_engine_matches_reference_sharded_engine(tmp_project, monkeypatch,
                                                         sharded_calls):
    # both packages' engines with mesh_shards 8: the reference's on its
    # virtual mesh, the port's on 8 CPU shards; then through a refresh
    monkeypatch.setenv("CQST_MESH_SHARDS", "8")
    pair = _Pair(tmp_project)
    try:
        assert pair.ctx.engine.sharded is not None and pair.jctx.engine.sharded is not None
        pair.assert_alike(QUERIES + HYBRID_QUERIES)
        assert len(sharded_calls) >= len(HYBRID_QUERIES)
        for root in (pair.j_root, pair.t_root):
            _mutate(root)
        pair.reindex()
        port, ref = pair.refresh()
        assert port == ref
        assert pair.ctx.engine.sharded.ids is pair.ctx.engine.dense.ids
        pair.assert_alike(QUERIES + HYBRID_QUERIES)
    finally:
        pair.close()


def test_batcher_runs_sharded_queries_solo(tmp_project, monkeypatch, sharded_calls):
    # the port: a sharded engine's queries run solo, so batched == solo; the
    # reference's batcher has no sharded branch: its burst is answered by
    # the single-device batch program, never the sharded one
    from cqs_tpu.cli.context import CommandContext as JContext
    from cqs_tpu.daemon.batcher import QueryBatcher as JBatcher
    from cqs_tpu.parallel import sharded_hybrid as j_sharded

    monkeypatch.setenv("CQST_MESH_SHARDS", "8")
    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        solo = {q: _hits(ctx.engine.search(q)) for q in HYBRID_QUERIES[:5]}
    finally:
        ctx.close()
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    batcher = QueryBatcher(ctx.engine)
    try:
        assert ctx.engine.sharded is not None
        n0 = len(sharded_calls)
        batcher.pause()
        futs = [batcher.submit(q) for q in HYBRID_QUERIES[:5]]
        batcher.resume()
        results = [f.result(timeout=60) for f in futs]
    finally:
        batcher.stop()
        ctx.close()
    assert batcher.stats["solo"] == 5 and batcher.stats["fused"] == 0
    assert len(sharded_calls) - n0 == 5
    for q, res in zip(HYBRID_QUERIES[:5], results):
        _assert_same_hits(_hits(res), solo[q])

    ref_calls = []
    real = j_sharded.ShardedHybridIndex.search_legs
    monkeypatch.setattr(j_sharded.ShardedHybridIndex, "search_legs",
                        lambda self, *a, **kw: ref_calls.append(1) or real(self, *a, **kw))
    jctx = JContext.create(str(tmp_project))
    jbatcher = JBatcher(jctx.engine)
    try:
        assert jctx.engine.sharded is not None
        jctx.engine.search(HYBRID_QUERIES[0])
        solo_calls = len(ref_calls)
        jbatcher.pause()
        futs = [jbatcher.submit(q) for q in HYBRID_QUERIES[1:6]]
        jbatcher.resume()
        [f.result(timeout=60) for f in futs]
    finally:
        jbatcher.stop()
        jctx.close()
    assert solo_calls == 1
    assert jbatcher.stats["fused"] == 5 and len(ref_calls) == solo_calls
