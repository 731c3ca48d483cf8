"""Screened B=1 program and the int8 engine routes of the port, on the CPU.

(a) ``hybrid_query_screened`` in both screen modes against the reference's
    program with Pallas in interpret mode, on the same screen arrays.
(b) ``DenseIndex``'s screens against the reference's formulas (the
    reference builds them on a TPU backend only): the int8 screen bit-equal,
    the projection the same seeded orthonormal matrix, the projected screen
    within one bf16 ulp (f32 sums in another order can flip a rounding).
(c) The port's engine on the fixture project with ``scan_q8=1``,
    ``scan_q8=2`` and ``screen_enable=1`` (both modes), on its device route
    (``host_mirror`` off: a CPU engine serves through the host mirror by
    default, ``tests/test_torch_host_path.py``): the selected program
    is the one that ran, solo equals the ``QueryBatcher`` for q8 and sk8, and
    ``mesh_shards`` (once refused) serves the single-device top 5.

Tolerances: rows exact; values rtol 1e-5 / atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cqs_tpu.search.program as jprog
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.main import main
from cqs_tpu_torch.daemon.batcher import QueryBatcher
from cqs_tpu_torch.index import DenseIndex, Stamp
from cqs_tpu_torch.ops.sparse import build_doc_sketch
from cqs_tpu_torch.search import engine as tengine
from cqs_tpu_torch.search import program as tprog

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
V, T, QT = 4096, 16, 8
QUERIES = ["validate token", "retry with exponential backoff", "session store",
           "decode jwt", "check expiry timestamp"]


def _corpus(rng, n_pad=8192, n_valid=7900, d=64, s=256, b=3):
    mat = rng.normal(size=(n_pad, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    mat[n_valid:] = 0.0
    ids = rng.integers(4, V, size=(n_pad, T)).astype(np.int32)
    w = np.log1p(rng.integers(1, 4, size=(n_pad, T))).astype(np.float32)
    ids[n_valid:] = 0
    w[n_valid:] = 0.0
    mask = np.zeros(n_pad, np.int32)
    mask[:n_valid] = 1
    mask[rng.choice(n_valid, size=n_valid // 20, replace=False)] = 0      # tombstones
    rows = rng.choice(n_valid, size=b, replace=False)
    q = mat[rows] + 0.3 * rng.normal(size=(b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_ids = np.zeros((b, QT), np.int32)
    q_w = np.zeros((b, QT), np.float32)
    q_ids[:, :5] = ids[rows, :5]
    q_w[:, :5] = np.log1p(np.arange(5, 0, -1)).astype(np.float32)
    alphas = np.full(b, 0.6, np.float32)
    return mat, ids, w, build_doc_sketch(ids, w, s), mask, q, q_ids, q_w, alphas


def _proj(d, sd):
    rng = np.random.default_rng(0xC95C + d * 131 + sd)
    q, _ = np.linalg.qr(rng.standard_normal((d, sd)).astype(np.float32))
    return np.ascontiguousarray(q, dtype=np.float32)


@pytest.mark.parametrize("mode,pool,screen_k", [("int8", 32, 0), ("proj", 32, 256),
                                                ("int8", 20, 0)])
def test_screened_matches_jax(mode, pool, screen_k):
    rng = np.random.default_rng(3)
    mat, ids, w, sk, mask, q, q_ids, q_w, alphas = _corpus(rng)
    mini_dim, fold = 32, 8
    tm = torch.from_numpy(mat).to(torch.bfloat16)
    if mode == "int8":
        screen = tprog.quantize_unit(tm)
        q_scr = q
    else:
        p = _proj(64, 32)
        screen = (tm.float() @ torch.from_numpy(p)).to(torch.bfloat16)
        q_scr = q @ p
    tsk = torch.from_numpy(sk).to(torch.bfloat16)
    t_arrays = (tm, screen, tprog.pack_terms(torch.from_numpy(ids), torch.from_numpy(w)),
                None, tprog.fold_sketch(tsk, mini_dim), torch.from_numpy(mask))
    j_screen = (jnp.asarray(screen.numpy()) if mode == "int8"
                else jnp.asarray(screen.float().numpy(), jnp.bfloat16))
    j_arrays = (jnp.asarray(mat, jnp.bfloat16), j_screen, jprog.pack_terms(ids, w), None,
                jprog.fold_sketch(jnp.asarray(sk, jnp.bfloat16), mini_dim),
                jnp.asarray(mask))

    def port(sel):
        return tprog.hybrid_query_screened(
            *t_arrays, torch.from_numpy(q[sel]), torch.from_numpy(q_scr[sel]),
            torch.from_numpy(q_ids[sel]), torch.from_numpy(q_w[sel]),
            torch.from_numpy(alphas[sel]), pool, screen_k, V, fold, 4)

    with pltpu.force_tpu_interpret_mode():
        ref = jprog.hybrid_query_screened(
            *j_arrays, jnp.asarray(q), jnp.asarray(q_scr), jnp.asarray(q_ids),
            jnp.asarray(q_w), jnp.asarray(alphas), pool, screen_k, V, fold, 4)
    got = port(slice(None))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for a, b in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    solo = port(slice(1, 2))                   # the engine runs it at B=1
    np.testing.assert_array_equal(solo[1].numpy(), got[1][1:2].numpy())


def test_screen_tile_matches_reference():
    for n, rb, pool in [(1 << 20, 256, 500), (1 << 20, 256, 2000), (8192, 64, 32),
                        (2048, 256, 2048), (1 << 20, 2048, 500), (3072, 16, 10)]:
        assert tprog._screen_tile(n, rb, pool) == jprog._screen_tile(n, rb, pool)
    assert tprog._screen_tile(1 << 20, 256, 500) == 16384


def _screen_index(monkeypatch, mode, n=1500, d=256):
    monkeypatch.setenv("CQST_SCREEN_ENABLE", "1")
    monkeypatch.setenv("CQST_SCREEN_MIN_ROWS", "1024")
    monkeypatch.setenv("CQST_SCREEN_MODE", mode)
    rng = np.random.default_rng(5)
    mat = rng.normal(size=(n, d)).astype(np.float32)
    stamp = Stamp(model_fingerprint="test", dim=d, chunk_count=n, generation=0)
    return DenseIndex([f"c{i}" for i in range(n)], mat, stamp, device="cpu"), rng


@pytest.mark.parametrize("mode", ["int8", "proj"])
def test_dense_screen_and_append(monkeypatch, mode):
    idx, rng = _screen_index(monkeypatch, mode)
    m = idx.matrix.float().numpy()
    if mode == "int8":
        want = np.asarray(jnp.clip(jnp.round(jnp.asarray(m) * 127.0), -127, 127)
                          .astype(jnp.int8))
        np.testing.assert_array_equal(idx.screen.numpy(), want)
        assert idx.dense_i8() is idx.screen
    else:
        np.testing.assert_array_equal(idx._screen_proj, _proj(256, 128))
        want = np.asarray(jnp.einsum("nd,ds->ns", jnp.asarray(m), jnp.asarray(_proj(256, 128)),
                                     preferred_element_type=jnp.float32))
        np.testing.assert_allclose(idx.screen.float().numpy(), want, rtol=2 ** -8, atol=1e-6)
    q = rng.normal(size=256).astype(np.float32)
    pq = idx.project_query(q)
    np.testing.assert_array_equal(pq, q if mode == "int8" else q @ _proj(256, 128))
    vecs = rng.normal(size=(4, 256)).astype(np.float32)
    idx.append(["a", "b", "c", "d"], vecs)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    got = idx.screen[1500:1504].float().numpy()
    if mode == "int8":
        np.testing.assert_array_equal(got, np.clip(np.round(vecs * 127.0), -127, 127))
    else:
        np.testing.assert_allclose(got, vecs @ _proj(256, 128), rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("env", [{"CQST_SCREEN_MIN_ROWS": "4096"}, {"CQST_SCREEN_ENABLE": "0"}])
def test_no_screen_when_gated(monkeypatch, env):
    idx, _ = _screen_index(monkeypatch, "int8")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    idx = DenseIndex(idx.ids, idx._host, idx.stamp, device="cpu")
    assert idx.screen is None and idx.project_query(np.ones(256, np.float32)) is None
    np.testing.assert_array_equal(idx.dense_i8().numpy(),
                                  tprog.quantize_unit(idx.matrix).numpy())


# -- the engine routes ---------------------------------------------------------

_KNOBS = {
    "q8": ({"CQST_SCAN_Q8": "1", "CQST_SCAN_Q8_MIN_ROWS": "1024"}, "hybrid_query_batch_q8"),
    "sk8": ({"CQST_SCAN_Q8": "2", "CQST_SCAN_Q8_MIN_ROWS": "1024"}, "hybrid_query_batch_sk8"),
    "screened-int8": ({"CQST_SCREEN_ENABLE": "1", "CQST_SCREEN_MIN_ROWS": "1024"},
                      "hybrid_query_screened"),
    "screened-proj": ({"CQST_SCREEN_ENABLE": "1", "CQST_SCREEN_MIN_ROWS": "1024",
                       "CQST_SCREEN_MODE": "proj"}, "hybrid_query_screened"),
}


def _hits(res):
    return [(h.row.id, h.score) for h in res.hits]


@pytest.mark.parametrize("route", list(_KNOBS))
def test_engine_runs_the_selected_program(tmp_project, monkeypatch, route):
    env, program = _KNOBS[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = {"bf16": 0, program: 0}
    for name, key in ((program, program), ("hybrid_query", "bf16")):
        real = getattr(tengine, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tengine, name, spy)
    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    ctx.engine.host_mirror = False          # the device programs, as on a card
    try:
        solo = {q: _hits(ctx.engine.search(q)) for q in QUERIES}
        assert calls[program] >= len(QUERIES) - 1 and calls["bf16"] == 0, calls
        assert all(solo.values())
        if route.startswith("screened"):
            assert ctx.engine.dense.screen is not None
            return
        ctx2 = CommandContext.create(str(tmp_project), device="cpu")
        ctx2.engine.host_mirror = False
        batcher = QueryBatcher(ctx2.engine)
        try:
            batcher.pause()
            futs = [batcher.submit(q) for q in QUERIES]
            batcher.resume()
            results = [f.result(timeout=60) for f in futs]
        finally:
            batcher.stop()
            ctx2.close()
        assert calls["bf16"] == 0
        assert batcher.stats["fused"] == len(QUERIES)
        for q, res in zip(QUERIES, results):
            got = _hits(res)
            assert [i for i, _ in got] == [i for i, _ in solo[q]], q
            assert np.allclose([s for _, s in got], [s for _, s in solo[q]], rtol=0, atol=1e-5)
    finally:
        ctx.close()


@pytest.mark.parametrize("knob,value", [("CQST_MESH_SHARDS", "2")])
def test_unported_knobs_still_raise(tmp_project, monkeypatch, knob, value):
    # the knob's guard is gone (mesh sharding is ported): a --device cpu
    # context builds a 2-shard engine whose top 5 equal the single-device
    # engine's
    from cqs_tpu_torch.parallel.sharded_hybrid import ShardedHybridIndex

    queries = QUERIES + ["authentication helpers", "revoke an active session"]
    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        assert ctx.engine.sharded is None
        single = {q: _hits(ctx.engine.search(q, limit=5)) for q in queries}
    finally:
        ctx.close()
    calls = []
    real = ShardedHybridIndex.search_legs
    monkeypatch.setattr(ShardedHybridIndex, "search_legs",
                        lambda self, *a, **kw: calls.append(1) or real(self, *a, **kw))
    monkeypatch.setenv(knob, value)
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        sharded = ctx.engine.sharded
        assert sharded is not None and sharded.mesh.size == int(value)
        for q in queries:
            got = _hits(ctx.engine.search(q, limit=5))
            assert got, q
            assert [i for i, _ in got] == [i for i, _ in single[q]], q
            assert np.allclose([s for _, s in got], [s for _, s in single[q]],
                               rtol=0, atol=1e-5), q
        # the unknown-category queries (alpha 0.8) ran the sharded program
        assert len(calls) >= 3
    finally:
        ctx.close()
