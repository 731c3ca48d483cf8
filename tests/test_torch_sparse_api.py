"""The sparse-only and index-size API of the port against the JAX package, on
the CPU: ``ops/sparse.py``'s ``query_to_dense``, ``sparse_scores``,
``sparse_scores_batch`` (one tile and several), ``sparse_topk``,
``build_doc_sketch_device`` and ``sketch_query``; ``SpladeIndex.search``
and ``DenseIndex.max_k``. Inputs are made with numpy from a seed.

Tolerances: rows and top-k order equal (ties to the lower row, as
``lax.top_k``); f32 scores within rtol 1e-6 / atol 1e-7 (sums in another
order); a device-built bf16 sketch within one bf16 ulp of the reference's
(rtol 2^-8), and equal to the host build rounded to bf16 where the f32 sums
agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cqs_tpu.ops.sparse as jsp
from cqs_tpu.index.dense import DenseIndex as JDense
from cqs_tpu.index.sparse import SpladeIndex as JSplade
from cqs_tpu.index.stamp import Stamp as JStamp
from cqs_tpu_torch.index import DenseIndex, SpladeIndex, Stamp
from cqs_tpu_torch.ops import sparse as tsp

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -8


def _terms(seed, n=300, t=8, v=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, size=(n, t)).astype(np.int32)
    w = rng.random((n, t)).astype(np.float32)
    w[rng.random((n, t)) < 0.2] = 0.0            # zero-weight padding terms
    return rng, ids, w


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_query_to_dense_matches_reference():
    ids = np.asarray([3, 7, 3, 0, 7, 3], np.int32)        # repeats and slot 0
    w = np.asarray([0.5, 1.25, 2.0, 0.0, -0.75, 1e-3], np.float32)
    got = tsp.query_to_dense(_t(ids), _t(w), 16).numpy()
    want = np.asarray(jsp.query_to_dense(jnp.asarray(ids), jnp.asarray(w), 16))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got[0] == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_sparse_scores_match_reference(masked):
    rng, ids, w = _terms(1)
    qv = rng.random(64).astype(np.float32)
    mask = (rng.random(300) > 0.3).astype(np.int32) if masked else None
    got = tsp.sparse_scores(_t(qv), _t(ids), _t(w), None if mask is None else _t(mask))
    want = jsp.sparse_scores(jnp.asarray(qv), jnp.asarray(ids), jnp.asarray(w),
                             None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if masked:
        assert (got.numpy()[mask == 0] == tsp.NEG).all()


@pytest.mark.parametrize("tile_n", [1 << 20, 128, 77])
def test_sparse_scores_batch_matches_reference(tile_n):
    # 1 << 20: one tile; 128 and 77: three and four tiles, the last partial
    rng, ids, w = _terms(2)
    qvs = rng.random((3, 64)).astype(np.float32)
    mask = (rng.random(300) > 0.25).astype(np.int32)
    got = tsp.sparse_scores_batch(_t(qvs), _t(ids), _t(w), _t(mask), tile_n=tile_n).numpy()
    want = np.asarray(jsp.sparse_scores_batch(jnp.asarray(qvs), jnp.asarray(ids),
                                              jnp.asarray(w), jnp.asarray(mask),
                                              tile_n=tile_n))
    assert got.shape == (3, 300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # tiling changes nothing: each tile's rows are the untiled rows
    np.testing.assert_array_equal(
        got, tsp.sparse_scores_batch(_t(qvs), _t(ids), _t(w), _t(mask)).numpy())


@pytest.mark.parametrize("k", [1, 5, 50])
def test_sparse_topk_matches_reference_with_ties(k):
    rng, ids, w = _terms(3, n=50)
    ids[10:20] = ids[0]                     # ten copies of row 0: tied scores
    w[10:20] = w[0]
    qv = rng.random(64).astype(np.float32)
    mask = np.ones(50, np.int32)
    mask[12] = 0
    vals, rows = tsp.sparse_topk(_t(qv), _t(ids), _t(w), k, _t(mask))
    jv, jr = jsp.sparse_topk(jnp.asarray(qv), jnp.asarray(ids), jnp.asarray(w), k,
                             jnp.asarray(mask))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    assert rows.dtype == torch.int32
    scores = (qv[ids] * w).sum(axis=1)
    scores[12] = -np.inf
    np.testing.assert_array_equal(rows.numpy(), np.argsort(-scores, kind="stable")[:k])


@pytest.mark.parametrize("tile", [8192, 64, 100])
def test_build_doc_sketch_device_matches_reference(tile):
    _, ids, w = _terms(4, n=300, t=16, v=4096)
    got = tsp.build_doc_sketch_device(_t(ids), _t(w), 128, tile=tile)
    want = np.asarray(jsp.build_doc_sketch_device(jnp.asarray(ids), jnp.asarray(w), 128,
                                                  tile=tile).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (300, 128)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=0)
    # the host build (f64 sums) rounded to bf16: within one ulp, and equal
    # wherever the two f32 sums round alike
    host = _t(tsp.build_doc_sketch(ids, w, 128)).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), host, rtol=BF16_RTOL, atol=0)
    assert (got.float().numpy() == host).mean() > 0.99


def test_sketch_query_matches_reference():
    rng = np.random.default_rng(5)
    q_ids = rng.integers(0, 4096, size=24).astype(np.int32)
    q_ids[5] = q_ids[0]                       # colliding terms add in order
    q_w = rng.random(24).astype(np.float32)
    got = tsp.sketch_query(_t(q_ids), _t(q_w), 256).numpy()
    want = np.asarray(jsp.sketch_query(jnp.asarray(q_ids), jnp.asarray(q_w), 256))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tsp.query_sketch(_t(q_ids)[None], _t(q_w)[None],
                                                        256)[0].numpy())


def _stamps(n, kind):
    return (Stamp(model_fingerprint="test", dim=16, chunk_count=n, generation=0, kind=kind),
            JStamp(model_fingerprint="test", dim=16, chunk_count=n, generation=0, kind=kind))


def _splade_pair(rng, n=6, t=4, v=64, pad=8):
    ids = rng.integers(1, v, size=(n, t)).astype(np.int32)
    w = rng.random((n, t)).astype(np.float32)
    names = [f"c{i}" for i in range(n)]
    ts, js = _stamps(n, "splade")
    return (SpladeIndex(names, ids, w, v, ts, device="cpu", pad_multiple=pad),
            JSplade(names, ids, w, v, js, pad_multiple=pad))


def _same_search(port, ref, q_ids, q_w, k, filter_mask=None):
    pv, pr = port.search(q_ids, q_w, k, filter_mask)
    jv, jr = ref.search(q_ids, q_w, k, filter_mask)
    np.testing.assert_array_equal(pr, np.asarray(jr))
    valid = pr >= 0
    np.testing.assert_allclose(pv[valid], np.asarray(jv)[valid], rtol=RTOL, atol=ATOL)
    return pv, pr


def test_splade_search_matches_reference():
    rng = np.random.default_rng(6)
    port, ref = _splade_pair(rng)
    # a query of exactly doc 2's terms finds doc 2 first
    pv, pr = _same_search(port, ref, port._host_ids[2], np.ones(4, np.float32), 3)
    assert pr[0] == 2
    # a term no document holds: every row is -1 (no zero-score matches)
    pv, pr = _same_search(port, ref, np.asarray([0], np.int32), np.ones(1, np.float32), 3)
    assert (pr == -1).all()
    # k past the capacity is cut to it; filtered rows never return
    for k in (1, 8, 100):
        q_ids = rng.integers(1, 64, size=6).astype(np.int32)
        pv, pr = _same_search(port, ref, q_ids, rng.random(6).astype(np.float32), k)
        assert pr.shape == (min(k, port.capacity),)
    fm = np.asarray([1, 0, 1, 0, 1, 1], np.int32)
    pv, pr = _same_search(port, ref, port._host_ids[1], np.ones(4, np.float32), 6, fm)
    assert 1 not in pr.tolist() and 3 not in pr.tolist()


def test_splade_search_after_append_and_remove():
    rng = np.random.default_rng(7)
    port, ref = _splade_pair(rng, n=3)
    new_ids = rng.integers(1, 64, size=(2, 4)).astype(np.int32)
    new_w = rng.random((2, 4)).astype(np.float32)
    for idx in (port, ref):
        idx.append(["x0", "x1"], new_ids, new_w)
        idx.remove({"c1"})
    pv, pr = _same_search(port, ref, new_ids[1], np.ones(4, np.float32), 5)
    assert pr[0] == 4 and 1 not in pr.tolist()


def test_dense_max_k_matches_reference():
    rng = np.random.default_rng(8)
    for n in (5, 1):
        mat = rng.normal(size=(n, 16)).astype(np.float32)
        names = [f"c{i}" for i in range(n)]
        ts, js = _stamps(n, "dense")
        port = DenseIndex(names, mat, ts, device="cpu", pad_multiple=8)
        ref = JDense(names, mat, js, pad_multiple=8)
        assert port.max_k == ref.max_k == n
        vals, rows = port.search(port._host[0][None], k=100)
        assert rows.shape[1] <= port.capacity
    ts, js = _stamps(0, "dense")
    empty = DenseIndex([], np.zeros((0, 16), np.float32), ts, device="cpu", pad_multiple=8)
    assert empty.max_k == JDense([], np.zeros((0, 16), np.float32), js, pad_multiple=8).max_k == 1
