"""Hybrid query program port against the JAX package on the CPU.

(a) N_pad = 1024 and 2048 against the reference on the CPU, which always
    takes its exact branch. At 1024 the port takes its exact branch too; at
    2048 it takes the scan branch (two tiles of the 1024-row fallback tile,
    as the TPU would), whose per-tile k of 50 covers the pool, so the
    results agree.
(b) N_pad = 8192 (4 tiles of 2048) at narrow widths: the port's per-tile
    scan path against the reference's TPU branch composed from its own
    functions (``_fused_candidates`` under Pallas interpret mode for both
    legs, the dense gather for the sketch half, ``_exact_rescore_fuse``).

Tolerances: rows exact; values rtol 1e-5 / atol 1e-6 (f32 sums in another
order); solo vs batched rows exact, values rtol 1e-6."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cqs_tpu.search.program as jprog
from cqs_tpu.ops.fusion import fuse_alpha as j_fuse_alpha, minmax_normalize as j_minmax
from cqs_tpu_torch.ops.fusion import NEG, fuse_alpha, minmax_normalize
from cqs_tpu_torch.ops.sparse import build_doc_sketch
from cqs_tpu_torch.search import program as tprog

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
V, T, QT = 4096, 16, 8


def _corpus(rng, n_pad, n_valid, d, s):
    mat = rng.normal(size=(n_pad, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    mat[n_valid:] = 0.0
    ids = rng.integers(4, V, size=(n_pad, T)).astype(np.int32)
    w = np.log1p(rng.integers(1, 4, size=(n_pad, T))).astype(np.float32)
    w[:, T - 3:] = 0.0                       # zero-weight padding terms
    ids[n_valid:] = 0
    w[n_valid:] = 0.0
    sketch = build_doc_sketch(ids, w, s)
    mask = np.zeros(n_pad, np.int32)
    mask[:n_valid] = 1
    mask[rng.choice(n_valid, size=n_valid // 20, replace=False)] = 0   # tombstones
    return mat, ids, w, sketch, mask


def _queries(rng, mat, ids, b):
    rows = rng.choice(int((np.abs(mat).sum(1) > 0).sum()), size=b, replace=False)
    q = mat[rows] + 0.3 * rng.normal(size=(b, mat.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_ids = np.zeros((b, QT), np.int32)
    q_w = np.zeros((b, QT), np.float32)
    for i, r in enumerate(rows):
        q_ids[i, :5] = ids[r, :5]
        q_w[i, :5] = np.log1p(np.arange(5, 0, -1)).astype(np.float32)
    alphas = np.array([0.7, 0.0, 1.0, 0.4][:b] + [0.6] * max(0, b - 4), np.float32)
    return q.astype(np.float32), q_ids, q_w, alphas[:b]


def _torch_arrays(mat, ids, w, sketch, mask):
    return (torch.from_numpy(mat).to(torch.bfloat16),
            tprog.pack_terms(torch.from_numpy(ids), torch.from_numpy(w)),
            torch.from_numpy(sketch).to(torch.bfloat16), torch.from_numpy(mask))


def _jax_arrays(mat, ids, w, sketch, mask):
    return (jnp.asarray(mat, jnp.bfloat16), jprog.pack_terms(ids, w),
            jnp.asarray(sketch, jnp.bfloat16), jnp.asarray(mask))


def _assert_legs(port, ref):
    port = [np.asarray(x) for x in port]
    ref = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(port[1], ref[1])
    for p, r in zip((port[0], port[2], port[3]), (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_pad", [1024, 2048])
@pytest.mark.parametrize("sketch_candidates", [True, False])
def test_small_corpus_matches_jax(seeded_rng, sketch_candidates, n_pad):
    mat, ids, w, sk, mask = _corpus(seeded_rng, n_pad, n_pad - 248, 64, 128)
    q, q_ids, q_w, alphas = _queries(seeded_rng, mat, ids, 4)
    pool = 50
    tm, tp, ts, tmask = _torch_arrays(mat, ids, w, sk, mask)
    jm, jp, js, jmask = _jax_arrays(mat, ids, w, sk, mask)
    port = tprog.hybrid_query_batch(tm, tp, None, ts, tmask, torch.from_numpy(q),
                                    torch.from_numpy(q_ids), torch.from_numpy(q_w),
                                    torch.from_numpy(alphas), pool, V,
                                    sketch_candidates=sketch_candidates)
    ref = jprog.hybrid_query_batch(jm, jp, None, js, jmask, jnp.asarray(q),
                                   jnp.asarray(q_ids), jnp.asarray(q_w),
                                   jnp.asarray(alphas), pool, V,
                                   sketch_candidates=sketch_candidates)
    _assert_legs(port, ref)
    solo = tprog.hybrid_query(tm, tp, None, ts, tmask, torch.from_numpy(q[0]),
                              torch.from_numpy(q_ids[0]), torch.from_numpy(q_w[0]),
                              float(alphas[0]), pool, V,
                              sketch_candidates=sketch_candidates)
    jsolo = jprog.hybrid_query(jm, jp, None, js, jmask, jnp.asarray(q[0]),
                               jnp.asarray(q_ids[0]), jnp.asarray(q_w[0]),
                               jnp.float32(alphas[0]), pool, V,
                               sketch_candidates=sketch_candidates)
    _assert_legs(solo, jsolo)


def _jax_tpu_branch(jm, jp, js, jmask, q, q_ids, q_w, alphas, pool, extraction):
    """The reference's TPU branch of ``_hybrid_impl`` composed from its own
    functions, Pallas in interpret mode."""
    q_mat = jnp.asarray(q).astype(jm.dtype)
    q_sk = jprog._query_sketch(jnp.asarray(q_ids), jnp.asarray(q_w),
                               js.shape[1]).astype(js.dtype)
    with pltpu.force_tpu_interpret_mode():
        dv, dc = jprog._fused_candidates(jm, q_mat, jmask, pool, tile_n=2048,
                                         extraction=extraction)
        _, sc = jprog._fused_candidates(js, q_sk, jmask, pool, tile_n=2048,
                                        extraction=extraction)
    rows = jnp.concatenate([dc, sc], axis=1).astype(jnp.int32)
    half = jnp.einsum("bpd,bd->bp", jnp.take(jm, sc.astype(jnp.int32), axis=0), q_mat,
                      preferred_element_type=jnp.float32)
    d_c = jnp.concatenate([dv, half], axis=1)
    return jprog._exact_rescore_fuse(jp, None, jmask, jnp.asarray(q_ids), jnp.asarray(q_w),
                                     jnp.asarray(alphas), rows, d_c, pool, V)


@pytest.mark.parametrize("extraction,pool", [("loop", 50), ("grouped", 32)])
def test_scan_branch_matches_jax_tpu_branch(extraction, pool):
    rng = np.random.default_rng(7)
    mat, ids, w, sk, mask = _corpus(rng, 8192, 7900, 64, 128)
    q, q_ids, q_w, alphas = _queries(rng, mat, ids, 3)
    ptk, ran = tprog.scan_geometry(8192, pool, 2048, extraction)
    assert (ptk, ran) == ((25, "loop") if extraction == "loop" else (16, "grouped"))
    tm, tp, ts, tmask = _torch_arrays(mat, ids, w, sk, mask)
    port = tprog.hybrid_query_batch(tm, tp, None, ts, tmask, torch.from_numpy(q),
                                    torch.from_numpy(q_ids), torch.from_numpy(q_w),
                                    torch.from_numpy(alphas), pool, V,
                                    extraction=extraction)
    ref = _jax_tpu_branch(*_jax_arrays(mat, ids, w, sk, mask), q, q_ids, q_w, alphas,
                          pool, extraction)
    _assert_legs(port, ref)
    # solo == batched on the port
    for b in range(3):
        solo = tprog.hybrid_query(tm, tp, None, ts, tmask, torch.from_numpy(q[b]),
                                  torch.from_numpy(q_ids[b]), torch.from_numpy(q_w[b]),
                                  float(alphas[b]), pool, V, extraction=extraction)
        np.testing.assert_array_equal(solo[1].numpy(), port[1][b].numpy())
        np.testing.assert_allclose(solo[0].numpy(), port[0][b].numpy(), rtol=1e-6)


def test_scan_geometry_downgrades_grouped():
    assert tprog.scan_geometry(131072, 500, 2048, "grouped") == (16, "grouped")
    assert tprog.scan_geometry(65536, 500, 2048, "grouped") == (32, "loop")
    assert tprog.scan_geometry(1 << 20, 500, 2048, "grouped") == (4, "grouped")
    for n, pool, ext in [(131072, 500, "grouped"), (65536, 500, "grouped"),
                         (4096, 500, "loop"), (1 << 20, 250, "grouped")]:
        assert tprog.scan_geometry(n, pool, 2048, ext)[1] == \
            jprog.effective_extraction(n, pool, 2048, ext)
    assert tprog._scan_tile(1024) is None and tprog._scan_tile(4096) == 2048
    assert tprog._scan_tile(2048) == 1024 and tprog._scan_tile(3072) == 1024


def test_pack_terms_bit_equal(seeded_rng):
    ids = seeded_rng.integers(0, V, size=(300, T)).astype(np.int32)
    w = seeded_rng.random(size=(300, T)).astype(np.float32)
    w[:, -2:] = 0.0
    port = tprog.pack_terms(torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jprog.pack_terms(ids, w)))


def test_query_sketch_term_order(seeded_rng):
    # colliding buckets (ids S apart, alternating sign) add in term order
    s = 128
    q_ids = np.array([[5, 5 + s, 5 + 2 * s, 5 + 3 * s, 77, 0, 0, 0],
                      [9, 9 + 5 * s, 9 + 2 * s, 300, 300 + s, 1, 0, 0]], np.int32)
    q_w = seeded_rng.random(size=q_ids.shape).astype(np.float32) * 3
    q_w[:, -2:] = 0.0
    port = tprog._query_sketch(torch.from_numpy(q_ids), torch.from_numpy(q_w), s).numpy()
    ref = np.asarray(jprog._query_sketch(jnp.asarray(q_ids), jnp.asarray(q_w), s))
    np.testing.assert_array_equal(port, ref)


def test_trim_query_terms_matches(seeded_rng):
    q_ids = seeded_rng.integers(4, V, size=(3, 64)).astype(np.int32)
    q_w = np.zeros((3, 64), np.float32)
    q_w[0, :11] = 1.0
    q_w[2, :3] = 2.0
    for a, b in zip(tprog.trim_query_terms(q_ids, q_w), jprog.trim_query_terms(q_ids, q_w)):
        np.testing.assert_array_equal(a, b)
    assert tprog.trim_query_terms(q_ids, q_w)[0].shape == (3, 16)


def test_minmax_normalize_near_neg():
    x = np.array([[0.5, NEG, 2.0, 1.0, NEG],
                  [NEG, NEG, NEG, NEG, NEG],
                  [3.0, 3.0, NEG, 3.0, NEG],
                  [-1e31, 0.25, NEG, 0.0, 7.0]], np.float32)
    port = minmax_normalize(torch.from_numpy(x)).numpy()
    ref = np.asarray(j_minmax(jnp.asarray(x)))
    np.testing.assert_array_equal(port, ref)
    assert np.all(port[1] == np.float32(NEG))


@pytest.mark.parametrize("alpha", [0.8, 0.0, -0.5])
def test_fuse_alpha_matches(alpha):
    d = np.array([[0.9, NEG, 0.2, NEG, 0.5]], np.float32)
    s = np.array([[0.1, 0.7, NEG, NEG, 1.0]], np.float32)
    a = np.full((1, 1), alpha, np.float32)
    port = fuse_alpha(torch.from_numpy(d), torch.from_numpy(s), torch.from_numpy(a)).numpy()
    ref = np.asarray(j_fuse_alpha(jnp.asarray(d), jnp.asarray(s), jnp.asarray(a)))
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    assert port[0, 3] == np.float32(NEG)


def test_dense_query_matches(seeded_rng):
    mat, ids, w, sk, mask = _corpus(seeded_rng, 2048, 1500, 64, 128)
    q = _queries(seeded_rng, mat, ids, 1)[0][0]
    pv, pr = tprog.dense_query(torch.from_numpy(mat).to(torch.bfloat16),
                               torch.from_numpy(mask), torch.from_numpy(q), 40)
    jv, jr = jprog.dense_query(jnp.asarray(mat, jnp.bfloat16), jnp.asarray(mask),
                               jnp.asarray(q), 40)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)


def test_bf16_storage_rounds_like_jax(seeded_rng):
    x = seeded_rng.normal(size=(64, 32)).astype(np.float32)
    port = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    ref = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(port, ref)
    assert ml_dtypes.bfloat16 is not None and jax.default_backend() == "cpu"
