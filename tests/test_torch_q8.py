"""int8 slice of the port against the JAX package on the CPU: the int8 plain
twins of both scan bodies against ``topk_pallas`` in interpret mode, the
dtype rule of ``scan_topk``, the kernel argument checks, the quantizers
(``quantize_unit``, ``quantile_linear``, ``quantize_sketch``, ``dense_i8``,
``sketch_i8``) and the q8/sk8 programs.

Tolerances: int8 x int8 scan values and rows exact (integer sums have no
order); widened scans values rtol 1e-5 (f32 sums in another order), rows
exact; quantizers bit-equal; programs rows exact, values rtol 1e-5 /
atol 1e-6; solo (B=1) equals batched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cqs_tpu.search.program as jprog
from cqs_tpu.index.dense import DenseIndex as JDense
from cqs_tpu.index.sparse import SpladeIndex as JSplade
from cqs_tpu.index.stamp import Stamp
from cqs_tpu.ops.topk import topk_pallas
from cqs_tpu_torch.index import DenseIndex, SpladeIndex
from cqs_tpu_torch.ops.sparse import build_doc_sketch
from cqs_tpu_torch.ops.topk import (
    KERNELS, LOOP_I8, check_kernel_args, scan_query, scan_topk, scan_topk_plain_grouped,
    scan_topk_plain_loop,
)
from cqs_tpu_torch.search import program as tprog

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
V, T, QT = 4096, 16, 8
_TDT = {"i8": torch.int8, "bf16": torch.bfloat16}
_JDT = {"i8": jnp.int8, "bf16": jnp.bfloat16}


def _i8(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _query(rng, kind, b, d):
    if kind == "i8":
        return _i8(rng, b, d)
    q = rng.normal(size=(b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pallas(index, q, k, mask, tile, m, extraction, qkind):
    with pltpu.force_tpu_interpret_mode():
        v, r = topk_pallas(jnp.asarray(index, jnp.int8), jnp.asarray(q, _JDT[qkind]), k,
                           jnp.asarray(mask), tile_n=tile, per_tile_k=m,
                           extraction=extraction)
    return np.asarray(v), np.asarray(r)


def _port(index, q, k, mask, tile, m, extraction, qkind):
    v, r = scan_topk(torch.from_numpy(index), torch.from_numpy(q).to(_TDT[qkind]), k,
                     torch.from_numpy(mask), tile_n=tile, per_tile_k=m,
                     extraction=extraction)
    return v.numpy(), r.numpy()


def _assert_scan(port, ref, qkind):
    if qkind == "i8":
        np.testing.assert_array_equal(port[0], ref[0])
    else:
        np.testing.assert_allclose(port[0], ref[0], rtol=RTOL)
    np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("qkind", ["i8", "bf16"])
@pytest.mark.parametrize("extraction", ["loop", "grouped"])
def test_int8_twins_every_tile_slot(seeded_rng, extraction, qkind):
    # k = tiles * m exposes every per-tile slot, including the NEG slots of
    # a nearly empty tile and of an empty one
    n, d, b, tile, m = 1024, 32, 3, 256, 6
    index = _i8(seeded_rng, n, d)
    q = _query(seeded_rng, qkind, b, d)
    mask = np.ones(n, np.int32)
    mask[256:509] = 0
    mask[768:1024] = 0
    args = (index, q, (n // tile) * m, mask, tile, m, extraction, qkind)
    _assert_scan(_port(*args), _pallas(*args), qkind)


def _adversarial(name, rng):
    """int8 twins of the Pallas op tests' adversarial cases: (index, q,
    mask, tile, m)."""
    if name == "ties":
        index = np.tile(np.eye(16, dtype=np.int8)[0] * 100, (512, 1))
        return index, np.eye(16, dtype=np.int8)[:1] * 127, np.ones(512, np.int32), 256, 4
    if name == "heavy_mask":
        mask = np.zeros(1024, np.int32)
        mask[rng.choice(1024, size=51, replace=False)] = 1
        return _i8(rng, 1024, 16), _i8(rng, 2, 16), mask, 128, 8
    index = np.zeros((1024 if name == "spread_spikes" else 512, 16), np.int8)
    if name == "same_group_collision":
        index[5, 0], index[133, 0], index[300, 0] = 100, 90, 10
    else:
        index[:, 1:] = _i8(rng, index.shape[0], 15) // 64
        for rank, row in enumerate([3, 200, 650, 900]):
            index[row] = 0
            index[row, 0] = 120 - 10 * rank
    return index, np.eye(16, dtype=np.int8)[:1] * 127, np.ones(len(index), np.int32), 512, 2


@pytest.mark.parametrize("extraction", ["loop", "grouped"])
@pytest.mark.parametrize("case", ["ties", "heavy_mask", "same_group_collision",
                                  "spread_spikes"])
def test_int8_twins_adversarial(seeded_rng, case, extraction):
    index, q, mask, tile, m = _adversarial(case, seeded_rng)
    args = (index, q, (len(index) // tile) * m, mask, tile, m, extraction, "i8")
    port = _port(*args)
    _assert_scan(port, _pallas(*args), "i8")
    if case == "same_group_collision" and extraction == "grouped":
        assert list(port[1][0][:2]) == [5, 300]       # row 133 shares row 5's group
    if case == "spread_spikes":
        assert list(port[1][0][:4]) == [3, 200, 650, 900]


@pytest.mark.parametrize("grouped", [False, True])
def test_plain_twins_int8_scores_exact(grouped):
    # partial sums of 127 * 127 * j pass 2^24 at j = 1041 and are odd, so an
    # f32 product would round on the way; the float64 twin is exact
    n, d, tile = 256, 1056, 128
    index = np.full((n, d), 127, np.int8)
    q = np.full((1, d), 127, np.int8)
    fn = scan_topk_plain_grouped if grouped else scan_topk_plain_loop
    v, r = fn(torch.from_numpy(index), torch.from_numpy(q), None, tile, 2)
    assert v.dtype == torch.float32
    assert v.flatten().tolist() == [127.0 * 127 * d] * 4
    assert r[:, 0, 0].tolist() == [0, 128]


def test_int8_rows_bf16_query_not_cast(seeded_rng):
    # a unit-norm query against int8 rows is widened, never cast to int8
    # (which would zero it): scores are the f32 products with the bf16 query
    index = _i8(seeded_rng, 512, 32)
    q = _query(seeded_rng, "bf16", 2, 32)
    for qt in (torch.from_numpy(q), torch.from_numpy(q).to(torch.bfloat16)):
        assert scan_query(torch.from_numpy(index), qt).dtype == torch.bfloat16
        v, r = scan_topk(torch.from_numpy(index), qt, 5, tile_n=256)
        qb = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
        want = qb @ index.astype(np.float32).T
        assert np.abs(v.numpy()).max() > 1.0
        np.testing.assert_allclose(v.numpy(), np.take_along_axis(want, r.numpy(), 1),
                                   rtol=RTOL)
    assert scan_query(torch.zeros(4, 8, dtype=torch.bfloat16),
                      torch.ones(1, 8)).dtype == torch.bfloat16
    assert scan_query(torch.zeros(4, 8, dtype=torch.int8),
                      torch.ones(1, 8, dtype=torch.int8)).dtype == torch.int8


@pytest.mark.parametrize("rows,query,d,ok", [
    (torch.bfloat16, torch.bfloat16, 24, "bf16"),
    (torch.int8, torch.int8, 32, "i8"),
    (torch.int8, torch.bfloat16, 48, "i8w"),
    (torch.int8, torch.int8, 24, None),          # int8 rows need D % 16
    (torch.bfloat16, torch.int8, 32, None),      # no kernel for the pair
    (torch.int8, torch.float32, 32, None),
])
def test_check_kernel_args_dtype_pairs(rows, query, d, ok):
    args = (torch.zeros(512, d, dtype=rows), torch.zeros(2, d, dtype=query),
            torch.ones(512, dtype=torch.int32), 128, 4)
    if ok is None:
        with pytest.raises((TypeError, ValueError)):
            check_kernel_args(*args, grouped=False)
    else:
        assert check_kernel_args(*args, grouped=True) == ok


def test_six_wrappers_refuse_cpu_tensors():
    assert len({k.name for k in KERNELS}) == len({k.symbol for k in KERNELS}) == 6
    assert {(k.kind, k.grouped) for k in KERNELS} == {
        (kind, g) for kind in ("bf16", "i8", "i8w") for g in (False, True)}
    index = torch.zeros(512, 16, dtype=torch.int8)
    for kernel in KERNELS:
        with pytest.raises(ValueError):
            kernel(index, index[:2], torch.ones(512, dtype=torch.int32), 128, 4)
        assert kernel.launches == 0
    assert LOOP_I8.replaces == "cqs_tpu/ops/topk.py:69"


# -- quantizers ----------------------------------------------------------------

_JAX_HI = jax.jit(lambda s: jnp.quantile(jnp.abs(s.astype(jnp.float32)).reshape(-1), 0.9999))


@pytest.mark.parametrize("n", [1, 7, 1000, 16385, 65537])
def test_quantile_linear_bit_equal(seeded_rng, n):
    # against the reference's jitted |x| quantile (quantize_sketch's _hi), on
    # 40 scalings each so the interpolation's rounding is exercised
    for scale in np.geomspace(0.1, 100, 40):
        x = np.abs(seeded_rng.standard_t(3, size=n) * scale).astype(np.float32)
        x[: n // 3] = np.round(x[: n // 3], 1)                # repeated values
        port = tprog.quantile_linear(torch.from_numpy(x).abs(), 0.9999).numpy()
        ref = np.asarray(_JAX_HI(jnp.asarray(x)))
        assert port.dtype == np.float32 and port.tobytes() == ref.tobytes(), scale


def _jq(x):
    return np.asarray(jnp.clip(jnp.round(jnp.asarray(x, jnp.float32) * 127.0),
                               -127, 127).astype(jnp.int8))


def test_quantize_unit_rounding_boundaries():
    # k +/- 0.5 over 127 (the rounding boundaries, half to even), bf16 grid
    # values and saturation
    k = np.arange(-130, 131, dtype=np.float64)
    x = np.concatenate([(k + 0.5) / 127, (k - 0.5) / 127, np.arange(-300, 301) / 256,
                        [0.5, -0.5, 1.5 / 127, -2.5 / 127, 2.0, -2.0]]).astype(np.float32)
    port = tprog.quantize_unit(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(port, _jq(x))
    assert tprog.quantize_unit(torch.tensor([0.5, -0.5])).tolist() == [64, -64]


@pytest.mark.parametrize("n", [2048, 40960])
def test_quantize_sketch_bit_equal(seeded_rng, n):
    # 40960 rows: a strided sample (stride 2) and a chunked quantization
    ids = seeded_rng.integers(0, V, size=(n, T)).astype(np.int32)
    w = np.log1p(seeded_rng.integers(1, 6, size=(n, T))).astype(np.float32)
    sk = build_doc_sketch(ids, w, 128)
    sk[3, 5] = 500.0                                          # outlier clips
    port = tprog.quantize_sketch(torch.from_numpy(sk).to(torch.bfloat16)).numpy()
    ref = np.asarray(jprog.quantize_sketch(jnp.asarray(sk, jnp.bfloat16)))
    np.testing.assert_array_equal(port, ref)
    assert port[3, 5] == 127


def test_query_sketch_quantizer_bit_equal(seeded_rng):
    q_sk = seeded_rng.normal(size=(5, 64)).astype(np.float32) * 3
    q_sk[2] = 0.0                                             # the 1e-6 floor
    port = tprog._quantize_query_sketch(torch.from_numpy(q_sk)).numpy()
    qs = jnp.asarray(q_sk)
    scale = 127.0 / jnp.maximum(jnp.max(jnp.abs(qs), axis=1, keepdims=True), 1e-6)
    ref = np.asarray(jnp.clip(jnp.round(qs * scale), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(port, ref)


def _indexes(rng, n=300, d=32, s=128):
    ids = [f"c{i}" for i in range(n)]
    mat = rng.normal(size=(n, d)).astype(np.float32)
    mat[:4, 0] = 10.0                                         # large components
    doc_ids = rng.integers(1, V, size=(n, T)).astype(np.int32)
    doc_w = rng.random((n, T)).astype(np.float32)
    stamp = Stamp(model_fingerprint="test", dim=d, chunk_count=n, generation=0)
    port = (DenseIndex(ids, mat, stamp, device="cpu", pad_multiple=512),
            SpladeIndex(ids, doc_ids, doc_w, V, stamp, device="cpu", pad_multiple=512,
                        sketch_dim=s))
    ref = (JDense(ids, mat, stamp, pad_multiple=512),
           JSplade(ids, doc_ids, doc_w, V, stamp, pad_multiple=512, sketch_dim=s))
    return port, ref


def _assert_i8_arrays(port, ref):
    np.testing.assert_array_equal(port[0].dense_i8().numpy(), np.asarray(ref[0].dense_i8()))
    np.testing.assert_array_equal(port[1].sketch_i8().numpy(), np.asarray(ref[1].sketch_i8()))


def test_index_int8_copies_follow_append_and_remove(seeded_rng):
    port, ref = _indexes(seeded_rng)
    _assert_i8_arrays(port, ref)
    d8, s8 = port[0].dense_i8(), port[1].sketch_i8()
    assert port[0].dense_i8() is d8 and port[1].sketch_i8() is s8     # cached
    new = [f"n{i}" for i in range(20)]
    vecs = seeded_rng.normal(size=(20, 32)).astype(np.float32)
    t_ids = seeded_rng.integers(1, V, size=(20, T)).astype(np.int32)
    t_w = seeded_rng.random((20, T)).astype(np.float32) * 4
    for p, r in zip(port, ref):
        p.append(new, vecs) if p is port[0] else p.append(new, t_ids, t_w)
        r.append(new, vecs) if r is ref[0] else r.append(new, t_ids, t_w)
    assert port[0].dense_i8() is not d8 and port[1].sketch_i8() is not s8
    _assert_i8_arrays(port, ref)
    for idx in (*port, *ref):
        idx.remove({"c3", "n5"})
    _assert_i8_arrays(port, ref)
    np.testing.assert_array_equal(port[0].mask.numpy(), np.asarray(ref[0].mask))


def test_fold_sketch_and_mini_cache(seeded_rng):
    port, ref = _indexes(seeded_rng, s=256)
    mini = port[1].sketch_mini(32)
    assert port[1].sketch_mini(32) is mini and port[1].sketch_mini(64) is not mini
    got = mini.view(torch.int16).numpy()
    want = np.asarray(jprog.fold_sketch(ref[1].sketch, 32)).view(np.int16)
    np.testing.assert_array_equal(got, want)


# -- the q8 and sk8 programs ---------------------------------------------------

def _corpus(rng, n_pad=8192, n_valid=7900, d=64, s=128):
    mat = rng.normal(size=(n_pad, d)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    mat[n_valid:] = 0.0
    ids = rng.integers(4, V, size=(n_pad, T)).astype(np.int32)
    w = np.log1p(rng.integers(1, 4, size=(n_pad, T))).astype(np.float32)
    w[:, T - 3:] = 0.0
    ids[n_valid:] = 0
    w[n_valid:] = 0.0
    mask = np.zeros(n_pad, np.int32)
    mask[:n_valid] = 1
    mask[rng.choice(n_valid, size=n_valid // 20, replace=False)] = 0      # tombstones
    rows = rng.choice(n_valid, size=3, replace=False)
    q = mat[rows] + 0.3 * rng.normal(size=(3, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_ids = np.zeros((3, QT), np.int32)
    q_w = np.zeros((3, QT), np.float32)
    q_ids[:, :5] = ids[rows, :5]
    q_w[:, :5] = np.log1p(np.arange(5, 0, -1)).astype(np.float32)
    alphas = np.array([0.7, 0.0, 0.4], np.float32)
    return mat, ids, w, build_doc_sketch(ids, w, s), mask, q, q_ids, q_w, alphas


def _assert_legs(port, ref):
    port = [np.asarray(x) for x in port]
    ref = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(port[1], ref[1])
    for p, r in zip((port[0], port[2], port[3]), (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("extraction,pool", [("loop", 50), ("grouped", 32)])
@pytest.mark.parametrize("program", ["q8", "sk8"])
def test_int8_programs_match_jax(program, extraction, pool):
    rng = np.random.default_rng(11)
    mat, ids, w, sk, mask, q, q_ids, q_w, alphas = _corpus(rng)
    tm = torch.from_numpy(mat).to(torch.bfloat16)
    t_pk = tprog.pack_terms(torch.from_numpy(ids), torch.from_numpy(w))
    tsk8 = tprog.quantize_sketch(torch.from_numpy(sk).to(torch.bfloat16))
    td8 = tprog.quantize_unit(tm)
    tmask = torch.from_numpy(mask)
    jm = jnp.asarray(mat, jnp.bfloat16)
    j_pk = jprog.pack_terms(ids, w)
    jsk8 = jprog.quantize_sketch(jnp.asarray(sk, jnp.bfloat16))
    np.testing.assert_array_equal(tsk8.numpy(), np.asarray(jsk8))

    def port(b):
        tq = (torch.from_numpy(q[b]), torch.from_numpy(q_ids[b]), torch.from_numpy(q_w[b]),
              torch.from_numpy(alphas[b]))
        if program == "q8":
            return tprog.hybrid_query_batch_q8(tm, td8, t_pk, None, tsk8, tmask, *tq, pool, V,
                                               extraction=extraction)
        return tprog.hybrid_query_batch_sk8(tm, t_pk, None, tsk8, tmask, *tq, pool, V,
                                            extraction=extraction)

    jq = (jnp.asarray(q), jnp.asarray(q_ids), jnp.asarray(q_w), jnp.asarray(alphas))
    with pltpu.force_tpu_interpret_mode():
        if program == "q8":
            ref = jprog.hybrid_query_batch_q8(jm, jnp.asarray(td8.numpy()), j_pk, None, jsk8,
                                              jnp.asarray(mask), *jq, pool, V,
                                              extraction=extraction)
        else:
            ref = jprog.hybrid_query_batch_sk8(jm, j_pk, None, jsk8, jnp.asarray(mask), *jq,
                                               pool, V, extraction=extraction)
    batched = port(slice(None))
    _assert_legs(batched, ref)
    assert np.all(mask[batched[1][batched[0] > -1e30].numpy()] > 0)
    for b in range(3):
        solo = port(slice(b, b + 1))
        np.testing.assert_array_equal(solo[1].numpy(), batched[1][b:b + 1].numpy())
        np.testing.assert_allclose(solo[0].numpy(), batched[0][b:b + 1].numpy(), rtol=1e-6)


def test_int8_programs_need_tiles():
    z = torch.zeros(1024, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="scan tiles"):
        tprog.hybrid_query_batch_q8(z.to(torch.bfloat16), z, None, None, z, None,
                                    torch.zeros(1, 16), None, None, None, 8, V)
