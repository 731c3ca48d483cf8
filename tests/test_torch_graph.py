"""The graph ANN and the tiered index of the port against the JAX package,
on the CPU: the same inputs, made from a numpy seed (clustered unit rows, as
``tests/test_graph.py`` makes them), through ``cqs_tpu/index/{graph,tiered}.py``
and ``cqs_tpu_torch/index/{graph,tiered}.py``. The reference runs as its own
tests run it on the CPU (``lax.top_k`` builds, jitted beam search); the
port's exact build runs ``scan_topk``'s plain twin.

Tolerances: ``default_itopk``, ``add_reverse_edges``, the NN-descent graph
and every id list equal; the exact kNN graph equal, where a slot may differ
only between near-ties (the two scores within 1e-5 of each other); beam
search rows equal and values within 1e-5 (f32 sums in another order), at an
f32 matrix and at the bf16 storage; the port's batched search equal to its
solo search bit for bit."""

import numpy as np
import pytest
import torch

import cqs_tpu.index.graph as jg
from cqs_tpu.index import Stamp as JStamp
from cqs_tpu.index.tiered import TieredIndex as JTiered
import cqs_tpu_torch.index.graph as tg
from cqs_tpu_torch.index import GraphIndex, Stamp, TieredIndex

torch.set_num_threads(1)
DIM = 32


def _clustered(seed: int, n: int, d: int = DIM, centers: int = 20) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d))
    mat = c[rng.integers(0, centers, size=n)] + 0.3 * rng.normal(size=(n, d))
    return (mat / np.linalg.norm(mat, axis=1, keepdims=True)).astype(np.float32)


def _queries(mat: np.ndarray, seed: int, b: int, noise: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = mat[rng.integers(0, len(mat), b)] + noise * rng.normal(size=(b, mat.shape[1]))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _stamps(n: int, d: int = DIM, kind: str = "graph"):
    return (Stamp(model_fingerprint="t", dim=d, chunk_count=n, generation=0, kind=kind),
            JStamp(model_fingerprint="t", dim=d, chunk_count=n, generation=0, kind=kind))


@pytest.fixture(scope="module")
def corpus():
    return _clustered(7, 2000)


@pytest.fixture(scope="module")
def built(corpus):
    """Both packages' GraphIndex over the corpus (degree 16), each built by
    its own exact build."""
    ids = [f"c{i}" for i in range(len(corpus))]
    ts, js = _stamps(len(corpus))
    return (GraphIndex.build(ids, corpus, ts, degree=16, device="cpu"),
            jg.GraphIndex.build(ids, corpus, js, degree=16))


@pytest.mark.parametrize("n", [0, 1, 2, 10, 1000, 3745, 65536, 100_000, 1 << 20, 10 ** 9])
def test_default_itopk_matches(n):
    assert tg.default_itopk(n) == jg.default_itopk(n)


@pytest.mark.parametrize("n,degree,half,seed", [
    (4, 4, 1, 0), (64, 8, None, 1), (300, 16, None, 2), (1000, 32, None, 3),
    (200, 16, 0, 4), (50, 6, 5, 5)])
def test_add_reverse_edges_bit_for_bit(n, degree, half, seed):
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, size=(n, degree), dtype=np.int32)
    got = tg.add_reverse_edges(nbrs, half)
    want = jg.add_reverse_edges(nbrs, half)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _assert_near_tie_slots(mat: np.ndarray, got: np.ndarray, want: np.ndarray) -> None:
    """Slot for slot equal, or a near-tie: the two rows' bf16 scores against
    the slot's own row within 1e-5."""
    rows = mat.astype(np.float32)
    bf = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    diff = np.argwhere(got != want)
    for i, j in diff:
        a = float(bf[i] @ bf[got[i, j]])
        b = float(bf[i] @ bf[want[i, j]])
        assert abs(a - b) <= 1e-5, (i, j, got[i, j], want[i, j], a, b)


@pytest.mark.parametrize("n,degree", [(3, 8), (200, 8), (500, 16), (2000, 16)])
def test_build_knn_graph_matches_reference(corpus, n, degree):
    mat = corpus[:n]
    got = tg.build_knn_graph(mat, degree, device="cpu")
    want = jg.build_knn_graph(mat, degree)
    assert got.shape == want.shape == (n, degree) and got.dtype == np.int32
    _assert_near_tie_slots(mat, got, want)
    assert (got == want).mean() >= 0.999


def test_knn_lists_have_no_self_edges_and_are_exact(corpus):
    mat = corpus[:300]
    lists = tg.knn_lists(mat, 8, batch=128, device="cpu")    # three blocks
    bf = torch.from_numpy(mat).to(torch.bfloat16).float().numpy()
    sims = bf @ bf.T
    np.fill_diagonal(sims, -np.inf)
    want = np.argsort(-sims, axis=1, kind="stable")[:, :8]
    assert not (lists == np.arange(300)[:, None]).any()
    _assert_near_tie_slots(mat, lists, want)


@pytest.mark.parametrize("degree,seed", [(8, 0), (16, 3)])
def test_nn_descent_matches_reference(corpus, degree, seed):
    # the same seed draws the same numbers in the same order: one draw out
    # of order and the graphs diverge
    got = tg.nn_descent_graph(corpus[:512], degree, rounds=4, batch=200, seed=seed,
                              device="cpu")
    want = jg.nn_descent_graph(corpus[:512], degree, rounds=4, batch=200, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert not (got == np.arange(512)[:, None]).any()


def test_nn_descent_from_a_device_matrix(corpus):
    mat_dev = torch.from_numpy(corpus[:512]).to(torch.bfloat16)
    got = tg.nn_descent_graph(mat_dev, 8, rounds=2, mat_dev=mat_dev, device="cpu")
    np.testing.assert_array_equal(got, jg.nn_descent_graph(corpus[:512], 8, rounds=2))


def test_nn_descent_tiny_corpus_takes_the_exact_build(corpus):
    np.testing.assert_array_equal(tg.nn_descent_graph(corpus[:9], 8, device="cpu"),
                                  jg.nn_descent_graph(corpus[:9], 8))


def test_rowdot_is_exact_sum_of_products_in_any_batch():
    rng = np.random.default_rng(11)
    for d in (1, 3, 32, 33, 768):
        v = torch.from_numpy(rng.normal(size=(5, 7, d)).astype(np.float32)).to(torch.bfloat16)
        q = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32)).to(torch.bfloat16)
        got = tg.rowdot(v, q)
        want = (v.double() * q.double()[:, None, :]).sum(-1)
        assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5)
        for i in range(5):
            assert torch.equal(tg.rowdot(v[i:i + 1], q[i:i + 1])[0], got[i])


def test_search_matches_reference_bf16(built, corpus):
    port, ref = built
    q = _queries(corpus, 1, 20)
    for kw in ({"beam": 64}, {}, {"beam": 128, "iters": 16}):
        tv, tr = port.search(q, 10, **kw)
        jv, jr = ref.search(q, 10, **kw)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


def test_search_matches_reference_f32_matrix(built, corpus):
    import jax.numpy as jnp

    port, ref = built
    q = _queries(corpus, 2, 12)
    starts = np.linspace(0, len(corpus) - 1, 96).astype(np.int32)
    tv, tr = tg.graph_search(torch.from_numpy(port._host), port.graph, port.mask,
                             torch.from_numpy(q), torch.from_numpy(starts), 10, 12, 12)
    jv, jr = jg._graph_search_batch(jnp.asarray(ref._host), ref.graph, ref.mask,
                                    jnp.asarray(q), jnp.asarray(starts), 10, 12, expand=12)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_batched_search_equals_solo_bit_for_bit(built, corpus, monkeypatch):
    port, _ = built
    q = _queries(corpus, 3, 9)
    bv, br = port.search(q, 10)
    for i in range(len(q)):
        sv, sr = port.search(q[i], 10)
        np.testing.assert_array_equal(sr[0], br[i])
        np.testing.assert_array_equal(sv[0], bv[i])
    # a batch cut into chunks by the temporaries' budget: the same answers
    monkeypatch.setattr(tg, "SEARCH_BUDGET_BYTES", 1)
    cv, cr = port.search(q, 10)
    np.testing.assert_array_equal(cr, br)
    np.testing.assert_array_equal(cv, bv)


def test_remove_masks_rows_like_the_reference(corpus):
    ids = [f"c{i}" for i in range(600)]
    ts, js = _stamps(600)
    nbrs = jg.build_knn_graph(corpus[:600], 16)
    port = GraphIndex(ids, corpus[:600], nbrs, ts, device="cpu")
    ref = jg.GraphIndex(ids, corpus[:600], nbrs, js)
    doomed = {"c5", "c42", "c599", "absent"}
    assert port.remove(doomed) == ref.remove(doomed) == 3
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    q = np.stack([corpus[5], corpus[42], corpus[100]])
    tv, tr = port.search(q, 10, beam=64)
    jv, jr = ref.search(q, 10, beam=64)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    assert 5 not in tr[0][tv[0] > -1e30] and 42 not in tr[1][tv[1] > -1e30]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_graph_npz_loads_across_packages(built, corpus, tmp_path, writer):
    port, ref = built
    path = tmp_path / "graph.npz"
    (port if writer == "port" else ref).save(path)
    tp = GraphIndex.load(path, device="cpu")
    jp = jg.GraphIndex.load(path)
    assert tp.ids == jp.ids == port.ids and tp.stamp.to_json() == jp.stamp.to_json()
    np.testing.assert_array_equal(tp._neighbors, jp._neighbors)
    np.testing.assert_array_equal(tp._host, np.asarray(jp._host))
    q = _queries(corpus, 4, 5)
    tv, tr = tp.search(q, 5, beam=32)
    jv, jr = jp.search(q, 5, beam=32)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


def test_graph_load_refuses_a_bad_checksum(built, tmp_path):
    from cqs_tpu_torch.index import StampMismatch

    port, _ = built
    path = tmp_path / "graph.npz"
    port.save(path)
    with np.load(path) as z:
        parts = dict(z)
    parts["neighbors"] = parts["neighbors"][::-1].copy()
    np.savez_compressed(path, **parts)
    with pytest.raises(StampMismatch, match="checksum"):
        GraphIndex.load(path, device="cpu")


# -- the tiered index ---------------------------------------------------------

def _tier_pair(n: int, d: int = 64, rebuild_frac: float = 10.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(n, d)).astype(np.float32)
    ids = [f"c{i}" for i in range(n)]
    ts, js = _stamps(n, d, "dense")
    return (rng, mat, TieredIndex.build(ids, mat, ts, rebuild_frac=rebuild_frac, device="cpu"),
            JTiered.build(ids, mat, js, rebuild_frac=rebuild_frac))


def _assert_same_tier_search(port, ref, q, k):
    tv, tids = port.search(q, k)
    jv, jids = ref.search(q, k)
    assert tids == jids
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    return tids


def test_tiered_insert_is_found_before_any_rebuild():
    rng, mat, port, ref = _tier_pair(600)
    extra = rng.normal(size=(5, 64)).astype(np.float32)
    new = [f"new{i}" for i in range(5)]
    assert port.insert(new, extra) is ref.insert(new, extra) is False
    assert port.delta_count == ref.delta_count == 5 and port.count == ref.count == 605
    got = _assert_same_tier_search(port, ref, extra[2], 3)
    assert got[0][0] == "new2"
    _assert_same_tier_search(port, ref, np.concatenate([extra, mat[:4]]), 12)


def test_tiered_threshold_rebuild_folds_the_delta():
    rng, mat, port, ref = _tier_pair(64, rebuild_frac=0.1)
    extra = rng.normal(size=(1100, 64)).astype(np.float32)
    new = [f"new{i}" for i in range(1100)]
    # below max(1024, 6) the delta keeps growing; the insert that reaches
    # it folds everything into a new graph
    assert port.insert(new[:1000], extra[:1000]) is ref.insert(new[:1000], extra[:1000]) is False
    assert port.insert(new[1000:], extra[1000:]) is ref.insert(new[1000:], extra[1000:]) is True
    assert port.delta_count == ref.delta_count == 0
    assert port.base.count == ref.base.count == 64 + 1100 and port.base.ids == ref.base.ids
    np.testing.assert_array_equal(port.base._neighbors, ref.base._neighbors)
    assert _assert_same_tier_search(port, ref, extra[7], 3)[0][0] == "new7"


def test_tiered_tombstones_in_both_tiers():
    rng, mat, port, ref = _tier_pair(128)
    extra = rng.normal(size=(3, 64)).astype(np.float32)
    port.insert(["d0", "d1", "d2"], extra)
    ref.insert(["d0", "d1", "d2"], extra)
    assert port.remove({"c5", "d1", "nope"}) == ref.remove({"c5", "d1", "nope"}) == 2
    # the delta's count keeps its tombstoned slot until a rebuild, as in the reference
    assert port.count == ref.count == 130
    assert "c5" not in _assert_same_tier_search(port, ref, mat[5], 5)[0]
    assert "d1" not in _assert_same_tier_search(port, ref, extra[1], 5)[0]
    # a rebuild reclaims both tombstones
    port._rebuild()
    ref._rebuild()
    assert port.base.ids == ref.base.ids and "c5" not in port.base.ids
    assert "d1" not in port.base.ids and port.delta_count == 0
    _assert_same_tier_search(port, ref, np.stack([mat[6], extra[0]]), 4)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tiered_files_load_across_packages(tmp_path, writer):
    rng, mat, port, ref = _tier_pair(96)
    extra = rng.normal(size=(4, 64)).astype(np.float32)
    new = [f"d{i}" for i in range(4)]
    port.insert(new, extra)
    ref.insert(new, extra)
    (port if writer == "port" else ref).save(tmp_path / "tiered.npz")
    assert (tmp_path / "tiered.base.npz").is_file() and (tmp_path / "tiered.delta.npz").is_file()
    tp = TieredIndex.load(tmp_path / "tiered.npz", device="cpu")
    jp = JTiered.load(tmp_path / "tiered.npz")
    assert tp.count == jp.count == port.count
    assert _assert_same_tier_search(tp, jp, extra[0], 2)[0][0] == "d0"
    _assert_same_tier_search(tp, jp, mat[:3], 6)
