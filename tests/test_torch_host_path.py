"""The host mirror of the hybrid program (CPU serving) in the port, on the CPU.

(a) ``hybrid_query_host``, ``dense_query_host`` and ``sparse_scores_csr``
    against the reference's on the same inputs, with both packages' native
    ``hostscan`` libraries (``native=True``) and with both on their numpy
    fallbacks (``native=False``): rows equal, values to rtol 1e-6.
(b) The mirror against the port's own device program (``hybrid_query_batch``
    and ``dense_query`` on CPU tensors), to the reference's pins
    (``tests/test_host_path.py``): in sketch mode the top-10 rows and the
    valid row set equal, values within rtol 2e-4 / atol 1e-5; in csr mode
    the sparse leg is the exact dot (rtol 1e-4 / atol 1e-5) and the best
    exact-sparse row is a candidate; the q8 dense head equals the full scan
    (rtol 1e-5); no masked row surfaces.
(c) The routes: a CPU engine and the CPU batcher serve through the mirror
    (the device programs are poisoned), ``host_sparse_csr`` switches its
    sparse leg between the CSR postings and the sketch views, and the index
    host views are dropped when the tensors are rebound.
(d) A CPU engine of each package on the fixture project, at
    ``host_sparse_csr`` 1 and 0: the same hits, scores within 1e-5."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import cqs_tpu.native as j_native
import cqs_tpu.search.program as jprog
import cqs_tpu_torch.native as t_native
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.main import main
from cqs_tpu_torch.daemon import batcher as tbatcher
from cqs_tpu_torch.daemon.batcher import QueryBatcher
from cqs_tpu_torch.index import DenseIndex, SpladeIndex, Stamp
from cqs_tpu_torch.ops.sparse import build_doc_sketch
from cqs_tpu_torch.search import engine as tengine
from cqs_tpu_torch.search import program as tprog
from test_torch_slice import same_tokenizer_path  # noqa: F401  (autouse fixture)
from test_torch_standalone import reference_library

torch.set_num_threads(1)
V = 997
PIN_RTOL, PIN_ATOL = 2e-4, 1e-5     # the reference's mirror-vs-device pins
CSR_RTOL, CSR_ATOL = 1e-4, 1e-5     # exact sparse leg in csr mode
PORT_RTOL = 1e-6                    # port mirror against reference mirror
QUERIES = ["validate token", "retry with exponential backoff", "session store",
           "decode jwt", "check expiry timestamp", "authentication helpers"]


def _mk(N=256, D=64, T=8, S=128, B=4, Qt=6, seed=0):
    """The reference's fixture (``tests/test_host_path.py::_mk``)."""
    rng = np.random.default_rng(seed)
    mat = rng.normal(size=(N, D)).astype(np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    doc_ids = rng.integers(0, V, size=(N, T)).astype(np.int32)
    doc_w = rng.random((N, T)).astype(np.float32)
    sketch = build_doc_sketch(doc_ids, doc_w, S)
    mask = np.ones(N, np.int32)
    mask[-7:] = 0                      # tombstoned tail rows
    q = rng.normal(size=(B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q_ids = rng.integers(0, V, size=(B, Qt)).astype(np.int32)
    q_w = rng.random((B, Qt)).astype(np.float32)
    alphas = np.asarray([0.7, 0.0, 0.95, 0.4], np.float32)[:B]
    return mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas


def _csr_of(doc_ids, doc_w, vocab_size):
    """The CSR build of ``SpladeIndex.host_csr`` (unpadded rows)."""
    n, t = doc_ids.shape
    ids, w = doc_ids.ravel(), doc_w.ravel()
    nz = w > 0.0
    ids, w = ids[nz], w[nz]
    rows = np.repeat(np.arange(n, dtype=np.int32), t)[nz]
    order = np.argsort(ids, kind="stable")
    indptr = np.zeros(vocab_size + 1, np.int64)
    np.cumsum(np.bincount(ids, minlength=vocab_size), out=indptr[1:])
    return indptr, rows[order], w[order].astype(np.float32)


def _dense_docs(doc_ids, doc_w):
    out = np.zeros((doc_ids.shape[0], V), np.float32)
    np.add.at(out, (np.arange(doc_ids.shape[0])[:, None], doc_ids), doc_w)
    return out


def _bf16_bits(mat):
    return torch.from_numpy(mat).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def native(request, monkeypatch):
    """Both packages on their native hostscan libraries, or both on their
    numpy fallbacks (``CQST_DISABLE_NATIVE``)."""
    if not request.param:
        monkeypatch.setenv("CQST_DISABLE_NATIVE", "1")
        assert t_native.get_hostscan() is None and j_native.get_hostscan() is None
        return False
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain to build the hostscan libraries")
    assert t_native.get_hostscan() is not None
    ref = reference_library(monkeypatch, j_native.get_hostscan, "_htried", "_hlib",
                            lambda: j_native._HLIB.is_file() and j_native._HSTAMP.is_file()
                            and j_native._HSTAMP.read_text().strip() == j_native._hsrc_hash())
    assert ref is not None
    return True


def _assert_same(port, ref):
    for a, b in zip(port, ref):
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=PORT_RTOL, atol=0)


# -- (a) the port's mirror against the reference's ------------------------------

MODES = {
    "sketch": dict(sketch_candidates=True),
    "no-sketch-candidates": dict(sketch_candidates=False),
    "csr": dict(csr=True),
    "csr-no-sketch-candidates": dict(csr=True, sketch_candidates=False),
    "q8": dict(q8=True),
    "q8-csr": dict(q8=True, csr=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mirror_matches_reference(native, mode):
    mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas = _mk()
    kw = dict(MODES[mode])
    mat_r = tprog.bf16_round(mat)
    extra = {"mat_bf16": _bf16_bits(mat)}
    if kw.pop("csr", False):
        extra["csr"] = _csr_of(doc_ids, doc_w, V)
    if kw.pop("q8", False):
        extra["mat_i8"] = np.clip(np.round(mat_r * 127.0), -127, 127).astype(np.int8)
    args = (mat_r, doc_ids, doc_w, tprog.bf16_round(sketch), mask, tprog.bf16_round(q),
            q_ids, q_w, alphas, 32, V)
    port = tprog.hybrid_query_host(*args, **kw, **extra)
    ref = jprog.hybrid_query_host(*args, **kw, **extra)
    _assert_same(port, ref)
    assert (port[0] > -1e30).any()


def test_bf16_round_matches_reference():
    x = np.random.default_rng(3).normal(size=4096).astype(np.float32) * 100
    x[:4] = [0.0, -0.0, 1.00390625, 1.01171875]      # ties to even
    np.testing.assert_array_equal(tprog.bf16_round(x), jprog.bf16_round(x))


def test_np_topk_rows_ties_to_the_lower_row():
    s = np.asarray([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5]], np.float32)
    for k in (1, 3, 4, 6, 9):
        got = tprog._np_topk_rows(s, k)
        np.testing.assert_array_equal(got, jprog._np_topk_rows(s, k))
    np.testing.assert_array_equal(tprog._np_topk_rows(s, 3)[0], [1, 2, 4])


def test_dense_query_host_matches_reference():
    mat, _, _, _, mask, q, _, _, _ = _mk()
    mat_r = tprog.bf16_round(mat)
    for b in range(q.shape[0]):
        port = tprog.dense_query_host(mat_r, mask, q[b], 16)
        ref = jprog.dense_query_host(mat_r, mask, q[b], 16)
        _assert_same(port, ref)


def test_sparse_scores_csr_exact_and_matches_reference(native):
    _, doc_ids, doc_w, _, _, _, q_ids, q_w, _ = _mk()
    csr = _csr_of(doc_ids, doc_w, V)
    dense_docs = _dense_docs(doc_ids, doc_w)
    for b in range(q_ids.shape[0]):
        qv = np.zeros(V, np.float32)
        np.add.at(qv, q_ids[b], q_w[b])
        got = tprog.sparse_scores_csr(*csr, q_ids[b], q_w[b], doc_ids.shape[0])
        np.testing.assert_array_equal(
            got, jprog.sparse_scores_csr(*csr, q_ids[b], q_w[b], doc_ids.shape[0]))
        np.testing.assert_allclose(got, dense_docs @ qv, rtol=1e-5, atol=1e-6)
        lib = t_native.csr_accumulate(*csr, q_ids[b], q_w[b], doc_ids.shape[0])
        if native:      # the native walk is bit-identical to the numpy one
            np.testing.assert_array_equal(lib, got)
        else:
            assert lib is None


def test_native_scans_match_numpy(native):
    mat, _, _, _, mask, q, _, _, _ = _mk()
    mat_r, q_r = tprog.bf16_round(mat), tprog.bf16_round(q)
    valid = mask.astype(np.uint8)
    got = t_native.bf16_matmul_masked(_bf16_bits(mat), q_r, valid, tprog.NEG)
    m8 = np.clip(np.round(mat_r * 127.0), -127, 127).astype(np.int8)
    q8 = np.clip(np.round(q_r * 127.0), -127, 127).astype(np.int8)
    got8 = t_native.i8_matmul_masked(m8, q8, valid, tprog.NEG)
    if not native:
        assert got is None and got8 is None
        return
    want = q_r @ mat_r.T
    want[:, mask == 0] = tprog.NEG
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want8 = q8.astype(np.float32) @ m8.astype(np.float32).T
    want8[:, mask == 0] = tprog.NEG
    np.testing.assert_array_equal(got8, want8)


def test_hostscan_builds_into_the_port_build_dir():
    if shutil.which("g++") is None:
        assert t_native.get_hostscan() is None
        return
    assert t_native.get_hostscan() is not None
    assert t_native._HLIB.parent == Path(t_native.__file__).parent.parent / "_build" / "native"
    stamp = t_native._HSTAMP.read_text().strip()
    assert stamp == t_native._hkey() and stamp.startswith(t_native._file_hash(t_native._HSRC))


# -- (b) the mirror against the port's device program ---------------------------

def _device(mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas, pool=32,
            sketch_candidates=True):
    out = tprog.hybrid_query_batch(
        torch.from_numpy(mat).to(torch.bfloat16), torch.from_numpy(doc_ids),
        torch.from_numpy(doc_w), torch.from_numpy(sketch).to(torch.bfloat16),
        torch.from_numpy(mask), torch.from_numpy(q), torch.from_numpy(q_ids),
        torch.from_numpy(q_w), torch.from_numpy(alphas), pool, V,
        sketch_candidates=sketch_candidates)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("sketch_candidates", [True, False])
def test_mirror_matches_device_program(native, sketch_candidates):
    mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas = _mk()
    df, dr, dd, ds = _device(mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas,
                             sketch_candidates=sketch_candidates)
    hf, hr, hd, hs = tprog.hybrid_query_host(
        tprog.bf16_round(mat), doc_ids, doc_w, tprog.bf16_round(sketch), mask,
        tprog.bf16_round(q), q_ids, q_w, alphas, 32, V,
        sketch_candidates=sketch_candidates, mat_bf16=_bf16_bits(mat))
    for b in range(df.shape[0]):
        dv, hv = df[b] > -1e30, hf[b] > -1e30
        assert dv.sum() == hv.sum()
        n = min(10, int(dv.sum()))
        assert list(dr[b][:n]) == list(hr[b][:n]), f"query {b} top rows differ"
        assert set(dr[b][dv].tolist()) == set(hr[b][hv].tolist())
        np.testing.assert_allclose(hf[b][:n], df[b][:n], rtol=PIN_RTOL, atol=PIN_ATOL)
        np.testing.assert_allclose(hd[b][:n], dd[b][:n], rtol=PIN_RTOL, atol=PIN_ATOL)
        sv = (ds[b][:n] > -1e30) & (hs[b][:n] > -1e30)
        assert (ds[b][:n] > -1e30).tolist() == (hs[b][:n] > -1e30).tolist()
        np.testing.assert_allclose(hs[b][:n][sv], ds[b][:n][sv], rtol=PIN_RTOL, atol=PIN_ATOL)


def test_mirror_q8_dense_head_matches_full_scan(native):
    mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas = _mk()
    for b in range(q.shape[0]):     # spikes whose margins dwarf int8 noise
        v = q[b] + 0.1 * np.float32(b + 1)
        mat[20 + b] = v / np.linalg.norm(v)
    mat = tprog.bf16_round(mat / np.linalg.norm(mat, axis=1, keepdims=True))
    mat_i8 = np.clip(np.round(mat * 127.0), -127, 127).astype(np.int8)
    args = (mat, doc_ids, doc_w, tprog.bf16_round(sketch), mask, tprog.bf16_round(q),
            q_ids, q_w, alphas, 32, V)
    base = tprog.hybrid_query_host(*args)
    got = tprog.hybrid_query_host(*args, mat_i8=mat_i8)
    for b in range(q.shape[0]):
        assert list(got[1][b][:5]) == list(base[1][b][:5]), f"query {b}"
        np.testing.assert_allclose(got[0][b][:5], base[0][b][:5], rtol=1e-5)
        np.testing.assert_allclose(got[2][b][:5], base[2][b][:5], rtol=1e-5)


@pytest.mark.parametrize("csr", [False, True])
def test_mirror_respects_mask(native, csr):
    mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas = _mk()
    hf, hr, _, _ = tprog.hybrid_query_host(
        tprog.bf16_round(mat), doc_ids, doc_w, tprog.bf16_round(sketch), mask,
        tprog.bf16_round(q), q_ids, q_w, alphas, 32, V,
        csr=_csr_of(doc_ids, doc_w, V) if csr else None)
    valid = hf > -1e30
    assert valid.any() and np.all(mask[hr[valid]] > 0), "masked row surfaced"


def test_mirror_csr_mode_is_exact(native):
    mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas = _mk()
    alphas = np.full_like(alphas, 0.1)     # sparse-heavy: the best sparse row stays
    hf, hr, hd, hs = tprog.hybrid_query_host(
        tprog.bf16_round(mat), None, None, None, mask, tprog.bf16_round(q), q_ids, q_w,
        alphas, 32, V, csr=_csr_of(doc_ids, doc_w, V))
    dense_docs = _dense_docs(doc_ids, doc_w)
    for b in range(q.shape[0]):
        qv = np.zeros(V, np.float32)
        np.add.at(qv, q_ids[b], q_w[b])
        s_true = dense_docs @ qv
        valid = hf[b] > -1e30
        for r, s in zip(hr[b][valid], hs[b][valid]):
            assert mask[r] > 0
            if s > -1e30:
                np.testing.assert_allclose(s, s_true[r], rtol=CSR_RTOL, atol=CSR_ATOL)
        s_m = np.where((mask > 0) & (s_true > 0), s_true, -np.inf)
        if np.isfinite(s_m.max()):
            assert int(s_m.argmax()) in set(hr[b][valid].tolist())


def test_mirror_csr_without_sketch_candidates(native):
    mat, doc_ids, doc_w, sketch, mask, q, q_ids, q_w, alphas = _mk()
    csr = _csr_of(doc_ids, doc_w, V)
    hf, hr, hd, hs = tprog.hybrid_query_host(
        tprog.bf16_round(mat), None, None, None, mask, tprog.bf16_round(q), q_ids, q_w,
        alphas, 32, V, sketch_candidates=False, csr=csr)
    assert hr.shape == (q.shape[0], 32) and (hf[0] > -1e30).any()
    # dense-only candidates: the same rows as the dense leg's top-32
    d = tprog.bf16_round(q) @ tprog.bf16_round(mat).T
    d[:, mask == 0] = tprog.NEG
    for b in range(q.shape[0]):
        assert set(hr[b].tolist()) == set(tprog._np_topk_rows(d[b:b + 1], 32)[0].tolist())


def test_dense_query_host_matches_device_program():
    mat, _, _, _, mask, q, _, _, _ = _mk()
    vals_d, rows_d = tprog.dense_query(torch.from_numpy(mat).to(torch.bfloat16),
                                       torch.from_numpy(mask), torch.from_numpy(q[0]), 16)
    vals_h, rows_h = tprog.dense_query_host(tprog.bf16_round(mat), mask, q[0], 16)
    assert list(rows_d.numpy()) == list(rows_h)
    np.testing.assert_allclose(vals_h, vals_d.numpy(), rtol=PIN_RTOL, atol=PIN_ATOL)


# -- (c) the routes and the host views ------------------------------------------

#: knobs that select the device programs on a card; the CPU engine must
#: serve through the mirror under each (q8 and sk8 give it the int8 view)
ROUTE_KNOBS = {
    "default": {},
    "q8": {"CQST_SCAN_Q8": "1", "CQST_SCAN_Q8_MIN_ROWS": "1024"},
    "sk8": {"CQST_SCAN_Q8": "2", "CQST_SCAN_Q8_MIN_ROWS": "1024"},
    "screened": {"CQST_SCREEN_ENABLE": "1", "CQST_SCREEN_MIN_ROWS": "1024"},
}
DEVICE_PROGRAMS = ("hybrid_query", "dense_query", "hybrid_query_batch_q8",
                   "hybrid_query_batch_sk8", "hybrid_query_screened")


def _hits(res):
    return [(h.row.id, h.score) for h in res.hits]


def _spy_mirror(monkeypatch, calls: list):
    """Poison the device programs in the engine and the batcher and record
    each host-mirror call's route (csr or sketch views, the int8 view)."""
    for mod, names in ((tengine, DEVICE_PROGRAMS), (tbatcher, ("hybrid_query_batch",))):
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(
                f"{_n} ran on a CPU engine"))
    for mod in (tengine, tbatcher):
        real = mod.hybrid_query_host

        def spy(*a, _real=real, **kw):
            calls.append({"csr": kw["csr"] is not None, "sketch": kw["sketch"] is not None,
                          "i8": kw["mat_i8"] is not None, "b": kw["q_dense"].shape[0]})
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "hybrid_query_host", spy)
    real_dense = tengine.dense_query_host

    def dense_spy(*a, **kw):
        calls.append({"dense": True})
        return real_dense(*a, **kw)

    monkeypatch.setattr(tengine, "dense_query_host", dense_spy)


@pytest.mark.parametrize("route", list(ROUTE_KNOBS))
@pytest.mark.parametrize("csr", ["1", "0"])
def test_cpu_engine_and_batcher_serve_through_the_mirror(tmp_project, monkeypatch, route,
                                                          csr):
    for k, v in {**ROUTE_KNOBS[route], "CQST_HOST_SPARSE_CSR": csr}.items():
        monkeypatch.setenv(k, v)
    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    calls: list = []
    _spy_mirror(monkeypatch, calls)
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        assert ctx.engine.host_mirror
        solo = {q: _hits(ctx.engine.search(q)) for q in QUERIES}
        assert all(solo.values())
        hybrid = [c for c in calls if "csr" in c]
        assert len(hybrid) >= len(QUERIES) - 1, calls
        assert all(c["csr"] == (csr == "1") and c["sketch"] == (csr == "0") for c in hybrid)
        assert all(c["i8"] == (route in ("q8", "sk8")) for c in hybrid)
        assert ctx.engine.search("check the expiry", alpha_override=1.0).hits
        assert calls[-1] == {"dense": True}
        calls.clear()
        ctx2 = CommandContext.create(str(tmp_project), device="cpu")
        batcher = QueryBatcher(ctx2.engine)
        try:
            batcher.pause()
            futs = [batcher.submit(q) for q in QUERIES]
            batcher.resume()
            results = [f.result(timeout=60) for f in futs]
        finally:
            batcher.stop()
            ctx2.close()
        assert batcher.stats["fused"] == len(QUERIES)
        # one mirror call a group (each group's queries share their index)
        assert sum(c["b"] for c in calls if "b" in c) == len(QUERIES)
        assert len([c for c in calls if "b" in c]) == batcher.stats["batches"]
        for q, res in zip(QUERIES, results):
            got = _hits(res)
            assert [i for i, _ in got] == [i for i, _ in solo[q]], q
            assert np.allclose([s for _, s in got], [s for _, s in solo[q]], rtol=0, atol=1e-5)
    finally:
        ctx.close()


def test_engine_without_the_mirror_runs_the_device_program(tmp_project, monkeypatch):
    # host_mirror off: a CPU engine runs the device program (its plain scans)
    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    monkeypatch.setattr(tengine, "hybrid_query_host",
                        lambda *a, **k: pytest.fail("the mirror ran"))
    monkeypatch.setattr(tengine, "dense_query_host",
                        lambda *a, **k: pytest.fail("the mirror ran"))
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    try:
        ctx.engine.host_mirror = False
        assert all(ctx.engine.search(q).hits for q in QUERIES)
    finally:
        ctx.close()


def _stamp(n, kind="dense"):
    return Stamp(model_fingerprint="test", dim=16, chunk_count=n, generation=0, kind=kind)


def test_dense_host_views_dropped_on_append_and_remove():
    rng = np.random.default_rng(7)
    idx = DenseIndex([f"c{i}" for i in range(5)], rng.normal(size=(5, 16)).astype(np.float32),
                     _stamp(5), device="cpu", pad_multiple=8)
    m0, mask0 = idx.host_view()
    assert idx.host_view()[0] is m0 and idx.host_bf16() is idx.host_bf16()
    i8 = idx.host_i8()
    assert idx.host_i8() is i8
    new = rng.normal(size=(2, 16)).astype(np.float32)
    idx.append(["x0", "x1"], new)
    m1, mask1 = idx.host_view()
    assert m1 is not m0 and mask1[:7].tolist() == [1] * 7
    np.testing.assert_array_equal(m1, idx.matrix.float().numpy())
    np.testing.assert_array_equal(idx.host_bf16(), _bf16_bits(idx.matrix.float().numpy()))
    np.testing.assert_array_equal(idx.host_i8(), np.clip(np.round(m1 * 127.0), -127, 127))
    assert idx.host_i8() is not i8
    idx.remove({"c1"})
    m2, mask2 = idx.host_view()
    assert mask2[1] == 0 and mask2[:7].sum() == 6
    np.testing.assert_array_equal(m2, m1)


def test_sparse_host_views_dropped_on_append():
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 64, size=(4, 4)).astype(np.int32)
    w = rng.random((4, 4)).astype(np.float32)
    idx = SpladeIndex([f"c{i}" for i in range(4)], ids, w, 64, _stamp(4, "splade"),
                      device="cpu", pad_multiple=8, sketch_dim=16)
    v0, csr0 = idx.host_view(), idx.host_csr()
    assert idx.host_view()[0] is v0[0] and idx.host_csr()[0] is csr0[0]
    new_ids = rng.integers(1, 64, size=(2, 4)).astype(np.int32)
    new_w = rng.random((2, 4)).astype(np.float32)
    idx.append(["x0", "x1"], new_ids, new_w)
    v1, csr1 = idx.host_view(), idx.host_csr()
    assert v1[0] is not v0[0] and csr1[0] is not csr0[0]
    np.testing.assert_array_equal(v1[0], idx.doc_ids.numpy())
    np.testing.assert_array_equal(v1[2], idx.sketch.float().numpy())
    np.testing.assert_array_equal(csr1[0], _csr_of(idx._host_ids, idx._host_w, 64)[0])
    # the CSR walk scores the appended rows exactly
    got = tprog.sparse_scores_csr(*csr1, new_ids[1], np.ones(4, np.float32), idx.capacity)
    want = _dense_scores(idx, new_ids[1])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _dense_scores(idx, q_ids):
    qv = np.zeros(idx.vocab_size, np.float32)
    np.add.at(qv, q_ids, 1.0)
    return (qv[idx.doc_ids.numpy()] * idx.doc_w.numpy()).sum(axis=1)


# -- (d) engines of both packages through their mirrors --------------------------

@pytest.mark.parametrize("csr", ["1", "0"])
def test_cpu_engines_of_both_packages_agree(tmp_project, monkeypatch, csr):
    from cqs_tpu.cli.context import CommandContext as JContext
    from cqs_tpu.pipeline import run_index_pipeline as j_index
    from cqs_tpu_torch.models.convert import embedder_params_from_jax
    from cqs_tpu_torch.pipeline import run_index_pipeline

    monkeypatch.setenv("CQST_HOST_SPARSE_CSR", csr)
    port_root = tmp_project.parent / f"{tmp_project.name}_port"
    shutil.copytree(tmp_project, port_root)
    jctx = JContext.create(str(tmp_project))
    ctx = CommandContext.create(str(port_root), device="cpu")
    try:
        j_index(jctx.root, jctx.store, jctx.embedder, jctx._maybe_splade(), config=jctx.config)
        jctx.embedder._ensure_model()
        ctx.embedder.load_params(embedder_params_from_jax(
            {"table": np.asarray(jctx.embedder._params["table"])}))
        run_index_pipeline(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(),
                           config=ctx.config)
        for q in QUERIES:
            ref, port = _hits(jctx.engine.search(q)), _hits(ctx.engine.search(q))
            assert port and [i for i, _ in port] == [i for i, _ in ref], q
            assert np.allclose([s for _, s in port], [s for _, s in ref], rtol=0, atol=1e-5)
    finally:
        jctx.close()
        ctx.close()
