"""Index and model port against the JAX package on the CPU: padded device
arrays, npz round trips both ways, append/remove, the numpy Threefry table,
embeddings and splade-hash terms.

Tolerances: device arrays and terms bit-equal; the hash table and
embeddings within 1e-6 (XLA's erfinv/log1p are not reproduced bit for bit;
the bit-equal share is reported)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cqs_tpu.index.dense import DenseIndex as JDense
from cqs_tpu.index.sparse import SpladeIndex as JSplade
from cqs_tpu.index.stamp import Stamp, StampMismatch
from cqs_tpu.models.embedder import Embedder as JEmbedder
from cqs_tpu.models.splade import SpladeEncoder as JSplade_enc
from cqs_tpu_torch.index import DenseIndex, SpladeIndex
from cqs_tpu_torch.models import Embedder, SpladeEncoder
from cqs_tpu_torch.models.convert import embedder_params_from_jax
from cqs_tpu_torch.models.hash_table import normal_table, random_bits

torch.set_num_threads(1)
V, T = 32768, 32


def _dense_data(rng, n, d=64):
    ids = [f"src/f{i % 7}.py:{i}:h{i}" for i in range(n)]
    return ids, rng.normal(size=(n, d)).astype(np.float32)


def _sparse_data(rng, n):
    ids = rng.integers(4, V, size=(n, T)).astype(np.int32)
    w = np.log1p(rng.integers(1, 5, size=(n, T))).astype(np.float32)
    w[:, T - 4:] = 0.0
    return ids, w


def _stamp(n, kind="dense", dim=64):
    return Stamp(model_fingerprint="fp", dim=dim, chunk_count=n, generation=1, kind=kind)


def _bf16_bits(x):
    return np.asarray(x.view(torch.int16)) if isinstance(x, torch.Tensor) \
        else np.asarray(x).view(np.int16)


def _assert_dense_equal(port, ref):
    np.testing.assert_array_equal(_bf16_bits(port.matrix), _bf16_bits(ref.matrix))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    assert port.ids == ref.ids and port.ids_digest == ref.ids_digest


def _assert_sparse_equal(port, ref):
    np.testing.assert_array_equal(port.doc_ids.numpy(), np.asarray(ref.doc_ids))
    np.testing.assert_array_equal(port.doc_w.numpy(), np.asarray(ref.doc_w))
    np.testing.assert_array_equal(_bf16_bits(port.sketch), _bf16_bits(ref.sketch))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.packed_terms().numpy(), np.asarray(ref.packed_terms()))


@pytest.mark.parametrize("n", [0, 37, 2048, 2100])
def test_dense_padded_arrays_equal(seeded_rng, n):
    ids, mat = _dense_data(seeded_rng, n)
    port = DenseIndex(ids, mat, _stamp(n), device="cpu")
    ref = JDense(ids, mat, _stamp(n))
    assert port.capacity == ref.capacity
    _assert_dense_equal(port, ref)


@pytest.mark.parametrize("n", [37, 2100])
def test_sparse_padded_arrays_equal(seeded_rng, n):
    ids = [f"c{i}" for i in range(n)]
    t_ids, t_w = _sparse_data(seeded_rng, n)
    port = SpladeIndex(ids, t_ids, t_w, V, _stamp(n, "splade", V), device="cpu")
    ref = JSplade(ids, t_ids, t_w, V, _stamp(n, "splade", V))
    _assert_sparse_equal(port, ref)


def test_npz_round_trip_both_ways(seeded_rng, tmp_path):
    n = 300
    ids, mat = _dense_data(seeded_rng, n)
    t_ids, t_w = _sparse_data(seeded_rng, n)
    JDense(ids, mat, _stamp(n)).save(tmp_path / "j_dense.npz")
    DenseIndex(ids, mat, _stamp(n), device="cpu").save(tmp_path / "t_dense.npz")
    JSplade(ids, t_ids, t_w, V, _stamp(n, "splade", V)).save(tmp_path / "j_sp.npz")
    SpladeIndex(ids, t_ids, t_w, V, _stamp(n, "splade", V), device="cpu").save(
        tmp_path / "t_sp.npz")
    for name in ("j_dense", "t_dense"):
        port = DenseIndex.load(tmp_path / f"{name}.npz", expect=_stamp(n), device="cpu")
        ref = JDense.load(tmp_path / f"{name}.npz", expect=_stamp(n))
        _assert_dense_equal(port, ref)
    for name in ("j_sp", "t_sp"):
        port = SpladeIndex.load(tmp_path / f"{name}.npz", device="cpu")
        ref = JSplade.load(tmp_path / f"{name}.npz")
        _assert_sparse_equal(port, ref)
    with pytest.raises(StampMismatch):
        DenseIndex.load(tmp_path / "j_dense.npz", expect=_stamp(n + 1), device="cpu")


def test_append_and_remove_match(seeded_rng):
    ids, mat = _dense_data(seeded_rng, 120)
    t_ids, t_w = _sparse_data(seeded_rng, 120)
    pd, rd = (DenseIndex(ids[:100], mat[:100], _stamp(100), device="cpu"),
              JDense(ids[:100], mat[:100], _stamp(100)))
    ps, rs = (SpladeIndex(ids[:100], t_ids[:100], t_w[:100], V, _stamp(100), device="cpu"),
              JSplade(ids[:100], t_ids[:100], t_w[:100], V, _stamp(100)))
    before = pd.matrix
    for idx in (pd, rd):
        idx.append(ids[100:], mat[100:])
        assert idx.remove({ids[3], ids[110]}) == 2
    for idx in (ps, rs):
        idx.append(ids[100:], t_ids[100:], t_w[100:])
        assert idx.remove({ids[3], ids[110]}) == 2
    assert pd.matrix is not before            # rebind, not an in-place write
    _assert_dense_equal(pd, rd)
    _assert_sparse_equal(ps, rs)
    q = mat[5:7]
    pv, pr = pd.search(q, 10)
    jv, jr = rd.search(q, 10, use_pallas=False)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_allclose(pv, jv, rtol=1e-5)


def test_hash_table_matches_jax_random_normal(record_property):
    # the full-size table the hash tier uses
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (V, 256), dtype=jnp.float32))
    port = normal_table(0, V, 256)
    diff = np.abs(port - ref)
    equal = float((port == ref).mean())
    record_property("bit_equal_share", equal)
    record_property("max_abs_diff", float(diff.max()))
    print(f"hash table: {equal:.4%} bit-equal, max |diff| {diff.max():.3g}")
    assert diff.max() <= 1e-6 and equal > 0.95


@pytest.mark.parametrize("seed", [1, 12345, 2**31 - 1])
def test_threefry_bits_exact(seed):
    n = 4096
    ref = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (n,), dtype=jnp.uint32))
    np.testing.assert_array_equal(random_bits(seed, n), ref)


def test_embeddings_through_jax_params():
    texts = ["def validate_token(token): return check(token)",
             "retry with exponential backoff", "", "x" * 3000,
             "class SessionStore: stores active sessions " * 40]
    jemb = JEmbedder("hash")
    ref = jemb.embed_documents(texts)
    port = Embedder("hash", device="cpu")
    port.load_params(embedder_params_from_jax({"table": np.asarray(jemb._params["table"])}))
    np.testing.assert_allclose(port.embed_documents(texts), ref, atol=1e-6)
    np.testing.assert_allclose(port.embed_query("token check"), jemb.embed_query("token check"),
                               atol=1e-6)
    own = Embedder("hash", device="cpu")            # numpy Threefry table
    np.testing.assert_allclose(own.embed_documents(texts), ref, atol=1e-6)
    assert own.fingerprint == jemb.fingerprint and own.dim == jemb.dim == 256
    assert own.split_into_windows(texts[4]) == jemb.split_into_windows(texts[4])


def test_neural_families_not_ported():
    with pytest.raises(NotImplementedError, match="Neural model families"):
        Embedder("bge-large-ft", device="cpu")
    with pytest.raises(NotImplementedError):
        SpladeEncoder("splade-distil")


def test_splade_hash_terms_identical():
    texts = ["validate the bearer token against the signing key",
             "fn retry_with_backoff(max_attempts: u32) retry retry", "", "a b c " * 200]
    port, ref = SpladeEncoder("splade-hash"), JSplade_enc("splade-hash")
    for is_query in (False, True):
        for a, b in zip(port.encode_batch(texts, is_query), ref.encode_batch(texts, is_query)):
            np.testing.assert_array_equal(a, b)
    assert port.fingerprint == ref.fingerprint and port.vocab_size == ref.vocab_size
    np.testing.assert_array_equal(port.encode("token", is_query=True)[0],
                                  ref.encode("token", is_query=True)[0])
