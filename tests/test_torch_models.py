"""The port's neural models against the JAX package's, module by module, and
the port's checkpoint loader against the reference's.

Both packages get the same parameters: the reference's Flax tree, drawn by
its own init and then moved off its initial values with a numpy seed (so
RMSNorm's ``1 + w`` and every bias matter), is carried into the port with
``models/convert.py::params_from_flax``. Inputs come from a numpy seed and
hold a padded row.

Tolerances: every model at f32, max |difference| <= 1e-5 (the same f32
operations, summed in another order); Gemma and qwen3 at the reference's
bf16, per-row cosine >= 0.999 and, on the unit-norm embeddings, max
|difference| <= 2e-2 (bf16 rounds at other places in the two frameworks);
attention over slices of the batch against one slice: bit-equal; the
safetensors reader against ``safetensors.numpy``: equal arrays; forwards
after either package's loader: max |difference| <= 1e-5."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cqs_tpu.models import bert as jbert
from cqs_tpu.models import gemma as jgemma
from cqs_tpu.models import hybrid as jhybrid
from cqs_tpu.models import loader as jloader
from cqs_tpu.models.registry import ModelPreset as JPreset
from cqs_tpu_torch.models import bert as tbert
from cqs_tpu_torch.models import gemma as tgemma
from cqs_tpu_torch.models import hybrid as thybrid
from cqs_tpu_torch.models import layers, loader
from cqs_tpu_torch.models.convert import params_from_flax
from cqs_tpu_torch.models.embedder import build_module

torch.set_num_threads(1)
CPU = torch.device("cpu")
VOCAB = 500


def inputs(seed: int, batch: int = 3, length: int = 80, vocab: int = VOCAB):
    """ids and mask [batch, length] int32; row 1 padded from 2/3 of its length."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.int32)
    ids[1, 2 * length // 3:] = 0
    mask[1, 2 * length // 3:] = 0
    return ids, mask


def jax_params(module, seed: int, *args):
    """The Flax module's init, each leaf moved by 0.05 * N(0, 1) (numpy)."""
    params = module.init(jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in args))
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)


def port(factory, params):
    module = build_module(factory, CPU, 0)
    module.load_state_dict(params_from_flax(params))
    return module


def run_port(module, *args):
    with torch.no_grad():
        return module(*(torch.from_numpy(a).long() for a in args)).float().numpy()


def run_jax(module, params, *args):
    return np.asarray(module.apply(params, *(jnp.asarray(a) for a in args)), np.float32)


def row_cosines(a, b):
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


# -- Gemma / qwen3 -------------------------------------------------------------

def gemma_configs(variant: str, dtype: str):
    """The small geometry (4 heads over 2 kv heads) with a sliding and a full
    layer, ``query_pre_attn_scalar`` 24 (not the head dim 16) and a window
    of 64 (33 after halving) under inputs of 80 tokens."""
    kw = dict(layer_types=("sliding_attention", "full_attention"), query_pre_attn_scalar=24.0)
    j = dataclasses.replace(jgemma.GemmaConfig.small_test(vocab_size=VOCAB), **kw,
                            dtype=getattr(jnp, dtype))
    t = dataclasses.replace(tgemma.GemmaConfig.small_test(vocab_size=VOCAB), **kw,
                            dtype=getattr(torch, dtype))
    if variant == "qwen3":
        j = dataclasses.replace(j, pooling="last_token", use_projection=False, causal=True,
                                embed_dim=j.hidden_size, mlp_act="silu", norm_plus_one=False,
                                sandwich_norm=False, scale_embeddings=False)
        t = t.as_qwen3()
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["gemma", "qwen3"])
def test_gemma_encoder_and_embedder(variant, dtype):
    jcfg, tcfg = gemma_configs(variant, dtype)
    ids, mask = inputs(11)
    jmodel = jgemma.GemmaEmbedder(jcfg)
    params = jax_params(jmodel, 3, ids, mask)
    tmodel = port(lambda: tgemma.GemmaEmbedder(tcfg), params)
    ref = run_jax(jmodel, params, ids, mask)
    got = run_port(tmodel, ids, mask)
    hid_ref = run_jax(jgemma.GemmaEncoder(jcfg), {"params": params["params"]["encoder"]}, ids, mask)
    hid = run_port(tmodel.encoder, ids, mask)
    assert got.shape == ref.shape == (3, jcfg.embed_dim)
    if dtype == "float32":
        np.testing.assert_allclose(hid, hid_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        assert row_cosines(hid, hid_ref).min() >= 0.999
        assert row_cosines(got, ref).min() >= 0.999
        assert np.abs(got - ref).max() <= 2e-2


def test_gemma_kv_heads_repeat_in_a_row():
    # jnp.repeat repeats each kv head in a row (q heads 0,1 read kv head 0):
    # the torch twin is repeat_interleave; .repeat would interleave them
    # differently, which the 4-over-2 geometry above would catch
    k = np.arange(2 * 3).reshape(1, 1, 2, 3).astype(np.float32)
    ref = np.asarray(jnp.repeat(jnp.asarray(k), 2, axis=2))
    np.testing.assert_array_equal(torch.from_numpy(k).repeat_interleave(2, dim=2).numpy(), ref)
    assert not np.array_equal(torch.from_numpy(k).repeat(1, 1, 2, 1).numpy(), ref)


def test_gemma_embedding_scale_rounds_first():
    # sqrt(768) is cast to bf16 (27.75) before it multiplies
    t = tgemma.GemmaConfig()
    ref = float(jnp.asarray(768 ** 0.5, dtype=jnp.bfloat16))
    assert float(torch.tensor(t.hidden_size ** 0.5, dtype=t.dtype)) == ref == 27.75
    assert t.effective_window() == jgemma.GemmaConfig().effective_window() == 257


# -- BERT family ----------------------------------------------------------------

BERT_KW = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=128)


def bert_configs():
    return (jbert.BertConfig(**BERT_KW, dtype=jnp.float32),
            tbert.BertConfig(**BERT_KW, dtype=torch.float32))


@pytest.mark.parametrize("pooling", ["cls", "mean", "last_token"])
def test_bert_dense_embedder(pooling):
    jcfg, tcfg = bert_configs()
    ids, mask = inputs(5)
    jmodel = jbert.BertDenseEmbedder(jcfg, pooling=pooling)
    params = jax_params(jmodel, 1, ids, mask)
    got = run_port(port(lambda: tbert.BertDenseEmbedder(tcfg, pooling=pooling), params), ids, mask)
    np.testing.assert_allclose(got, run_jax(jmodel, params, ids, mask), rtol=0, atol=1e-5)


def test_splade_model():
    jcfg, tcfg = bert_configs()
    ids, mask = inputs(6)
    jmodel = jbert.SpladeModel(jcfg)
    params = jax_params(jmodel, 2, ids, mask)
    got = run_port(port(lambda: tbert.SpladeModel(tcfg), params), ids, mask)
    assert got.shape == (3, VOCAB) and (got > 0).any()
    np.testing.assert_allclose(got, run_jax(jmodel, params, ids, mask), rtol=0, atol=1e-5)


def test_cross_encoder():
    jcfg, tcfg = bert_configs()
    ids, mask = inputs(7)
    types = np.zeros_like(ids)
    types[:, 20:] = 1
    jmodel = jbert.CrossEncoder(jcfg)
    params = jax_params(jmodel, 3, ids, mask, types)
    got = run_port(port(lambda: tbert.CrossEncoder(tcfg), params), ids, mask, types)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, run_jax(jmodel, params, ids, mask, types), rtol=0, atol=1e-5)


def test_hybrid_embedder_with_the_jax_table():
    jcfg, tcfg = bert_configs()
    ids, mask = inputs(8)
    jmodel = jhybrid.HybridDenseEmbedder(jhybrid.HybridConfig(bert=jcfg, hash_dim=32))
    params = jax_params(jmodel, 4, ids, mask)
    tmodel = port(lambda: thybrid.HybridDenseEmbedder(thybrid.HybridConfig(bert=tcfg, hash_dim=32)),
                  params)
    jtable = np.array(jhybrid.hash_table(VOCAB, 32, 0))
    # the port's own numpy Threefry table is the JAX one to within 1e-6 ...
    np.testing.assert_allclose(tmodel.table.numpy(), jtable, rtol=0, atol=1e-6)
    tmodel.table.copy_(torch.from_numpy(jtable))        # ... and here it is JAX's
    got = run_port(tmodel, ids, mask)
    assert got.shape == (3, 32 + 64)
    np.testing.assert_allclose(got, run_jax(jmodel, params, ids, mask), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_attention_is_bit_equal(monkeypatch, dtype):
    ids, mask = inputs(9, batch=7, length=96)
    gcfg = dataclasses.replace(tgemma.GemmaConfig.small_test(vocab_size=VOCAB), dtype=dtype)
    bcfg = tbert.BertConfig(**{**BERT_KW, "max_position": 96}, dtype=dtype)
    for model in (build_module(lambda: tgemma.GemmaEmbedder(gcfg).encoder, CPU, 0),
                  build_module(lambda: tbert.BertEncoder(bcfg), CPU, 0)):
        whole = run_port(model, ids, mask)
        for slice_bytes in (1, 3 * 4 * 96 * 96 * 4):       # one row, three rows a slice
            monkeypatch.setattr(layers, "ATTN_SLICE_BYTES", slice_bytes)
            np.testing.assert_array_equal(run_port(model, ids, mask), whole)
        monkeypatch.undo()


# -- the loader -----------------------------------------------------------------

def test_safetensors_reader_matches_the_package(tmp_path):
    import ml_dtypes
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((4,)).astype(np.float16),
              "bf16": rng.standard_normal((2, 3, 4)).astype(ml_dtypes.bfloat16),
              "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
              "i32": np.arange(5, dtype=np.int32), "empty": np.zeros((0, 4), np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = loader.read_safetensors(tmp_path / "a.safetensors")
    ref = load_file(str(tmp_path / "a.safetensors"))
    assert set(got) == set(ref) == set(arrays)
    for name, arr in ref.items():
        t = got[name]
        if name == "bf16":
            np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
            assert t.dtype == torch.bfloat16
        else:
            np.testing.assert_array_equal(t.numpy(), arr)
    # and the port's writer, read back by the package
    loader.write_safetensors(tmp_path / "b.safetensors", got)
    back = load_file(str(tmp_path / "b.safetensors"))
    for name, arr in ref.items():
        np.testing.assert_array_equal(back[name].astype(np.float32) if name == "bf16" else back[name],
                                      arr.astype(np.float32) if name == "bf16" else arr)


def _jpreset(family: str) -> JPreset:
    return JPreset(name="t", family=family, dim=8, max_seq_len=64, pooling="model")


def test_hf_gemma3_checkpoint_loads_alike(tmp_path):
    transformers = pytest.importorskip("transformers")
    from safetensors.numpy import save_file

    cfg = transformers.Gemma3TextConfig(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=128,
        query_pre_attn_scalar=16, sliding_window=16,
        layer_types=["sliding_attention", "full_attention", "sliding_attention"],
        use_bidirectional_attention=True)
    torch.manual_seed(0)
    transformers.Gemma3TextModel(cfg).save_pretrained(tmp_path, safe_serialization=True)
    rng = np.random.default_rng(1)
    for sub, (i, o) in (("2_Dense", (32, 96)), ("3_Dense", (96, 24))):
        (tmp_path / sub).mkdir()
        save_file({"linear.weight": rng.standard_normal((o, i)).astype(np.float32) * 0.1},
                  str(tmp_path / sub / "model.safetensors"))
        (tmp_path / sub / "config.json").write_text(json.dumps({"in_features": i, "out_features": o}))
    jcfg = jgemma.GemmaConfig.from_hf_config(tmp_path, dtype=jnp.float32)
    tcfg = tgemma.GemmaConfig.from_hf_config(tmp_path, dtype=torch.float32)
    assert dataclasses.asdict(tcfg) == {**dataclasses.asdict(jcfg), "dtype": torch.float32}
    ids, mask = inputs(12, length=40)
    jmodel = jgemma.GemmaEmbedder(jcfg)
    jp = jloader.load_safetensors_params(
        tmp_path, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)),
        _jpreset("gemma"))
    tmodel = build_module(lambda: tgemma.GemmaEmbedder(tcfg), CPU, 0)
    tmodel.load_state_dict(loader.load_safetensors_params(tmp_path, tmodel.state_dict(), "gemma"))
    np.testing.assert_allclose(run_port(tmodel, ids, mask), run_jax(jmodel, jp, ids, mask),
                               rtol=0, atol=1e-5)


def test_hf_qwen3_checkpoint_loads_alike(tmp_path):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Qwen3Config(
        vocab_size=VOCAB, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=64)
    torch.manual_seed(2)
    transformers.Qwen3Model(cfg).save_pretrained(tmp_path, safe_serialization=True)
    jcfg = jgemma.GemmaConfig.from_hf_config(tmp_path, dtype=jnp.float32)
    tcfg = tgemma.GemmaConfig.from_hf_config(tmp_path, dtype=torch.float32)
    assert tcfg.causal and not tcfg.sandwich_norm and tcfg.pooling == "last_token"
    ids, mask = inputs(13, length=20)
    jmodel = jgemma.GemmaEmbedder(jcfg)
    jp = jloader.load_safetensors_params(
        tmp_path, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)),
        _jpreset("qwen3"))
    tmodel = build_module(lambda: tgemma.GemmaEmbedder(tcfg), CPU, 0)
    tmodel.load_state_dict(loader.load_safetensors_params(tmp_path, tmodel.state_dict(), "qwen3"))
    np.testing.assert_allclose(run_port(tmodel, ids, mask), run_jax(jmodel, jp, ids, mask),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def bert_mlm_ckpt(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=128)
    torch.manual_seed(1)
    d = tmp_path_factory.mktemp("bert_mlm")
    transformers.BertForMaskedLM(cfg).save_pretrained(d, safe_serialization=True)
    return d


def test_hf_bert_mlm_checkpoint_loads_alike(bert_mlm_ckpt):
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position=128)
    ids, mask = inputs(14, length=40)
    for jmodel, factory in ((jbert.SpladeModel(jbert.BertConfig(**kw, dtype=jnp.float32)),
                             lambda: tbert.SpladeModel(tbert.BertConfig(**kw, dtype=torch.float32))),
                            (jbert.BertDenseEmbedder(jbert.BertConfig(**kw, dtype=jnp.float32)),
                             lambda: tbert.BertDenseEmbedder(tbert.BertConfig(**kw, dtype=torch.float32)))):
        jp = jloader.load_safetensors_params(
            bert_mlm_ckpt, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)),
            _jpreset("bert"))
        tmodel = build_module(factory, CPU, 0)
        tmodel.load_state_dict(loader.load_safetensors_params(bert_mlm_ckpt, tmodel.state_dict(),
                                                              "bert"))
        np.testing.assert_allclose(run_port(tmodel, ids, mask), run_jax(jmodel, jp, ids, mask),
                                   rtol=0, atol=1e-5)


def test_bert_position_table_keeps_its_leading_rows(bert_mlm_ckpt):
    # the one deliberate difference: a 128-row table into a 64-position
    # module. The reference's reshape raises; the port loads rows 0-63.
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position=64)
    ids = jnp.zeros((1, 8), jnp.int32)
    jmodel = jbert.SpladeModel(jbert.BertConfig(**kw, dtype=jnp.float32))
    with pytest.raises(ValueError):
        jloader.load_safetensors_params(bert_mlm_ckpt, jmodel.init(jax.random.PRNGKey(0), ids, ids),
                                        _jpreset("bert"))
    tmodel = build_module(lambda: tbert.SpladeModel(tbert.BertConfig(**kw, dtype=torch.float32)),
                          CPU, 0)
    tmodel.load_state_dict(loader.load_safetensors_params(bert_mlm_ckpt, tmodel.state_dict(), "bert"))
    full = loader.read_safetensors(bert_mlm_ckpt / "model.safetensors")
    np.testing.assert_array_equal(tmodel.encoder.embeddings.position.weight.detach().numpy(),
                                  full["bert.embeddings.position_embeddings.weight"][:64].numpy())


def test_hf_cross_encoder_checkpoint_loads_alike(tmp_path):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=64, num_labels=1)
    torch.manual_seed(5)
    transformers.BertForSequenceClassification(cfg).save_pretrained(tmp_path, safe_serialization=True)
    kw = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position=64)
    ids, mask = inputs(15, length=48)
    types = np.zeros_like(ids)
    types[:, 24:] = 1
    jmodel = jbert.CrossEncoder(jbert.BertConfig(**kw, dtype=jnp.float32))
    jp = jloader.load_cross_encoder_params(
        tmp_path, jmodel.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in (ids, mask, types))))
    tmodel = build_module(lambda: tbert.CrossEncoder(tbert.BertConfig(**kw, dtype=torch.float32)),
                          CPU, 0)
    tmodel.load_state_dict(loader.load_cross_encoder_params(tmp_path, tmodel.state_dict()))
    np.testing.assert_allclose(run_port(tmodel, ids, mask, types),
                               run_jax(jmodel, jp, ids, mask, types), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["bert", "hybrid", "cross-encoder"])
def test_native_checkpoint_loads_and_matches(tmp_path, kind):
    jcfg, tcfg = bert_configs()
    ids, mask = inputs(16)
    types = np.zeros_like(ids)
    args = (ids, mask, types) if kind == "cross-encoder" else (ids, mask)
    jmodel, factory = {
        "bert": (jbert.BertDenseEmbedder(jcfg, pooling="mean"),
                 lambda: tbert.BertDenseEmbedder(tcfg, pooling="mean")),
        "hybrid": (jhybrid.HybridDenseEmbedder(jhybrid.HybridConfig(bert=jcfg)),
                   lambda: thybrid.HybridDenseEmbedder(thybrid.HybridConfig(bert=tcfg))),
        "cross-encoder": (jbert.CrossEncoder(jcfg), lambda: tbert.CrossEncoder(tcfg)),
    }[kind]
    params = jax_params(jmodel, 6, *args)
    jloader.save_flax_checkpoint(params, tmp_path, {"family": kind})
    tmodel = build_module(factory, CPU, 0)
    tmodel.load_state_dict(loader.load_native_checkpoint(tmp_path, tmodel.state_dict()))
    if kind == "hybrid":
        tmodel.table.copy_(torch.from_numpy(np.array(jhybrid.hash_table(VOCAB, 256, 0))))
    np.testing.assert_allclose(run_port(tmodel, *args), run_jax(jmodel, params, *args),
                               rtol=0, atol=1e-5)
    # a tensor the module needs and the file lacks is an error, as in the reference
    tensors = loader.read_safetensors(tmp_path / "model.safetensors")
    tensors.pop(sorted(tensors)[0])
    loader.write_safetensors(tmp_path / "model.safetensors", tensors)
    with pytest.raises(ValueError, match="missing"):
        loader.load_native_checkpoint(tmp_path, tmodel.state_dict())
    assert loader.load_native_checkpoint(tmp_path / "absent", tmodel.state_dict()) is None
