"""The port's model facades (``Embedder``, ``SpladeEncoder``,
``CrossEncoderReranker``), its CLI context and its engine's rerank against
the JAX package's, from checkpoints on disk.

The facades of ``splade-distil`` and ``minilm-l6`` build their model at the
preset's geometry (BERT-base, MiniLM-L6): here both packages' presets of
those names are narrowed to 2 layers of width 32 (same vocabulary, same
lengths), so a tiny HF checkpoint fits them.

Tolerances: gemma runs at bf16 in both packages, per-row cosine >= 0.999 and
max |difference| <= 2e-2; bert, hybrid and qwen3 facades at f32 (the CPU's
dtype in both), max |difference| <= 1e-5; SPLADE at bf16, weights within
2e-2 and ids equal wherever the weight stands 2e-2 clear of its neighbours
(an id may swap with a near-tie); reranker: the same order; the CLIs end to
end (models at f32 in both packages, see ``f32_models``): the same hit ids,
scores within 1e-4."""

import dataclasses
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cqs_tpu.models import embedder as jembedder
from cqs_tpu.models import registry as jregistry
from cqs_tpu.models.embedder import Embedder as JEmbedder
from cqs_tpu.models.loader import save_flax_checkpoint
from cqs_tpu.models.reranker import CrossEncoderReranker as JReranker
from cqs_tpu.models.splade import SpladeEncoder as JSplade
from cqs_tpu_torch.models import registry as tregistry
from cqs_tpu_torch.models import CrossEncoderReranker, Embedder, SpladeEncoder, WeightlessModelError
from cqs_tpu_torch.models.convert import params_from_flax
from test_torch_slice import same_tokenizer_path  # noqa: F401  (autouse)

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)
TEXTS = ["def validate_token(token): return check_expiry(decode_jwt(token))",
         "retry with exponential backoff", "", "x " * 700,
         "class SessionStore: stores active sessions " * 30]
TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)


def row_cosines(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.fixture
def tiny_presets(monkeypatch):
    """``splade-distil`` and ``minilm-l6`` narrowed in both registries."""
    for reg in (jregistry, tregistry):
        for name in ("splade-distil", "minilm-l6"):
            monkeypatch.setitem(reg._PRESETS, name, dataclasses.replace(reg._PRESETS[name], **TINY))


def write_gemma(d, seed: int = 0):
    """A tiny EmbeddingGemma: Gemma3 text model (width 32, a sliding and a
    full layer, window 16) with the SentenceTransformer head 32 -> 64 -> 768,
    so it embeds at the ``embeddinggemma-300m`` preset's 768."""
    from safetensors.numpy import save_file

    cfg = transformers.Gemma3TextConfig(
        vocab_size=32768, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8, max_position_embeddings=2048,
        query_pre_attn_scalar=16, sliding_window=16,
        layer_types=["sliding_attention", "full_attention"], use_bidirectional_attention=True)
    torch.manual_seed(seed)
    transformers.Gemma3TextModel(cfg).save_pretrained(d, safe_serialization=True)
    rng = np.random.default_rng(seed)
    for sub, (i, o) in (("2_Dense", (32, 64)), ("3_Dense", (64, 768))):
        (d / sub).mkdir()
        save_file({"linear.weight": rng.standard_normal((o, i)).astype(np.float32) * 0.2},
                  str(d / sub / "model.safetensors"))
        (d / sub / "config.json").write_text(json.dumps({"in_features": i, "out_features": o}))
    return d


def write_bert(d, cls, seed: int, **kw):
    cfg = transformers.BertConfig(vocab_size=30522, hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=256, **kw)
    torch.manual_seed(seed)
    cls(cfg).save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    base = tmp_path_factory.mktemp("ckpts")
    (base / "gemma").mkdir()
    return {"gemma": write_gemma(base / "gemma"),
            "splade": write_bert(base / "splade", transformers.BertForMaskedLM, 1),
            "rerank": write_bert(base / "rerank", transformers.BertForSequenceClassification, 2,
                                 num_labels=1)}


def test_embedder_gemma_from_hf_checkpoint(ckpts):
    ref = JEmbedder("embeddinggemma-300m", model_path=ckpts["gemma"])
    port = Embedder("embeddinggemma-300m", model_path=ckpts["gemma"], device="cpu")
    got, want = port.embed_documents(TEXTS), ref.embed_documents(TEXTS)
    assert got.shape == want.shape == (len(TEXTS), 768) and port.dim == ref.dim == 768
    assert row_cosines(got, want).min() >= 0.999 and np.abs(got - want).max() <= 2e-2
    q, qr = port.embed_query("token expiry"), ref.embed_query("token expiry")
    assert row_cosines(q[None], qr[None]).min() >= 0.999 and np.abs(q - qr).max() <= 2e-2
    assert port.fingerprint == ref.fingerprint
    # the idle unload drops the module; the next call reloads the checkpoint
    port.clear_session()
    assert port._model is None
    np.testing.assert_array_equal(port.embed_documents(TEXTS[:2]), got[:2])


@pytest.mark.parametrize("preset,family", [("bge-base", "bert"), ("cqs-hybrid", "hybrid")])
def test_embedder_native_checkpoint(tmp_path, preset, family):
    geometry = dict(vocab_size=32768, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_position=128)
    # a native checkpoint of the reference's module at the tiny geometry
    import jax

    from cqs_tpu.models import bert as jbert
    from cqs_tpu.models import hybrid as jhybrid

    bcfg = jbert.BertConfig(**geometry, dtype=jnp.float32)
    module = (jbert.BertDenseEmbedder(bcfg, pooling="mean") if family == "bert"
              else jhybrid.HybridDenseEmbedder(jhybrid.HybridConfig(bert=bcfg)))
    dummy = jnp.zeros((1, 8), jnp.int32)
    params = module.init(jax.random.PRNGKey(4), dummy, jnp.ones_like(dummy))
    save_flax_checkpoint(params, tmp_path, {"family": family, "pooling": "mean",
                                            "query_prefix": "q: ", "doc_prefix": "d: ",
                                            **geometry})
    ref = JEmbedder(preset, model_path=tmp_path)
    port = Embedder(preset, model_path=tmp_path, device="cpu")
    assert port.dim == ref.dim and port.max_seq_len == ref.max_seq_len == 128
    assert (port.query_prefix, port.doc_prefix) == ("q: ", "d: ")
    np.testing.assert_allclose(port.embed_documents(TEXTS), ref.embed_documents(TEXTS),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.embed_query("session store"), ref.embed_query("session store"),
                               rtol=0, atol=1e-5)


def test_embedder_qwen3_from_hf_checkpoint(tmp_path):
    # the qwen3-embedding-4b preset's output width (2560) with one narrow layer
    cfg = transformers.Qwen3Config(
        vocab_size=32768, hidden_size=2560, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, head_dim=16, max_position_embeddings=4096)
    torch.manual_seed(3)
    transformers.Qwen3Model(cfg).to(torch.bfloat16).save_pretrained(tmp_path, safe_serialization=True)
    ref = JEmbedder("qwen3-embedding-4b", model_path=tmp_path)
    port = Embedder("qwen3-embedding-4b", model_path=tmp_path, device="cpu")
    got, want = port.embed_documents(TEXTS[:3]), ref.embed_documents(TEXTS[:3])
    assert got.shape == want.shape == (3, 2560)
    assert row_cosines(got, want).min() >= 0.999 and np.abs(got - want).max() <= 2e-2


@pytest.mark.parametrize("preset", ["embeddinggemma-300m", "qwen3-embedding-8b"])
def test_weightless_gemma_family(preset):
    ref = JEmbedder(preset, allow_random_weights=True)
    port = Embedder(preset, allow_random_weights=True, device="cpu")
    assert port.dim == ref.dim == 64
    ref._ensure_model()
    port.load_params(params_from_flax(ref._params))
    got, want = port.embed_documents(TEXTS[:3]), ref.embed_documents(TEXTS[:3])
    assert got.shape == want.shape == (3, 64)
    assert row_cosines(got, want).min() >= 0.999 and np.abs(got - want).max() <= 2e-2


def test_weightless_refusals(tmp_path, tiny_presets):
    for make in (lambda: Embedder("embeddinggemma-300m", device="cpu"),
                 lambda: Embedder("bge-base", device="cpu"),
                 lambda: SpladeEncoder("splade-distil", device="cpu"),
                 lambda: CrossEncoderReranker("minilm-l6", device="cpu")):
        with pytest.raises(WeightlessModelError):
            make()
    (tmp_path / "empty").mkdir()
    with pytest.raises(WeightlessModelError, match="no loadable"):
        Embedder("cqs-mini", model_path=tmp_path / "empty", device="cpu").embed_query("x")
    with pytest.raises(jembedder.WeightlessModelError, match="no loadable"):
        JEmbedder("cqs-mini", model_path=tmp_path / "empty").embed_query("x")
    with pytest.raises(WeightlessModelError, match="no loadable"):
        CrossEncoderReranker("minilm-l6", model_path=tmp_path / "empty",
                             device="cpu").rerank("q", ["a", "b"])
    # a neural SPLADE runs a model, so it needs a device
    with pytest.raises(ValueError, match="device"):
        SpladeEncoder("splade-distil", allow_random_weights=True)


def test_splade_encoder_from_hf_checkpoint(ckpts, tiny_presets):
    port = SpladeEncoder("splade-distil", model_path=ckpts["splade"], device="cpu")
    ref = JSplade("splade-distil", model_path=ckpts["splade"])
    assert port.fingerprint == ref.fingerprint and port.vocab_size == ref.vocab_size == 30522
    for is_query in (False, True):
        (ids, w), (rids, rw) = port.encode_batch(TEXTS, is_query), ref.encode_batch(TEXTS, is_query)
        assert ids.shape == rids.shape and (w > 0).sum() > 0
        np.testing.assert_allclose(w, rw, rtol=0, atol=2e-2)
        gap = np.minimum(np.abs(np.diff(rw, axis=1, prepend=np.inf)),
                         np.abs(np.diff(rw, axis=1, append=-np.inf)))
        clear = gap >= 2e-2
        np.testing.assert_array_equal(ids[clear], rids[clear])
    # a query alone and in a batch: the same shapes, the same terms
    alone = port.encode("retry with exponential backoff", is_query=True)
    batched = port.encode_batch(TEXTS, is_query=True)
    np.testing.assert_array_equal(alone[0], batched[0][1])
    np.testing.assert_array_equal(alone[1], batched[1][1])


def test_reranker_from_hf_checkpoint(ckpts, tiny_presets):
    passages = [t or "empty" for t in TEXTS] + ["decode a jwt token", "backoff delay per attempt"]
    port = CrossEncoderReranker("minilm-l6", model_path=ckpts["rerank"], device="cpu")
    ref = JReranker("minilm-l6", model_path=ckpts["rerank"])
    np.testing.assert_allclose(port.score("token expiry", passages),
                               ref.score("token expiry", passages), rtol=0, atol=1e-5)
    order = port.rerank("token expiry", passages)
    assert order == ref.rerank("token expiry", passages)
    assert sorted(order) == list(range(len(passages)))
    assert port.rerank("q", []) == []


# -- the CLIs end to end ----------------------------------------------------------

QUERIES = ["validate token", "retry with exponential backoff", "session store", "decode jwt"]


@pytest.fixture
def f32_models(monkeypatch):
    """Gemma (bf16 from its HF config) and SPLADE (bf16 always) run at f32 in
    both packages here: at bf16 the two frameworks round at other places
    (the module tests hold that), and the search scores below would carry
    those roundings, not the wiring this test is about."""
    from cqs_tpu.models import bert as jbert
    from cqs_tpu.models import gemma as jgemma
    from cqs_tpu_torch.models import bert as tbert
    from cqs_tpu_torch.models import gemma as tgemma

    for mod, f32 in ((jgemma, jnp.float32), (tgemma, torch.float32)):
        orig = mod.GemmaConfig.from_hf_config.__func__
        monkeypatch.setattr(mod.GemmaConfig, "from_hf_config", classmethod(
            lambda cls, d, dtype=None, _o=orig, _f=f32: _o(cls, d, dtype=_f)))
    for mod, f32 in ((jbert, jnp.float32), (tbert, torch.float32)):
        cfg = mod.BertConfig
        monkeypatch.setattr(mod, "BertConfig", lambda *a, _c=cfg, _f=f32, **kw: _c(
            *a, **{**kw, "dtype": kw.get("dtype", _f)}))


def _hits(res):
    return [(h.row.id, h.score) for h in res.hits]


def test_both_clis_index_and_search_with_neural_models(tmp_project, ckpts, tiny_presets,
                                                       f32_models):
    from cqs_tpu.cli.context import CommandContext as JContext
    from cqs_tpu.cli.main import main as j_main
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main

    (tmp_project / ".cqs-tpu.toml").write_text(
        f'[embedding]\nmodel = "embeddinggemma-300m"\nmodel_path = "{ckpts["gemma"]}"\n'
        f'[splade]\nmodel = "splade-distil"\nmodel_path = "{ckpts["splade"]}"\n'
        f'[reranker]\nmodel = "minilm-l6"\nmodel_path = "{ckpts["rerank"]}"\n')
    port_root = tmp_project.parent / "port_copy"
    shutil.copytree(tmp_project, port_root)
    assert j_main(["index", "--path", str(tmp_project)]) == 0
    assert main(["index", "--path", str(port_root), "--device", "cpu"]) == 0
    jctx = JContext.create(str(tmp_project))
    ctx = CommandContext.create(str(port_root), device="cpu")
    try:
        assert ctx.embedder.preset.family == "gemma" and ctx.splade.preset.name == "splade-distil"
        assert ctx.store.chunk_count() == jctx.store.chunk_count() > 10
        assert ctx.store.get_meta("splade_model") == "splade-distil"
        for rerank in (False, True):
            for q in QUERIES:
                port = _hits(ctx.engine.search(q, rerank=rerank))
                ref = _hits(jctx.engine.search(q, rerank=rerank))
                assert port and [i for i, _ in port] == [i for i, _ in ref], (q, rerank)
                assert max(abs(a - b) for (_, a), (_, b) in zip(port, ref)) <= 1e-4
        assert type(ctx.engine._reranker).__name__ == "CrossEncoderReranker"
    finally:
        jctx.close()
        ctx.close()
    # and through the port's CLI, --rerank included
    assert main(["search", "decode jwt", "--rerank", "--json", "--path", str(port_root),
                 "--device", "cpu"]) == 0


def test_slot_config_names_the_reranker(tmp_project, ckpts, tiny_presets):
    """A slot's own ``config.toml`` may name its reranker, as in the reference
    (``cqs_tpu/cli/context.py:54-58``)."""
    from cqs_tpu.cli.context import CommandContext as JContext
    from cqs_tpu_torch.cli.context import CommandContext
    from cqs_tpu_torch.cli.main import main
    from cqs_tpu_torch.store import slot_dir

    assert main(["index", "--path", str(tmp_project), "--device", "cpu"]) == 0
    ctx = CommandContext.create(str(tmp_project), device="cpu")
    slot_cfg = slot_dir(ctx.index_dir, ctx.slot) / "config.toml"
    ctx.close()
    slot_cfg.write_text(f'[reranker]\nmodel = "minilm-l6"\nmodel_path = "{ckpts["rerank"]}"\n')
    port, ref = CommandContext.create(str(tmp_project), device="cpu"), JContext.create(str(tmp_project))
    try:
        for c in (port, ref):
            assert (c.config.reranker_model, c.config.reranker_model_path) == (
                "minilm-l6", str(ckpts["rerank"]))
        port.engine.search("check token expiry timestamp", rerank=True)
        rr = port.engine._reranker
        assert isinstance(rr, CrossEncoderReranker) and rr.preset.name == "minilm-l6"
        assert rr.model_path == ckpts["rerank"]
    finally:
        port.close()
        ref.close()
