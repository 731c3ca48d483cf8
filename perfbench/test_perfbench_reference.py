"""The plain reference against the port at small widths on the CPU, in f32,
and the control: the reference in fp8 fails the cells' comparisons."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.drivers.train_pairs import readings
from perfbench.reference import bert as ref
from perfbench.reference import tokenizer as rtok
from perfbench.weights import draw_bert, write_checkpoint

BENCH = Path(__file__).resolve().parent
SMALL = {"architectures": ["BertModel"], "model_type": "bert", "vocab_size": 30522,
         "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "intermediate_size": 128, "max_position_embeddings": 64, "type_vocab_size": 2,
         "layer_norm_eps": 1e-12, "hidden_act": "gelu"}
TEXTS = ["parse the request body and return the token", "Section one: indexing a repository",
         "alpha_beta gamma delta", "a much longer text " * 9]


def _port_embedder(tmp_path, c, pooling):
    from cqs_tpu_torch.models.bert import BertConfig, BertDenseEmbedder
    from cqs_tpu_torch.models.loader import load_safetensors_params

    w = draw_bert(c, 11, torch.device("cpu"), torch.float32)
    ckpt = write_checkpoint(tmp_path / "ck", c, w)
    cfg = BertConfig(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                     num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                     intermediate_size=c["intermediate_size"],
                     max_position=c["max_position_embeddings"], dtype=torch.float32)
    model = BertDenseEmbedder(cfg, pooling=pooling).eval()
    model.load_state_dict(load_safetensors_params(ckpt, model.state_dict(), "bert"))
    return model, w


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_reference_forward_matches_the_port_in_f32(tmp_path, pooling):
    from cqs_tpu_torch.models.tokenizer import HashTokenizer

    model, w = _port_embedder(tmp_path, SMALL, pooling)
    tok = HashTokenizer(SMALL["vocab_size"])
    encs = [tok.encode(t, 64) for t in TEXTS]
    ids = torch.from_numpy(np.stack([e.ids for e in encs])).long()
    mask = torch.from_numpy(np.stack([e.mask for e in encs]))
    with torch.no_grad():
        port = model(ids, mask).numpy()
    rids, rmask = rtok.encode_batch(TEXTS, SMALL["vocab_size"], 64, 64)
    assert np.array_equal(rids, ids.numpy()) and np.array_equal(rmask, mask.numpy())
    with torch.no_grad():
        want = ref.embed(w, SMALL, torch.from_numpy(rids), torch.from_numpy(rmask), pooling).numpy()
    assert np.abs(port - want).max() < 1e-5


def _batch(seed: int, B: int, K: int, L: int):
    from perfbench.gen.pairs import PairGenerator

    t = json.loads((BENCH / "traffic" / "train.json").read_text())
    t.update(pool_pairs=64, batch=B, negatives=K)
    q, p, n = PairGenerator(t, seed).step(0)
    return t, (q, p, n)


def test_reference_contrastive_step_matches_the_port_in_f32():
    from cqs_tpu_torch.models.loader import load_safetensors_params
    from cqs_tpu_torch.models.tokenizer import HashTokenizer
    from cqs_tpu_torch.parallel import ContrastiveTrainer, TrainConfig
    from cqs_tpu_torch.parallel.train import make_pair_batch

    import tempfile

    c, B, K, L = dict(SMALL, max_position_embeddings=32), 8, 2, 32
    t, (q, p, n) = _batch(3, B, K, L)
    w = draw_bert(c, 5, torch.device("cpu"), torch.float32)
    trainer = ContrastiveTrainer(TrainConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"], intermediate_size=c["intermediate_size"], seq_len=L,
        batch_per_device=B, lr=t["lr"], temperature=t["temperature"], dtype=torch.float32),
        device="cpu")
    with tempfile.TemporaryDirectory() as d:
        ckpt = write_checkpoint(Path(d), c, w)
        trainer.model.load_state_dict(load_safetensors_params(ckpt, trainer.model.state_dict(), "bert"))
    from perfbench.drivers.train_pairs import _leaf_names

    names = _leaf_names(trainer.model, w)
    tok = HashTokenizer(c["vocab_size"])
    qp, dp = t["query_prefix"], t["doc_prefix"]
    batch = make_pair_batch([qp + x for x in q], [dp + x for x in p], tok, L)
    encs = [tok.encode(dp + x, L) for x in n]
    n_ids = np.stack([e.ids for e in encs]).reshape(B, K, -1)
    n_mask = np.stack([e.mask for e in encs]).reshape(B, K, -1)
    loss, _ = trainer.train_step(*batch, n_ids, n_mask)
    got = {"losses": [loss],
           "grads": {names[id(x)]: m / (1 - trainer.opt.b1)
                     for x, m in zip(trainer.opt.params, trainer.opt.mu)},
           "deltas": {names[id(x)]: x.detach() - w[names[id(x)]]
                      for x in trainer.model.parameters()}}

    class _Cell:
        config, traffic, device = c, dict(t, seq_len=L), torch.device("cpu")
    from perfbench.drivers.train_pairs import reference_steps

    want = reference_steps(_Cell, w, [(q, p, n)])
    r = readings(got, want)
    assert r["loss_gap"] < 1e-6
    assert r["grad_diff"] < 1e-4 and r["delta_diff"] < 1e-3


def test_fp8_reference_fails_the_index_comparison():
    c = dict(SMALL, hidden_size=128, num_attention_heads=4, intermediate_size=512)
    w = draw_bert(c, 2, torch.device("cpu"), torch.float32)
    ids, mask = rtok.encode_batch(TEXTS * 4, c["vocab_size"], 64)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        want = ref.embed(w, c, ids, mask, "cls")
        low = ref.embed(w, c, ids, mask, "cls", "fp8")
    limit = json.loads((BENCH / "limits" / "bge-large.index.json").read_text())["vec_gap"]
    assert float((low - want).norm(dim=1).max()) > limit


def test_fp8_reference_fails_the_training_comparison():
    c, B, K, L = dict(SMALL, max_position_embeddings=32), 8, 2, 32
    t, texts = _batch(4, B, K, L)
    w = draw_bert(c, 6, torch.device("cpu"), torch.float32)

    class _Cell:
        config, traffic, device = c, dict(t, seq_len=L), torch.device("cpu")
    from perfbench.drivers.train_pairs import reference_steps

    steps = [texts] * 3
    want = reference_steps(_Cell, w, steps)
    low = readings(reference_steps(_Cell, w, steps, "fp8"), want)
    limits = json.loads((BENCH / "limits" / "minilm-l6.train.json").read_text())
    assert any(low[k] > lim for k, lim in limits.items() if k in low)


@pytest.mark.parametrize("max_seq_len", [128, 512])
def test_reference_nl_is_the_ports_nl_of_the_generated_files(tmp_path, max_seq_len):
    """Every chunk of generated files (windows included), as the port's parser,
    windowing and NL template make it, is what ``reference/nl.py`` works out
    from the generator's manifest."""
    from cqs_tpu_torch.nl import generate_nl
    from cqs_tpu_torch.parser import parse_file
    from cqs_tpu_torch.pipeline import apply_windowing
    from perfbench.gen.repo import RepoGenerator
    from perfbench.reference import nl as rnl

    class Windows:
        """The embedder's windowing, at ``max_seq_len``, over the port's
        hash tokenizer."""
        def __init__(self):
            from cqs_tpu_torch.models.tokenizer import load_tokenizer
            self.tokenizer = load_tokenizer(None, vocab_size=30522)
            self.max_seq_len = max_seq_len

        def token_count(self, text):
            return self.tokenizer.token_count(text)

        def split_into_windows(self, text):
            from cqs_tpu_torch.models.embedder import Embedder
            return Embedder.split_into_windows(self, text)

    t = json.loads((BENCH / "traffic" / "index.json").read_text())
    t.update(files_per_iteration=8, base_files=8)
    g = RepoGenerator(t, 2**31 + 41)
    files = g.base() + g.iteration(1)
    port, mine = {}, {}
    for f in files:
        (tmp_path / f.origin).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / f.origin).write_text(f.text)
        for c in apply_windowing(parse_file(tmp_path / f.origin, tmp_path).chunks, Windows()):
            port[(c.origin, c.name, c.line_start)] = (c.line_end, generate_nl(c, max_seq_len))
        for it in f.items:
            for c in rnl.chunks_of(it, max_seq_len):
                mine[c.key] = (c.line_end, rnl.base_nl(c, max_seq_len))
    assert any("#w" in k[1] for k in mine) and any(k[1] in {i.name for f in files
                                                            for i in f.items if i.calls}
                                                   for k in mine)
    assert mine == port


def test_reference_enrichment_follows_callers_and_keeps_vanished_context():
    from perfbench.gen.repo import RepoGenerator
    from perfbench.reference import nl as rnl

    t = json.loads((BENCH / "traffic" / "index.json").read_text())
    t.update(files_per_iteration=8, base_files=8)
    g = RepoGenerator(t, 5)
    base, pull = g.base(), g.iteration(1)
    repo = rnl.Repository(512)
    repo.index(base)
    after = repo.index(base + pull)
    called = {c for f in pull for i in f.items for c in i.calls}
    assert called and called <= set(g.functions)
    # (an NL already at its budget of 4 characters a token has no room left)
    short = {e.chunk.name for e in after.values() if e.chunk.name in called
             and len(e.nl_base) < 1500}
    assert len(short) > len(called) // 2
    assert all("Called by: " in e.nl for e in after.values() if e.chunk.name in short)
    assert sum(e.enriched_now for e in after.values() if e.chunk.name in short) > len(short) // 2
    pull2 = g.iteration(2)
    again = repo.index(base + pull2)
    # called by the first pull alone, calling nothing: no context left
    gone = short - {c for f in base + pull2 for i in f.items for c in i.calls} - \
        {i.name for f in base for i in f.items if i.calls}
    kept = [(k, e) for k, e in again.items() if e.chunk.name in gone]
    assert kept and all(e.nl == after[k].nl and not e.enriched_now for k, e in kept)
