"""DeepSeek-V2 as a dense embedder (``cqs_tpu_torch/models/deepseek.py``)
against the plain reference ``perfbench/reference/deepseek_v2.py`` on the
CPU, at a small size with seeded random weights: hidden 64, one dense and
two expert layers, 8 routed experts top-2 and one shared, kv rank 32, nope
16, rope 8, v 16. The JAX package has no such model, so the reference is the
benchmark's plain one. The weights are drawn in Hugging Face's
``DeepseekV2ForCausalLM`` layout by the benchmark's own drawer and writer
and reach the port through its loader.

Tolerances: the port and the reference both compute in float32 here (the
port's CPU dtype) from the same weights; they differ in the order of sums
(grouped against per-expert products, the rotation's form, the f32 logits
of ``models/layers.py::attention``), a few float32 ulps of values of order
1, so 1e-5 absolute holds with room.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from cqs_tpu_torch.models import deepseek as ds
from cqs_tpu_torch.models import loader
from cqs_tpu_torch.models import registry as reg
from cqs_tpu_torch.models.embedder import Embedder, build_module
from cqs_tpu_torch.utils import trace
from perfbench import flops_dsv2
from perfbench.drivers import index_repo_dsv2 as drv
from perfbench.reference import deepseek_v2 as ref
from perfbench.reference import tokenizer as rtok
from perfbench.weights import write_safetensors

CPU = torch.device("cpu")
PB = Path(__file__).resolve().parent.parent / "perfbench"
PUBLISHED = json.loads((PB / "configs" / "dsv2-lite.json").read_text())
#: the small geometry (a HF config.json's keys)
TINY = {**PUBLISHED, "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
        "moe_intermediate_size": 24, "n_routed_experts": 8, "n_shared_experts": 1,
        "num_experts_per_tok": 2, "vocab_size": 512, "compute_dtype": "float32",
        "rope_scaling": {**PUBLISHED["rope_scaling"], "factor": 4,
                         "original_max_position_embeddings": 64}}
#: the port and the reference in float32 (module docstring)
ATOL = 1e-5


def hf_weights(c: dict, seed: int = 7) -> dict[str, torch.Tensor]:
    return drv.draw_dsv2(c, seed, CPU, torch.float32)


def checkpoint(tmp_path: Path, c: dict, weights: dict) -> Path:
    d = tmp_path / "ckpt"
    d.mkdir(exist_ok=True)
    (d / "config.json").write_text(json.dumps({k: c[k] for k in drv.HF_KEYS if k in c}))
    write_safetensors(d / "model.safetensors", weights)
    return d


def port_model(tmp_path: Path, c: dict = TINY, seed: int = 7):
    """The port's module with the checkpoint's weights, and those weights."""
    w = hf_weights(c, seed)
    d = checkpoint(tmp_path, c, w)
    cfg = ds.DeepseekV2Config.from_hf_config(d, dtype=torch.float32)
    module = build_module(lambda: ds.DeepseekEmbedder(cfg), CPU, 0)
    module.load_state_dict(loader.load_safetensors_params(d, module.state_dict(), "deepseek"))
    return module, w


def batch(seed: int = 0, rows: int = 4, length: int = 40, vocab: int = 512):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(4, vocab, (rows, length), generator=g)
    mask = torch.ones(rows, length, dtype=torch.long)
    for r, n in enumerate([length, 29, 7, 1][:rows]):
        mask[r, n:] = 0
        ids[r, n:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    module, w = port_model(tmp_path_factory.mktemp("tiny"))
    ids, mask = batch()
    with torch.inference_mode():
        states = module.hidden_states(ids, mask)
        vecs = module(ids, mask)
    ref_states, ref_final = ref.hidden_states(w, TINY, ids, mask, every_layer=True)
    return {"module": module, "w": w, "ids": ids, "mask": mask, "states": states, "vecs": vecs,
            "ref_states": ref_states, "ref_final": ref_final}


@pytest.mark.parametrize("what", ["vectors", "embeddings", "layer_0", "layer_1", "layer_2"])
def test_port_matches_the_reference(tiny, what):
    """Vectors, and each layer's hidden states at the real positions (a pad
    position's MLP is left out by design)."""
    real = tiny["mask"].bool()
    if what == "vectors":
        got, want = tiny["vecs"], ref.pool(tiny["ref_final"], tiny["mask"])
    else:
        i = 0 if what == "embeddings" else int(what.split("_")[1]) + 1
        got, want = tiny["states"][i][real], tiny["ref_states"][i][real]
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want, rtol=0, atol=ATOL)
    if what == "layer_2":             # an expert layer moved the states
        assert (tiny["states"][3] - tiny["states"][2])[real].abs().max() > 0.01


@pytest.mark.parametrize("case", ["published", "small", "plain"])
def test_yarn_tables_and_softmax_scale(case):
    c = {"published": PUBLISHED, "small": TINY,
         "plain": {**TINY, "rope_scaling": None}}[case]
    cfg = ds.DeepseekV2Config.from_hf_config(c)
    want_freq, want_m = ref.rope_inv_freq(c)
    torch.testing.assert_close(ds.yarn_inv_freq(cfg), want_freq, rtol=0, atol=0)
    assert math.isclose(cfg.softmax_scale(), ref.softmax_scale(c), rel_tol=1e-15)
    sin, cos = ds.yarn_tables(50, cfg, CPU)
    ang = torch.outer(torch.arange(50, dtype=torch.float32), want_freq)
    torch.testing.assert_close(sin, torch.sin(ang) * want_m, rtol=0, atol=1e-7)
    torch.testing.assert_close(cos, torch.cos(ang) * want_m, rtol=0, atol=1e-7)
    plain = 1.0 / (1e4 ** (torch.arange(0, cfg.qk_rope_head_dim, 2).float() / cfg.qk_rope_head_dim))
    if case == "published":
        # 192 ** -0.5 * (0.1 * 0.707 * ln 40 + 1) ** 2; YaRN's correction range is dims
        # 10..23 of 32: below it the frequencies are RoPE's, above it RoPE's / 40
        assert math.isclose(cfg.softmax_scale(),
                            192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2, rel_tol=1e-12)
        freq = ds.yarn_inv_freq(cfg)
        torch.testing.assert_close(freq[:10], plain[:10], rtol=1e-6, atol=0)
        torch.testing.assert_close(freq[23:], plain[23:] / 40, rtol=1e-6, atol=0)
        assert want_m == 1.0
    elif case == "plain":
        torch.testing.assert_close(ds.yarn_inv_freq(cfg), plain, rtol=1e-6, atol=0)
        assert cfg.softmax_scale() == (16 + 8) ** -0.5


@pytest.mark.parametrize("norm,scale", [(False, 1.0), (False, 2.5), (True, 1.0)])
def test_router_top_k_indices_and_weights(norm, scale):
    cfg = dataclasses.replace(ds.DeepseekV2Config.from_hf_config(TINY, dtype=torch.float32),
                              norm_topk_prob=norm, routed_scaling_factor=scale)
    moe = build_module(lambda: ds.MoE(cfg), CPU, 3)
    h = torch.randn(33, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    idx, w = moe.route(h)
    scores = torch.softmax(h.double() @ moe.router.weight.double().T, dim=-1)
    want_w, want_idx = torch.topk(scores, 2, dim=-1)
    want_w = want_w / want_w.sum(-1, keepdim=True) if norm else want_w * scale
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(w.double(), want_w, rtol=0, atol=1e-6)
    assert w.dtype == torch.float32


@pytest.mark.parametrize("case", ["uneven", "empty_experts", "one_expert", "chunked"])
def test_grouped_experts_match_each_expert_alone(case, monkeypatch):
    cfg = ds.DeepseekV2Config.from_hf_config(TINY, dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    if case == "chunked":
        moe = build_module(lambda: ds.MoE(cfg), CPU, 4)
        h = torch.randn(37, cfg.hidden_size, generator=g)
        with torch.no_grad():
            whole = moe(h)
            monkeypatch.setattr(ds, "MOE_CHUNK_TOKENS", 8)
            # the same rows, whose products block differently at another
            # row count: float32 ulps
            torch.testing.assert_close(moe(h), whole, rtol=0, atol=1e-6)
        return
    experts = build_module(lambda: ds.RoutedExperts(cfg), CPU, 5)
    counts = {"uneven": [5, 0, 1, 9, 2, 0, 3, 7], "empty_experts": [0, 0, 6, 0, 0, 0, 0, 4],
              "one_expert": [0, 0, 0, 0, 0, 11, 0, 0]}[case]
    xs = torch.randn(sum(counts), cfg.hidden_size, generator=g)
    offs = torch.cumsum(torch.tensor(counts), 0).to(torch.int32)
    with torch.no_grad():
        got = experts(xs, offs)
        want, at = [], 0
        for e, n in enumerate(counts):
            x = xs[at:at + n]
            gate, up = experts.gate_up[e, :24], experts.gate_up[e, 24:]
            want.append((torch.nn.functional.silu(x @ gate.T) * (x @ up.T)) @ experts.down[e].T)
            at += n
    torch.testing.assert_close(got, torch.cat(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["longer_bucket", "pad_rows", "other_rows"])
def test_padding_leaves_real_rows_unchanged(tiny, case):
    """A row's vector does not depend on the padding after it, the pad rows
    of its batch, or the other rows (the MLPs see real positions only)."""
    module, ids, mask = tiny["module"], tiny["ids"], tiny["mask"]
    with torch.inference_mode():
        alone = module(ids[1:2, :29], mask[1:2, :29])
        if case == "longer_bucket":
            pad = torch.zeros(1, 88, dtype=torch.long)
            got = module(torch.cat([ids[1:2], pad], 1), torch.cat([mask[1:2], pad], 1))
        elif case == "pad_rows":
            rows_ids = torch.zeros(8, 29, dtype=torch.long)
            rows_mask = torch.zeros(8, 29, dtype=torch.long)
            rows_ids[0], rows_mask[0] = ids[1, :29], mask[1, :29]
            rows_mask[1:, 0] = 1               # the embedder's pad rows
            got = module(rows_ids, rows_mask)[:1]
        else:
            got = tiny["vecs"][1:2]
    torch.testing.assert_close(got, alone, rtol=0, atol=ATOL)


def test_real_positions_from_the_host_mask(tiny):
    """The embedder hands the forward its real positions from the host's
    mask (no wait on the device): the same indices, the same vectors."""
    module, ids, mask = tiny["module"], tiny["ids"], tiny["mask"]
    real = ds.real_positions(mask.numpy())
    assert torch.equal(real, ds.real_positions(mask))
    with torch.inference_mode():
        got = module(ids, mask, real=real)
    assert torch.equal(got, tiny["vecs"])


def test_the_check_redraws_the_written_weights():
    """The driver frees its drawn weights once written and draws them again
    for the check: one seed gives the same tensors, another seed others."""
    a, b, other = hf_weights(TINY, 11), hf_weights(TINY, 11), hf_weights(TINY, 12)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.embed_tokens.weight"], other["model.embed_tokens.weight"])


def test_last_token_pooling(tiny):
    module, mask = tiny["module"], tiny["mask"]
    last = tiny["states"][-1][torch.arange(4), mask.sum(1) - 1]
    want = module.final_norm(last.float())
    want = want / want.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(tiny["vecs"], want, rtol=0, atol=1e-6)
    assert torch.allclose(tiny["vecs"].norm(dim=-1), torch.ones(4))


@pytest.mark.parametrize("case", ["loads", "lm_head_ignored", "missing", "shape"])
def test_map_deepseek_on_a_hf_checkpoint(tmp_path, case):
    """HF names written by the benchmark's writer, mapped by the loader:
    each expert's gate and up rows stacked into ``gate_up``."""
    w = hf_weights(TINY, 3)
    if case == "lm_head_ignored":
        w["lm_head.weight"] = torch.randn(512, 64)
    elif case == "missing":
        del w["model.layers.2.mlp.experts.5.up_proj.weight"]
    elif case == "shape":
        w["model.layers.0.self_attn.kv_b_proj.weight"] = torch.zeros(512, 31)
    d = checkpoint(tmp_path, TINY, w)
    cfg = ds.DeepseekV2Config.from_hf_config(d, dtype=torch.float32)
    module = build_module(lambda: ds.DeepseekEmbedder(cfg), CPU, 0)
    if case in ("missing", "shape"):
        with pytest.raises((ValueError, KeyError)):
            loader.load_safetensors_params(d, module.state_dict(), "deepseek")
        return
    sd = loader.load_safetensors_params(d, module.state_dict(), "deepseek")
    assert set(sd) == set(module.state_dict())
    assert torch.equal(sd["layer_1.moe.experts.gate_up"][3, :24],
                       w["model.layers.1.mlp.experts.3.gate_proj.weight"])
    assert torch.equal(sd["layer_1.moe.experts.gate_up"][3, 24:],
                       w["model.layers.1.mlp.experts.3.up_proj.weight"])
    assert torch.equal(sd["layer_2.moe.experts.down"][7],
                       w["model.layers.2.mlp.experts.7.down_proj.weight"])
    assert torch.equal(sd["layer_0.mlp.gate.weight"], w["model.layers.0.mlp.gate_proj.weight"])
    assert torch.equal(sd["layer_2.moe.shared.down.weight"],
                       w["model.layers.2.mlp.shared_experts.down_proj.weight"])
    assert torch.equal(sd["layer_0.attn.kv_norm.weight"],
                       w["model.layers.0.self_attn.kv_a_layernorm.weight"])


@pytest.mark.parametrize("change,match", [
    ({"q_lora_rank": 1536}, "q_lora_rank"),
    ({"topk_method": "group_limited_greedy"}, "topk_method"),
    ({"scoring_func": "sigmoid"}, "scoring_func"),
    ({"rope_scaling": {"type": "linear", "factor": 2.0}}, "rope_scaling"),
    ({}, None)])
def test_from_hf_config_refuses_what_it_does_not_implement(change, match):
    c = {**PUBLISHED, **change}
    if match:
        with pytest.raises(ValueError, match=match):
            ds.DeepseekV2Config.from_hf_config(c)
        return
    cfg = ds.DeepseekV2Config.from_hf_config(c)
    assert (cfg.hidden_size, cfg.num_layers, cfg.n_routed_experts, cfg.num_experts_per_tok,
            cfg.kv_lora_rank, cfg.q_head_dim, cfg.v_head_dim, cfg.vocab_size) == \
        (2048, 9, 64, 6, 512, 192, 128, 102400)
    assert [cfg.is_moe(i) for i in range(9)] == [False] + [True] * 8


@pytest.mark.parametrize("preset,vocab", [("deepseek-v2-lite", 102400),
                                          ("embeddinggemma-300m", 32768),
                                          ("qwen3-embedding-8b", 32768), ("bge-large", 30522)])
def test_hash_tokenizer_vocabulary_by_family(preset, vocab):
    emb = Embedder(preset, allow_random_weights=True, device="cpu")
    assert emb.tokenizer.vocab_size == vocab
    words = " ".join(f"w{i}x" for i in range(20000))
    ids = emb.tokenizer.encode(words, 30000).ids
    assert int(ids.max()) < vocab
    if vocab == 102400:               # the ids reach past the 32768 of the other decoders
        assert int(ids.max()) > 90000
        assert emb.dim == ds.DeepseekV2Config.small_test().hidden_size


def test_preset_through_the_index_command(tmp_path):
    """The ``deepseek-v2-lite`` preset from ``.cqs-tpu.toml`` with a HF
    checkpoint, through ``CommandContext`` and ``cmd_index``: the stored
    vectors are the reference's over the reference tokenizer's ids."""
    from cqs_tpu_torch.cli.commands import cmd_index
    from cqs_tpu_torch.cli.context import CommandContext

    c = {**TINY, "vocab_size": 102400}
    w = hf_weights(c, 11)
    d = checkpoint(tmp_path, c, w)
    proj = tmp_path / "proj"
    (proj / "src").mkdir(parents=True)
    (proj / "src" / "auth.py").write_text(
        "def validate_token(token):\n    \"\"\"Check a bearer token.\"\"\"\n"
        "    return token.startswith('Bearer ')\n\n\ndef refresh(session):\n"
        "    return validate_token(session.token)\n")
    (proj / ".cqs-tpu.toml").write_text(f'[embedding]\nmodel = "deepseek-v2-lite"\n'
                                        f'model_path = "{d}"\n\n[index]\ndisable_splade = "true"\n')
    ctx = CommandContext.create(str(proj), device="cpu")
    try:
        assert cmd_index(ctx, Namespace(force=False, no_enrich=False, json=True)) == 0
        rows = ctx.store.db.execute("SELECT nl, embedding FROM chunks").fetchall()
    finally:
        ctx.close()
    assert len(rows) >= 2
    texts = [r[0] for r in rows]
    got = np.stack([np.frombuffer(r[1], "<f4") for r in rows])
    encs = [rtok.encode(t, 102400, 2048) for t in texts]
    n = max(len(e) for e in encs)
    ids = torch.zeros(len(encs), n, dtype=torch.long)
    mask = torch.zeros(len(encs), n, dtype=torch.long)
    for i, e in enumerate(encs):
        ids[i, :len(e)], mask[i, :len(e)] = torch.from_numpy(e), 1
    want = ref.embed(w, c, ids, mask).numpy()
    assert got.shape == (len(rows), 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_spans_and_counters_under_a_recorder(tiny, monkeypatch):
    """Each counter against its count by hand; the spans of every layer;
    nothing is counted without a recorder."""
    module, ids, mask = tiny["module"], tiny["ids"], tiny["mask"]
    seen = []
    for li in (1, 2):
        moe = module._stack[li].moe

        def spy(h, inner=moe.route):
            idx, w = inner(h)
            seen.append(torch.bincount(idx.reshape(-1), minlength=8))
            return idx, w
        monkeypatch.setattr(moe, "route", spy)
    with torch.inference_mode():
        module(ids, mask)
    assert module._pending is None
    seen.clear()
    with trace.recording() as rec, torch.inference_mode():
        module(ids, mask)
        module.flush_counters()
    c, s = rec.counters, rec.summary()["spans"]
    real = int(mask.sum())
    assert c["moe.tokens"] == 2 * real and c["moe.pad_rows"] == 2 * (mask.numel() - real)
    assert c["moe.routed_rows"] == 2 * 2 * real == sum(int(n.sum()) for n in seen)
    assert c["moe.max_expert_rows"] == sum(int(n.max()) for n in seen)
    assert c["moe.active_experts"] == sum(int((n > 0).sum()) for n in seen)
    assert s["mla"]["count"] == 3 and s["moe"]["count"] == 2
    assert s["moe_route"]["count"] == 2 and s["moe_experts"]["count"] == 2


def test_published_counts():
    """The configuration's active parameters and the expert products'
    operations and bytes, by hand from the published widths."""
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    expert = 3 * 2048 * 1408
    moe = 2048 * 64 + 6 * expert + 2 * expert
    assert flops_dsv2.active_params(PUBLISHED) == 9 * attn + 3 * 2048 * 10944 + 8 * moe
    assert flops_dsv2.forward_flops(PUBLISHED, 10) == 20.0 * flops_dsv2.active_params(PUBLISHED)
    assert flops_dsv2.expert_flops(PUBLISHED, 6) == 6 * 2.0 * expert
    assert flops_dsv2.expert_bytes(PUBLISHED, 1, 64) == 2 * (64 * expert + 2 * 2048 + 3 * 1408)
    # a few rows are bound by reading the weights, many by the products
    few, many = flops_dsv2.expert_roofline_s(PUBLISHED, 64, 64), \
        flops_dsv2.expert_roofline_s(PUBLISHED, 1 << 20, 64)
    assert few == flops_dsv2.expert_bytes(PUBLISHED, 64, 64) / flops_dsv2.HBM_BYTES_PER_S
    assert many == flops_dsv2.expert_flops(PUBLISHED, 1 << 20) / 989e12


#: the cell's per-layer metrics: the expert layer's own readers, and the
#: index cell's, which read the driver's record as they read bge's
METRICS = ["expert_roofline.dsv2-lite", "moe_device_share.dsv2-lite",
           "expert_imbalance.dsv2-lite", "mfu.index", "idle_share.index", "pad_share.index",
           "host_ms_per_chunk.index"]


@pytest.mark.parametrize("name", METRICS)
def test_per_layer_readers(name):
    """Each reader reads its number from a traced record; the expert layer's
    read nothing from a record without the program's counters and spans (the
    parent's), and nothing reads another cell's record."""
    from perfbench import run

    read = run.reader(name)
    top = {"cell": "index", "window_s": 50.0, "chunks": 500, "forward_s": 20.0,
           "positions": 1000, "real_positions": 400, "n_experts": 64, "real_flops": 989e12}
    rec = {**top, "trace": {"window_s": 10.0, "busy_s": 4.0, "grouped_mm_s": 2.0,
                            "expert_roofline_s": 1.0, "moe_device_s": 3.0,
                            "forward_device_s": 4.0,
                            "moe_counters": {"moe.routed_rows": 6400,
                                             "moe.max_expert_rows": 300}}}
    want = {"expert_roofline.dsv2-lite": 50.0, "moe_device_share.dsv2-lite": 75.0,
            "expert_imbalance.dsv2-lite": 3.0, "mfu.index": 2.0, "idle_share.index": 60.0,
            "pad_share.index": 60.0, "host_ms_per_chunk.index": 60.0}[name]
    assert read(rec) == pytest.approx(want)
    bare = {**top, "trace": {"window_s": 10.0, "busy_s": 4.0, "grouped_mm_s": 0.0,
                             "expert_roofline_s": 0.0, "moe_device_s": 0.0,
                             "forward_device_s": 0.0, "moe_counters": {}}}
    assert read(bare) == (None if name.endswith(".dsv2-lite") else pytest.approx(want))
    assert read({"cell": "index"}) is None
    assert read({**rec, "cell": "train"}) is None


def test_the_cell_reports_only_readers_of_its_record():
    """``BENCHMARK.json`` gives the cell the expert layer's three readers and
    the four index readers that read what its driver records, and no reader
    of another layout (``matmul_roofline.index`` reads cuBLAS products)."""
    from perfbench import run

    bench = json.loads((PB.parent / "BENCHMARK.json").read_text())
    names = {m["name"] for m in run.per_layer_of(bench, "dsv2-lite.index")}
    assert names == set(METRICS)


TINY_PRESET = reg.ModelPreset(name="deepseek-tiny", family="deepseek", dim=64, max_seq_len=128,
                              pooling="last_token", vocab_size=512)


def _driver_cell(monkeypatch, tmp_path, trace_on=False, faults=(), control=False):
    """A tiny cell through the driver, in a ``TMPDIR`` of its own. Every
    vector the window embeds is compared (``check_sample`` above their
    count), so a fault that alters any of them fails however many pulls the
    window holds."""
    from perfbench.core import Cell

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setitem(reg._PRESETS, TINY_PRESET.name, TINY_PRESET)
    conf = {**TINY, "preset": TINY_PRESET.name, "max_seq_len": 128}
    traffic = {**json.loads((PB / "traffic" / "index-dsv2.json").read_text()),
               "files_per_iteration": 3, "base_files": 6, "check_sample": 1 << 20,
               "traced_iterations": 1}
    limits = {**json.loads((PB / "limits" / "dsv2-lite.index.json").read_text()), "vec_gap": 1e-4}
    cell = Cell(workload="tiny-dsv2.index", config=conf, traffic=traffic, limits=limits,
                seed=2**31 + 23, seconds=0.3, trace=trace_on, device=CPU,
                t0=time.perf_counter(), faults=frozenset(faults), control=control)
    try:
        return drv.run(cell)
    finally:
        cell.cleanup()


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_benchmark_driver_runs_correct_on_the_cpu(monkeypatch, tmp_path, trace_on):
    out = _driver_cell(monkeypatch, tmp_path, trace_on, control=not trace_on)
    assert out.correct and out.attempted > 0, out.checks
    assert out.checks["vec_gap"][0] < 1e-5 and out.checks["vec_gap_med"][0] < 1e-5
    assert set(out.e2e) == {"index_chunks_per_s", "setup_s"}
    if trace_on:
        n = out.record["trace"]["moe_counters"]
        assert n["moe.routed_rows"] == 2 * n["moe.tokens"] > 0
        assert n["moe.max_expert_rows"] * 8 >= n["moe.routed_rows"] // 2
        assert out.record["real_flops"] > 0
        # the index cell's readers read this driver's record
        from perfbench import run

        for name in ("mfu.index", "idle_share.index", "pad_share.index",
                     "host_ms_per_chunk.index", "expert_imbalance.dsv2-lite"):
            assert run.reader(name)(out.record) is not None, name
    else:
        # the controls: the reference's bf16 reads near the program (f32
        # here); fp8, an altered first token and each expert fault read far
        ctl = {k: v["vec_gap"] for k, v in out.record["control"].items()}
        assert set(ctl) == {"bf16", "fp8", "token", "last_expert", "shared"}
        assert ctl["bf16"] < 0.05
        assert min(ctl[k] for k in ("fp8", "token", "last_expert", "shared")) > 100 * \
            out.checks["vec_gap"][0]


@pytest.mark.parametrize("fault", ["token", "half_batch", "answer", "unchanged", "enriched_nl"])
def test_a_fault_in_the_driver_s_timed_path_is_not_correct(monkeypatch, tmp_path, fault):
    assert not _driver_cell(monkeypatch, tmp_path, faults=(fault,)).correct


def test_the_parent_without_the_preset_fails_at_once(monkeypatch):
    """A program that lacks the preset fails before any weight is drawn."""
    from perfbench.core import Cell

    drawn = []
    monkeypatch.setattr(drv, "draw_dsv2", lambda *a, **k: drawn.append(1))
    cell = Cell(workload="tiny-dsv2.none", config={**TINY, "preset": "no-such-preset"},
                traffic={}, limits={}, seed=1, seconds=0.1, trace=False, device=CPU,
                t0=time.perf_counter())
    with pytest.raises(KeyError, match="unknown model preset"):
        drv.run(cell)
    assert drawn == []
