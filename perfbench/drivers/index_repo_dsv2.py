"""Driver ``index_repo_dsv2``: pulls indexed into a repository with a
DeepSeek-V2 decoder as the code embedder.

The traffic, the window and the checks are ``index_repo``'s (its observer of
the store, its spans around the pipeline's stages and its token fault are
imported from there unchanged); what differs is the model. Set-up draws the
configuration's weights on the device from the seed in the Hugging Face
``DeepseekV2ForCausalLM`` key layout (linear and embedding N(0, 0.02),
RMSNorm weights 1 + N(0, 0.05); no ``lm_head``, which an embedder does not
read), writes them with ``config.json`` as a checkpoint into ``TMPDIR``, and
opens one ``CommandContext`` on a project whose ``.cqs-tpu.toml`` names the
preset and the checkpoint. Neither the drawn weights nor the checkpoint's
file outlive the model's load: the window runs without ~10 GB of host copies
and page cache. The check draws the weights again from the seed and compares
the sampled stored vectors with ``perfbench/reference/deepseek_v2.py``'s f32
forward, on the card, in blocks of at most :data:`REF_BLOCK_TOKENS` positions.
The result record is ``index_repo``'s (``"cell": "index"``), so that cell's
readers read it; the expert layer's readings are added under ``trace``.

A traced run also profiles one pull with host operators and device activity
while the program's recorder is on (``cqs_tpu_torch/utils/trace.py``): the
device time of the grouped expert products (``aten::_grouped_mm``), the
device time of the operators launched inside the program's ``moe`` and
``forward`` spans, and the expert layer's counters. Then it traces the
device alone over ``traced_iterations`` pulls, as ``index_repo`` does.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import io
import json
import shutil
import time
from argparse import Namespace

import numpy as np
import torch

from perfbench import flops_dsv2
from perfbench.core import Outcome, sync
from perfbench.drivers.index_repo import _Observer, _stage_spans, _token_fault
from perfbench.gen.repo import RepoGenerator
from perfbench.reference import deepseek_v2 as ref
from perfbench.reference import tokenizer as rtok
from perfbench.trace import Spans, device_window
from perfbench.weights import DTYPES, write_safetensors

#: the reference's blocks hold at most this many positions (rows x length)
REF_BLOCK_TOKENS = 16384
#: the keys of a configuration file that its ``config.json`` carries: the
#: published config's
HF_KEYS = ("architectures", "attention_bias", "first_k_dense_replace", "hidden_act",
           "hidden_size", "intermediate_size", "kv_lora_rank", "max_position_embeddings",
           "model_type", "moe_intermediate_size", "moe_layer_freq", "n_group",
           "n_routed_experts", "n_shared_experts", "norm_topk_prob", "num_attention_heads",
           "num_experts_per_tok", "num_hidden_layers", "num_key_value_heads", "q_lora_rank",
           "qk_nope_head_dim", "qk_rope_head_dim", "rms_norm_eps", "rope_scaling", "rope_theta",
           "routed_scaling_factor", "scoring_func", "seq_aux", "tie_word_embeddings",
           "topk_group", "topk_method", "v_head_dim", "vocab_size")


def dsv2_shapes(c: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(key, shape, kind) of every tensor of a ``DeepseekV2Model`` in the
    causal LM's layout (``model.`` prefix); kind ``w`` a matrix or the
    embedding, ``g`` an RMSNorm weight."""
    H, n, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    nope, rope, vd, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                            c["kv_lora_rank"])
    out = [("model.embed_tokens.weight", (V, H), "w")]

    def mlp(key, inter):
        return [(f"{key}.gate_proj.weight", (inter, H), "w"),
                (f"{key}.up_proj.weight", (inter, H), "w"),
                (f"{key}.down_proj.weight", (H, inter), "w")]
    for i in range(c["num_hidden_layers"]):
        b = f"model.layers.{i}."
        out += [(b + "input_layernorm.weight", (H,), "g"),
                (b + "self_attn.q_proj.weight", (n * (nope + rope), H), "w"),
                (b + "self_attn.kv_a_proj_with_mqa.weight", (rank + rope, H), "w"),
                (b + "self_attn.kv_a_layernorm.weight", (rank,), "g"),
                (b + "self_attn.kv_b_proj.weight", (n * (nope + vd), rank), "w"),
                (b + "self_attn.o_proj.weight", (H, n * vd), "w"),
                (b + "post_attention_layernorm.weight", (H,), "g")]
        if i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0:
            out.append((b + "mlp.gate.weight", (c["n_routed_experts"], H), "w"))
            for e in range(c["n_routed_experts"]):
                out += mlp(f"{b}mlp.experts.{e}", c["moe_intermediate_size"])
            if c["n_shared_experts"]:
                out += mlp(f"{b}mlp.shared_experts",
                           c["moe_intermediate_size"] * c["n_shared_experts"])
        else:
            out += mlp(b + "mlp", c["intermediate_size"])
    out.append(("model.norm.weight", (H,), "g"))
    return out


def draw_dsv2(c: dict, seed: int, device: torch.device, dtype: torch.dtype
              ) -> dict[str, torch.Tensor]:
    """Every tensor of :func:`dsv2_shapes`, drawn on ``device`` from
    ``seed`` one after another, in ``dtype``, left there: the same seed
    draws the same tensors."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    out = {}
    for key, shape, kind in dsv2_shapes(c):
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        x = 1.0 + 0.05 * x if kind == "g" else 0.02 * x
        out[key] = x.to(dtype)
    return out


class _Forwards:
    """The benchmark's span around ``Embedder._forward``: seconds, padded and
    real positions. Faults for the checks' tests replace rows, as
    ``index_repo``'s do."""

    def __init__(self, embedder, spans: Spans, faults: frozenset):
        self.inner, self.spans, self.faults = embedder._forward, spans, faults
        self.positions = self.real = 0
        embedder._forward = self

    def __call__(self, ids, mask):
        self.positions += int(mask.size)
        self.real += int(mask.sum())
        with self.spans("forward"):
            out = self.inner(ids, mask)
        if "half_batch" in self.faults and len(out) > 1:
            half = (len(out) + 1) // 2
            out = np.concatenate([out[:half], out[:len(out) - half]])
        if "answer" in self.faults and len(out) > 1:
            out = out.copy()
            out[0] = out[1]
        return out


def _span_device_seconds(prof, marks: list, names: tuple[str, ...]) -> dict[str, float]:
    """By span name: the device seconds of the kernels of host operators
    that started inside a recorded span of that name (``marks``: the
    recorder's ``(start_ns, end_ns, name)``)."""
    start = prof.profiler.kineto_results.trace_start_ns()
    # spans of one name follow one another on the pipeline's thread
    spans = {n: sorted(((m0 - start) / 1e3, (m1 - start) / 1e3) for m0, m1, name in marks
                       if name == n) for n in names}
    starts = {n: [a for a, _ in iv] for n, iv in spans.items()}
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        dev_us = float(getattr(e, "self_device_time_total", 0.0) or 0.0)
        if dev_us <= 0 or str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = float(e.time_range.start)
        for n, iv in spans.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and t <= iv[i][1]:
                out[n] += dev_us / 1e6
    return out


def _profile_pull(fn, sync_dev) -> dict:
    """One pull (``fn``) traced with host operators and device activity
    while the program's recorder is on."""
    from torch.profiler import ProfilerActivity, profile

    from cqs_tpu_torch.utils.trace import recording

    sync_dev()
    with recording() as rec, profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        fn()
        sync_dev()
    grouped = sum(float(getattr(e, "self_device_time_total", 0.0) or 0.0)
                  for e in prof.key_averages() if e.key == "aten::_grouped_mm") / 1e6
    within = _span_device_seconds(prof, rec.marks(), ("moe", "forward"))
    summary = rec.summary()
    return {"grouped_mm_s": grouped, "moe_device_s": within["moe"],
            "forward_device_s": within["forward"], "counters": summary["counters"],
            "spans": {k: v["total_s"] for k, v in summary["spans"].items()}}


def run(cell) -> Outcome:
    c, t, dev = cell.config, cell.traffic, cell.device
    from cqs_tpu_torch.models.registry import get_preset

    get_preset(c["preset"])          # before any weight is drawn: a program without it fails now
    from cqs_tpu_torch.cli.commands import cmd_index
    from cqs_tpu_torch.cli.context import CommandContext

    work = cell.workdir()
    with cell.step("draw weights on the device"):
        drawn = draw_dsv2(c, cell.seed, dev, DTYPES[c["compute_dtype"]])
    with cell.step("write the checkpoint"):
        ckpt = work / "checkpoint"
        ckpt.mkdir()
        (ckpt / "config.json").write_text(json.dumps({k: c[k] for k in HF_KEYS if k in c},
                                                     indent=1))
        write_safetensors(ckpt / "model.safetensors", drawn)
        del drawn
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    proj = work / "project"
    proj.mkdir()
    (proj / ".cqs-tpu.toml").write_text(
        f'[embedding]\nmodel = "{c["preset"]}"\nmodel_path = "{ckpt}"\n\n'
        f'[index]\ndisable_splade = "true"\n')
    gen = RepoGenerator(t, cell.seed)
    spans = Spans()
    with cell.step("open the context and load the model"):
        ctx = CommandContext.create(str(proj), device=dev)
        embedder = ctx.embedder
        embedder.warm()
        # the model is on the device: its file's pages leave the host now
        (ckpt / "model.safetensors").unlink()
    if "token" in cell.faults:
        _token_fault(embedder.tokenizer)
    if "unchanged" in cell.faults:
        embedder.embed_documents = lambda texts: np.zeros((len(texts), embedder.dim), np.float32)
    if "enriched_nl" in cell.faults:
        from cqs_tpu_torch import pipeline

        enriched = pipeline.generate_nl_enriched
        pipeline.generate_nl_enriched = \
            lambda *a, **k: enriched(*a, **k).replace("Called by: ", "Called by: zz ", 1)
    fw = _Forwards(embedder, spans, cell.faults) if cell.trace or cell.faults else None
    with cell.step("warm every (batch, bucket) shape"):
        prev = 0
        for bucket in embedder.buckets:
            text = " ".join(gen.words.draw(np.random.default_rng(bucket), max(1, (prev + bucket) // 2 - 2)))
            for rows in sorted({8, 32, 128, embedder.preset.batch_size(bucket)}):
                embedder.embed_documents([text] * rows)
            prev = bucket
        sync(dev)
    base = gen.base()
    pull: list = []
    observe = None

    def index_once(files, draw: bool) -> dict:
        """Replace the previous pull's files by ``files`` and index."""
        nonlocal pull
        for d in {(proj / f.origin).parent for f in pull}:
            shutil.rmtree(d)
        for f in files:
            path = proj / f.origin
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(f.text)
        out = io.StringIO()
        t0 = time.perf_counter()
        with spans("index"), contextlib.redirect_stdout(out):
            rc = cmd_index(ctx, Namespace(force=False, no_enrich=False, json=True))
        dt = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cmd_index returned {rc}: {out.getvalue()[-500:]}")
        pull = [] if files is base else files
        if observe is not None:
            with spans("check"):
                observe(base + pull, {f.origin for f in files}, draw)
        return {"seconds": dt, **json.loads(out.getvalue().strip().splitlines()[-1])["results"]}

    with cell.step(f"index the base repository ({len(base)} files)"):
        index_once(base, False)
        observe = _Observer(cell, ctx.store.path)
        observe(base, {f.origin for f in base}, False)
    at = gen.base_iterations
    with cell.step("index the first pull"):
        index_once(gen.iteration(at), False)
    spans.seconds.clear()
    spans.count.clear()
    if fw is not None:
        fw.positions = fw.real = 0
    setup_s = time.perf_counter() - cell.t0
    cell.log(f"set-up done: {setup_s:.3f} s; window of {cell.seconds} s of index time")
    window_s, its, tot = 0.0, 0, {"chunks_upserted": 0, "embedded": 0, "embed_reused": 0,
                                  "enriched": 0, "files_removed": 0}
    per_it = []
    with _stage_spans(spans, embedder) if cell.trace else contextlib.nullcontext():
        while window_s < cell.seconds:
            r = index_once(gen.iteration(at + 1 + its), True)
            window_s += r["seconds"]
            its += 1
            per_it.append(f"{r['seconds']:.3f}/{r['chunks_upserted']}/{r['enriched']}")
            for k in tot:
                tot[k] += int(r.get(k, 0))
    cell.log(f"window: {its} pulls, {window_s:.3f} s of index time, "
             f"{spans.seconds['check']:.3f} s of checks, {tot}")
    cell.log(f"pulls (s/chunks/enriched): {' '.join(per_it)}")
    record = {"cell": "index", "window_s": window_s, "chunks": tot["chunks_upserted"],
              "iterations": its, "n_experts": c["n_routed_experts"], **tot}
    if fw is not None:
        record.update(forward_s=spans.seconds["forward"], positions=fw.positions,
                      real_positions=fw.real,
                      real_flops=flops_dsv2.forward_flops(c, fw.real))
        cell.log(f"window spans (s): {dict(spans.seconds)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if cell.trace:
        n_trace, at = int(t["traced_iterations"]), at + 1 + its
        with cell.step("profile 1 pull with the program's recorder on"), \
                _stage_spans(spans, embedder):
            prof = _profile_pull(lambda: index_once(gen.iteration(at), True), lambda: sync(dev))
        n = prof["counters"]
        cell.log(f"profiled pull: {json.dumps(prof)}")
        with cell.step(f"trace the device over {n_trace} pulls"), _stage_spans(spans, embedder):
            trace = device_window(lambda: [index_once(gen.iteration(at + 1 + k), True)
                                           for k in range(n_trace)], spans, lambda: sync(dev),
                                  exclude=("check",))
        rows, active = n.get("moe.routed_rows", 0), n.get("moe.active_experts", 0)
        trace.update(grouped_mm_s=prof["grouped_mm_s"], moe_device_s=prof["moe_device_s"],
                     forward_device_s=prof["forward_device_s"],
                     expert_roofline_s=flops_dsv2.expert_roofline_s(c, rows, active) if rows else 0.0,
                     moe_counters=n)
        record["trace"] = trace
    if "enriched_nl" in cell.faults:
        pipeline.generate_nl_enriched = enriched
    observe.close()
    ctx.close()
    del ctx, embedder, fw
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with cell.step("check against the reference"):
        checks, record["control"] = _check(cell, observe)
    failed = tot["chunks_upserted"] - tot["embedded"] + observe.missing
    e2e = {"index_chunks_per_s": (tot["chunks_upserted"] / window_s, "chunks/s"),
           "setup_s": (setup_s, "s")}
    return Outcome(attempted=tot["chunks_upserted"], failed=max(0, failed), e2e=e2e,
                   record=record, checks=checks, memory_peak_bytes=peak, trace=trace)


def _check(cell, observe: _Observer) -> tuple[dict, dict | None]:
    lim = cell.limits
    pairs = observe.pairs()
    texts = list(dict.fromkeys(t for t, _ in pairs))
    at = {t: i for i, t in enumerate(texts)}
    params = draw_dsv2(cell.config, cell.seed, cell.device,
                       DTYPES[cell.config["compute_dtype"]])
    ref_vecs = reference_vectors(cell, params, texts)
    gaps = [float(np.linalg.norm(v - ref_vecs[at[t]])) for t, v in pairs]
    control = None
    if cell.control:
        def readings(vecs):
            g = np.linalg.norm(vecs - ref_vecs, axis=1)
            return {"vec_gap": float(g.max()), "vec_gap_med": float(np.median(g))}
        control = {p: readings(reference_vectors(cell, params, texts, p)) for p in ("bf16", "fp8")}
        control["token"] = readings(reference_vectors(cell, params, ["zz" + t for t in texts]))
        for fault in ref.FAULTS:
            control[fault] = readings(reference_vectors(cell, params, texts, fault=fault))
    del params
    cell.log(f"compared {len(pairs)} stored vectors ({len(texts)} texts) of {observe.seen} "
             f"embedded in the window")
    return {"chunk_mismatch": (observe.chunk_bad, lim["chunk_mismatch"]),
            "nl_mismatch": (observe.nl_bad, lim["nl_mismatch"]),
            "missing_vectors": (observe.missing, lim["missing_vectors"]),
            "vec_gap": (max(gaps, default=float("inf")), lim["vec_gap"]),
            "vec_gap_med": (float(np.median(gaps)) if gaps else float("inf"), lim["vec_gap_med"])}, \
        control


def reference_vectors(cell, params: dict, texts: list[str], precision: str = "f32",
                      fault: str | None = None) -> np.ndarray:
    """The reference's unit vectors of ``texts`` (with the configuration's
    document prefix), on the cell's device, in blocks of like length of at
    most :data:`REF_BLOCK_TOKENS` positions."""
    c, dev = cell.config, cell.device
    ref.tf32_off()
    encs = [rtok.encode(c["doc_prefix"] + t, c["vocab_size"], c["max_seq_len"]) for t in texts]
    order = np.argsort([len(e) for e in encs], kind="stable")
    out = np.zeros((len(texts), c["hidden_size"]), np.float32)
    with torch.no_grad():
        s = 0
        while s < len(order):
            e = s + 1
            while e < len(order) and (e - s + 1) * len(encs[order[e]]) <= REF_BLOCK_TOKENS:
                e += 1
            idx = order[s:e]
            n = len(encs[idx[-1]])
            ids = torch.zeros(len(idx), n, dtype=torch.long)
            mask = torch.zeros(len(idx), n, dtype=torch.long)
            for j, i in enumerate(idx):
                ids[j, :len(encs[i])] = torch.from_numpy(encs[i])
                mask[j, :len(encs[i])] = 1
            v = ref.embed(params, c, ids.to(dev), mask.to(dev), precision, fault)
            out[idx] = v.cpu().numpy()
            s += len(idx)
    return out
