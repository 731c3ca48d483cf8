"""The port's tracer (``cqs_tpu_torch/utils/trace.py``): spans with ids,
parents and roots, per-name totals and self time, counters, and the spans and
counters the index pipeline, the embedder and the trainer record; the
recorder is never turned on by an untraced benchmark run."""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import pytest
import torch

from cqs_tpu_torch.utils import trace
from cqs_tpu_torch.utils.trace import count, recorder, recording, span

CPU = torch.device("cpu")


def _by_name(rec) -> dict:
    out: dict = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def _children(rec, parent) -> set[str]:
    return {s.name for s in rec.spans if s.parent == parent.id}


def test_spans_nest_with_parents_roots_fields_and_wall_clock_bounds():
    with recording() as rec:
        before = time.time_ns()
        with span("request", kind="pull"):
            with span("stage_a"):
                with span("leaf"):
                    pass
            with span("stage_b", n=3):
                pass
        after = time.time_ns()
        with span("request"):
            pass
    by = _by_name(rec)
    first, second = by["request"]
    (a,), (b,), (leaf,) = by["stage_a"], by["stage_b"], by["leaf"]
    assert first.parent is None and first.root == first.id and first.fields == {"kind": "pull"}
    assert a.parent == first.id and b.parent == first.id and leaf.parent == a.id
    assert {a.root, b.root, leaf.root} == {first.id}
    assert b.fields == {"n": 3}
    assert second.parent is None and second.root == second.id != first.id
    assert len({s.id for s in rec.spans}) == len(rec.spans) == 5
    assert before <= first.start_ns <= a.start_ns <= leaf.start_ns <= leaf.end_ns <= a.end_ns \
        <= b.start_ns <= b.end_ns <= first.end_ns <= after
    assert {s.thread for s in rec.spans} == {threading.get_ident()}
    assert rec.marks()[0] == (leaf.start_ns, leaf.end_ns, "leaf")


def test_self_time_is_the_duration_less_the_children():
    with recording() as rec:
        with span("outer"):
            time.sleep(0.02)
            with span("inner"):
                time.sleep(0.03)
            with span("inner"):
                time.sleep(0.01)
    s = rec.summary()["spans"]
    (outer,), inner = _by_name(rec)["outer"], _by_name(rec)["inner"]
    assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
    assert s["outer"]["total_s"] == pytest.approx((outer.end_ns - outer.start_ns) / 1e9)
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - sum((x.end_ns - x.start_ns) / 1e9 for x in inner))
    assert s["outer"]["self_s"] >= 0.02 and s["inner"]["self_s"] == s["inner"]["total_s"] >= 0.04
    assert rec.seconds_within("inner", "outer") == pytest.approx(s["inner"]["total_s"])
    assert rec.seconds_within("outer", "inner") == 0.0


def test_worker_threads_keep_their_own_parents():
    """A span opened on another thread is not a child of the span open on
    the thread that started it: each thread has its own stack."""
    seen = []

    def work(k):
        with span("work", k=k):
            with span("work_inner"):
                seen.append(k)
    with recording() as rec:
        with span("request"):
            threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and sorted(seen) == [0, 1, 2, 3]
    by = _by_name(rec)
    (req,) = by["request"]
    assert all(w.parent is None and w.root == w.id for w in by["work"])
    assert {w.thread for w in by["work"]} .isdisjoint({req.thread})
    parent_of = {w.id: w for w in by["work"]}
    for inner in by["work_inner"]:
        assert parent_of[inner.parent].thread == inner.thread
    assert rec.summary()["spans"]["request"]["self_s"] == pytest.approx(
        rec.summary()["spans"]["request"]["total_s"])


def test_a_span_closed_out_of_order_leaves_the_stack_whole():
    """A generator suspended inside its span outlives the span that was open
    when it started; the stack still ends empty and the next span is a
    root."""
    def gen():
        with span("inside_generator"):
            yield 1
            yield 2

    with recording() as rec:
        it = gen()
        with span("caller"):
            next(it)
        assert list(it) == [2]
        with span("after"):
            pass
    by = _by_name(rec)
    (caller,), (inner,), (after,) = by["caller"], by["inside_generator"], by["after"]
    assert inner.parent == caller.id and after.parent is None
    assert trace._OPEN.stack == []


def test_counters_and_the_bound_on_kept_spans(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with recording() as rec:
        count("rows")
        count("rows", 4)
        for _ in range(5):
            with span("s"):
                pass
    summary = rec.summary()
    assert summary["counters"] == {"rows": 5}
    assert summary["spans"]["s"]["count"] == 5
    assert len(rec.spans) == 3 and summary["dropped"] == 2


def test_one_recorder_at_a_time_and_none_after():
    with recording():
        assert recorder() is not None
        with pytest.raises(RuntimeError):
            with recording():
                pass
    assert recorder() is None


class _Loud:
    """A field that counts every time it is formatted."""

    def __init__(self):
        self.n = 0

    def __format__(self, spec):
        self.n += 1
        return "loud"

    __str__ = __repr__ = lambda self: self.__format__("")


def test_off_records_nothing_and_formats_nothing(monkeypatch):
    loud = _Loud()
    made = []
    monkeypatch.setattr(trace, "SpanRecord", lambda *a: made.append(a))
    level = trace._LOG.level
    trace._LOG.setLevel(logging.WARNING)
    try:
        assert recorder() is None
        with span("quiet", field=loud):
            count("rows", 3)
    finally:
        trace._LOG.setLevel(level)
    assert loud.n == 0 and made == []


def test_the_log_line_is_kept(caplog):
    loud = _Loud()
    with caplog.at_level(logging.DEBUG, logger="cqs_tpu"):
        with span("loud_span", field=loud):
            pass
    assert loud.n == 1
    assert any("span{loud_span field=loud} close elapsed_ms=" in r.getMessage()
               for r in caplog.records)


def test_the_index_pipeline_records_its_stage_tree(tmp_project):
    from cqs_tpu_torch.models import Embedder, SpladeEncoder
    from cqs_tpu_torch.pipeline import run_index_pipeline
    from cqs_tpu_torch.store import Store

    embedder = Embedder("hash", device=CPU)
    masks = []
    inner = embedder._forward

    def forward(ids, mask):
        masks.append((mask.copy(), ids.copy()))
        return inner(ids, mask)
    embedder._forward = forward
    store = Store.open(tmp_project / ".cqs-tpu")
    try:
        with recording() as rec:
            stats = run_index_pipeline(tmp_project, store, embedder, SpladeEncoder(device=CPU))
    finally:
        store.close()
    by = _by_name(rec)
    (root,) = by["index_pipeline"]
    assert root.parent is None and {s.root for s in rec.spans} == {root.id}
    assert _children(rec, root) == {"enumerate", "remove", "parse", "upsert", "embed", "enrich",
                                    "splade"}
    (enrich,) = by["enrich"]
    assert _children(rec, enrich) == {"enrich_graph", "enrich_nl", "enrich_embed"}
    for stage in ("embed", "enrich_embed"):
        assert _children(rec, by[stage][0]) == {"embed_texts"}
    for et in by["embed_texts"]:
        assert _children(rec, et) == {"tokenize", "embed_bucket"}
    assert all(_children(rec, b) == {"forward"} for b in by["embed_bucket"])
    c = rec.summary()["counters"]
    assert stats.enriched > 0 and c["enrich.reembedded"] == stats.enriched
    assert c["enrich.rebuilt"] >= c["enrich.reembedded"]
    assert c["embed.positions"] == sum(m.size for m, _ in masks)
    # a pad row (all-zero ids) is padding, its forced first position too
    assert c["embed.real_positions"] == sum(int(m[ids.any(axis=1)].sum()) for m, ids in masks)
    assert 0 < c["embed.real_positions"] < c["embed.positions"]


def test_a_train_step_records_its_four_parts():
    from cqs_tpu_torch.parallel.train import ContrastiveTrainer, TrainConfig

    cfg = TrainConfig(vocab_size=512, hidden_size=64, num_layers=1, num_heads=4,
                      intermediate_size=128, seq_len=16, batch_per_device=4)
    trainer = ContrastiveTrainer(cfg, seed=0, device=CPU)
    rng = np.random.default_rng(0)
    B, K, L = 4, 2, 16

    def part(*shape):
        ids = rng.integers(4, cfg.vocab_size, size=shape).astype(np.int32)
        mask = (np.arange(L) < rng.integers(2, L + 1, size=shape[:-1] + (1,))).astype(np.int32)
        return ids, mask
    (qi, qm), (pi, pm), (ni, nm) = part(B, L), part(B, L), part(B, K, L)
    with recording() as rec:
        loss, _ = trainer.train_step(qi, qm, pi, pm, ni, nm)
    assert np.isfinite(loss)
    (step,) = _by_name(rec)["train_step"]
    kids = sorted((s for s in rec.spans if s.parent == step.id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["train_forward", "train_backward", "train_optimizer",
                                      "train_loss_read"]
    assert step.parent is None and all(s.root == step.id for s in rec.spans)
    c = rec.summary()["counters"]
    assert c["train.positions"] == qm.size + pm.size + nm.size
    assert c["train.real_positions"] == int(qm.sum() + pm.sum() + nm.sum())


def test_program_marks_name_the_device_windows_idle_gaps(monkeypatch):
    """The recorder's marks, on ``perfbench/trace.py``'s clock, name each
    idle gap of a device window by the innermost span the host was in; the
    window's busy time, its length and the gaps' sum do not depend on them.
    With no card, the CPU's matrix products stand in for device work."""
    from perfbench import trace as bench_trace
    from perfbench.trace import Spans, device_window

    monkeypatch.setattr(bench_trace, "_is_device", lambda e: e.name == "aten::mm")
    x = torch.ones(256, 256)

    def pull():
        with spans("bench_outer"), span("program_root"):
            with span("host_stage"):
                time.sleep(0.05)
            with span("device_stage"):
                for _ in range(3):
                    x @ x
            with span("host_tail"):
                time.sleep(0.02)

    def traced():
        with recording() as rec:
            pull()
        spans.marks.extend(rec.marks())
    windows = []
    for program_marks in (False, True):
        spans = Spans()
        out = device_window(traced if program_marks else pull, spans, lambda: None)
        gaps = {label.rsplit(" (", 1)[0]: sec for label, sec in out["idle_gaps"]}
        assert 0 < out["busy_s"] < out["window_s"]
        assert sum(gaps.values()) + out["busy_s"] == pytest.approx(out["window_s"], rel=1e-6)
        windows.append(gaps)
    without, with_marks = windows
    assert set(without) <= {"bench_outer", "outside spans"} and without["bench_outer"] >= 0.06
    assert with_marks["host_stage"] >= 0.04 and with_marks["host_tail"] >= 0.015
    assert with_marks.get("bench_outer", 0.0) < 0.01


def test_an_untraced_benchmark_run_never_turns_the_recorder_on(monkeypatch):
    """A run with ``--trace 0`` of each driver (tiny cells on the CPU): no
    recorder is made."""
    import json
    from pathlib import Path

    from perfbench.core import Cell
    from perfbench.drivers import index_repo, train_pairs

    made = []
    real = trace.Recorder
    monkeypatch.setattr(trace, "Recorder", lambda *a, **k: made.append(1) or real(*a, **k))
    pb = Path(__file__).resolve().parent.parent / "perfbench"

    def load(*parts):
        return json.loads(pb.joinpath(*parts).read_text())
    index_conf = {**load("configs", "bge-large.json"), "preset": "cqs-mini", "vocab_size": 32768,
                  "hidden_size": 256, "num_hidden_layers": 4, "num_attention_heads": 8,
                  "intermediate_size": 512, "max_position_embeddings": 128, "max_seq_len": 128,
                  "pooling": "mean", "compute_dtype": "float32"}
    index_traffic = {**load("traffic", "index.json"), "files_per_iteration": 2, "base_files": 4,
                     "check_sample": 16}
    train_conf = {**load("configs", "minilm-l6.json"), "hidden_size": 32, "num_hidden_layers": 2,
                  "num_attention_heads": 4, "intermediate_size": 64,
                  "max_position_embeddings": 32, "compute_dtype": "float32"}
    train_traffic = {**load("traffic", "train.json"), "batch": 8, "seq_len": 32, "pool_pairs": 64}
    for driver, conf, traffic, limits in (
            (index_repo, index_conf, index_traffic,
             {"vec_gap": 1e-4, "chunk_mismatch": 0, "nl_mismatch": 0, "missing_vectors": 0}),
            (train_pairs, train_conf, train_traffic,
             {"loss_gap": 1e-4, "grad_gap_med": 1e-3, "delta_gap_med": 1e-3,
              "window_loss_gap": 1e-4, "window_delta_gap_med": 1e-3, "nonfinite": 0})):
        cell = Cell(workload=f"tiny.{driver.__name__.rsplit('.', 1)[1]}", config=conf,
                    traffic=traffic, limits=limits, seed=2**31 + 5, seconds=0.3, trace=False,
                    device=CPU, t0=time.perf_counter())
        try:
            out = driver.run(cell)
        finally:
            cell.cleanup()
        assert out.correct and out.attempted > 0
    assert made == [] and recorder() is None
