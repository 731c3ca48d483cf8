"""Driver ``index_repo``: pulls indexed into a repository with a neural
embedder.

Set-up draws the configuration's weights on the device from the seed, writes
them as a Hugging Face checkpoint into ``TMPDIR``, opens one
``CommandContext`` on a project whose ``.cqs-tpu.toml`` names the preset and
the checkpoint, and warms every (batch, bucket) shape the embedder can form
(batches 8 / 32 / 128 / the preset's, buckets up to the serving length). It
then indexes the base repository (``base_files`` files) and one pull. Each
iteration of the window is a pull: the previous pull's files are deleted and
``files_per_iteration`` new ones written, then the port's ``cmd_index``
handler runs in this process, which removes the old files' chunks, indexes
the new ones and re-enriches the store. So every pull meets a store of the
same size. The window's time is the sum of those calls.

After each call, outside the window's time, the store is read: every chunk
of the files present against the generator's manifest (windows included),
its base and enriched NL against the reference's NL of that manifest
(``perfbench/reference/nl.py``), no chunk without vectors; and stored vectors
that the call embedded are sampled from the seed. Once the window has closed
and the program is freed, the sampled vectors (both columns, the longest NLs
among them) are compared with the reference's f32 forward over the
reference's NL, tokenized by the reference's own tokenizer.
"""

from __future__ import annotations

import contextlib
import gc
import heapq
import io
import json
import shutil
import sqlite3
import time
from argparse import Namespace

import numpy as np
import torch

from perfbench import flops
from perfbench.core import Outcome, sync
from perfbench.gen.repo import RepoGenerator
from perfbench.reference import bert as ref
from perfbench.reference import nl as rnl
from perfbench.reference import tokenizer as rtok
from perfbench.trace import Spans, device_window, gemm_seconds
from perfbench.weights import DTYPES, draw_bert, write_checkpoint

class _Forwards:
    """The benchmark's span around ``Embedder._forward`` (which ends in a
    copy to the host): seconds, padded and real positions, and the real
    tokens' forward operations. Faults for the checks' tests replace rows."""

    def __init__(self, embedder, c: dict, spans: Spans, faults: frozenset):
        self.inner, self.c, self.spans, self.faults = embedder._forward, c, spans, faults
        self.positions = self.real = 0
        self.real_flops = 0.0
        embedder._forward = self

    def __call__(self, ids, mask):
        lengths = mask.sum(axis=1)
        self.positions += int(mask.size)
        self.real += int(lengths.sum())
        self.real_flops += flops.forward_flops(self.c, lengths.tolist())
        with self.spans("forward"):
            out = self.inner(ids, mask)
        if "half_batch" in self.faults and len(out) > 1:
            half = (len(out) + 1) // 2
            out = np.concatenate([out[:half], out[:len(out) - half]])
        if "answer" in self.faults and len(out) > 1:
            out = out.copy()
            out[0] = out[1]
        return out


@contextlib.contextmanager
def _stage_spans(spans: Spans, embedder):
    """The benchmark's spans around the index pipeline's embedding stage and
    its enrichment pass (module attributes, looked up at each call) and
    around ``Embedder.embed_documents``, by which a trace's idle gaps are
    told apart."""
    from cqs_tpu_torch import pipeline

    def wrap(name, fn):
        def inner(*a, **k):
            with spans(name):
                return fn(*a, **k)
        return inner
    saved = {k: getattr(pipeline, k) for k in ("_embed_pending", "run_enrichment_pass")}
    for k, fn in saved.items():
        setattr(pipeline, k, wrap(k.strip("_"), fn))
    embedder.embed_documents = wrap("embed_documents", embedder.embed_documents)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(pipeline, k, fn)
        del embedder.embed_documents


def _token_fault(tokenizer) -> None:
    inner = tokenizer.encode

    def encode(text, max_len):
        e = inner(text, max_len)
        if e.mask.sum() > 2:
            e.ids[1] = 4 + (int(e.ids[1]) - 3) % (tokenizer.vocab_size - 4)
        return e
    tokenizer.encode = encode


class _Observer:
    """Reads the store after each ``cmd_index`` call (outside the window's
    time) against the reference's view of the files present: chunks that
    differ from the manifest, NL that differs from the reference's, chunks
    without vectors; and draws, from the seed, a sample of the vectors the
    call embedded (reservoir sampling) and keeps the longest texts."""

    def __init__(self, cell, db_path):
        t = cell.traffic
        self.repo = rnl.Repository(int(cell.config["max_seq_len"]))
        self.db = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
        self.rng = np.random.default_rng([cell.seed & ((1 << 64) - 1), 0xC4EC])
        self.k, self.n_longest = int(t["check_sample"]), int(t["check_longest"])
        self.sample: list[tuple[str, np.ndarray]] = []
        self.longest: list[tuple[int, int, str, np.ndarray]] = []
        self.seen = 0
        self.chunk_bad = self.nl_bad = self.missing = 0

    def __call__(self, files, new_origins: set, draw: bool) -> None:
        want = self.repo.index(files)
        rows = self.db.execute("SELECT id, origin, name, line_start, line_end, nl, nl_base, "
                               "embedding IS NULL OR embedding_base IS NULL FROM chunks").fetchall()
        got = {(r[1], r[2], r[3]): r for r in rows}
        by_origin: dict[str, set] = {}
        for r in rows:
            by_origin.setdefault(r[1], set()).add((r[2], r[3], r[4]))
        by_want: dict[str, set] = {}
        for e in want.values():
            by_want.setdefault(e.chunk.origin, set()).add(
                (e.chunk.name, e.chunk.line_start, e.chunk.line_end))
        self.chunk_bad += sum(by_origin.get(o) != by_want.get(o) for o in set(by_origin) | set(by_want))
        self.missing += sum(int(r[7]) for r in rows)
        cand = []
        for key, e in want.items():
            r = got.get(key)
            if r is None:
                continue
            if r[5] != e.nl or r[6] != e.nl_base:
                self.nl_bad += 1
            if draw and e.chunk.origin in new_origins:
                cand.append((r[0], "embedding_base", e.nl_base))
            if draw and (e.enriched_now or e.chunk.origin in new_origins):
                cand.append((r[0], "embedding", e.nl))
        if cand:
            self._draw(cand)

    def _vector(self, cid: str, column: str) -> np.ndarray:
        blob = self.db.execute(f"SELECT {column} FROM chunks WHERE id = ?", (cid,)).fetchone()[0]
        return np.frombuffer(blob, "<f4").copy() if blob is not None else None

    def _draw(self, cand: list) -> None:
        for cid, column, text in cand:
            self.seen += 1
            slot = len(self.sample) if len(self.sample) < self.k else int(self.rng.integers(self.seen))
            if slot < self.k:
                v = self._vector(cid, column)
                if v is not None:
                    if slot == len(self.sample):
                        self.sample.append((text, v))
                    else:
                        self.sample[slot] = (text, v)
            if len(self.longest) < self.n_longest or len(text) > self.longest[0][0]:
                v = self._vector(cid, column)
                if v is not None:
                    item = (len(text), self.seen, text, v)
                    if len(self.longest) < self.n_longest:
                        heapq.heappush(self.longest, item)
                    else:
                        heapq.heapreplace(self.longest, item)

    def pairs(self) -> list[tuple[str, np.ndarray]]:
        return self.sample + [(t, v) for _, _, t, v in self.longest]

    def close(self) -> None:
        self.db.close()


def run(cell) -> Outcome:
    c, t, dev = cell.config, cell.traffic, cell.device
    from cqs_tpu_torch.cli.commands import cmd_index
    from cqs_tpu_torch.cli.context import CommandContext

    work = cell.workdir()
    with cell.step("draw weights on the device"):
        weights = draw_bert(c, cell.seed, dev, DTYPES[c["compute_dtype"]])
        host = {k: v.cpu() for k, v in weights.items()}
        del weights
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    with cell.step("write the checkpoint"):
        ckpt = write_checkpoint(work / "checkpoint", c, host)
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
    if "token" in cell.faults:
        _token_fault(embedder.tokenizer)
    if "unchanged" in cell.faults:
        embedder.embed_documents = lambda texts: np.zeros((len(texts), embedder.dim), np.float32)
    if "enriched_nl" in cell.faults:
        from cqs_tpu_torch import pipeline

        enriched = pipeline.generate_nl_enriched
        pipeline.generate_nl_enriched = \
            lambda *a, **k: enriched(*a, **k).replace("Called by: ", "Called by: zz ", 1)
    fw = _Forwards(embedder, c, spans, cell.faults) if cell.trace or cell.faults else None
    with cell.step("warm every (batch, bucket) shape"):
        top = embedder.preset.batch_size(max(embedder.buckets))
        prev = 0
        for bucket in embedder.buckets:
            text = " ".join(gen.words.draw(np.random.default_rng(bucket), max(1, (prev + bucket) // 2 - 2)))
            for rows in sorted({8, 32, 128, top}):
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
        fw.real_flops = 0.0
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
              "iterations": its, **tot}
    if fw is not None:
        record.update(forward_s=spans.seconds["forward"], positions=fw.positions,
                      real_positions=fw.real, real_flops=fw.real_flops)
        cell.log(f"window spans (s): {dict(spans.seconds)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if cell.trace:
        n_trace, at = int(t["traced_iterations"]), at + 1 + its
        with cell.step("trace the matrix products of 1 pull"), _stage_spans(spans, embedder):
            p0 = fw.positions
            gemm_s = gemm_seconds(lambda: index_once(gen.iteration(at), True), lambda: sync(dev))
            gemm_flops = flops.dense_flops(c, fw.positions - p0)
        with cell.step(f"trace the device over {n_trace} pulls"), _stage_spans(spans, embedder):
            trace = device_window(lambda: [index_once(gen.iteration(at + 1 + k), True)
                                           for k in range(n_trace)], spans, lambda: sync(dev),
                                  exclude=("check",))
        trace.update(gemm_s=gemm_s, gemm_flops=gemm_flops)
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
        checks, record["control"] = _check(cell, observe, host)
    failed = tot["chunks_upserted"] - tot["embedded"] + observe.missing
    e2e = {"index_chunks_per_s": (tot["chunks_upserted"] / window_s, "chunks/s"),
           "setup_s": (setup_s, "s")}
    return Outcome(attempted=tot["chunks_upserted"], failed=max(0, failed), e2e=e2e,
                   record=record, checks=checks, memory_peak_bytes=peak, trace=trace)


def _check(cell, observe: _Observer, host: dict) -> tuple[dict, dict | None]:
    lim = cell.limits
    pairs = observe.pairs()
    texts = list(dict.fromkeys(t for t, _ in pairs))
    at = {t: i for i, t in enumerate(texts)}
    ref_vecs = reference_vectors(cell, host, texts)
    gap = max((float(np.linalg.norm(v - ref_vecs[at[t]])) for t, v in pairs), default=float("inf"))
    control = None
    if cell.control:
        control = {p: {"vec_gap": float(np.linalg.norm(
            reference_vectors(cell, host, texts, p) - ref_vecs, axis=1).max())} for p in ("bf16", "fp8")}
        altered = reference_vectors(cell, host, ["zz" + t for t in texts])
        control["token"] = {"vec_gap": float(np.linalg.norm(altered - ref_vecs, axis=1).max())}
    cell.log(f"compared {len(pairs)} stored vectors ({len(texts)} texts) of {observe.seen} "
             f"embedded in the window")
    return {"chunk_mismatch": (observe.chunk_bad, lim["chunk_mismatch"]),
            "nl_mismatch": (observe.nl_bad, lim["nl_mismatch"]),
            "missing_vectors": (observe.missing, lim["missing_vectors"]),
            "vec_gap": (gap, lim["vec_gap"])}, control


def reference_vectors(cell, host: dict, texts: list[str], precision: str = "f32") -> np.ndarray:
    """The reference's unit vectors of ``texts`` (with the configuration's
    document prefix), on the cell's device, in blocks of 32 rows of like
    length."""
    c, dev = cell.config, cell.device
    ref.tf32_off()
    params = {k: v.to(dev) for k, v in host.items()}
    encs = [rtok.encode(c["doc_prefix"] + t, c["vocab_size"], c["max_seq_len"]) for t in texts]
    order = np.argsort([len(e) for e in encs])
    out = np.zeros((len(texts), c["hidden_size"]), np.float32)
    with torch.no_grad():
        for s in range(0, len(order), 32):
            idx = order[s:s + 32]
            n = max(len(encs[i]) for i in idx)
            ids = torch.zeros(len(idx), n, dtype=torch.long)
            mask = torch.zeros(len(idx), n, dtype=torch.long)
            for j, i in enumerate(idx):
                ids[j, :len(encs[i])] = torch.from_numpy(encs[i])
                mask[j, :len(encs[i])] = 1
            v = ref.embed(params, c, ids.to(dev), mask.to(dev), c["pooling"], precision)
            out[idx] = v.cpu().numpy()
    del params
    return out
