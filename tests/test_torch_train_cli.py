"""The port's training commands and tiered serving against the JAX package's,
through the CLI handlers, on the fixture project and on the CPU.

The fixture project is indexed once by the reference; both packages then run
their commands over that index (the on-disk format is shared, and the port
loads the reference's artifacts). Each reference handler
(``cqs_tpu/cli/commands.py``) is called with the arguments the port's parser
gives for the same command line (the port copies the reference's flags).
Everything is written under ``tmp_path``; widths are tiny (hidden 32, one
layer, seq 16-32).

Tolerances: mined pairs equal; teacher labels the same ids with scores within
1e-5 (the packages' query embeddings differ in the last bits: the port's hash
table is a numpy reproduction of ``jax.random.normal``); ``train-reranker`` from
one ``--init``: every parameter within atol 1e-4 (AdamW's sign-like first
steps move a near-zero gradient by up to one lr, 1e-4 here, when its last
bit differs) and 99.9% of its entries within 1e-6, but for the key biases,
whose true gradient is 0 (the softmax ignores a shift of a query's logits);
checkpoints loaded across packages: embeddings within 1e-5 (the same f32
model summed in other orders); ``params.pkl`` resumed with 0 steps and saved
again: bit-equal; the tiered engines' hits: the same ids, scores within
1e-5."""

import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import cqs_tpu.cli.commands as JC
import cqs_tpu.native as j_native
import cqs_tpu_torch.native as t_native
from cqs_tpu.cli.context import CommandContext as JContext
from cqs_tpu.models.embedder import Embedder as JEmbedder
from cqs_tpu.pipeline import run_index_pipeline as j_index
from cqs_tpu_torch.cli.commands import HANDLERS
from cqs_tpu_torch.cli.context import CommandContext
from cqs_tpu_torch.cli.main import build_parser
from cqs_tpu_torch.daemon.batcher import QueryBatcher
from cqs_tpu_torch.models.embedder import Embedder
from cqs_tpu_torch.models.loader import read_safetensors
from cqs_tpu_torch.search.engine import TieredServing
from cqs_tpu_torch.search.router import classify_query

TINY = ["--hidden-size", "32", "--num-layers", "1", "--intermediate-size", "64"]


@pytest.fixture(autouse=True)
def same_tokenizer_path(monkeypatch):
    """Both packages tokenize by one path (``tests/test_torch_slice.py``)."""
    if (j_native.get_lib() is None) != (t_native.get_lib() is None):
        monkeypatch.setenv("CQST_DISABLE_NATIVE", "1")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def one_device_mesh(monkeypatch):
    """The reference's train commands build their mesh over every JAX
    device (8 virtual CPU devices in the tests); the port trains on one.
    Both packages train on one device here (pytest restores the function)."""
    import cqs_tpu.parallel as jparallel

    monkeypatch.setattr(jparallel, "make_2d_mesh",
                        lambda *a, **k: jparallel.mesh.make_2d_mesh(1))


@pytest.fixture
def project(tmp_project):
    """The fixture project, indexed by the reference (store, dense and
    sparse artifacts)."""
    ctx = JContext.create(str(tmp_project))
    try:
        j_index(ctx.root, ctx.store, ctx.embedder, ctx._maybe_splade(), config=ctx.config)
        _ = ctx.engine
    finally:
        ctx.close()
    return tmp_project


def run(package: str, root: Path, argv: list[str], slot: str | None = None) -> int:
    """One command through either package's handler, its arguments from the
    port's parser."""
    args = build_parser().parse_args(argv)
    if package == "port":
        ctx = CommandContext.create(str(root), slot, device="cpu")
        handler = HANDLERS[args.command]
    else:
        ctx = JContext.create(str(root), slot)
        handler = getattr(JC, "cmd_" + args.command.replace("-", "_"))
    try:
        return handler(ctx, args)
    finally:
        ctx.close()


def write_pool(root: Path, pairs_path: Path, pool: Path, gate: Path, held: int = 4) -> None:
    """A v3-format query set from mined pairs (query -> the positive's origin
    and name), the first ``held`` queries as a gate file."""
    from cqs_tpu_torch.store import Store
    from cqs_tpu_torch.train.data import load_pairs

    store = Store.open(root / ".cqs-tpu", slot="default", readonly=True)
    try:
        qs, seen = [], set()
        for p in load_pairs(pairs_path):
            row = store.get_chunk(p.positive_id)
            if row is None or p.query in seen:
                continue
            seen.add(p.query)
            qs.append({"query": p.query, "category": classify_query(p.query).category.value,
                       "gold_chunk": {"origin": row.origin, "name": row.name.split("#w")[0]}})
    finally:
        store.close()
    gate.write_text(json.dumps({"queries": qs[:held]}))
    pool.write_text(json.dumps({"queries": qs[held:]}))


def test_train_data_and_teacher_labels_match_the_reference(project, tmp_path):
    pairs = {}
    for pkg in ("ref", "port"):
        out = tmp_path / f"{pkg}_pairs.jsonl"
        assert run(pkg, project, ["train-data", "--source", "all", "--max", "40",
                                  "--engine-negatives", "2", "--out", str(out)]) == 0
        pairs[pkg] = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(pairs["port"]) >= 10 and pairs["port"] == pairs["ref"]
    assert any(p["negatives"] for p in pairs["port"])
    pool, gate = tmp_path / "pool.json", tmp_path / "gate.json"
    write_pool(project, tmp_path / "port_pairs.jsonl", pool, gate)
    labels = {}
    for pkg in ("ref", "port"):
        out = tmp_path / f"{pkg}_labels.jsonl"
        assert run(pkg, project, ["train-distill", "--labels-only", "--pool", str(pool),
                                  "--exclude", str(gate), "-k", "8",
                                  "--labels", str(out)]) == 0
        labels[pkg] = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(labels["port"]) == len(labels["ref"]) >= 5
    held_out = {q["query"] for q in json.loads(gate.read_text())["queries"]}
    for a, b in zip(labels["port"], labels["ref"]):
        assert a["query"] == b["query"] and a["query"] not in held_out
        assert [c for c, _ in a["candidates"]] == [c for c, _ in b["candidates"]]
        np.testing.assert_allclose([s for _, s in a["candidates"]],
                                   [s for _, s in b["candidates"]], rtol=0, atol=1e-5)


def synthetic_pairs(path: Path, n: int = 12) -> None:
    rows = [{"query": f"how does step {i} work", "positive": f"step {i} applies the rule {i}",
             "positive_id": "", "negatives": [f"step {i + 1} applies the rule {i + 1}",
                                              f"unrelated text {i}"]} for i in range(n)]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def test_train_reranker_matches_the_reference_from_one_init(project, tmp_path):
    import jax
    import jax.numpy as jnp

    from cqs_tpu.models.bert import BertConfig as JBertConfig
    from cqs_tpu.models.bert import CrossEncoder as JCrossEncoder
    from cqs_tpu.models.loader import save_flax_checkpoint

    pairs = tmp_path / "pairs.jsonl"
    synthetic_pairs(pairs)
    cfg = JBertConfig(vocab_size=32768, hidden_size=32, num_layers=1, num_heads=8,
                      intermediate_size=64, max_position=32, dtype=jnp.float32)
    d = jnp.zeros((1, 16), dtype=jnp.int32)
    init = jax.device_get(JCrossEncoder(cfg).init(jax.random.PRNGKey(3), d, jnp.ones_like(d), d))
    save_flax_checkpoint(init, tmp_path / "init", {"family": "cross-encoder"})
    got = {}
    for pkg in ("ref", "port"):
        out = tmp_path / pkg
        assert run(pkg, project, ["train-reranker", str(pairs), "--steps", "3", "--batch", "4",
                                  "--seq-len", "32", *TINY, "--init", str(tmp_path / "init"),
                                  "--out", str(out)]) == 0
        got[pkg] = {k: v.numpy() for k, v in read_safetensors(out / "model.safetensors").items()}
    losses = [json.loads(ln)["loss"] for ln in (tmp_path / "port" / "train_log.jsonl")
              .read_text().splitlines()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert got["port"].keys() == got["ref"].keys()
    for k in got["ref"]:
        a, b = got["port"][k], got["ref"][k]
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-4, k
        if not k.endswith("/k/bias"):     # a true gradient of 0: both move by noise
            assert np.mean(np.abs(a - b) > 1e-6) <= 1e-3, k
    flat_init = {"/".join(k): v for k, v in _flatten(init["params"]).items()}
    assert any(not np.array_equal(got["ref"][k], flat_init[k]) for k in flat_init)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def distill_args(steps: int) -> list[str]:
    return ["--steps", str(steps), "--batch", "4", "--seq-len", "16", "--cands", "4", *TINY]


def test_checkpoints_and_resume_cross_packages(project, tmp_path):
    pairs = tmp_path / "pairs.jsonl"
    assert run("port", project, ["train-data", "--source", "store", "--max", "40",
                                 "--out", str(pairs)]) == 0
    # the teacher labels; each package distills a student, whose native
    # checkpoint both load, and whose params.pkl the other resumes: 0 steps
    # save what was loaded, bit for bit
    labels = tmp_path / "labels.jsonl"
    pool, gate = tmp_path / "pool.json", tmp_path / "gate.json"
    write_pool(project, pairs, pool, gate)
    assert run("port", project, ["train-distill", "--labels-only", "--pool", str(pool),
                                 "-k", "8", "--labels", str(labels)]) == 0
    for src, dst in (("ref", "port"), ("port", "ref")):
        out = tmp_path / f"{src}_distilled"
        # the gate probe on the port's side only: the reference runs its model
        # op by op there, for seconds a batch
        gate_args = ["--gate", str(gate)] if src == "port" else []
        assert run(src, project, ["train-distill", "--labels", str(labels), *distill_args(2),
                                  *gate_args, "--out", str(out)]) == 0
        resumed = tmp_path / f"{src}_resumed_by_{dst}"
        resumed.mkdir()
        shutil.copy(out / "params.pkl", resumed / "params.pkl")
        assert run(dst, project, ["train-distill", "--labels", str(labels), *distill_args(0),
                                  "--resume", "--out", str(resumed)]) == 0
        with open(out / "params.pkl", "rb") as f:
            a = _flatten(pickle.load(f))
        with open(resumed / "params.pkl", "rb") as f:
            b = _flatten(pickle.load(f))
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
        assert a[("params", "encoder", "layer_0", "q", "kernel")].shape == (32, 8, 4)
        texts = ["validate a bearer token", "retry with backoff", "session store"]
        want = JEmbedder("cqs-mini", out).embed_documents(texts)
        got = Embedder("cqs-mini", out, device="cpu").embed_documents(texts)
        assert want.shape == got.shape == (3, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    log = (tmp_path / "port_distilled" / "train_log.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in log] == [0, 1]


#: (the port's mesh, the reference's ``make_2d_mesh`` arguments over its
#: virtual CPU devices): the reference's grid on four chips, and dp 2
GRIDS = [((1, 4), (4,)), ((2, 2), (4, 2))]


@pytest.mark.parametrize("shape,jargs", GRIDS, ids=["1x4", "2x2"])
def test_train_commands_on_a_grid(project, tmp_path, monkeypatch, capsys, shape, jargs):
    """``train`` and ``train-distill`` with each package's ``make_2d_mesh``
    giving the same (dp, tp) grid: the same ``mesh`` line, ``--batch``
    divided by dp (9 rows: 9 at dp 1, 8 at dp 2), the distilled losses from
    one ``--resume`` checkpoint within the bf16 tolerance (rtol 2e-2, and
    the reference prints 4 decimals), and each package resumes the other's
    grid checkpoint with 0 steps and saves it bit for bit."""
    import cqs_tpu.parallel as jparallel
    import cqs_tpu_torch.parallel as tparallel
    from cqs_tpu_torch.parallel.train import DistillTrainer, TrainConfig

    dp, tp = shape
    monkeypatch.setattr(jparallel, "make_2d_mesh",
                        lambda *a, **k: jparallel.mesh.make_2d_mesh(*jargs))
    monkeypatch.setattr(tparallel, "make_2d_mesh", lambda *a, **k: tparallel.mesh.make_2d_mesh(
        dp * tp, dp=dp, device="cpu"))
    want_rows = 9 // dp * dp

    def lines(pkg, argv, prefix):
        capsys.readouterr()
        assert run(pkg, project, argv) == 0
        out = [ln.strip() for ln in capsys.readouterr().out.splitlines()]
        return [ln for ln in out if ln.startswith(prefix)]

    pairs = tmp_path / "pairs.jsonl"
    synthetic_pairs(pairs)
    said = {pkg: lines(pkg, ["train", str(pairs), "--steps", "1", "--batch", "9", "--seq-len",
                             "16", *TINY, "--out", str(tmp_path / f"{pkg}_ck")], "training on")
            for pkg in ("ref", "port")}
    assert said["port"] == said["ref"] == [
        f"training on 12 pairs, global batch {want_rows}, mesh {{'dp': {dp}, 'tp': {tp}}}"]
    mined = tmp_path / "mined.jsonl"
    assert run("port", project, ["train-data", "--source", "store", "--max", "40",
                                 "--out", str(mined)]) == 0
    labels, pool, gate = tmp_path / "labels.jsonl", tmp_path / "pool.json", tmp_path / "gate.json"
    write_pool(project, mined, pool, gate)
    assert run("port", project, ["train-distill", "--labels-only", "--pool", str(pool),
                                 "-k", "8", "--labels", str(labels)]) == 0
    # one initial checkpoint for both packages, at the command's widths
    init = DistillTrainer(TrainConfig(hidden_size=32, num_layers=1, intermediate_size=64,
                                      seq_len=16), seed=4, device="cpu").params_tree()
    losses, head = {}, f"batch {4 // dp * dp} x K=4, mesh {{'dp': {dp}, 'tp': {tp}}}"
    for pkg in ("ref", "port"):
        out = tmp_path / f"{pkg}_distilled"
        out.mkdir()
        with open(out / "params.pkl", "wb") as f:
            pickle.dump(init, f)
        said = lines(pkg, ["train-distill", "--labels", str(labels), *distill_args(2),
                           "--resume", "--out", str(out)], "")
        assert any(ln.startswith("distilling on") and ln.endswith(head) for ln in said), said
        losses[pkg] = [float(ln.split()[3]) for ln in said if ln.startswith("step")]
    port_log = [json.loads(ln)["loss"] for ln in (tmp_path / "port_distilled" / "train_log.jsonl")
                .read_text().splitlines()]
    assert len(port_log) == len(losses["ref"]) == 2 and all(np.isfinite(port_log))
    np.testing.assert_allclose(port_log, losses["ref"], rtol=2e-2, atol=1e-4)
    assert [round(x, 4) for x in port_log] == pytest.approx(losses["port"], abs=1e-4)
    for src, dst in (("ref", "port"), ("port", "ref")):
        resumed = tmp_path / f"{src}_resumed_by_{dst}"
        resumed.mkdir()
        shutil.copy(tmp_path / f"{src}_distilled" / "params.pkl", resumed / "params.pkl")
        assert run(dst, project, ["train-distill", "--labels", str(labels), *distill_args(0),
                                  "--resume", "--out", str(resumed)]) == 0
        with open(tmp_path / f"{src}_distilled" / "params.pkl", "rb") as f:
            a = _flatten(pickle.load(f))
        with open(resumed / "params.pkl", "rb") as f:
            b = _flatten(pickle.load(f))
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), src
        assert not all(np.array_equal(a[k], _flatten(init)[k]) for k in a)


def test_export_model_and_train_centroids_run(project, tmp_path):
    for pkg in ("ref", "port"):
        assert run(pkg, project, ["export-model", "--out", str(tmp_path / pkg)]) == 0
        assert json.loads((tmp_path / pkg / "config.json").read_text())["preset"] == "hash"
    with open(tmp_path / "ref" / "params.pkl", "rb") as f:
        want = np.asarray(pickle.load(f)["table"])
    with open(tmp_path / "port" / "params.pkl", "rb") as f:
        got = pickle.load(f)["table"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)   # numpy's normals vs JAX's
    queries = [{"query": q, "category": c} for q, c in (
        ("validate_token", "identifier_lookup"), ("decode_jwt", "identifier_lookup"),
        ("SessionStore", "identifier_lookup"), ("backoff_delay", "identifier_lookup"),
        ("how does retry work", "behavioral"), ("what checks token expiry", "behavioral"),
        ("how are sessions revoked", "behavioral"), ("how is a jwt decoded", "behavioral"))]
    qfile = tmp_path / "queries.json"
    qfile.write_text(json.dumps({"queries": queries}))
    assert run("port", project, ["train-centroids", str(qfile)]) == 0
    saved = json.loads(next((project / ".cqs-tpu").rglob("classifier_centroids.json")).read_text())
    assert saved


def test_tiered_serving_routes_like_the_reference(project, tmp_path, monkeypatch):
    pairs = tmp_path / "pairs.jsonl"
    synthetic_pairs(pairs)
    ck = tmp_path / "ck"
    assert run("port", project, ["train", str(pairs), "--steps", "1", "--batch", "8",
                                 "--seq-len", "16", *TINY, "--out", str(ck)]) == 0
    slot = project / ".cqs-tpu" / "slots" / "distilled"
    slot.mkdir(parents=True)
    (slot / "config.toml").write_text(f'[embedding]\nmodel = "cqs-mini"\nmodel_path = "{ck}"\n')
    jctx = JContext.create(str(project), "distilled")
    try:
        j_index(jctx.root, jctx.store, jctx.embedder, jctx._maybe_splade(), config=jctx.config)
        _ = jctx.engine
    finally:
        jctx.close()
    monkeypatch.setenv("CQST_TIER_SLOT", "distilled")
    queries = ["decode_jwt", "not the session store", "retry with exponential backoff",
               "validate token", "no expiry check"]
    jctx = JContext.create(str(project))
    ctx = CommandContext.create(str(project), device="cpu")
    ctx2 = CommandContext.create(str(project), device="cpu")
    try:
        assert type(jctx.engine).__name__ == "TieredServing"
        eng = ctx.engine
        assert isinstance(eng, TieredServing)
        routed = [q for q in queries if eng.engine_for(q) is eng._tier]
        assert routed and len(routed) < len(queries)
        solo = {}
        for q in queries:
            ref = [(h.row.id, h.score) for h in jctx.engine.search(q).hits]
            got = [(h.row.id, h.score) for h in eng.search(q).hits]
            own = eng.engine_for(q).search(q)
            assert got and [i for i, _ in got] == [i for i, _ in ref], q
            np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=1e-5)
            assert [h.row.id for h in own.hits] == [i for i, _ in got]
            solo[q] = got
        batcher = QueryBatcher(ctx2.engine)
        try:
            batcher.pause()
            futs = [batcher.submit(q) for q in queries]
            batcher.resume()
            results = [f.result(timeout=120) for f in futs]
        finally:
            batcher.stop()
        assert batcher.stats["fused"] >= 1 and batcher.stats["cache_hits"] == 0
        for q, res in zip(queries, results):
            got = [(h.row.id, h.score) for h in res.hits]
            assert [i for i, _ in got] == [i for i, _ in solo[q]], q
            np.testing.assert_allclose([s for _, s in got], [s for _, s in solo[q]], atol=1e-5)
    finally:
        jctx.close()
        ctx.close()
        ctx2.close()
