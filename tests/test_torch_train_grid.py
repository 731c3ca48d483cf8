"""The port's (dp, tp) training grid on logical CPU meshes, against the
port's one-device trainers and against the JAX package's trainers on a mesh
of the same shape.

A grid is one process over ``make_2d_mesh(n, device="cpu")``: n logical CPU
devices, the parameters placed by ``parallel/tensor_parallel.py``, the
batch's rows split over dp, the losses over the whole global batch. Widths
are ``tests/test_torch_train.py``'s: vocab 512, hidden 64, intermediate 128,
one layer, seq 16; the global batch is 4 rows (6 at dp 3), K 2 mined
negatives a pair or K 4 candidates a query.

Tolerances, and why:

- the grid against the one-device step, f32: the same f32 operations, with
  the MLP's second product summed over tp partial products and the gradient
  norm over shards, so in other orders: losses within rtol 1e-5, parameter
  deltas by ``test_torch_train.py``'s f32 rule (cosine >= 0.9999, at most 1%
  of entries off by more than 1e-6, the key biases left out). bf16: that
  file's bf16 rule (loss rtol 2e-2, the deltas' cosine >= 0.99 over the
  model and >= 0.9 a parameter): the partial products round to bf16 before
  their sum. A (1, 1) mesh is the one-device step: bit-equal;
- the grid against the reference's trainer on its mesh: in
  ``tests/test_torch_train_grid_reference.py``;
- the clip over shards against the clip over the whole gradients, the
  optimizer's update by device against one update, a checkpoint's round
  trip: within rtol 1e-6 where a norm is summed in another order, else
  bit-equal; a checkpoint written on a grid served by the reference's
  model: within 1e-5 (the same f32 model summed in other orders).

No test starts a subprocess or a process group or opens a port: the grid is
one process.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cqs_tpu.parallel.train as jtrain
from cqs_tpu.models import hybrid as jhybrid
from cqs_tpu.models.bert import BertConfig as JBertConfig
from cqs_tpu.models.bert import BertDenseEmbedder as JBert
from cqs_tpu.parallel import make_2d_mesh as j2d
from cqs_tpu_torch.models.convert import flax_leaf_to_torch
from cqs_tpu_torch.parallel import train as ttrain
from cqs_tpu_torch.parallel.mesh import Mesh, make_2d_mesh
from cqs_tpu_torch.parallel.tensor_parallel import TPGrid, param_sharding_spec
from test_torch_train import check_deltas, delta_report, f32_reference, flat, loss_rtol  # noqa: F401

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent
WIDTHS = dict(vocab_size=512, hidden_size=64, num_layers=1, num_heads=4,
              intermediate_size=128, seq_len=16)
L = 16
MESHES = [(1, 2), (1, 4), (1, 8), (2, 2), (3, 2)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def global_rows(dp: int) -> int:
    return 6 if dp == 3 else 4


def pair_batches(seed: int, steps: int, rows: int, negatives: bool):
    """(q_ids, q_mask, p_ids, p_mask[, n_ids, n_mask]) batches of ``rows``
    pairs (2 mined negatives a pair), row 1 of each side half padded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        arrs = []
        for shape in ((rows, L), (rows, L)) + (((rows, 2, L),) if negatives else ()):
            ids = rng.integers(4, WIDTHS["vocab_size"], size=shape).astype(np.int32)
            mask = np.ones(shape, np.int32)
            ids[..., 1, L // 2:] = 0
            mask[..., 1, L // 2:] = 0
            arrs += [ids, mask]
        out.append(arrs)
    return out


def distill_batches(seed: int, steps: int, rows: int, k: int = 4):
    """DistillBatcher-shaped batches of ``rows`` queries: the last lane of
    row 0 padded (one live token, teacher score -1e30, valid 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        q_ids = rng.integers(4, WIDTHS["vocab_size"], size=(rows, L)).astype(np.int32)
        d_ids = rng.integers(4, WIDTHS["vocab_size"], size=(rows, k, L)).astype(np.int32)
        d_mask = np.ones((rows, k, L), np.int32)
        t = rng.normal(0.5, 0.2, size=(rows, k)).astype(np.float32)
        valid = np.ones((rows, k), np.int32)
        d_ids[0, k - 1], d_mask[0, k - 1] = 0, 0
        d_mask[0, k - 1, 0] = 1
        t[0, k - 1], valid[0, k - 1] = -1e30, 0
        out.append([q_ids, np.ones((rows, L), np.int32), d_ids, d_mask, t, valid])
    return out


def batches(kind: str, seed: int, steps: int, rows: int):
    if kind == "distill":
        return distill_batches(seed, steps, rows)
    return pair_batches(seed, steps, rows, kind == "hard")


def step(trainer, kind: str, batch) -> tuple[float, float]:
    return (trainer.distill_step if kind == "distill" else trainer.train_step)(*batch)


def config(rows: int, dtype=torch.float32, **kw) -> ttrain.TrainConfig:
    return ttrain.TrainConfig(**{**WIDTHS, **kw}, batch_per_device=rows, dtype=dtype)


def grid_mesh(shape) -> Mesh:
    dp, tp = shape
    return make_2d_mesh(dp * tp, dp=dp, device="cpu")


def one_and_grid(kind: str, shape, dtype=torch.float32, seed: int = 0, **kw):
    """A one-device trainer and a grid trainer from the same seed, the
    grid's global batch the one-device trainer's."""
    dp = shape[0]
    cls = ttrain.DistillTrainer if kind == "distill" else ttrain.ContrastiveTrainer
    rows = global_rows(dp)
    one = cls(config(rows, dtype, **kw), seed, device=CPU)
    grid = cls(config(rows // dp, dtype, **kw), seed, mesh=grid_mesh(shape))
    assert grid.global_batch == one.global_batch == rows
    return one, grid


def same_tree(a, b) -> bool:
    fa, fb = flat(a), flat(b)
    return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


def flax_shapes(family: str, hidden: int, inter: int):
    jcfg = JBertConfig(vocab_size=512, hidden_size=hidden, num_layers=1, num_heads=4,
                       intermediate_size=inter, max_position=L)
    model = (JBert(jcfg, pooling="mean") if family == "bert"
             else jhybrid.HybridDenseEmbedder(jhybrid.HybridConfig(bert=jcfg)))
    d = jnp.zeros((1, L), jnp.int32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), d, jnp.ones_like(d))


#: (hidden, intermediate): tp divides both; I 132 (ff1 stays whole at tp 8,
#: ff2 splits on H); H 60 (the tables and ff2 stay whole at tp 8, ff1 splits)
ODD_WIDTHS = [(64, 128), (64, 132), (60, 128)]


@pytest.mark.parametrize("family", ["bert", "hybrid"])
@pytest.mark.parametrize("widths", ODD_WIDTHS, ids=["divisible", "i132", "h60"])
def test_placement_matches_the_reference(family, widths):
    """Every leaf's split dim (or none) is the reference's
    ``_param_sharding_spec`` on its mesh of the same tp, read through the
    ``[out, in]`` transposition; the grid holds each split leaf as tp shards
    of that dim, the rest in the module, every parameter once."""
    tree = flax_shapes(family, *widths)
    splits = 0
    for tp in (1, 2, 4, 8):
        mesh = j2d(tp)
        assert dict(mesh.shape) == {"dp": 1, "tp": tp}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = tuple(getattr(p, "key", p) for p in path)[1:]      # past "params"
            spec = tuple(jtrain._param_sharding_spec(path, leaf, mesh).spec)
            want = spec.index("tp") if "tp" in spec else None
            key, value = flax_leaf_to_torch(names, np.zeros(leaf.shape, np.float32))
            dim = param_sharding_spec(key, tuple(value.shape), tp)
            got = None if dim is None else (value.ndim - 1 - dim if names[-1] == "kernel" else dim)
            assert got == want, (tp, names, got, want)
            splits += want is not None
        cfg = config(1, family=family, hidden_size=widths[0], intermediate_size=widths[1])
        model = ttrain.build_model(cfg, CPU, 0)
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        grid = TPGrid(model, make_2d_mesh(tp, device="cpu"))
        for key, value in whole.items():
            dim = param_sharding_spec(key, tuple(value.shape), tp)
            if dim is None:
                assert key not in grid.shards and key in dict(model.named_parameters())
            else:
                assert grid.split[key] == dim and len(grid.shards[key]) == tp
                assert all(s.shape[dim] == value.shape[dim] // tp for s in grid.shards[key])
                assert key not in dict(model.named_parameters())
        assert sum(p.numel() for p in grid.parameters()) == sum(v.numel() for v in whole.values())
        got = grid.state_dict()
        assert list(got) == list(whole) and all(torch.equal(got[k], whole[k]) for k in whole)
    assert splits


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["in_batch", "hard", "distill"])
def test_grid_step_matches_one_device(kind, shape):
    one, grid = one_and_grid(kind, shape)
    before = one.params_tree()
    assert same_tree(before, grid.params_tree())          # the same init, bit for bit
    for batch in batches(kind, 3, 2, global_rows(shape[0])):
        lo, ao = step(one, kind, batch)
        lg, ag = step(grid, kind, batch)
        assert np.isfinite(lg) and lg == pytest.approx(lo, rel=1e-5), (lo, lg)
        assert ag == ao
    check_deltas(delta_report(before, one.params_tree(), grid.params_tree()), "f32")


@pytest.mark.parametrize("widths", ODD_WIDTHS[1:], ids=["i132", "h60"])
def test_grid_step_at_widths_tp_does_not_divide(widths):
    # the MLP's other placements: ff1 whole and ff2 split on H (I 132), ff1
    # split and ff2 whole (H 60), the tables whole at H 60
    one, grid = one_and_grid("hard", (1, 8), hidden_size=widths[0], intermediate_size=widths[1])
    before = one.params_tree()
    for batch in batches("hard", 4, 2, 4):
        lo, _ = step(one, "hard", batch)
        lg, _ = step(grid, "hard", batch)
        assert lg == pytest.approx(lo, rel=1e-5), (lo, lg)
    check_deltas(delta_report(before, one.params_tree(), grid.params_tree()), "f32")


def test_grid_step_in_bf16():
    one, grid = one_and_grid("hard", (2, 2), torch.bfloat16)
    before = one.params_tree()
    for batch in batches("hard", 5, 2, 4):
        lo, _ = step(one, "hard", batch)
        lg, _ = step(grid, "hard", batch)
        assert np.isfinite(lg) and lg == pytest.approx(lo, rel=loss_rtol("bf16")), (lo, lg)
    check_deltas(delta_report(before, one.params_tree(), grid.params_tree()), "bf16")


@pytest.mark.parametrize("kind", ["hard", "distill"])
def test_one_by_one_mesh_is_the_one_device_trainer(kind):
    cls = ttrain.DistillTrainer if kind == "distill" else ttrain.ContrastiveTrainer
    one = cls(config(4, torch.bfloat16), device=CPU)
    mesh = cls(config(4, torch.bfloat16), mesh=make_2d_mesh(1, device="cpu"))
    assert mesh.grid is None and mesh.device == one.device
    for batch in batches(kind, 6, 2, 4):
        assert step(mesh, kind, batch) == step(one, kind, batch)
    assert same_tree(one.params_tree(), mesh.params_tree())


def test_global_batch_and_jitted_step():
    tr = ttrain.ContrastiveTrainer(config(2), mesh=make_2d_mesh(6, device="cpu"))
    assert tr.mesh.shape == {"dp": 3, "tp": 2} and tr.global_batch == 6
    fn, args = tr.jitted_step()
    assert [a.shape for a in args] == [(6, L)] * 4
    before = [p.detach().clone() for p in tr.trainable()]
    out = fn(*args)
    assert len(out) == 4 and torch.isfinite(out[2])
    assert any(not torch.equal(a, b) for a, b in zip(before, tr.trainable()))


@pytest.mark.parametrize("kind", ["in_batch", "distill"])
def test_loss_contracts_the_global_batch(kind):
    """At (2, 2) the loss is the one-device loss of the whole global batch;
    each dp row's own negatives would train another objective, whose loss
    is a clear distance away."""
    one, grid = one_and_grid(kind, (2, 2))
    batch = batches(kind, 8, 1, 4)[0]
    loss = grid.distill_loss if kind == "distill" else grid.loss
    whole = one.distill_loss if kind == "distill" else one.loss
    with torch.no_grad():
        got, want = float(loss(*batch)[0]), float(whole(*batch)[0])
        local = np.mean([float(whole(*[a[r * 2:(r + 1) * 2] for a in batch])[0])
                         for r in range(2)])
    assert got == pytest.approx(want, rel=1e-5)
    assert abs(got - local) > 1e-2 * abs(want), (got, local)


def test_clip_over_shards_equals_the_whole(monkeypatch):
    _, tr = one_and_grid("distill", (1, 4))
    tr.distill_loss(*batches("distill", 9, 1, 4)[0])[0].backward()
    grads = [p.grad * 100 for p in tr.trainable()]             # well above the clip norm
    grid = tr.grid

    def whole_of(shards):
        out, i = [], 0
        for key in grid.keys:
            n = len(grid.shards[key]) if key in grid.shards else 1
            out.append(torch.cat(shards[i:i + n], grid.split[key]) if key in grid.shards
                       else shards[i].clone())
            i += n
        return out

    whole = whole_of(grads)
    norm_whole = ttrain.clip_by_global_norm_(whole, 1.0)
    norm_shards = ttrain.clip_by_global_norm_(grads, 1.0)
    assert norm_shards == pytest.approx(norm_whole, rel=1e-6) and norm_whole > 1.0
    for a, b in zip(whole_of(grads), whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    # over several devices, each device's sum of squares adds on the first
    grads = [torch.from_numpy(np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32))
             for _ in range(5)]
    want = float(ttrain.global_norm(grads))
    monkeypatch.setattr(ttrain, "by_device", lambda ts: [[0, 2, 4], [1, 3]])
    assert float(ttrain.global_norm(grads)) == pytest.approx(want, rel=1e-6)


def test_adamw_by_device_is_one_update():
    rng = np.random.default_rng(2)
    shapes = [(5, 3), (4,), (2, 2, 2), (6,)]
    values = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params = [[torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values] for _ in range(2)]
    opts = [ttrain.AdamW(p, 1e-2, clip_norm=1.0) for p in params]
    opts[1]._groups = [[0, 2], [1, 3]]                    # two devices' groups
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        for ps, opt in zip(params, opts):
            for p, g in zip(ps, grads):
                p.grad = torch.from_numpy(g.copy())
            opt.step()
    for a, b in zip(*params):
        assert torch.equal(a, b)


def test_hybrid_scales_stay_frozen_on_a_grid():
    tr = ttrain.ContrastiveTrainer(config(2, family="hybrid"), mesh=grid_mesh((2, 2)))
    assert all(p is not tr.model.scales for p in tr.trainable())
    tr.train_step(*batches("in_batch", 10, 1, 4)[0])
    assert tr.model.scales.detach().numpy().tobytes() == np.array([1.0, 0.3], np.float32).tobytes()
    assert tr.params_tree()["params"]["scales"].tobytes() == np.array([1.0, 0.3], np.float32).tobytes()


def test_grid_checkpoint_loads_in_one_device_and_the_reference():
    _, grid = one_and_grid("hard", (1, 4))
    grid.train_step(*batches("hard", 11, 1, 4)[0])
    tree = grid.params_tree()
    one = ttrain.ContrastiveTrainer(config(4), seed=5, device=CPU)
    one.load_params_tree(tree)
    assert same_tree(one.params_tree(), tree)
    ids, mask = batches("in_batch", 12, 1, 4)[0][:2]
    want = grid.encode(ids, mask)
    np.testing.assert_allclose(one.encode(ids, mask), want, rtol=0, atol=1e-5)
    jcfg = JBertConfig(**{k: v for k, v in WIDTHS.items() if k != "seq_len"}, max_position=L,
                       dtype=jnp.float32)
    got = np.asarray(JBert(jcfg, pooling="mean").apply(tree, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("family", ["bert", "hybrid"])
def test_load_params_tree_round_trips_on_a_grid(family):
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                  flax_shapes(family, 64, 128))
    tr = ttrain.DistillTrainer(config(2, family=family), mesh=grid_mesh((3, 2)))
    tr.load_params_tree(tree)
    assert same_tree(tr.params_tree(), tree)


def test_meshes_that_cannot_train_raise():
    with pytest.raises(ValueError, match="card"):
        Mesh([torch.device("cuda", 0)] * 2, ("dp", "tp"), (1, 2))
    with pytest.raises(ValueError, match="axes"):
        ttrain.ContrastiveTrainer(config(2), mesh=Mesh(["cpu", "cpu"]))
    with pytest.raises(ValueError, match="first device"):
        ttrain.ContrastiveTrainer(config(2), device=torch.device("cpu", 1),
                                  mesh=make_2d_mesh(2, device="cpu"))


def test_no_process_group_in_the_port():
    """The grid is one process: no module of the port, and not
    ``chip_smoke.py``, uses ``torch.distributed``."""
    sources = [p for p in (REPO / "cqs_tpu_torch").rglob("*.py") if "_build" not in p.parts]
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and node.attr == "distributed":
                raise AssertionError(f"{path}: torch.distributed")
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any("distributed" in n for n in names), path
