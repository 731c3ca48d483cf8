"""The port's trainers against the JAX package's, step by step, on the CPU.

The reference's own classes (``cqs_tpu/parallel/train.py``) run on a one-device
mesh (``make_2d_mesh(1)``); their initial parameters are carried into the
port (``models/convert.py::params_from_flax``) and both take the same numpy
batches. Widths are small: vocab 512, hidden 64, one layer, seq 16, B 4,
K 4.

Tolerances, and why:

- f32 (the reference's ``BertConfig`` monkeypatched to ``dtype=float32``; the
  port's ``TrainConfig.dtype`` f32): the same f32 operations summed in other
  orders, so losses agree within rtol 1e-5 at every step. Parameter deltas
  (after - before) are compared by cosine (>= 0.9999) and by the share of
  entries off by more than 1e-6 (<= 1%), not elementwise: Adam's first steps
  are sign-like (``m / sqrt(v)`` is +-1 for a lone gradient), so a gradient
  near zero whose last bit differs moves its weight by a whole lr (1e-4 to
  1e-3) the other way. The key biases are left out: their true gradient
  is 0 (the softmax ignores a shift of a query's logits), so both deltas are
  that noise.
- bf16 (both packages' default compute dtype, f32 master parameters): the two
  frameworks round bf16 products and sums at other places (XLA's CPU dot
  against PyTorch's), so a step's loss agrees within rtol 2e-2, the deltas
  over the whole model by cosine >= 0.99 and each parameter's by cosine >=
  0.9 (the loosest, 0.92 measured, is a 64-entry MLP output bias whose
  entries take Adam's sign-like first steps from near-zero gradients).
- The optimizer pieces against optax on random tensors: ``clip_by_global_norm``
  within rtol 1e-6 (the norm is summed in another order), the warmup-cosine
  schedule within rtol 1e-6 (optax evaluates it in f32), AdamW over 5 steps
  within 2 f32 ulps, rtol 2.4e-7 (f32 elementwise arithmetic in the same
  order; powf for the bias corrections). ``torch.optim.AdamW(weight_decay=1e-4)`` is the same
  formula rearranged: within atol 1e-6 of optax.
- ``param_dtype``: the same f32 parameters held in f32 (cast at use) and in
  bf16 give bit-equal forwards.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cqs_tpu.parallel.train as jtrain
from cqs_tpu.models.bert import BertConfig as JBertConfig
from cqs_tpu.models.bert import CrossEncoder as JCrossEncoder
from cqs_tpu.models.hybrid import hash_table as j_hash_table
from cqs_tpu.parallel import make_2d_mesh
from cqs_tpu_torch.models import bert as tbert
from cqs_tpu_torch.models.convert import flax_tree_from_torch, params_from_flax
from cqs_tpu_torch.models.layers import init_module
from cqs_tpu_torch.parallel import train as ttrain

CPU = torch.device("cpu")
SMALL = dict(vocab_size=512, hidden_size=64, num_layers=1, num_heads=4,
             intermediate_size=128, seq_len=16, batch_per_device=4)
B, L, K = 4, 16, 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_reference(monkeypatch):
    """The reference's trainers build their models in f32 (pytest restores
    the class afterwards)."""
    monkeypatch.setattr(jtrain, "BertConfig", functools.partial(JBertConfig, dtype=jnp.float32))


def pair_batches(seed: int, steps: int, negatives: bool):
    """``steps`` batches of (q_ids, q_mask, p_ids, p_mask[, n_ids, n_mask]),
    one row of each side padded."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        arrs = []
        for shape in ((B, L), (B, L)) + (((B, 2, L),) if negatives else ()):
            ids = rng.integers(4, SMALL["vocab_size"], size=shape).astype(np.int32)
            mask = np.ones(shape, np.int32)
            ids[..., 1, L // 2:] = 0
            mask[..., 1, L // 2:] = 0
            arrs += [ids, mask]
        out.append(arrs)
    return out


def distill_batches(seed: int, steps: int):
    """DistillBatcher-shaped batches: K candidates a query, the last lane of
    row 0 padded (one live token, teacher score -1e30, valid 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        q_ids = rng.integers(4, SMALL["vocab_size"], size=(B, L)).astype(np.int32)
        q_mask = np.ones((B, L), np.int32)
        d_ids = rng.integers(4, SMALL["vocab_size"], size=(B, K, L)).astype(np.int32)
        d_mask = np.ones((B, K, L), np.int32)
        t = rng.normal(0.5, 0.2, size=(B, K)).astype(np.float32)
        valid = np.ones((B, K), np.int32)
        d_ids[0, K - 1], d_mask[0, K - 1] = 0, 0
        d_mask[0, K - 1, 0] = 1
        t[0, K - 1], valid[0, K - 1] = -1e30, 0
        out.append([q_ids, q_mask, d_ids, d_mask, t, valid])
    return out


def flat(tree) -> dict:
    """A Flax tree -> {"params/a/b": float64 array}."""
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def delta_report(before, ref_after, port_after) -> dict:
    """Per parameter: (cosine of the two deltas, share of entries whose
    deltas differ by more than 1e-6); ``"_all"`` over the whole model."""
    b, r, p = flat(before), flat(ref_after), flat(port_after)
    assert b.keys() == r.keys() == p.keys()
    out = {}
    dr_all, dp_all = [], []
    for k in b:
        dr, dp = (r[k] - b[k]).ravel(), (p[k] - b[k]).ravel()
        dr_all.append(dr)
        dp_all.append(dp)
        cos = 1.0 if np.array_equal(dr, dp) else float(
            dr @ dp / max(np.linalg.norm(dr) * np.linalg.norm(dp), 1e-30))
        out[k] = (cos, float(np.mean(np.abs(dr - dp) > 1e-6)))
    dr, dp = np.concatenate(dr_all), np.concatenate(dp_all)
    out["_all"] = (float(dr @ dp / (np.linalg.norm(dr) * np.linalg.norm(dp))),
                   float(np.mean(np.abs(dr - dp) > 1e-6)))
    return out


def check_deltas(report: dict, dtype: str) -> None:
    for name, (cos, off) in report.items():
        if name.endswith("/k/bias"):
            # the key bias adds q.b to every logit of a query's row, which the
            # softmax ignores: its gradient is exactly zero, and both deltas
            # are rounding noise that Adam scales up to +-lr
            continue
        if dtype == "f32":
            assert cos >= 0.9999 and off <= 0.01, (name, cos, off)
        elif name == "_all":
            assert cos >= 0.99, (name, cos)
        else:
            assert cos >= 0.9, (name, cos)


def trainers(kind: str, dtype: str, **cfg):
    """(reference trainer, port trainer) from the reference's initial
    parameters; ``kind`` contrastive or distill."""
    jcls = jtrain.DistillTrainer if kind == "distill" else jtrain.ContrastiveTrainer
    tcls = ttrain.DistillTrainer if kind == "distill" else ttrain.ContrastiveTrainer
    ref = jcls(make_2d_mesh(1), jtrain.TrainConfig(**{**SMALL, **cfg}), seed=0)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    port = tcls(ttrain.TrainConfig(**{**SMALL, **cfg}, dtype=tdt), seed=1, device=CPU)
    port.load_params_tree(jax.device_get(ref.params))
    if cfg.get("family") == "hybrid":
        table = np.asarray(j_hash_table(SMALL["vocab_size"], 256, 0))
        port.model.table.copy_(torch.from_numpy(table))
    return ref, port


def loss_rtol(dtype: str) -> float:
    return 1e-5 if dtype == "f32" else 2e-2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hard", [False, True], ids=["in_batch", "hard_negatives"])
def test_contrastive_steps_match_the_reference(request, dtype, hard):
    if dtype == "f32":
        request.getfixturevalue("f32_reference")
    ref, port = trainers("contrastive", dtype)
    before = jax.device_get(ref.params)
    for batch in pair_batches(3, 3, hard):
        jl, ja = ref.train_step(*batch)
        tl, ta = port.train_step(*batch)
        assert np.isfinite(tl)
        assert tl == pytest.approx(jl, rel=loss_rtol(dtype)), (jl, tl)
        if dtype == "f32":
            assert ta == ja
    check_deltas(delta_report(before, jax.device_get(ref.params), port.params_tree()), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_distill_steps_match_the_reference(request, dtype):
    if dtype == "f32":
        request.getfixturevalue("f32_reference")
    ref, port = trainers("distill", dtype)
    before = jax.device_get(ref.params)
    for batch in distill_batches(5, 3):
        jl, ja = ref.distill_step(*batch)
        tl, ta = port.distill_step(*batch)
        assert np.isfinite(tl)
        assert tl == pytest.approx(jl, rel=loss_rtol(dtype)), (jl, tl)
        if dtype == "f32":
            assert ta == ja
    check_deltas(delta_report(before, jax.device_get(ref.params), port.params_tree()), dtype)


def test_hybrid_scales_stay_frozen_where_the_reference_moves_them(f32_reference):
    """The reference masks the scales with ``optax.masked``, which hands a
    masked leaf its raw gradient as the update: after one step its scales are
    init + gradient. The port leaves them out of the optimizer: they stay at
    [1.0, 0.3], and every other parameter agrees with the reference."""
    ref, port = trainers("contrastive", "f32", family="hybrid")
    before = jax.device_get(ref.params)
    batch = pair_batches(7, 1, False)[0]
    # the scales' raw gradient at the initial parameters, from a second port
    # model whose scales take a gradient (the f32 forwards agree to 1e-5)
    _, probe = trainers("contrastive", "f32", family="hybrid")
    probe.model.scales.requires_grad_(True)
    probe.loss(*batch)[0].backward()
    grad = probe.model.scales.grad.numpy()
    jl, _ = ref.train_step(*batch)
    tl, _ = port.train_step(*batch)
    assert tl == pytest.approx(jl, rel=1e-5)
    ref_scales = np.asarray(ref.params["params"]["scales"])
    assert np.abs(grad).max() > 1e-4
    np.testing.assert_allclose(ref_scales, np.array([1.0, 0.3], np.float32) + grad, rtol=1e-4)
    assert port.model.scales.detach().numpy().tobytes() == np.array([1.0, 0.3], np.float32).tobytes()
    report = delta_report(before, jax.device_get(ref.params), port.params_tree())
    report.pop("params/scales")
    report.pop("_all")
    check_deltas(report, "f32")


def test_distilled_hybrid_trains_its_scales():
    # the reference's DistillTrainer swaps in chain(clip, adamw) over every
    # parameter, so a distilled hybrid moves its scales; so does the port's
    port = ttrain.DistillTrainer(ttrain.TrainConfig(**SMALL, family="hybrid",
                                                    dtype=torch.float32), device=CPU)
    port.distill_step(*distill_batches(9, 1)[0])
    assert port.model.scales.detach().tolist() != pytest.approx([1.0, 0.3], abs=1e-7)


def random_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32),
                  "d": rng.normal(size=(3, 2, 4)).astype(np.float32)}}


def leaves(tree) -> list[np.ndarray]:
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    tree = jax.tree_util.tree_map(lambda x: x * scale, random_tree(0))
    want, _ = optax.clip_by_global_norm(1.0).update(tree, optax.EmptyState())
    grads = [torch.from_numpy(x.copy()) for x in leaves(tree)]
    norm = ttrain.clip_by_global_norm_(grads, 1.0)
    assert norm == pytest.approx(float(optax.global_norm(tree)), rel=1e-6)
    for g, w in zip(grads, leaves(want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
    if scale < 1:                       # below the norm: untouched
        for g, x in zip(grads, leaves(tree)):
            assert np.array_equal(g.numpy(), x)


def test_warmup_cosine_matches_optax():
    steps = 200
    warm, decay = max(10, steps // 10), max(steps, 20)
    want = optax.warmup_cosine_decay_schedule(0.0, 5e-4, warmup_steps=warm, decay_steps=decay)
    got = ttrain.warmup_cosine(5e-4, warm, decay)
    assert got(0) == 0.0 and float(want(0)) == 0.0       # the first update is 0
    for count in (0, 1, warm - 1, warm, warm + 1, decay // 2, decay - 1, decay, decay + 7):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=5e-10), count


@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_adamw_matches_optax_over_five_steps(lr):
    rng = np.random.default_rng(4)
    params = random_tree(1)
    sched = ttrain.warmup_cosine(1e-2, 2, 6)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        1e-2 if lr == "constant" else optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)))
    state = tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves(params)]
    opt = ttrain.AdamW(tp, 1e-2 if lr == "constant" else sched, clip_norm=1.0)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(tp, leaves(grads)):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        assert all(p.grad is None for p in tp)
        for p, w in zip(tp, leaves(params)):
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=2.4e-7, atol=1e-9)


def test_torch_adamw_is_the_same_formula():
    rng = np.random.default_rng(2)
    params = random_tree(3)
    tx = optax.adamw(1e-3)
    state = tx.init(params)
    tp = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves(params)]
    opt = torch.optim.AdamW(tp, lr=1e-3, weight_decay=1e-4, eps=1e-8, betas=(0.9, 0.999))
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                       params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(tp, leaves(grads)):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    for p, w in zip(tp, leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-6)


def test_padded_lane_leaves_every_gradient_finite():
    port = ttrain.DistillTrainer(ttrain.TrainConfig(**SMALL), device=CPU)
    batch = distill_batches(11, 1)[0]
    batch[4][1, :2] = -1e30                      # a second row with two padded lanes
    batch[5][1, :2] = 0
    batch[3][1, :2] = 0
    batch[3][1, :2, 0] = 1
    loss, agree = port.distill_loss(*batch)
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in port.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_reranker_steps_match_the_reference():
    """Three steps of the reference's ``cmd_train_reranker`` step (copied
    from ``cqs_tpu/cli/commands.py``: chain(clip, adamw(warmup-cosine))) in
    f32 against :class:`RerankerTrainer`: the first update is 0 (lr 0)."""
    cfg = JBertConfig(vocab_size=512, hidden_size=64, num_layers=1, num_heads=4,
                      intermediate_size=128, max_position=24, dtype=jnp.float32)
    model = JCrossEncoder(cfg)
    d = jnp.zeros((1, 16), dtype=jnp.int32)
    params = model.init(jax.random.PRNGKey(0), d, jnp.ones_like(d), d)
    steps = 3
    sched = optax.warmup_cosine_decay_schedule(0.0, 5e-4, warmup_steps=max(10, steps // 10),
                                               decay_steps=max(steps, 20))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched))
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, pi, pm, pt, ni, nm, nt):
        def loss_fn(params):
            sp = model.apply(params, pi, pm, pt)
            sn = model.apply(params, ni, nm, nt)
            return jax.nn.softplus(sn - sp).mean(), (sp > sn).mean()
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss, acc

    tcfg = tbert.BertConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                               if f.name != "dtype"}, dtype=torch.float32)
    port = ttrain.RerankerTrainer(tcfg, steps, lr=5e-4, device=CPU)
    port.load_params_tree(jax.device_get(params))
    rng = np.random.default_rng(6)
    before = jax.device_get(params)
    for s in range(steps):
        arrs = [rng.integers(4, 512, size=(4, 24)).astype(np.int32),
                np.ones((4, 24), np.int32), (np.arange(24)[None, :] >= 10).repeat(4, 0)
                .astype(np.int32)] * 2
        arrs[3] = rng.integers(4, 512, size=(4, 24)).astype(np.int32)
        params, opt, jl, _ = step(params, opt, *map(jnp.asarray, arrs))
        tl, _ = port.train_step(*arrs)
        assert tl == pytest.approx(float(jl), rel=1e-5)
        if s == 0:       # lr 0: only the moments moved
            for k, v in flat(port.params_tree()).items():
                assert np.array_equal(v, flat(before)[k]), k
    check_deltas(delta_report(before, jax.device_get(params), port.params_tree()), "f32")


def bert_module(dtype, param_dtype, seed: int = 0):
    cfg = tbert.BertConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                           intermediate_size=128, max_position=16, dtype=dtype,
                           param_dtype=param_dtype)
    return init_module(tbert.BertDenseEmbedder(cfg, pooling="mean"), seed), cfg


def test_param_dtype_forward_is_bit_equal():
    master, cfg = bert_module(torch.bfloat16, torch.float32)
    held, _ = bert_module(torch.bfloat16, None, seed=5)
    with torch.no_grad():
        master.load_state_dict(params_from_flax(flax_tree_from_torch(master.state_dict(), cfg)))
        held.load_state_dict(master.state_dict())          # cast to bf16 on load
    assert held.encoder.layer_0.q.weight.dtype == torch.bfloat16
    assert master.encoder.layer_0.q.weight.dtype == torch.float32
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(4, 512, size=(3, 16)))
    mask = torch.ones(3, 16, dtype=torch.int32)
    mask[1, 9:] = 0
    with torch.no_grad():
        a, b = master(ids, mask), held(ids, mask)
    assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["bert", "hybrid", "cross", "gemma"])
def test_flax_tree_round_trip(family):
    """``flax_tree_from_torch`` inverts ``params_from_flax``, and its shapes
    are the reference's Flax shapes."""
    from cqs_tpu.models import gemma as jgemma
    from cqs_tpu.models import hybrid as jhybrid
    from cqs_tpu.models.bert import BertDenseEmbedder as JBert
    from cqs_tpu_torch.models import gemma as tgemma
    from cqs_tpu_torch.models import hybrid as thybrid

    if family == "gemma":
        jcfg = jgemma.GemmaConfig.small_test(vocab_size=256)
        tcfg = dataclasses.replace(tgemma.GemmaConfig.small_test(vocab_size=256),
                                   dtype=torch.float32)
        jm = jgemma.GemmaEmbedder(jcfg)
        factory = lambda: tgemma.GemmaEmbedder(tcfg)             # noqa: E731
    else:
        jcfg = JBertConfig(vocab_size=256, hidden_size=32, num_layers=1, num_heads=4,
                           intermediate_size=64, max_position=16)
        tcfg = tbert.BertConfig(vocab_size=256, hidden_size=32, num_layers=1, num_heads=4,
                                intermediate_size=64, max_position=16, dtype=torch.float32)
        jm, factory = {
            "bert": (JBert(jcfg, pooling="mean"), lambda: tbert.BertDenseEmbedder(tcfg)),
            "hybrid": (jhybrid.HybridDenseEmbedder(jhybrid.HybridConfig(bert=jcfg)),
                       lambda: thybrid.HybridDenseEmbedder(thybrid.HybridConfig(bert=tcfg))),
            "cross": (JCrossEncoder(jcfg), lambda: tbert.CrossEncoder(tcfg)),
        }[family]
    d = jnp.zeros((1, 8), jnp.int32)
    args = (d, jnp.ones_like(d), d) if family == "cross" else (d, jnp.ones_like(d))
    rng = np.random.default_rng(0)
    # the reference's tree structure and shapes (traced, not run), random values
    tree = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32),
                                  jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args))
    module = factory()
    with torch.no_grad():
        module.load_state_dict(params_from_flax(tree))
    back = flax_tree_from_torch(module.state_dict(), tcfg)
    want, got = flat(tree), flat(back)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].shape == got[k].shape and np.array_equal(want[k], got[k]), k


def test_trainers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.ContrastiveTrainer(ttrain.TrainConfig(**SMALL))


def test_fresh_init_has_flax_distributions():
    """A fresh trainer's parameters are drawn from Flax's distributions (not
    its bits): per parameter, stds within 25% and means within 5 standard
    errors of their difference (the smallest table has 128 entries);
    embedding tables have std sqrt(1 / features), not sqrt(1 / rows), 3-90x
    apart at these shapes; kernels truncated lecun normal; biases 0, norms
    1, exactly."""
    ref = jtrain.ContrastiveTrainer(make_2d_mesh(1), jtrain.TrainConfig(**SMALL))
    port = ttrain.ContrastiveTrainer(ttrain.TrainConfig(**SMALL), device=CPU)
    want, got = flat(jax.device_get(ref.params)), flat(port.params_tree())
    assert want.keys() == got.keys()
    for k in want:
        w, g = want[k], got[k]
        assert w.shape == g.shape, k
        if w.std() == 0:
            assert np.array_equal(w, g), k
            continue
        assert abs(g.std() / w.std() - 1) < 0.25, (k, g.std(), w.std())
        assert abs(g.mean() - w.mean()) < 5 * w.std() * np.sqrt(2 / w.size), k
