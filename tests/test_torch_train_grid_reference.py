"""The port's (dp, tp) training grid against the JAX package's trainers on
a mesh of the same shape, on the CPU: the reference's ``make_2d_mesh(8)``
(1, 8), ``make_2d_mesh(6)`` (3, 2) and ``make_2d_mesh(4, dp=2)`` (2, 2) over
its virtual CPU devices, the port's ``make_2d_mesh`` of the same arguments
over logical CPU devices, from the reference's initial parameters
(``load_params_tree``), two steps on the same batches.

Tolerance: ``tests/test_torch_train.py``'s f32 rule (the reference's
``BertConfig`` in f32): losses within rtol 1e-5, parameter deltas by cosine
>= 0.9999 with at most 1% of entries off by more than 1e-6, the key biases
left out; the same f32 model summed in other orders, and split otherwise.
Apart from ``tests/test_torch_train_grid.py`` because the reference's
compiles take most of the time."""

import jax
import pytest

import cqs_tpu.parallel.train as jtrain
from cqs_tpu.parallel import make_2d_mesh as j2d
from cqs_tpu_torch.parallel import train as ttrain
from cqs_tpu_torch.parallel.mesh import make_2d_mesh
from test_torch_train import check_deltas, delta_report, f32_reference  # noqa: F401
from test_torch_train_grid import WIDTHS, batches, config, one_thread, step  # noqa: F401


#: (kind, the reference's mesh, rows a dp row)
REFERENCE_GRIDS = [("hard", (8, None), 4), ("distill", (6, None), 2), ("in_batch", (4, 2), 2)]


@pytest.mark.parametrize("kind,mesh_args,rows", REFERENCE_GRIDS,
                         ids=["1x8-hard", "3x2-distill", "2x2-in_batch"])
def test_grid_matches_the_reference_on_its_mesh(f32_reference, kind, mesh_args, rows):
    n, dp = mesh_args
    jmesh = j2d(n, dp=dp)
    pmesh = make_2d_mesh(n, dp=dp, device="cpu")
    assert pmesh.shape == dict(jmesh.shape)
    jcls = jtrain.DistillTrainer if kind == "distill" else jtrain.ContrastiveTrainer
    tcls = ttrain.DistillTrainer if kind == "distill" else ttrain.ContrastiveTrainer
    ref = jcls(jmesh, jtrain.TrainConfig(**WIDTHS, batch_per_device=rows), seed=0)
    port = tcls(config(rows), seed=1, mesh=pmesh)
    assert port.global_batch == ref.global_batch
    port.load_params_tree(jax.device_get(ref.params))
    before = jax.device_get(ref.params)
    for batch in batches(kind, 7, 2, ref.global_batch):
        jl, ja = step(ref, kind, batch)
        tl, ta = step(port, kind, batch)
        assert tl == pytest.approx(jl, rel=1e-5), (jl, tl)
        assert ta == ja
    check_deltas(delta_report(before, jax.device_get(ref.params), port.params_tree()), "f32")
