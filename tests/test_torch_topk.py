"""Scan top-k port: the plain twins of the two Pallas kernels against
``topk_pallas`` in interpret mode, ``topk_plain`` against ``topk_xla``, the
stable top-k tie order, and the kernel wrapper's argument checks.

Tolerances: values rtol 1e-5 (f32 sums taken in another order); rows exact
(the adversarial cases have exact scores, the random ones no near-ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cqs_tpu.ops.topk import topk_pallas, topk_xla
from cqs_tpu_torch.ops.fusion import NEG, stable_topk
from cqs_tpu_torch.ops.topk import (
    GROUPED, LOOP, check_kernel_args, merge_tiles, scan_topk, scan_topk_plain_grouped,
    scan_topk_plain_loop, topk_plain,
)

torch.set_num_threads(1)
RTOL = 1e-5


def _normed(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pallas(index, q, k, mask, tile, ptk=None, extraction="loop", bf16=False):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        v, r = topk_pallas(jnp.asarray(index, dt), jnp.asarray(q, dt), k,
                           jnp.asarray(mask), tile_n=tile, per_tile_k=ptk,
                           extraction=extraction)
    return np.asarray(v), np.asarray(r)


def _port(index, q, k, mask, tile, ptk=None, extraction="loop", bf16=False):
    dt = torch.bfloat16 if bf16 else torch.float32
    v, r = scan_topk(torch.from_numpy(index).to(dt), torch.from_numpy(q).to(dt), k,
                     torch.from_numpy(mask), tile_n=tile, per_tile_k=ptk,
                     extraction=extraction)
    return v.numpy(), r.numpy()


def _assert_same(port, ref):
    np.testing.assert_allclose(port[0], ref[0], rtol=RTOL)
    np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("extraction", ["loop", "grouped"])
@pytest.mark.parametrize("bf16", [False, True])
def test_matches_pallas_interpret(seeded_rng, extraction, bf16):
    # twin of test_ops TestTopkPallas.test_matches_xla, both extractions
    n, d, b, k, tile = 512, 32, 4, 8, 128
    index = _normed(seeded_rng, n, d)
    q = _normed(seeded_rng, b, d)
    mask = np.ones(n, np.int32)
    mask[100:110] = 0
    args = (index, q, k, mask, tile)
    _assert_same(_port(*args, extraction=extraction, bf16=bf16),
                 _pallas(*args, extraction=extraction, bf16=bf16))


@pytest.mark.parametrize("extraction", ["loop", "grouped"])
def test_every_tile_slot_matches(seeded_rng, extraction):
    # k = tiles * m exposes every per-tile slot through the stable merge,
    # including the NEG slots past a heavily masked tile's valid rows
    n, d, b, tile, m = 1024, 16, 3, 256, 6
    index = _normed(seeded_rng, n, d)
    q = _normed(seeded_rng, b, d)
    mask = np.ones(n, np.int32)
    mask[256:509] = 0                # tile 1 keeps 3 valid rows < m
    mask[768:1024] = 0               # tile 3 has none
    k = (n // tile) * m
    args = (index, q, k, mask, tile, m, extraction)
    _assert_same(_port(*args), _pallas(*args))


def test_grouped_gs1_matches_xla_exactly(seeded_rng):
    # tile 128: one row per group, so grouped equals the exact top-k
    n, d, b, k = 512, 32, 4, 8
    index = _normed(seeded_rng, n, d)
    q = _normed(seeded_rng, b, d)
    mask = np.ones(n, np.int32)
    mask[100:110] = 0
    pv, pi = _port(index, q, k, mask, 128, extraction="grouped")
    xv, xi = topk_xla(jnp.asarray(index), jnp.asarray(q), k, jnp.asarray(mask))
    np.testing.assert_allclose(pv, np.asarray(xv), rtol=RTOL)
    np.testing.assert_array_equal(pi, np.asarray(xi))


def test_grouped_spread_spikes_exact(seeded_rng):
    n, d, k = 1024, 16, 4
    index = seeded_rng.normal(size=(n, d)).astype(np.float32) * 1e-3
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    spikes = [3, 200, 650, 900]
    for rank, row in enumerate(spikes):
        index[row] = 0.0
        index[row, 0] = 10.0 - rank
    args = (index, q, k, np.ones(n, np.int32), 512, 2, "grouped")
    pv, pi = _port(*args)
    assert list(pi[0]) == spikes
    np.testing.assert_allclose(pv[0], [10.0, 9.0, 8.0, 7.0], rtol=1e-6)
    _assert_same((pv, pi), _pallas(*args))


def test_grouped_same_group_collision_keeps_better():
    n, d, k = 512, 8, 2
    index = np.zeros((n, d), np.float32)
    index[5, 0] = 10.0
    index[133, 0] = 9.0                    # same group as column 5
    index[300, 0] = 1.0
    q = np.zeros((1, d), np.float32)
    q[0, 0] = 1.0
    args = (index, q, k, np.ones(n, np.int32), 512, None, "grouped")
    pv, pi = _port(*args)
    assert list(pi[0]) == [5, 300]
    _assert_same((pv, pi), _pallas(*args))


@pytest.mark.parametrize("extraction", ["loop", "grouped"])
def test_heavy_mask(seeded_rng, extraction):
    n, d, b, k = 1024, 16, 2, 8
    index = _normed(seeded_rng, n, d)
    q = _normed(seeded_rng, b, d)
    mask = np.zeros(n, np.int32)
    keep = seeded_rng.choice(n, size=n // 20, replace=False)
    mask[keep] = 1
    port = _port(index, q, k, mask, 128, extraction=extraction)
    _assert_same(port, _pallas(index, q, k, mask, 128, extraction=extraction))
    valid = port[0] > -1e30
    assert valid.sum() > 0 and np.all(np.isin(port[1][valid], keep))


@pytest.mark.parametrize("extraction", ["loop", "grouped"])
def test_ties_go_to_lower_rows(extraction):
    # all rows score equally: loop keeps the lowest columns of each tile,
    # grouped the lowest lanes at offset 0
    n, d, tile, m = 512, 8, 256, 4
    index = np.tile(np.eye(d, dtype=np.float32)[0], (n, 1))
    q = np.eye(d, dtype=np.float32)[:1]
    args = (index, q, (n // tile) * m, np.ones(n, np.int32), tile, m, extraction)
    pv, pi = _port(*args)
    assert list(pi[0]) == [0, 1, 2, 3, 256, 257, 258, 259]
    _assert_same((pv, pi), _pallas(*args))


def test_plain_per_tile_layout(seeded_rng):
    # tile-major [tiles, B, m] outputs with global rows, as the kernels write
    n, d, b, tile, m = 512, 8, 2, 128, 3
    index = torch.from_numpy(_normed(seeded_rng, n, d))
    q = torch.from_numpy(_normed(seeded_rng, b, d))
    for fn in (scan_topk_plain_loop, scan_topk_plain_grouped):
        v, r = fn(index, q, None, tile, m)
        assert v.shape == (n // tile, b, m) and r.dtype == torch.int32
        assert torch.all(r // tile == torch.arange(n // tile)[:, None, None])
        merged = merge_tiles(v, r, 2 * n)        # pads past tiles * m
        assert merged[0].shape == (b, 2 * n)
        assert torch.all(merged[0][:, (n // tile) * m:] == NEG)


def test_topk_plain_matches_xla(seeded_rng):
    index = _normed(seeded_rng, 100, 16)
    q = _normed(seeded_rng, 3, 16)
    mask = np.ones(100, np.int32)
    mask[7] = 0
    pv, pi = topk_plain(torch.from_numpy(index), torch.from_numpy(q), 5,
                        torch.from_numpy(mask))
    xv, xi = topk_xla(jnp.asarray(index), jnp.asarray(q), 5, jnp.asarray(mask))
    np.testing.assert_allclose(pv.numpy(), np.asarray(xv), rtol=RTOL)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(xi))


def test_topk_plain_deterministic_ties():
    index = torch.from_numpy(np.tile(np.eye(4, dtype=np.float32)[0], (6, 1)))
    q = torch.from_numpy(np.eye(4, dtype=np.float32)[:1])
    _, idx = topk_plain(index, q, 3)
    assert idx[0].tolist() == [0, 1, 2]


def test_stable_topk_tie_order():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, NEG, NEG]])
    v, i = stable_topk(x, 6)
    assert i[0].tolist() == [1, 2, 4, 3, 0, 5]
    assert v[0, :3].tolist() == [3.0, 3.0, 3.0]


def _kargs(n=512, d=16, b=2, dtype=torch.bfloat16):
    return (torch.zeros(n, d, dtype=dtype), torch.zeros(b, d, dtype=dtype),
            torch.ones(n, dtype=torch.int32))


@pytest.mark.parametrize("bad", [
    dict(dtype=torch.float32),                 # kernels take bf16 only
    dict(d=12),                                # not a multiple of 8
    dict(d=4104),                              # wider than 4096
    dict(n=500),                               # rows do not tile
])
def test_kernel_args_rejected(bad):
    n, d = bad.get("n", 512), bad.get("d", 16)
    index, q, mask = _kargs(n, d, dtype=bad.get("dtype", torch.bfloat16))
    with pytest.raises((TypeError, ValueError)):
        check_kernel_args(index, q, mask, 128, 4, grouped=False)


def test_kernel_args_grouped_limits():
    index, q, mask = _kargs()
    check_kernel_args(index, q, mask, 128, 4, grouped=True)
    with pytest.raises(ValueError):
        check_kernel_args(index, q, mask, 128, 129, grouped=True)
    with pytest.raises(ValueError):
        check_kernel_args(index, q, mask, 96, 4, grouped=True)


def test_wrapper_raises_on_cpu_tensor_and_bad_shapes():
    index, q, mask = _kargs()
    for kernel in (LOOP, GROUPED):
        with pytest.raises(ValueError):
            kernel(index, q, mask, 128, 4)
        assert kernel.launches == 0
    with pytest.raises(ValueError):
        scan_topk(index[:500], q, 4, tile_n=128)
    with pytest.raises(ValueError):
        scan_topk(index, q, 4, tile_n=128, per_tile_k=200, extraction="grouped")
