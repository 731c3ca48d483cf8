"""The split loop kernel (``csrc/scan_loop_mma.cu``) on the CPU: its
algorithm in plain PyTorch (:func:`scan_topk_plain_loop_split`) and a numpy
emulation of its device steps (64-bit keys, the bitonic runs, the pairwise
reductions and the slice merge, with the kernel's own index arithmetic),
each held slot for slot against the loop twin ``scan_topk_plain_loop`` and
against ``topk_pallas(..., extraction="loop")`` in interpret mode; then the
routing of every main-path shape.

Tolerance: none. The inputs are int8 (exact integer sums) or integer-valued
bf16 (exact in f32 in any order), so values and rows must be equal; the
interpret-mode comparison on random unit rows takes values at rtol 1e-5
(f32 sums in another order) and rows exact, as test_torch_topk does."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cqs_tpu.ops.topk import topk_pallas
from cqs_tpu_torch.ops.fusion import NEG, stable_topk
from cqs_tpu_torch.ops.topk import (
    IMPLS, KERNELS, LOOP, LOOP_CC, LOOP_I8, LOOP_I8_CC, LOOP_I8W, LOOP_SPLIT, LOOP_SPLIT_I8,
    SPLIT_MAX_M, SPLIT_MAX_QUERY_BLOCK, SPLIT_MAX_SLICES, SPLIT_NARROW_M,
    SPLIT_WIDE_M_QUERY_BLOCK, SplitScanKernel, _scores, _tile_major, _tile_scores, loop_impl,
    merge_tiles, scan_topk, scan_topk_plain_loop, shard_geometry, split_query_block,
    split_slices,
)
from cqs_tpu_torch.search.engine import bf16_extraction
from cqs_tpu_torch.search.program import _screen_tile, scan_geometry

torch.set_num_threads(1)
SUB = 128


def _inputs(rng, n, d, b, kind, masked=0.02):
    if kind == "i8":
        index = torch.from_numpy(rng.integers(-128, 128, size=(n, d)).astype(np.int8))
        q = torch.from_numpy(rng.integers(-128, 128, size=(b, d)).astype(np.int8))
    else:
        index = torch.from_numpy(rng.integers(-8, 9, size=(n, d)).astype(np.float32)).bfloat16()
        q = torch.from_numpy(rng.integers(-3, 4, size=(b, d)).astype(np.float32)).bfloat16()
    mask = torch.from_numpy((rng.random(n) >= masked).astype(np.int32))
    return index, q, mask


def _assert_equal(got, ref):
    assert torch.equal(got[0], ref[0]), "values differ"
    assert torch.equal(got[1], ref[1]), "rows differ"


def scan_topk_plain_loop_split(index: torch.Tensor, queries: torch.Tensor,
                               mask: torch.Tensor | None, tile_n: int, m: int,
                               slice_n: int):
    """The split loop kernel's algorithm in plain PyTorch: each slice of
    ``slice_n`` rows (dividing ``tile_n``) keeps its exact top-min(m,
    slice_n) (descending, ties to the lower row), then each tile's slice
    lists merge into its m slots, and the slots that end on NEG take the
    tile's first row. Equal to :func:`scan_topk_plain_loop` slot for slot;
    tile-major outputs as it."""
    if tile_n % slice_n:
        raise ValueError(f"slice {slice_n} does not divide tile {tile_n}")
    s = _tile_scores(index, queries, mask, tile_n)
    b, t, _ = s.shape
    per = s.view(b, t, tile_n // slice_n, slice_n)
    v, col = stable_topk(per, min(m, slice_n))          # [B, T, P, m'] per slice
    col = col + torch.arange(tile_n // slice_n, device=s.device)[None, None, :, None] * slice_n
    # the slices' lists in slice order: a stable top-m keeps the lower row on ties
    v, pos = stable_topk(v.reshape(b, t, -1), m)
    col = col.reshape(b, t, -1).gather(2, pos)
    col = torch.where(v <= NEG / 2, torch.zeros_like(col), col)
    base = torch.arange(t, device=s.device)[None, :, None] * tile_n
    return _tile_major(v, col + base)


# -- a numpy emulation of the kernel's device steps ------------------------------

def _keys(v, rows):
    """make_key: monotone score bits (-0 folded into +0) over ~row."""
    b = (v.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    o = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000)).astype(np.uint64)
    return (o << np.uint64(32)) | (~rows.astype(np.uint32)).astype(np.uint64)


def _key_val(k):
    o = (k >> np.uint64(32)).astype(np.uint32)
    return np.where(o & np.uint32(0x80000000), o & np.uint32(0x7FFFFFFF), ~o).view(np.float32)


def _key_row(k):
    return (~(k & np.uint64(0xFFFFFFFF)).astype(np.uint32)).view(np.int32)


def _ce_lo(c, j):
    return ((c & ~(j - 1)) << 1) | (c & (j - 1))


def _ce_desc(a, i, l):
    x, y = a[:, i].copy(), a[:, l].copy()
    a[:, i], a[:, l] = np.maximum(x, y), np.minimum(x, y)


def _sort_runs(a, lg):
    n, L = a.shape[1], 1 << lg
    c = np.arange(n // 2)
    k = 2
    while k <= L:
        j = k >> 1
        while j > 0:
            i = _ce_lo(c, j)
            x, y = a[:, i].copy(), a[:, i + j].copy()
            desc = (k == L) | ((i & k) == 0)
            swap = np.where(desc, x < y, x > y)
            a[:, i], a[:, i + j] = np.where(swap, y, x), np.where(swap, x, y)
            j >>= 1
        k <<= 1


def _clean(a, starts, lg):
    half = (1 << lg) >> 1
    j = half
    while j > 0:
        c = np.arange(len(starts) * half)
        i = starts[c // half] + _ce_lo(c % half, j)
        _ce_desc(a, i, i + j)
        j >>= 1


def _reduce_runs(a, nruns, lg):
    L, sb = 1 << lg, 1
    while sb < nruns:
        starts = np.arange(nruns // (2 * sb)) * 2 * sb * L
        e = np.arange(len(starts) * L)
        i, base = e & (L - 1), starts[e >> lg]
        a[:, base + i] = np.maximum(a[:, base + i], a[:, base + sb * L + L - 1 - i])
        _clean(a, starts, lg)
        sb <<= 1


def _merge_top(lst, nw, lg):
    L = 1 << lg
    lst[:, :L] = np.maximum(lst[:, :L], nw[:, L - 1 - np.arange(L)])
    _clean(lst, np.array([0]), lg)


def _merge_short(lst, nw, lg, lb):
    L, n = 1 << lg, 1 << lb
    tail = lst[:, L - n:]                         # a view: written in place
    tail[:] = np.maximum(tail, nw[:, n - 1 - np.arange(n)])
    flipped = tail[:, ::-1].copy()                # clean ascending = descending, reversed
    _clean(flipped, np.array([0]), lb)
    tail[:] = flipped[:, ::-1]
    _clean(lst, np.array([0]), lg)


def _emulate(scores, tile_n, m, slices):
    """loop_split_kernel + merge_slices_kernel on a [B, N] f32 score matrix
    (masked rows already NEG). Returns tile-major (vals, rows)."""
    lg = max(0, int(np.ceil(np.log2(m))))
    L = 1 << lg
    bsz, n = scores.shape
    tiles, rows_per = n // tile_n, tile_n // slices
    out_v = np.empty((tiles, bsz, m), np.float32)
    out_i = np.empty((tiles, bsz, m), np.int32)
    for t in range(tiles):
        parts = []
        for p in range(slices):
            lst = np.zeros((bsz, L), np.uint64)
            for s in range(rows_per // SUB):
                rows = t * tile_n + p * rows_per + s * SUB + np.arange(SUB)
                keys = _keys(scores[:, rows], np.broadcast_to(rows, (bsz, SUB)))
                enter = keys > lst[:, m - 1:m]
                c = enter.sum(axis=1)
                if not c.any():
                    continue                          # no key enters any list
                # the candidates packed in order, padded with empty keys to a
                # power of two, the same for every query
                lb = int(np.ceil(np.log2(c.max())))
                nw = np.zeros((bsz, 1 << lb), np.uint64)
                for qi in range(bsz):
                    nw[qi, :c[qi]] = keys[qi, enter[qi]]
                if lb >= lg:
                    _sort_runs(nw, lg)
                    _reduce_runs(nw, 1 << (lb - lg), lg)
                    _merge_top(lst, nw, lg)
                else:
                    _sort_runs(nw, lb)
                    _merge_short(lst, nw, lg, lb)
            parts.append(lst[:, :m])
        if slices == 1:
            final = parts[0]
        else:
            a = np.zeros((bsz, slices * L), np.uint64)
            for p, part in enumerate(parts):
                a[:, p * L:p * L + m] = part
            _reduce_runs(a, slices, lg)
            final = a[:, :m]
        v = _key_val(final)
        out_v[t] = v
        out_i[t] = np.where(v <= NEG / 2, t * tile_n, _key_row(final))
    return torch.from_numpy(out_v), torch.from_numpy(out_i)


def _emulated(index, q, mask, tile_n, m, slices):
    return _emulate(_scores(index, q, mask).numpy(), tile_n, m, slices)


# -- the split twin against the loop twin ------------------------------------------

@pytest.mark.parametrize("kind", ["i8", "bf16"])
@pytest.mark.parametrize("tile,slice_n", [(128, 128), (128, 32), (1024, 128),
                                          (2048, 256), (4096, 1024), (16384, 2048),
                                          (2048, 2048), (384, 96)])
def test_split_twin_matches_loop_twin(seeded_rng, kind, tile, slice_n):
    # slice heights 32-2048, dividing m or not (m 1-128, among them m larger
    # than a slice), B 1 / 3 / 65
    n = 2 * tile
    for b in (1, 3, 65):
        index, q, mask = _inputs(seeded_rng, n, 16, b, kind)
        for m in (1, 4, 5, 16, 33, 64, 128):
            if m > tile:
                continue
            _assert_equal(scan_topk_plain_loop_split(index, q, mask, tile, m, slice_n),
                          scan_topk_plain_loop(index, q, mask, tile, m))


@pytest.mark.parametrize("kind", ["i8", "bf16"])
@pytest.mark.parametrize("case", ["fully_masked_tile", "fewer_valid_than_m", "all_equal"])
def test_split_twin_edge_tiles(seeded_rng, kind, case):
    n, tile, m = 2048, 512, 64
    index, q, mask = _inputs(seeded_rng, n, 16, 3, kind)
    if case == "fully_masked_tile":
        mask[512:1024] = 0
    elif case == "fewer_valid_than_m":
        mask[1024:1536] = 0
        mask[[1100, 1300, 1535]] = 1                 # 3 valid rows < m, across slices
    else:
        index = torch.ones_like(index)
    ref = scan_topk_plain_loop(index, q, mask, tile, m)
    for slice_n in (128, 256, 512):
        _assert_equal(scan_topk_plain_loop_split(index, q, mask, tile, m, slice_n), ref)
    if case == "fully_masked_tile":
        assert torch.all(ref[0][1] == NEG) and torch.all(ref[1][1] == 512)
    if case == "fewer_valid_than_m":
        assert all(sorted(r) == [1100, 1300, 1535] for r in ref[1][2, :, :3].tolist())
        assert torch.all(ref[0][2, :, 3:] == NEG) and torch.all(ref[1][2, :, 3:] == 1024)


# -- the emulated device steps against the loop twin --------------------------------

@pytest.mark.parametrize("kind", ["i8", "bf16"])
@pytest.mark.parametrize("m", [1, 2, 4, 7, 16, 33, 64, 128, 129, 200, 256, 500, 512])
def test_device_steps_match_loop_twin(seeded_rng, kind, m):
    # every slice count the wrapper can pick at these tiles (1-16), B 1/3/65
    # (B 1/3 at m > 128, where each list holds 256 or 512 keys and slices of
    # 128-256 rows hold fewer rows than m), 2% masked rows plus a fully
    # masked tile and one with 3 valid rows
    for tile in (128, 512, 2048):
        if tile < m:
            continue
        n = 3 * tile
        for b in (1, 3, 65) if m <= SPLIT_NARROW_M else (1, 3):
            index, q, mask = _inputs(seeded_rng, n, 16, b, kind)
            mask[tile:2 * tile] = 0
            mask[2 * tile:3 * tile - 3] = 0
            ref = scan_topk_plain_loop(index, q, mask, tile, m)
            slices = 1
            while slices <= min(SPLIT_MAX_SLICES, tile // SUB):
                _assert_equal(_emulated(index, q, mask, tile, m, slices), ref)
                slices *= 2


@pytest.mark.parametrize("kind", ["i8", "bf16"])
def test_device_steps_all_equal_and_ascending(seeded_rng, kind):
    # all-equal scores (ties everywhere: the lowest rows win) and scores that
    # rise with the row (every sub-tile enters every list)
    tile, m = 1024, 64
    index, q, mask = _inputs(seeded_rng, 2 * tile, 16, 3, kind, masked=0.0)
    ones = torch.ones_like(index)
    for slices in (1, 4, 8):
        ref = scan_topk_plain_loop(ones, q, mask, tile, m)
        _assert_equal(_emulated(ones, q, mask, tile, m, slices), ref)
    ramp = torch.arange(2 * tile, dtype=torch.float32)[None, :].repeat(3, 1)
    scores = torch.where(mask[None, :] > 0, ramp, torch.full_like(ramp, NEG))
    for slices in (1, 8):
        v, r = _emulate(scores.numpy(), tile, m, slices)
        assert torch.equal(r[0, 0], torch.arange(tile - 1, tile - 1 - m, -1, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["i8", "bf16"])
def test_wide_device_steps_all_equal_and_ascending(seeded_rng, kind):
    # m 500 (lists of 512 keys): all-equal scores, where the lowest rows win
    # through every slice merge, and rising scores, where every sub-tile
    # enters every list; slices of 2048 down to 128 rows (fewer than m)
    tile, m = 2048, 500
    index, q, mask = _inputs(seeded_rng, 2 * tile, 16, 3, kind, masked=0.0)
    ones = torch.ones_like(index)
    ref = scan_topk_plain_loop(ones, q, mask, tile, m)
    assert torch.equal(ref[1][1, 0], torch.arange(tile, tile + m, dtype=torch.int32))
    for slices in (1, 4, 16):
        _assert_equal(_emulated(ones, q, mask, tile, m, slices), ref)
    ramp = torch.arange(2 * tile, dtype=torch.float32)[None, :].repeat(3, 1)
    for slices in (1, 16):
        v, r = _emulate(ramp.numpy(), tile, m, slices)
        assert torch.equal(r[0, 0], torch.arange(tile - 1, tile - 1 - m, -1, dtype=torch.int32))
        assert torch.equal(v[1, 2], torch.arange(2 * tile - 1, 2 * tile - 1 - m, -1,
                                                 dtype=torch.float32))


def test_key_order_is_the_reference_order():
    v = np.array([1.5, 1.5, -0.0, 0.0, NEG, NEG, -2.0, 3.0e38], np.float32)
    rows = np.array([9, 3, 5, 4, 0, 7, 1, 2])
    k = _keys(v, rows)
    order = sorted(range(len(v)), key=lambda i: -int(k[i]))
    assert [rows[i] for i in order] == [2, 3, 9, 4, 5, 1, 0, 7]  # -0 ties +0 on the row
    np.testing.assert_array_equal(_key_val(k), v + np.float32(0.0))
    np.testing.assert_array_equal(_key_row(k), rows)


# -- against the reference in interpret mode ----------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_split_matches_pallas_interpret(seeded_rng, bf16):
    # as test_torch_topk.test_every_tile_slot_matches: k = tiles * m exposes
    # every per-tile slot through the stable merge
    n, d, b, tile, m = 1024, 32, 4, 512, 6
    x = seeded_rng.normal(size=(n, d)).astype(np.float32)
    index = x / np.linalg.norm(x, axis=1, keepdims=True)
    y = seeded_rng.normal(size=(b, d)).astype(np.float32)
    q = y / np.linalg.norm(y, axis=1, keepdims=True)
    mask = np.ones(n, np.int32)
    mask[600:1020] = 0                           # tile 1 keeps 4 valid rows < m
    k = (n // tile) * m
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        rv, rr = topk_pallas(jnp.asarray(index, jdt), jnp.asarray(q, jdt), k, jnp.asarray(mask),
                             tile_n=tile, per_tile_k=m, extraction="loop")
    ti, tq, tm = torch.from_numpy(index).to(dt), torch.from_numpy(q).to(dt), torch.from_numpy(mask)
    for got in (scan_topk_plain_loop_split(ti, tq, tm, tile, m, 128),
                _emulated(ti, tq, tm, tile, m, 4)):
        v, r = merge_tiles(*got, k)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5)
        np.testing.assert_array_equal(r.numpy(), np.asarray(rr))


@pytest.mark.parametrize("kind", ["i8", "bf16"])
def test_wide_split_matches_pallas_interpret(seeded_rng, kind):
    # m 200 > 128 against the reference's _scan_kernel in interpret mode
    # (200 rounds a tile); k = tiles * m exposes every per-tile slot. Tile 1
    # keeps 40 valid rows < m, spread over its 128-row slices
    n, d, b, tile, m = 1024, 32, 2, 512, 200
    mask = np.ones(n, np.int32)
    mask[512:1024] = 0
    mask[512 + 13 * np.arange(40)] = 1
    if kind == "i8":
        index = seeded_rng.integers(-128, 128, size=(n, d)).astype(np.int8)
        q = seeded_rng.integers(-128, 128, size=(b, d)).astype(np.int8)
        ti, tq = torch.from_numpy(index), torch.from_numpy(q)
        ji, jq = jnp.asarray(index), jnp.asarray(q)
    else:
        x = seeded_rng.normal(size=(n, d)).astype(np.float32)
        index = x / np.linalg.norm(x, axis=1, keepdims=True)
        y = seeded_rng.normal(size=(b, d)).astype(np.float32)
        q = y / np.linalg.norm(y, axis=1, keepdims=True)
        ti, tq = torch.from_numpy(index).bfloat16(), torch.from_numpy(q).bfloat16()
        ji, jq = jnp.asarray(index, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16)
    tm = torch.from_numpy(mask)
    k = (n // tile) * m
    with pltpu.force_tpu_interpret_mode():
        rv, rr = topk_pallas(ji, jq, k, jnp.asarray(mask), tile_n=tile, per_tile_k=m,
                             extraction="loop")
    for got in (scan_topk_plain_loop(ti, tq, tm, tile, m),
                _emulated(ti, tq, tm, tile, m, 4)):
        v, r = merge_tiles(*got, k)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5)
        np.testing.assert_array_equal(r.numpy(), np.asarray(rr))


# -- routing --------------------------------------------------------------------------

#: (kind, B, rows, tile, m) of the main path: the repository corpus, a
#: daemon-sized corpus, 1,048,576 rows, and the screened program's int8 scan
MAIN_PATH = [("bf16", b, 4096, 2048, 64) for b in (1, 8, 64)] + [
    ("bf16", 64, 65536, 2048, 32), ("bf16", 1, 1 << 20, 2048, 4), ("bf16", 128, 1 << 20, 2048, 64),
    ("i8", 1, 4096, 2048, 64), ("i8", 64, 4096, 2048, 64), ("i8", 1, 1 << 20, 16384, 16)]


@pytest.mark.parametrize("kind,b,n,tile,m", MAIN_PATH)
def test_main_path_shapes_take_the_split_kernel(kind, b, n, tile, m):
    route = LOOP if kind == "bf16" else LOOP_I8
    assert loop_impl(kind, tile, m) == "split"
    assert route.impl(tile, m) is (LOOP_SPLIT if kind == "bf16" else LOOP_SPLIT_I8)
    slices = split_slices(n, tile, b)
    assert slices & (slices - 1) == 0 and tile % (slices * SUB) == 0
    qb = split_query_block(b)
    ctas = (n // tile) * slices * -(-b // qb)
    assert slices == SPLIT_MAX_SLICES or ctas >= 264       # the grid fills 132 SMs twice
    assert qb in (8, 16, 32) and qb >= min(b, SPLIT_MAX_QUERY_BLOCK)


def test_split_slices_at_the_repository_corpus():
    # 4,096 rows, tile 2048: 16 slices of 128 rows, 32 CTAs at B=1 (the
    # CUDA-core kernel ran 2); 1 slice where the tiles alone fill the card
    assert split_slices(4096, 2048, 1) == 16
    assert split_slices(65536, 2048, 64) == 8                 # 32 tiles x 8 x 2 query blocks
    assert split_slices(1 << 20, 2048, 1) == split_slices(1 << 20, 2048, 128) == 1
    assert split_slices(1 << 20, 16384, 1) == 8


def test_template_keeps_what_the_split_does_not_take():
    assert loop_impl("i8w", 2048, 4) == "template"
    assert loop_impl("bf16", 2048, SPLIT_MAX_M + 1) == "template"
    assert loop_impl("bf16", 96 * 2, 4) == "template"   # tile not a multiple of 128
    # m 129-512 moved to the split kernel; the template keeps m > 512
    assert LOOP.impl(2048, 513) is LOOP_CC
    assert LOOP_I8.impl(2048, 513) is LOOP_I8_CC
    for kind in ("bf16", "i8"):
        assert loop_impl(kind, 2048, 500) == "split"
        assert loop_impl(kind, 96, 64) == "template"     # a shard under 128 rows
    assert LOOP_I8W not in (LOOP_SPLIT, LOOP_SPLIT_I8)


def test_shard_scans_take_the_split_kernel():
    # a shard's exact top-500 (the sharded programs' pool) at 262,144 rows
    # and at a shard that is not a power of two: whole 2,048-row tiles, the
    # split kernel of either row kind, a query block of 8 and the grid
    # filling the card
    for rows in (262144, 250000):
        n, tile, m = shard_geometry(rows, 500)
        assert (tile, m) == (2048, 500) and n % tile == 0
        assert LOOP.impl(tile, m) is LOOP_SPLIT and LOOP_I8.impl(tile, m) is LOOP_SPLIT_I8
        assert split_query_block(1, m) == SPLIT_WIDE_M_QUERY_BLOCK == 8
        slices = split_slices(n, tile, 1, m)
        assert 132 <= (n // tile) * slices <= 264 and tile % (slices * SUB) == 0
    # one wave of two CTAs an SM: 256 CTAs of 1,024 rows (m <= 128 would take 4)
    assert split_slices(262144, 2048, 1, 500) == 2 and split_slices(262144, 2048, 1, 64) == 4
    # a small shard still fills the card: one 2,048-row tile in 16 slices
    assert split_slices(2048, 2048, 1, 500) == 16
    # every batch takes 8-query blocks above m 128 (lists of 256-512 keys)
    assert {split_query_block(b, m) for b in range(1, 300) for m in (129, 500, 512)} == {8}
    assert split_query_block(64, 128) == 32


@pytest.mark.parametrize("b", [1, 4, 8, 16, 32, 64])
def test_daemon_batches_below_131072_rows_reach_the_split_kernel(b):
    # the batcher's rungs 1-64 on every padded corpus below 131,072 rows
    # take "loop" (engine.bf16_extraction), at the programs' per-tile k
    for cap in range(4096, 131072, 2048 * 7):
        assert bf16_extraction(cap, b) == "loop"
        m, ext = scan_geometry(cap, 500, 2048, "grouped")
        assert LOOP.impl(2048, m) is LOOP_SPLIT, (cap, b, m)
    assert bf16_extraction(131072, 64) == "grouped"


def test_screened_int8_scan_takes_the_split_kernel():
    n = 1 << 20
    tile = _screen_tile(n, 256, 500)
    m, _ = scan_geometry(n, 500, tile)
    assert (tile, m) == (16384, 16)
    assert LOOP_I8.impl(tile, m) is LOOP_SPLIT_I8


def test_split_wrappers_refuse_cpu_tensors_and_count_apart():
    index = torch.zeros(4096, 16, dtype=torch.bfloat16)
    mask = torch.ones(4096, dtype=torch.int32)
    for k in (LOOP_SPLIT, LOOP_SPLIT_I8):
        assert isinstance(k, SplitScanKernel) and k.source.endswith("scan_loop_mma.cu")
        with pytest.raises(ValueError):
            k(index, index[:1], mask, 2048, 64)
        assert k.launches == 0
    assert len({k.name for k in IMPLS}) == len(IMPLS) == 8
    assert {k for k in IMPLS} >= {LOOP_SPLIT, LOOP_CC, LOOP_SPLIT_I8, LOOP_I8_CC}
    assert LOOP in KERNELS and LOOP.launches == LOOP_SPLIT.launches + LOOP_CC.launches
    # scan_topk on the CPU runs the plain twin and launches nothing
    scan_topk(index, index[:2], 10, mask, tile_n=2048, per_tile_k=64)
    assert all(k.launches == 0 for k in IMPLS)


def test_split_entry_point_signature():
    src = (Path(__file__).resolve().parents[1] / LOOP_SPLIT.source).read_text()
    for k in (LOOP_SPLIT, LOOP_SPLIT_I8):
        sig = re.search(rf"int {k.symbol}\(([^)]*)\)", src)
        args = [a.split()[-1].lstrip("*") for a in sig.group(1).split(",")]
        assert args == ["q", "rows", "mask", "vals", "inds", "part", "B", "N", "D", "tile_n",
                        "m", "qb", "slices", "stream"]
    # the query blocks the entry point dispatches are those the wrapper picks
    built = {int(x) for x in re.findall(r"case (\d+): return launch<KIND, \d+>", src)}
    assert built == {split_query_block(b) for b in range(1, 300)} == {8, 16, 32}
    assert re.search(r"kMaxM = %d;" % SPLIT_MAX_M, src)
    assert re.search(r"kMaxSlices = %d;" % SPLIT_MAX_SLICES, src)
