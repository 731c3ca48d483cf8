"""The traffic generators and the operation counts, on the CPU."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench import flops
from perfbench.gen.pairs import PairGenerator
from perfbench.gen.repo import RepoGenerator

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def _traffic(name: str, **kw) -> dict:
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    t.update(kw)
    return t


def _texts(files) -> list[str]:
    return [f.origin + "\n" + f.text for f in files]


def test_repo_generator_is_deterministic_per_seed():
    t = _traffic("index", files_per_iteration=6)
    a, b = RepoGenerator(t, 2**31 + 3), RepoGenerator(t, 2**31 + 3)
    for it in range(3):
        assert _texts(a.iteration(it)) == _texts(b.iteration(it))


def test_repo_generator_is_fresh_per_iteration_and_seed():
    t = _traffic("index", files_per_iteration=6)
    g = RepoGenerator(t, 7)
    first, second = g.iteration(0), g.iteration(1)
    assert not set(_texts(first)) & set(_texts(second))
    names = [i.name for f in first + second for i in f.items if i.kind == "function"]
    assert len(names) == len(set(names))
    assert not set(_texts(RepoGenerator(t, 8).iteration(0))) & set(_texts(first))


def test_repo_generator_gives_every_seed_the_same_sizes():
    t = _traffic("index", files_per_iteration=8)

    def sizes(seed):
        return sorted((f.origin.endswith(".py"), len(f.items),
                       tuple(i.line_end - i.line_start for i in f.items))
                      for f in RepoGenerator(t, seed).iteration(2))
    assert sizes(1) == sizes(2**31 + 99)


def test_repo_generator_calls_earlier_functions():
    t = _traffic("index", files_per_iteration=8)
    g = RepoGenerator(t, 5)
    g.iteration(0)
    earlier = set(g.functions)
    later = g.iteration(1)
    py = "\n".join(f.text for f in later if f.origin.endswith(".py"))
    assert sum(f"{name}(" in py for name in earlier) > 10


def test_pair_generator_is_deterministic_and_draws_distinct_pairs():
    t = _traffic("train", pool_pairs=256, batch=32)
    a, b = PairGenerator(t, 2**31 + 5), PairGenerator(t, 2**31 + 5)
    for i in range(3):
        assert a.step(i) == b.step(i)
    q, p, n = a.step(0)
    assert len(q) == len(p) == 32 and len(n) == 32 * t["negatives"]
    assert len(set(q)) == 32
    assert a.step(0) != a.step(1)
    assert PairGenerator(t, 9).step(0) != a.step(0)


def test_pair_generator_lengths_are_within_the_traffic_file():
    t = _traffic("train", pool_pairs=256)
    g = PairGenerator(t, 3)
    lo, hi = t["query_words"]
    assert all(lo <= len(x.split()) <= hi for x in g.queries)
    dw = t["doc_words"]
    assert all(dw["lo"] <= len(d.split()) <= dw["hi"] for row in g.docs for d in row)


CFG = {"hidden_size": 8, "intermediate_size": 32, "num_hidden_layers": 2}


def test_dense_flops_by_hand():
    # a layer: q, k, v, out (8 x 8 each) and two 8 x 32 feed-forward matrices
    per_token = 2 * 2 * (4 * 64 + 2 * 256)
    assert flops.dense_params(CFG) == 2 * (4 * 64 + 2 * 256)
    assert flops.dense_flops(CFG, 10) == 10 * per_token


def test_attention_and_forward_flops_by_hand():
    # q.k^T and p.v: 2 * L * L * H each, a layer; two layers
    assert flops.attention_flops(CFG, [3, 5]) == 2 * 2 * 2 * 8 * (9 + 25)
    assert flops.forward_flops(CFG, [3, 5]) == flops.dense_flops(CFG, 8) + 2 * 2 * 2 * 8 * 34
    assert flops.train_flops(CFG, [4]) == 3 * flops.forward_flops(CFG, [4])


@pytest.mark.parametrize("name", ["bge-large", "minilm-l6"])
def test_configs_hold_published_widths(name):
    c = json.loads((TRAFFIC.parent / "configs" / f"{name}.json").read_text())
    widths = {"bge-large": (1024, 24, 16, 4096), "minilm-l6": (384, 6, 12, 1536)}[name]
    assert (c["hidden_size"], c["num_hidden_layers"], c["num_attention_heads"],
            c["intermediate_size"], c["vocab_size"]) == (*widths, 30522)
