"""The generator is deterministic in the seed, differs across seeds, and
gives every seed the same sizes and gaps in another order."""
import numpy as np
import pytest

from bench.harness import spec, traffic

MIXES = ["code_batch", "repo_completion"]
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", MIXES)
def test_deterministic(mix):
    m = spec.load_json("traffic", mix)
    a, b = traffic.generate(m, BIG, 1000), traffic.generate(m, BIG, 1000)
    assert len(a) == m["requests"]
    for x, y in zip(a, b):
        assert np.array_equal(x["prompt"], y["prompt"])
        assert x["max_new"] == y["max_new"]
        assert x["arrival_tick"] == y["arrival_tick"]


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_differ_in_order_not_in_work(mix):
    m = spec.load_json("traffic", mix)
    a, b = traffic.generate(m, 1, 1000), traffic.generate(m, 2, 1000)
    same_order = [r["max_new"] for r in a] == [r["max_new"] for r in b]
    assert same_order == ("order" in m)
    assert not np.array_equal(a[0]["prompt"][:8], b[0]["prompt"][:8])
    assert sorted(r["prompt"].size for r in a) == \
        sorted(r["prompt"].size for r in b)
    assert sorted(r["max_new"] for r in a) == sorted(r["max_new"] for r in b)
    assert abs(a[-1]["arrival_tick"] - b[-1]["arrival_tick"]) <= 1


@pytest.mark.parametrize("mix", MIXES)
def test_bounds_and_order(mix):
    m = spec.load_json("traffic", mix)
    reqs = traffic.generate(m, 7, 1000)
    sizes = [r["prompt"].size for r in reqs]
    assert min(sizes) >= m["prompt"]["min"]
    assert max(sizes) <= m["prompt"]["max"]
    ticks = [r["arrival_tick"] for r in reqs]
    assert ticks == sorted(ticks)
    assert all(0 <= t.min() and t.max() < 1000
               for t in (r["prompt"] for r in reqs))


def test_poisson_rate():
    m = spec.load_json("traffic", "repo_completion")
    reqs = traffic.generate(m, 3, 1000)
    rate = len(reqs) / (reqs[-1]["arrival_tick"] + 1)
    assert abs(rate - m["arrivals"]["per_tick"]) < 0.1 * \
        m["arrivals"]["per_tick"]
