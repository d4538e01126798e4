"""The traffic generator: the same seed gives the same requests and
arrivals; other seeds order the same work and the same gaps."""

import numpy as np
import pytest

from benchmark.harness import traffic as gen
from benchmark.tests import tiny

SEEDS = [0, 7, 2 ** 31 + 12345, 2 ** 33 + 1]


@pytest.mark.parametrize("name", ["batch4-512-ddpm50", "open-512-ddim10",
                                  "batch1-1024-flow50"])
def test_requests_are_deterministic(name):
    mix = tiny._load(f"traffic/{name}.json")
    for seed in SEEDS:
        assert gen.requests(mix, seed) == gen.requests(mix, seed)
    a, b = gen.requests(mix, SEEDS[0]), gen.requests(mix, SEEDS[2])
    assert a != b
    assert sorted(r.guidance for r in a) == sorted(r.guidance for r in b)
    assert len(a) == mix["pool"]
    lo, hi = mix["prompt_words"]
    assert all(lo <= len(r.prompt.split()) <= hi for r in a)
    assert all(0 <= r.seed < 2 ** 31 for r in a)


def test_arrivals_are_fixed_by_the_mix():
    mix = tiny._load("traffic/open-512-ddim10.json")
    due = gen.arrivals(mix, 30.0)
    assert np.array_equal(due, gen.arrivals(dict(mix), 30.0))
    assert len(due) == round(mix["rate"] * 30.0)
    assert due[-1] < 30.0 and np.all(np.diff(due) > 0)
    gaps = np.diff(np.concatenate([[0.0], due]))
    assert abs(np.mean(gaps) * mix["rate"] - 1.0) < 0.1
    other = gen.arrivals(dict(mix, schedule_seed=mix["schedule_seed"] + 1),
                         30.0)
    assert not np.array_equal(other, due)
    assert np.allclose(np.sort(np.diff(np.concatenate([[0.0], other]))),
                       np.sort(gaps))
    after = gen.arrivals(mix, 30.0, "after")
    assert not np.array_equal(after, due)


def test_streams_of_one_seed_differ():
    a = gen.rng_for(5, "requests").random(4)
    b = gen.rng_for(5, "arrivals").random(4)
    assert not np.array_equal(a, b)
