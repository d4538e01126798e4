"""The general traffic generator: requests and arrivals from a traffic
mix's parameters and the run's seed.

A request is a prompt of words drawn from the mix's word list, its own
seed and its own guidance scale; the guidance scales are a fixed multiset
that the run's seed orders. An open loop's arrivals are the same for every
run seed: the quantiles of the exponential distribution at the mix's
rate, in an order fixed by the mix, so every seed offers the same work at
the same times and only the requests differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    prompt: str
    seed: int
    guidance: float


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator of one named stream of the run's seed."""
    salt = int.from_bytes(stream.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), salt])


def requests(traffic: dict, seed: int) -> list:
    """The mix's stream of ``pool`` requests under ``seed``; a load that
    needs more goes round it again."""
    rng = rng_for(seed, "requests")
    words, scales = traffic["words"], traffic["guidance"]
    lo, hi = traffic["prompt_words"]
    n = traffic["pool"]
    order = rng.permutation(n)          # the seed orders the scales
    out = []
    for i in range(n):
        k = int(rng.integers(lo, hi + 1))
        prompt = " ".join(words[j] for j in rng.choice(len(words), k))
        out.append(Request(prompt, int(rng.integers(0, 2 ** 31 - 1)),
                           float(scales[order[i] % len(scales)])))
    return out


def arrivals(traffic: dict, seconds: float,
             stream: str = "arrivals") -> np.ndarray:
    """Due times (s from the start of a span of ``seconds``) of an open
    loop at the mix's rate: n = round(rate x seconds) gaps, the
    exponential distribution's quantiles (k + 1/2) / n in an order drawn
    from the mix's ``schedule_seed``. Every run offers the same arrivals;
    its seed only chooses which requests arrive when."""
    rate = float(traffic["rate"])
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    order = rng_for(traffic["schedule_seed"], stream).permutation(n)
    return np.cumsum(gaps[order])
