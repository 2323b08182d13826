"""The one traffic generator: every mix is a data file it reads.

Closed loops: ``clients`` each hold one request (a frame) at a time and send
the next as soon as the last completes.  Client ``c``'s ``k``-th request is
a function of (seed, c, k) alone, never of timing.  Lengths are stratified:
the clients' ``k``-th requests together hold the ``clients`` quantiles of
the clipped lognormal, dealt to the clients in an order the seed draws
anew for every ``k``.  So every seed runs the same mix of sizes, in an
order of its own.

Open loops: a Poisson stream at ``rate_per_s`` whose rate is multiplied by
``on_factor`` for ``on_s`` seconds and by ``off_factor`` for the rest of
each ``period_s``; each arrival goes to a camera drawn from the seed.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, *keys])


def lognormal_quantiles(spec: dict, k: int) -> list[int]:
    """``k`` stratified lengths: the quantiles (i + 0.5) / k of a lognormal
    with ``median`` and ``sigma``, rounded and clipped to [min, max]."""
    nd = NormalDist()
    out = []
    for i in range(k):
        z = nd.inv_cdf((i + 0.5) / k)
        v = round(spec["median"] * math.exp(spec["sigma"] * z))
        out.append(int(min(max(v, spec["min"]), spec["max"])))
    return out


class ClosedLM:
    """(prompt length, output length, prompt tokens) of client c's k-th
    request."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.clients = traffic["clients"]
        self.prompts = lognormal_quantiles(traffic["prompt"], self.clients)
        self.outputs = lognormal_quantiles(traffic["output"], self.clients)
        self.seed = seed
        self.vocab = vocab
        self._perm: dict[int, tuple] = {}

    def _round(self, k: int):
        if k not in self._perm:
            rng = _rng(self.seed, 1, k)
            self._perm[k] = (rng.permutation(self.clients),
                             rng.permutation(self.clients))
        return self._perm[k]

    def shape(self, c: int, k: int) -> tuple[int, int]:
        pp, po = self._round(k)
        return self.prompts[pp[c]], self.outputs[po[c]]

    def tokens(self, c: int, k: int, length: int) -> np.ndarray:
        return _rng(self.seed, 2, c, k).integers(
            0, self.vocab, length, dtype=np.int64)

    def longest_prompt(self) -> int:
        return max(self.prompts)

    def shortest_prompt(self) -> int:
        return min(self.prompts)


def image_index(seed: int, pool: int, c: int, k: int) -> int:
    """The pool image of client c's k-th frame."""
    return int(_rng(seed, 3, c, k).integers(0, pool))


def open_arrivals(traffic: dict, seed: int, horizon_s: float):
    """[(due time, camera)] up to ``horizon_s``, from the seed."""
    rng = _rng(seed, 4)
    rate = traffic["rate_per_s"]
    b = traffic["burst"]
    t, out = 0.0, []
    top = rate * max(b["on_factor"], b["off_factor"])
    while True:
        # thinning of a Poisson stream at the highest rate
        t += rng.exponential(1.0 / top)
        if t >= horizon_s:
            return out
        on = (t % b["period_s"]) < b["on_s"]
        here = rate * (b["on_factor"] if on else b["off_factor"])
        if rng.random() * top < here:
            out.append((t, int(rng.integers(0, traffic["cameras"]))))
