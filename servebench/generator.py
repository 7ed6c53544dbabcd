"""Closed-loop traffic from a mix's parameters (``traffic/<name>.json``).

Every mix is read by this one generator. Lengths come from their
distribution's quantiles in strata of ``stratum`` requests: each stratum
holds the quantile multiset of prompt and of output lengths, in an order
(two independent shuffles, so prompt and output lengths pair differently)
drawn from the fixed ``ORDER_SEED``. The run's seed draws the token ids
(and, with ``shared_prefix``, the system prompts), not the order: in a
closed loop the order of lengths is the arrival pattern, and reordering
them alone moves the TTFT tail by half from seed to seed. So every seed
sends the same sizes at the same points of the loop.

A mix with ``shared_prefix`` prepends one of ``count`` system prompts of
``tokens`` tokens, chosen with Zipf popularity: each stratum holds every
prompt's share of the stratum (largest remainders), in the mix's order.

Each client's first request asks for a fraction of its output length,
stratified over the clients, so completions are staggered as in a loop that
has run a while.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# streams of the order seed (_ORDER, _FIRST) and of the run's seed (_TOKENS,
# _PREFIX); weights are drawn by torch from the run's seed itself
_ORDER, _TOKENS, _PREFIX, _FIRST = 1, 2, 3, 4
ORDER_SEED = 20  # the one order of lengths every mix and every run sends


def load_traffic(name: str, root: str = HERE) -> dict:
    """The mix ``traffic/<name>.json`` under ``root``."""
    with open(os.path.join(root, "traffic", name + ".json")) as f:
        mix = json.load(f)
    validate(mix)
    return mix


def validate(mix: dict) -> None:
    for key in ("clients", "stratum", "prompt", "output", "engine"):
        if key not in mix:
            raise ValueError(f"traffic mix lacks {key!r}")
    if mix.get("loop", "closed") != "closed":
        raise ValueError("the generator runs closed loops only")
    for key in ("prompt", "output"):
        d = mix[key]
        if d.get("dist") != "lognormal" or not 1 <= d["min"] <= d["median"] <= d["max"]:
            raise ValueError(f"{key}: a lognormal with 1 <= min <= median <= max")


def quantile_lengths(dist: dict, n: int) -> list:
    """``n`` lengths at the distribution's quantiles (i + 0.5) / n, clipped
    to [min, max]: the same multiset on every seed."""
    mu, sigma = math.log(dist["median"]), float(dist["sigma"])
    z = NormalDist()
    out = []
    for i in range(n):
        x = math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n))
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


def zipf_counts(count: int, s: float, n: int) -> list:
    """How many of ``n`` requests each of ``count`` prefixes gets under Zipf
    popularity p_i ~ 1 / (i + 1)^s: floors plus the largest remainders."""
    w = [1.0 / (i + 1) ** s for i in range(count)]
    total = sum(w)
    exact = [n * x / total for x in w]
    base = [int(math.floor(e)) for e in exact]
    rest = sorted(range(count), key=lambda i: (base[i] - exact[i], i))
    for i in rest[: n - sum(base)]:
        base[i] += 1
    return base


@dataclass
class Spec:
    """One request as the generator makes it."""

    index: int  # position in the stream
    prompt: list  # token ids
    max_new: int
    prefix: int = -1  # the shared system prompt's index, -1 for none


class Stream:
    """The request stream of one run: ``next_request()`` in send order."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed) % 2**64, int(vocab)
        self.k = int(mix["stratum"])
        self._p_lens = quantile_lengths(mix["prompt"], self.k)
        self._o_lens = quantile_lengths(mix["output"], self.k)
        sp = mix.get("shared_prefix")
        self.prefixes = []
        if sp:
            rng = np.random.default_rng([self.seed, _PREFIX])
            self.prefixes = [rng.integers(0, self.vocab, int(sp["tokens"])).tolist()
                             for _ in range(int(sp["count"]))]
            self._prefix_counts = zipf_counts(int(sp["count"]), float(sp["zipf"]), self.k)
        self._queue: list = []
        self._stratum = 0
        self._sent = 0

    def _fill(self) -> None:
        rng = np.random.default_rng([ORDER_SEED, _ORDER, self._stratum])
        p = rng.permutation(self._p_lens)
        o = rng.permutation(self._o_lens)
        pre = [-1] * self.k
        if self.prefixes:
            pre = rng.permutation([i for i, c in enumerate(self._prefix_counts) for _ in range(c)])
        tok = np.random.default_rng([self.seed, _TOKENS, self._stratum])
        for j in range(self.k):
            ids = tok.integers(0, self.vocab, int(p[j])).tolist()
            if pre[j] >= 0:
                ids = self.prefixes[int(pre[j])] + ids
            self._queue.append((ids, int(o[j]), int(pre[j])))
        self._stratum += 1

    def next_request(self) -> Spec:
        if not self._queue:
            self._fill()
        ids, out, pre = self._queue.pop(0)
        spec = Spec(self._sent, ids, out, pre)
        self._sent += 1
        return spec

    def first_requests(self) -> list:
        """One request a client, each asking for a stratified fraction of
        its drawn output length (at least 1 token)."""
        c = int(self.mix["clients"])
        order = np.random.default_rng([ORDER_SEED, _FIRST]).permutation(c)
        specs = []
        for i in range(c):
            s = self.next_request()
            s.max_new = max(1, int(s.max_new * (int(order[i]) + 0.5) / c))
            specs.append(s)
        return specs


def longest_request(mix: dict) -> int:
    """The most KV slots a request of this mix holds: prompt (with its
    shared prefix) plus output."""
    sp = mix.get("shared_prefix")
    return mix["prompt"]["max"] + mix["output"]["max"] + (int(sp["tokens"]) if sp else 0)
