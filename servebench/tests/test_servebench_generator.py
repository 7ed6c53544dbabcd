"""The traffic generator: deterministic per seed, the same lengths in the
same order for every seed (the generator's ``ORDER_SEED`` fixes them), each stratum
the distribution's quantile multiset, Zipf prefix choice, staggered first
requests."""

from collections import Counter

from conftest import tiny_traffic
from servebench import generator


def take(stream, n):
    return [stream.next_request() for _ in range(n)]


def test_same_seed_same_requests(monkeypatch):
    mix = tiny_traffic()
    a = take(generator.Stream(mix, 2**31 + 11, 512), 20)
    b = take(generator.Stream(mix, 2**31 + 11, 512), 20)
    assert [(r.prompt, r.max_new) for r in a] == [(r.prompt, r.max_new) for r in b]
    c = take(generator.Stream(mix, 2**31 + 12, 512), 20)
    assert [r.prompt for r in a] != [r.prompt for r in c]
    assert [(len(r.prompt), r.max_new) for r in a] == [(len(r.prompt), r.max_new) for r in c]
    monkeypatch.setattr(generator, "ORDER_SEED", generator.ORDER_SEED + 1)
    d = take(generator.Stream(mix, 2**31 + 11, 512), 20)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in d]


def test_every_seed_has_the_same_lengths_in_each_stratum():
    mix = tiny_traffic()
    k = mix["stratum"]
    multisets, orders = set(), set()
    for seed in (0, 1, 7, 2**33 + 5, -3):
        reqs = take(generator.Stream(mix, seed, 512), 3 * k)
        orders.add(tuple((len(r.prompt), r.max_new) for r in reqs))
        for s in range(3):
            part = reqs[s * k : (s + 1) * k]
            multisets.add((tuple(sorted(len(r.prompt) for r in part)),
                           tuple(sorted(r.max_new for r in part))))
    assert len(multisets) == 1 and len(orders) == 1
    prompts, outs = multisets.pop()
    assert prompts == tuple(sorted(generator.quantile_lengths(mix["prompt"], k)))
    assert min(prompts) >= mix["prompt"]["min"] and max(outs) <= mix["output"]["max"]


def test_quantile_lengths_follow_the_lognormal():
    d = {"dist": "lognormal", "median": 1024, "sigma": 0.7, "min": 128, "max": 4096}
    xs = generator.quantile_lengths(d, 64)
    assert xs == sorted(xs) and xs[31] <= 1024 <= xs[32]
    assert xs[0] >= 128 and xs[-1] <= 4096


def test_zipf_prefix_choice():
    counts = generator.zipf_counts(8, 1.1, 64)
    assert sum(counts) == 64 and counts == sorted(counts, reverse=True)
    w = [1 / (i + 1) ** 1.1 for i in range(8)]
    assert all(abs(c - 64 * x / sum(w)) < 1 for c, x in zip(counts, w))
    mix = tiny_traffic(prefix=True)
    stream = generator.Stream(mix, 5, 512)
    reqs = take(stream, mix["stratum"])
    seen = Counter(r.prefix for r in reqs)
    assert [seen[i] for i in range(3)] == generator.zipf_counts(3, 1.1, mix["stratum"])
    for r in reqs:
        assert r.prompt[: len(stream.prefixes[r.prefix])] == stream.prefixes[r.prefix]
        assert len(r.prompt) - 64 >= mix["prompt"]["min"]


def test_first_requests_are_staggered_fractions():
    mix = tiny_traffic()
    firsts = generator.Stream(mix, 3, 512).first_requests()
    full = take(generator.Stream(mix, 3, 512), mix["clients"])
    assert len(firsts) == mix["clients"]
    assert all(1 <= f.max_new <= g.max_new for f, g in zip(firsts, full))
    assert [f.prompt for f in firsts] == [g.prompt for g in full]
