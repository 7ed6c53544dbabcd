"""The port's serving engine, the features past its core: speculative decode
with ``ngram_draft``, prefix caching, ``n > 1`` with copy-on-write pages, the
full sampler (top-k, top-p, repetition penalty) and per-request sampling.

Ports of the corresponding tests of tests/test_engine.py on the port's own
engine, plus greedy parity with the JAX engine on the same weights (JAX's,
carried over bit-exactly): speculative decode and prefix caching give JAX's
tokens (a flip is accepted only at a bf16 near-tie, JAX's top-2 logit margin
below the 0.15 logits tolerance of tests/test_model.py, and the comparison
stops there) and, where no flip happened, JAX's counters exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as J
from hpc_ops_tpu.runtime.engine import Engine as JaxEngine
from hpc_ops_tpu.runtime.engine import ngram_draft as jax_ngram_draft
from hpc_ops_tpu_torch.config import SoftmaxPolicy
from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.runtime.engine import Engine, ngram_draft
from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

torch.set_num_threads(1)

SPEC_PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5]]


@pytest.fixture(scope="module")
def model():
    cfg = J.tiny_config()
    jw = J.init_weights(jax.random.PRNGKey(0), cfg)
    tw = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    return cfg, jw, T.tiny_config(), tw


def engine(model, **kw):
    _, _, tcfg, tw = model
    kw = {"num_blocks": 64, "block_size": 16, "max_batch": 4, **kw}
    return Engine(tcfg, tw, device="cpu", **kw)


def jax_margin(cfg, jw, tokens):
    n = len(tokens)
    caches = J.init_cache(cfg, num_blocks=8, block_size=16)
    logits, _ = J.forward_step(
        jw, caches, cfg, jnp.asarray(tokens, jnp.int32), jnp.asarray([n], jnp.int32),
        jnp.asarray([0, n], jnp.int32), jnp.asarray([list(range(8))], jnp.int32),
        is_prefill=True, max_seqlens_q=n,
    )
    return top2_margin(np.asarray(logits, np.float32))


def hold_to_jax(model, prompts, want, got):
    """Greedy tokens by assert_greedy_match; True when no flip was accepted."""
    cfg, jw, _, _ = model
    flips = [assert_greedy_match(w, g, lambda j, p=p, w=w: jax_margin(cfg, jw, p + w[:j]), 0.15)
             for p, w, g in zip(prompts, want, got)]
    return all(f is None for f in flips)


# ------------------------------------------------------------ speculative
def test_ngram_draft():
    assert ngram_draft([1, 2, 3, 4, 5, 2, 3], k=2) == [4, 5]
    assert ngram_draft([1, 2], k=2) == []  # too short
    assert ngram_draft([1, 2, 3, 4], k=2) == []  # no earlier match


def test_ngram_draft_equals_jax_on_random_histories():
    """200 seeded histories over a small alphabet (so n-grams recur), k 1-7
    and n 1-3: the port's drafter proposes exactly JAX's tokens."""
    rng = np.random.RandomState(17)
    for _ in range(200):
        hist = [int(t) for t in rng.randint(0, 6, rng.randint(0, 40))]
        k, n = int(rng.randint(1, 8)), int(rng.randint(1, 4))
        assert ngram_draft(hist, k, n) == jax_ngram_draft(hist, k, n), (hist, k, n)


def test_engine_speculative_lossless(model):
    """Greedy speculative decode gives plain greedy decode's tokens, whether
    the drafts are rejected (junk drafter) or accepted (oracle drafter)."""
    want = engine(model, max_batch=2).run(SPEC_PROMPTS, max_new=8)
    junk = engine(model, max_batch=2, speculative_k=3, draft_fn=lambda tokens, k: [0] * k)
    assert junk.run(SPEC_PROMPTS, max_new=8) == want
    assert junk.spec_proposed > 0
    fulls = [list(p) + list(o) for p, o in zip(SPEC_PROMPTS, want)]

    def oracle(tokens, k):
        for f in fulls:
            if f[: len(tokens)] == list(tokens):
                return f[len(tokens) : len(tokens) + k]
        return []

    orc = engine(model, max_batch=2, speculative_k=3, draft_fn=oracle)
    assert orc.run(SPEC_PROMPTS, max_new=8) == want
    st = orc.stats["speculative"]
    assert st == orc.speculative_stats and st["acceptance"] > 0.8
    assert orc.spec_proposed >= orc.spec_accepted > 0
    # acceptance means fewer decode dispatches than tokens
    assert orc.stats["decode_dispatches"] < junk.stats["decode_dispatches"]
    assert orc.stats["blocks_free"] == orc.stats["blocks_total"] - 1  # the dummy page


def test_engine_speculative_ngram_path(model):
    """The default n-gram drafter engages on repetitive output, at k 2 and at
    k 7 (sq 8: two row blocks of the decode kernel at the tiny config's
    GQA group of 2)."""
    prompt = [[3, 9, 4, 3, 9, 4, 3, 9]]
    want = engine(model, max_batch=1).run(prompt, max_new=6)
    for k in (2, 7):
        eng = engine(model, max_batch=1, speculative_k=k)
        assert eng.run(prompt, max_new=6) == want, k
        assert eng.spec_proposed > 0


def test_engine_speculative_matches_jax_engine(model):
    """Greedy speculative decode at k = 3 with one drafter in both engines
    (the true continuation, its later tokens corrupted at every other
    length, so steps accept all, some or none): JAX's tokens and, with no
    near-tie flip, JAX's spec_proposed / spec_accepted, decode dispatches
    and free blocks."""
    cfg, jw, _, _ = model
    fulls = [list(p) + o for p, o in
             zip(SPEC_PROMPTS, engine(model, max_batch=2).run(SPEC_PROMPTS, max_new=10))]

    def drafter(tokens, k):
        for f in fulls:
            if f[: len(tokens)] == list(tokens):
                d = f[len(tokens) : len(tokens) + k]
                return d if len(tokens) % 2 else d[:1] + [(t + 1) % 512 for t in d[1:]]
        return []

    kw = dict(num_blocks=64, block_size=16, max_batch=2, speculative_k=3, draft_fn=drafter)
    jeng = JaxEngine(cfg, jw, **kw)
    want = jeng.run([list(p) for p in SPEC_PROMPTS], max_new=10)
    eng = engine(model, **kw)
    got = eng.run(SPEC_PROMPTS, max_new=10)
    if hold_to_jax(model, SPEC_PROMPTS, want, got):
        assert (eng.spec_proposed, eng.spec_accepted) == (jeng.spec_proposed, jeng.spec_accepted)
        for key in ("decode_dispatches", "blocks_free", "speculative"):
            assert eng.stats[key] == jeng.stats[key], key
    assert eng.spec_proposed > eng.spec_accepted > 0


# ------------------------------------------------------------ prefix cache
def test_engine_prefix_cache_shares_and_stays_exact(model):
    """Requests sharing a long system prompt reuse its pages and decode the
    uncached engine's tokens."""
    sys_prompt = list(range(1, 40))  # 39 tokens: 2 full blocks of 16
    prompts = [sys_prompt + [100 + i] for i in range(3)]
    want = engine(model).run(prompts, max_new=4)
    eng = engine(model, prefix_cache=True)
    assert eng.run(prompts, max_new=4) == want
    assert eng.prefix_hits == 2 and eng.prefix_shared_blocks == 4  # 2 followers x 2 blocks
    assert eng.stats["prefix_hits"] == 2 and eng.stats["prefix_shared_blocks"] == 4


def test_engine_prefix_cache_retained_after_finish(model):
    """A finished request's pages are kept: a later request with the same
    prefix still hits, and decodes a fresh engine's tokens."""
    sys_prompt = list(range(3, 36))  # 33 tokens: 2 full blocks
    eng = engine(model, max_batch=2, prefix_cache=True)
    eng.run([sys_prompt + [7]], max_new=3)
    out2 = eng.run([sys_prompt + [9, 11]], max_new=3)
    assert eng.prefix_hits == 1 and eng.prefix_shared_blocks == 2
    assert out2 == engine(model, max_batch=2).run([sys_prompt + [9, 11]], max_new=3)


def test_engine_prefix_cache_eviction_under_pressure(model):
    """Kept pages are evicted LRU when the pool runs dry (the allocator's
    MemoryError); serving goes on, token-exact."""
    kw = dict(num_blocks=10, max_batch=1, max_blocks_per_seq=3)
    eng = engine(model, prefix_cache=True, **kw)
    for i in range(6):  # 6 distinct 2-block prompts > the 9 free blocks
        p = list(range(i * 50 + 1, i * 50 + 20))
        assert eng.run([p], max_new=3) == engine(model, **kw).run([p], max_new=3), i
    assert eng._retired and len(eng._retired) < 6  # some evicted, some kept


def test_engine_prefix_cache_matches_jax_engine(model):
    """Prefix caching over a shared 40-token prompt, then a second wave after
    the first finished: JAX's tokens and, with no near-tie flip, JAX's
    prefix_hits, prefix_shared_blocks and free blocks."""
    cfg, jw, _, _ = model
    sys_prompt = [int(t) for t in np.random.RandomState(5).randint(0, 512, 40)]
    waves = [[sys_prompt + [200 + i] * (1 + i) for i in range(3)],
             [sys_prompt + [300 + i, 301 + i] for i in range(2)]]
    kw = dict(num_blocks=64, block_size=16, max_batch=2, prefix_cache=True)
    jeng, eng = JaxEngine(cfg, jw, **kw), engine(model, **kw)
    exact = True
    for prompts in waves:
        want = jeng.run([list(p) for p in prompts], max_new=4)
        exact &= hold_to_jax(model, prompts, want, eng.run(prompts, max_new=4))
    assert eng.prefix_hits == 4 and eng.prefix_shared_blocks == 8
    if exact:
        for key in ("prefix_hits", "prefix_shared_blocks", "blocks_free"):
            assert eng.stats[key] == jeng.stats[key], key


# --------------------------------------------------------- n > 1, sampling
def test_engine_n_best_parallel_sampling(model):
    """One prefill, n continuations: the children share the parent's full
    blocks, own a copy of its partial tail page (equal contents in every
    cache tensor after the copy), diverge under temperature, and every
    page returns to the pool."""
    eng = engine(model, temperature=0.8, seed=7)
    free0 = eng.alloc.num_free
    prompt = list(range(1, 25))  # 24 tokens: 1 full + 1 partial block
    rids = eng.add_request(prompt, max_new=6, n=3)
    assert len(rids) == 3 and eng.requests[rids[0]].n_best == 3
    assert [eng.requests[r].parent for r in rids] == [None, rids[0], rids[0]]
    eng.step()  # the prefill: 3 first tokens, forks, copies
    pt = eng.alloc.table(rids[0])
    for crid in rids[1:]:
        ct = eng.alloc.table(crid)
        assert ct[0] == pt[0] and ct[1] != pt[1]
        for layer in eng.caches:
            for c in layer.values():
                assert torch.equal(c[:, int(ct[1])], c[:, int(pt[1])])
    while eng.step():
        pass
    outs = [eng.requests[r].out for r in rids]
    assert all(len(o) == 6 and all(0 <= t < 512 for t in o) for o in outs)
    assert len({tuple(o) for o in outs}) >= 2, outs
    assert eng.alloc.num_free == free0


def test_engine_n_best_topk1_is_greedy_under_multi_step_and_prefix_cache(model):
    """n = 3 at topk=1 (per request) under prefix caching: every
    continuation is the greedy one, and a second n-best request with the same
    prompt hits the kept pages. With multi_step=4 the children decode
    through the fused run at temperature, so only the first token (the eager
    sampler's, topk=1) is greedy there; the pages still all come back."""
    prompt = list(range(5, 30))  # 25 tokens
    want = engine(model).run([prompt], max_new=5)[0]
    eng = engine(model, temperature=0.8, prefix_cache=True)
    for wave in range(2):
        rids = eng.add_request(prompt, max_new=5, n=3, topk=1)
        while eng.step():
            pass
        assert [eng.requests[r].out for r in rids] == [want] * 3, wave
    assert eng.prefix_hits == 1
    fused = engine(model, temperature=0.8, prefix_cache=True, multi_step=4)
    free0 = fused.alloc.num_free
    rids = fused.add_request(prompt, max_new=5, n=3)
    while fused.step():
        pass
    assert all(len(fused.requests[r].out) == 5 for r in rids)
    fused._evict_one(), fused._evict_one(), fused._evict_one()
    assert fused.alloc.num_free == free0


def test_engine_cancel_parent_cancels_children(model):
    """Cancelling a parent before its prefill cancels its children; a child
    cancelled before the prefill is left out of it (JAX's engine would fork
    it and keep it in the batch, done, for ever), its siblings serve."""
    eng = engine(model, temperature=0.8)
    free0 = eng.alloc.num_free
    rids = eng.add_request([1, 2, 3], max_new=4, n=3)
    eng.cancel(rids[0])
    assert all(eng.requests[r].done for r in rids)
    assert not eng.step() and eng.alloc.num_free == free0
    rids = eng.add_request([1, 2, 3], max_new=4, n=3)
    eng.cancel(rids[1])
    while eng.step():
        pass
    assert eng.requests[rids[1]].out == []
    assert [len(eng.requests[r].out) for r in (rids[0], rids[2])] == [4, 4]
    assert eng.alloc.num_free == free0


def test_engine_temperature_seed_advances(model):
    """The seed advances a step: a fixed seed would replay one noise draw."""
    out = engine(model, max_batch=1, temperature=1.0, seed=3).run([[1, 2, 3]], max_new=12)[0]
    assert len(set(out)) >= 4, out


def test_engine_topk1_equals_greedy(model):
    """topk=1 keeps only the argmax, so the full-sampler path gives the greedy
    tokens exactly."""
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    want = engine(model, max_batch=2).run(prompts, max_new=5)
    eng = engine(model, max_batch=2, temperature=1.0, topk=1,
                 softmax_policy=SoftmaxPolicy.AFTER_TOPK)
    assert eng.run(prompts, max_new=5) == want


def test_engine_repetition_penalty_mask_accumulates(model):
    """The penalty mask row is seeded with the prompt and takes each sampled
    token through the sampler's in-place writeback, on the engine's device."""
    eng = engine(model, max_batch=2, temperature=0.9, topp=0.9, repetition_penalty=1.3, seed=11)
    assert eng.softmax_policy == SoftmaxPolicy.BEFORE_TOPK
    prompt = [5, 17, 300]
    rid = eng.add_request(list(prompt), max_new=4)
    while eng.step():
        pass
    out = eng.requests[rid].out
    assert len(out) == 4 and all(0 <= t < 512 for t in out)
    assert eng._penalty_mask.device == eng.device
    bits = np.unpackbits(eng._penalty_mask.numpy(), axis=1, bitorder="little")
    for t in prompt + out:
        assert bits[:, t].any(), t


def test_engine_penalty_slot_pool_grows(model):
    """More queued requests than mask rows: the pool grows from n rows to
    (n - 1) * 2 + 1, the scratch row staying last, instead of failing."""
    eng = engine(model, num_blocks=128, max_batch=1, temperature=0.9, repetition_penalty=1.2,
                 max_blocks_per_seq=2)
    n0 = eng._mask_slots
    outs = eng.run([[i + 1, i + 2] for i in range(n0 + 3)], max_new=2)
    assert all(len(o) == 2 for o in outs)
    assert eng._mask_slots == (n0 - 1) * 2 + 1
    assert eng._penalty_mask.shape[0] == eng._mask_slots
    assert sorted(eng._free_slots) == list(range(eng._mask_slots - 1))  # all returned


def test_engine_per_request_sampling_params(model):
    """A mixed batch: the engine-default greedy row stays exactly greedy, a
    per-request topk=1 row is greedy too, a sampled row stays in the vocab."""
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 6]]
    want = engine(model).run(prompts, max_new=5)
    eng = engine(model)
    r0 = eng.add_request(list(prompts[0]), max_new=5)
    r1 = eng.add_request(list(prompts[1]), max_new=5, temperature=1.0)
    r2 = eng.add_request(list(prompts[2]), max_new=5, temperature=1.0, topk=1)
    while eng.step():
        pass
    assert eng.requests[r0].out == want[0]
    assert eng.requests[r2].out == want[2]
    assert len(eng.requests[r1].out) == 5 and all(0 <= t < 512 for t in eng.requests[r1].out)


@pytest.mark.parametrize("penalty", [0.0, 1.1])
def test_engine_full_sampler_logprobs_and_one_copy_a_step(model, penalty):
    """topk=50, topp=0.9 (and a repetition penalty) with logprobs, a request
    of n = 3 and a per-request row: greedy (temperature 0) without the
    penalty, where it equals plain greedy decode; at temperature 1.2 with it
    (JAX rejects a greedy request under a repetition penalty). Every logprob
    is finite and <= 0, the children diverge, every page and mask row
    returns, and a decode step brings one tensor to the host."""
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    want = engine(model, max_batch=4).run(prompts[:1], max_new=5)[0]
    eng = engine(model, max_batch=4, temperature=0.8, topk=50, topp=0.9,
                 repetition_penalty=penalty, logprobs=True, seed=2)
    free0 = eng.alloc.num_free
    g = eng.add_request(prompts[0], max_new=5, temperature=1.2 if penalty else 0.0)
    kids = eng.add_request(prompts[1], max_new=5, n=3)
    eng.step(), eng.step()  # both prefills
    copies = []
    base_cpu, base_tolist = torch.Tensor.cpu, torch.Tensor.tolist

    def cpu(self, *a, **kw):
        copies.append("cpu")
        return base_cpu(self, *a, **kw)

    def tolist(self):
        copies.append("tolist")
        return base_tolist(self)

    torch.Tensor.cpu, torch.Tensor.tolist = cpu, tolist
    try:
        eng.step()  # one decode step of all four rows
    finally:
        torch.Tensor.cpu, torch.Tensor.tolist = base_cpu, base_tolist
    assert copies == ["cpu"], copies
    while eng.step():
        pass
    if not penalty:
        assert eng.requests[g].out == want
    outs = [eng.requests[r].out for r in kids]
    assert len({tuple(o) for o in outs}) >= 2, outs
    for r in [g] + kids:
        lp = eng.requests[r].logprobs
        assert len(lp) == 5 and all(np.isfinite(v) and v <= 0.0 for v in lp)
        assert all(0 <= t < 512 for t in eng.requests[r].out)
    assert eng.alloc.num_free == free0
    if penalty:
        assert sorted(eng._free_slots) == list(range(eng._mask_slots - 1))
