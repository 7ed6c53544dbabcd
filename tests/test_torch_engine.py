"""The port's serving engine: greedy parity with the JAX engine, and ports of
the core tests of tests/test_engine.py.

Weights are JAX's, carried over bit-exactly. Greedy outputs must be
identical; a flip is accepted only at a bf16 near-tie (JAX's top-2 logit
margin below the 0.15 logits tolerance of tests/test_model.py), and the
comparison stops there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as J
from hpc_ops_tpu.runtime.engine import Engine as JaxEngine
from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.runtime.engine import Engine
from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11]]


INT8 = dict(int8_kv=True, kv_scale=0.02)


@pytest.fixture(scope="module")
def model():
    cfg = J.tiny_config()
    jw = J.init_weights(jax.random.PRNGKey(0), cfg)
    tw = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    return cfg, jw, T.tiny_config(), tw


@pytest.fixture(scope="module")
def model_int8(model):
    """The same weights in the int8_kv serving mode (it changes no weight)."""
    _, jw, _, tw = model
    return J.tiny_config(**INT8), jw, T.tiny_config(**INT8), tw


@pytest.fixture(scope="module")
def model_moe():
    """tiny_config(moe=True): per-tensor fp8 experts, JAX's weights carried over."""
    cfg = J.tiny_config(moe=True)
    jw = J.init_weights(jax.random.PRNGKey(0), cfg)
    tw = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    return cfg, jw, T.tiny_config(moe=True), tw


@pytest.fixture(scope="module")
def model_fp8(model):
    """The same weights in the fp8_kv serving mode (it changes no weight)."""
    _, jw, _, tw = model
    return J.tiny_config(fp8_kv=True), jw, T.tiny_config(fp8_kv=True), tw


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


@pytest.mark.parametrize("chunk", [None, 2])
def test_engine_matches_jax_engine(model, chunk):
    cfg, jw, _, _ = model
    want = JaxEngine(cfg, jw, num_blocks=64, block_size=16, max_batch=4,
                     prefill_chunk=chunk).run(PROMPTS, max_new=4)
    got = engine(model, prefill_chunk=chunk).run(PROMPTS, max_new=4)
    for p, w, g in zip(PROMPTS, want, got):
        assert_greedy_match(w, g, lambda j, p=p, w=w: jax_margin(cfg, jw, p + w[:j]), 0.15)


def test_engine_int8_matches_jax_engine(model_int8):
    """int8_kv serving: greedy tokens equal to the JAX engine's on the same weights."""
    cfg, jw, _, _ = model_int8
    want = JaxEngine(cfg, jw, num_blocks=64, block_size=16, max_batch=4).run(PROMPTS, max_new=4)
    got = engine(model_int8).run(PROMPTS, max_new=4)
    for p, w, g in zip(PROMPTS, want, got):
        assert_greedy_match(w, g, lambda j, p=p, w=w: jax_margin(cfg, jw, p + w[:j]), 0.15)


def test_engine_fp8_matches_jax_engine(model_fp8):
    """fp8_kv serving: the engine drives the e4m3 caches unchanged; greedy
    tokens equal the JAX engine's on the same weights (a flip only at a
    near-tie of the JAX fp8 model's logits), and a batch decodes as each
    request alone."""
    cfg, jw, _, _ = model_fp8
    want = JaxEngine(cfg, jw, num_blocks=64, block_size=16, max_batch=4).run(PROMPTS, max_new=4)
    eng = engine(model_fp8)
    got = eng.run(PROMPTS, max_new=4)
    for p, w, g in zip(PROMPTS, want, got):
        assert_greedy_match(w, g, lambda j, p=p, w=w: jax_margin(cfg, jw, p + w[:j]), 0.15)
    assert all(c["k"].dtype == torch.float8_e4m3fn for c in eng.caches)
    assert got == [engine(model_fp8, max_batch=1).run([p], max_new=4)[0] for p in PROMPTS]


def test_engine_dense_int8_serving():
    """dense_int8 serving on the port's own quantised weights: a batch
    decodes exactly as each request alone (activation scales are per token)."""
    tcfg = T.tiny_config(dense_int8=True)
    m = (None, None, tcfg, T.init_weights(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    batch_out = engine(m).run(PROMPTS, max_new=4)
    assert batch_out == [engine(m, max_batch=1).run([p], max_new=4)[0] for p in PROMPTS]
    assert all(len(o) == 4 and all(0 <= t < 512 for t in o) for o in batch_out)


def test_engine_moe_matches_jax_engine(model_moe):
    """fp8 MoE serving: the engine drives the MoE model unchanged, and its
    greedy tokens equal the JAX engine's on the same weights."""
    cfg, jw, _, _ = model_moe
    want = JaxEngine(cfg, jw, num_blocks=64, block_size=16, max_batch=4).run(PROMPTS, max_new=3)
    got = engine(model_moe).run(PROMPTS, max_new=3)
    for p, w, g in zip(PROMPTS, want, got):
        assert_greedy_match(w, g, lambda j, p=p, w=w: jax_margin(cfg, jw, p + w[:j]), 0.15)
    assert all(len(g) == 3 for g in got)


def test_engine_int8_kv_serving(model_int8):
    """The port of tests/test_engine.py's int8 test: the engine drives the
    int8 slabs unchanged, and a batch decodes exactly as each request alone."""
    batch_out = engine(model_int8).run(PROMPTS, max_new=4)
    solo_out = [engine(model_int8, max_batch=1).run([p], max_new=4)[0] for p in PROMPTS]
    assert batch_out == solo_out
    for out in batch_out:
        assert len(out) == 4 and all(0 <= t < 512 for t in out)
    assert [set(c) for c in engine(model_int8).caches] == [{"kv"}] * 2


def test_engine_batch_matches_solo(model):
    batch_out = engine(model).run(PROMPTS, max_new=4)
    solo_out = [engine(model, max_batch=1).run([p], max_new=4)[0] for p in PROMPTS]
    assert batch_out == solo_out
    for out in batch_out:
        assert len(out) == 4 and all(0 <= t < 512 for t in out)


def test_engine_streams_and_frees(model):
    eng = engine(model, num_blocks=32, max_batch=2)
    free0 = eng.alloc.num_free
    r1 = eng.add_request([1, 2, 3], max_new=2)
    r2 = eng.add_request([4, 5], max_new=3)
    while eng.step():
        pass
    assert eng.requests[r1].done and eng.requests[r2].done
    assert len(eng.requests[r1].out) == 2 and len(eng.requests[r2].out) == 3
    assert eng.alloc.num_free == free0


def test_engine_more_requests_than_batch(model):
    outs = engine(model, max_batch=2).run([[1, 2], [3, 4], [5, 6]], max_new=3)
    assert all(len(o) == 3 for o in outs)


def test_engine_chunked_prefill(model):
    prompts = [list(range(1, 20)), [7, 8, 9], list(range(30, 60))]
    ref = engine(model).run(prompts, max_new=5)
    for chunk in (4, 16):
        assert engine(model, prefill_chunk=chunk).run(prompts, max_new=5) == ref


def test_engine_chunked_prefill_interleaves(model):
    eng = engine(model, prefill_chunk=4)
    r1 = eng.add_request([1, 2, 3], max_new=4)
    r2 = eng.add_request(list(range(1, 41)), max_new=2)
    eng.step()
    assert eng.requests[r1].prefilled == 3 and len(eng.requests[r1].out) == 1
    eng.step()
    assert len(eng.requests[r1].out) == 2 and eng.requests[r2].prefilled == 0
    eng.step()
    assert eng.requests[r2].prefilled == 4
    while eng.step():
        pass
    assert eng.requests[r2].done and len(eng.requests[r2].out) == 2


def test_engine_stop_tokens(model):
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    full = engine(model, max_batch=2).run([list(p) for p in prompts], max_new=8)
    stop = full[0][2]
    eng = engine(model, max_batch=2, stop_tokens=[stop])
    outs = eng.run([list(p) for p in prompts], max_new=8)
    assert outs[0] == full[0][:3]
    if stop not in full[1]:
        assert outs[1] == full[1]
    assert eng.requests[0].done


def test_engine_cancel(model):
    want = engine(model, max_batch=2).run([[1, 2, 3]], max_new=6)[0]
    eng = engine(model, max_batch=2)
    free0 = eng.alloc.num_free
    keep = eng.add_request([1, 2, 3], max_new=6)
    kill = eng.add_request([7, 8, 9, 10], max_new=6)
    eng.step(); eng.step(); eng.step()  # noqa: E702
    eng.cancel(kill)
    while eng.step():
        pass
    assert eng.requests[keep].out == want
    assert eng.requests[kill].done and len(eng.requests[kill].out) < 6
    assert eng.alloc.num_free == free0
    r3 = eng.add_request([5, 6], max_new=4)
    eng.cancel(r3)
    assert not eng.step()
    assert eng.alloc.num_free == free0


def test_engine_stats_and_sampling(model):
    eng = engine(model, temperature=0.8, seed=3)
    eng.run([[1, 2, 3], [4, 5]], max_new=3)
    s = eng.stats
    assert s["done"] == 2 and s["tokens_out"] == 6 and s["pending"] == 0
    assert s["prefill_dispatches"] == 2 and s["decode_dispatches"] >= 2
    with pytest.raises(ValueError, match="caps a sequence"):
        eng.add_request(list(range(300)), max_new=10)


@pytest.mark.parametrize(
    "kw", [{"speculative_k": 2}, {"multi_step": 4}, {"prefix_cache": True},
           {"topk": 5, "temperature": 1.0}, {"logprobs": True}],
)
def test_engine_deferred_features_raise(model, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 1"):
        engine(model, **kw)


def test_engine_defaults_to_the_card(model):
    """Without a device argument the engine runs on CUDA: where there is no
    card it raises instead of falling back to the CPU."""
    _, _, tcfg, tw = model
    if torch.cuda.is_available():
        assert Engine(tcfg, tw, num_blocks=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(tcfg, tw, num_blocks=8)
