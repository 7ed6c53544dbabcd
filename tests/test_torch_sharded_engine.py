"""The port's ShardedEngine on CPU ranks: greedy parity with the port's
single-device Engine and with JAX's ShardedEngine, and the engine features.

Weights are JAX's (``init_weights(PRNGKey(3), tiny_config())``), carried over
bit-exactly. Greedy tokens must be identical; a flip is accepted only at a
bf16 near-tie (the reference's top-2 logit margin below the 0.15 logits
tolerance of tests/test_model.py), and the comparison stops there, as in
tests/test_torch_engine.py. The tp step normalises the float32 sum of the
ranks' partials where one device rounds each residual to bf16 first, so
near-ties can flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as J
from hpc_ops_tpu.parallel import make_mesh as jax_make_mesh
from hpc_ops_tpu.runtime.sharded_engine import ShardedEngine as JaxShardedEngine
from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.parallel import make_mesh
from hpc_ops_tpu_torch.runtime.engine import Engine
from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine
from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17], [21, 22], [31]]
KW = dict(num_blocks=64, block_size=16, max_batch=4, max_blocks_per_seq=4)
TOL = 0.15


@pytest.fixture(scope="module")
def model():
    cfg = J.tiny_config()
    jw = J.init_weights(jax.random.PRNGKey(3), cfg)
    return cfg, jw, T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")


def mesh22():
    return make_mesh(tp=2, dp=2, devices=["cpu"] * 4)


def port_margin(tcfg, tw):
    """The port's single-device top-2 margin after ``tokens`` (a prefill)."""
    def margin(tokens):
        n = len(tokens)
        t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
        logits, _ = T.forward_step(tw, T.init_cache(tcfg, 8, 16, device="cpu"), tcfg, t(tokens), t([n]),
                                   t([0, n]), t([list(range(8))]), is_prefill=True, max_seqlens_q=n)
        return top2_margin(logits.float())
    return margin


def match_all(want, got, margin):
    for p, w, g in zip(PROMPTS, want, got):
        assert_greedy_match(w, g, lambda j, p=p, w=w: margin(p + w[:j]), TOL)


@pytest.mark.parametrize("kw", [dict(), dict(int8_kv=True, kv_scale=0.02)])
def test_sharded_engine_matches_engine(model, kw):
    """(dp 2, tp 2) greedy tokens against the port's single-device Engine on
    the same weights, bf16 KV and the int8 NHD_FUSED slab split over tp."""
    _, _, tw = model
    tcfg = T.tiny_config(**kw)
    want = Engine(tcfg, tw, device="cpu", **KW).run(PROMPTS, max_new=6)
    eng = ShardedEngine(tcfg, tw, mesh22(), **KW)
    got = eng.run(PROMPTS, max_new=6)
    match_all(want, got, port_margin(tcfg, tw))
    st = eng.stats
    assert st["done"] == len(PROMPTS) and st["tokens_out"] == 6 * len(PROMPTS)
    assert st["blocks_free"] == st["blocks_total"] - 2  # only each shard's reserved page is held
    assert st["prefill_dispatches"] == 3  # two requests a round, one per shard


def test_sharded_engine_matches_jax_sharded_engine(model):
    """The same prompts through JAX's ShardedEngine on a (dp 2, tp 2) host
    mesh (its interpret-mode kernels under one jit per step)."""
    cfg, jw, tw = model
    jmesh = jax_make_mesh(tp=2, dp=2, devices=jax.devices("cpu")[:4])
    want = JaxShardedEngine(cfg, jw, jmesh, **KW).run([list(p) for p in PROMPTS], max_new=6)
    got = ShardedEngine(T.tiny_config(), tw, mesh22(), **KW).run(PROMPTS, max_new=6)

    def jax_margin(tokens):
        n = len(tokens)
        logits, _ = J.forward_step(jw, J.init_cache(cfg, num_blocks=8, block_size=16), cfg,
                                   jnp.asarray(tokens, jnp.int32), jnp.asarray([n], jnp.int32),
                                   jnp.asarray([0, n], jnp.int32), jnp.asarray([list(range(8))], jnp.int32),
                                   is_prefill=True, max_seqlens_q=n)
        return top2_margin(np.asarray(logits, np.float32))

    match_all(want, got, jax_margin)


def test_chunked_prefill_equals_one_shot(model):
    """Prompts streamed in chunks of 2 (decode rounds in between, each
    request pinned to its shard) give the one-shot prefill's tokens."""
    _, _, tw = model
    tcfg = T.tiny_config()
    base = ShardedEngine(tcfg, tw, mesh22(), **KW).run(PROMPTS, max_new=6)
    eng = ShardedEngine(tcfg, tw, mesh22(), prefill_chunk=2, **KW)
    got = eng.run(PROMPTS, max_new=6)
    match_all(base, got, port_margin(tcfg, tw))
    assert eng.stats["prefill_dispatches"] > 3


def test_stop_tokens_end_requests(model):
    _, _, tw = model
    tcfg = T.tiny_config()
    free = ShardedEngine(tcfg, tw, mesh22(), **KW).run(PROMPTS[:2], max_new=6)
    stop = free[0][2]
    eng = ShardedEngine(tcfg, tw, mesh22(), stop_tokens=[stop], **KW)
    got = eng.run(PROMPTS[:2], max_new=6)
    assert got[0] == free[0][: free[0].index(stop) + 1]
    for want, out in zip(free, got):
        cut = next((i for i, t in enumerate(want) if t == stop), len(want) - 1)
        assert out == want[: cut + 1]


def test_temperature_sampling_is_seeded(model):
    _, _, tw = model
    tcfg = T.tiny_config()
    runs = [ShardedEngine(tcfg, tw, mesh22(), temperature=0.8, seed=s, **KW).run(PROMPTS, max_new=4)
            for s in (5, 5, 6)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(0 <= t < tcfg.vocab for out in runs[0] for t in out)


def test_refusals(model):
    _, _, tw = model
    tcfg = T.tiny_config()
    eng = ShardedEngine(tcfg, tw, mesh22(), **KW)
    with pytest.raises(ValueError, match="caps a sequence at 64"):
        eng.add_request(list(range(60)), max_new=8)
    with pytest.raises(NotImplementedError, match="item 1a"):
        ShardedEngine(tcfg, tw, mesh22(), multi_step=4, **KW)
    with pytest.raises(NotImplementedError, match="item 1b"):
        ShardedEngine(tcfg, tw, mesh22(), logprobs=True, **KW)
