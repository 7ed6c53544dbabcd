"""The port's hybrid (ddp x dp x tp) mesh on CPU ranks: the counterparts of
tests/test_multihost.py's eight cases, the mesh against JAX's, and the
per-device form of the fused collective.

``make_hybrid_mesh(2, 4, devices=["cpu"] * 8)``: two row shards ("hosts")
of four tp ranks, as JAX's test mesh. Weights are JAX's
(``init_weights(PRNGKey(3), tiny_config())``), carried over bit-exactly by
the converter. Each case holds the port's ShardedEngine against the port's
single-device Engine; greedy tokens must be identical, and a flip is
accepted only at a bf16 near-tie (the reference's top-2 logit margin below
the 0.15 logits tolerance of tests/test_model.py), the comparison stopping
there, as in tests/test_torch_sharded_engine.py: the tp step normalises the
float32 sum of the ranks' partials where one device rounds each residual
to bf16 first. One case is also held against JAX's ShardedEngine over
JAX's hybrid mesh of 8 host devices.

The per-device collective (a launch a rank) is checked bit for bit against
the one-launch form's plain version: both sum every row in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as J
from hpc_ops_tpu.parallel.mesh import make_hybrid_mesh as jax_make_hybrid_mesh
from hpc_ops_tpu.runtime.sharded_engine import ShardedEngine as JaxShardedEngine
from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.parallel import make_mesh
from hpc_ops_tpu_torch.parallel import mesh as M
from hpc_ops_tpu_torch.parallel.collective_kernels import (
    _allreduce_rmsnorm_ref,
    allreduce_rmsnorm,
    allreduce_rmsnorm_rank,
    collective_rmsnorm,
)
from hpc_ops_tpu_torch.parallel.mesh import make_hybrid_mesh, run_ranks
from hpc_ops_tpu_torch.runtime.engine import Engine
from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine
from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17], [21, 22], [31]]
KW = dict(num_blocks=64, block_size=16, max_batch=4, max_blocks_per_seq=4)
TOL = 0.15


def to_port(jw):
    return T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")


@pytest.fixture(scope="module")
def model():
    cfg = J.tiny_config()
    jw = J.init_weights(jax.random.PRNGKey(3), cfg)
    return cfg, jw, to_port(jw)


def hybrid():
    return make_hybrid_mesh(2, 4, devices=["cpu"] * 8)


def port_margin(tcfg, tw):
    """The port's single-device top-2 margin after ``tokens`` (a prefill)."""
    def margin(tokens):
        n = len(tokens)
        t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
        logits, _ = T.forward_step(tw, T.init_cache(tcfg, 8, 16, device="cpu"), tcfg, t(tokens), t([n]),
                                   t([0, n]), t([list(range(8))]), is_prefill=True, max_seqlens_q=n)
        return top2_margin(logits.float())
    return margin


def match_all(prompts, want, got, margin):
    return [assert_greedy_match(w, g, lambda j, p=p, w=w: margin(p + w[:j]), TOL)
            for p, w, g in zip(prompts, want, got)]


def test_mesh_matches_jax_hybrid_mesh():
    mesh = hybrid()
    jmesh = jax_make_hybrid_mesh(dcn_dp=2, tp=4, dp=1, devices=jax.devices("cpu")[:8])
    assert mesh.axis_names == jmesh.axis_names == ("ddp", "dp", "tp")
    assert dict(mesh.shape) == dict(jmesh.shape) and mesh.devices.shape == jmesh.devices.shape
    assert mesh.grid.shape == (2, 4)
    # the row shards are ddp-major: shard d of make_mesh(tp, dp) is shard d here
    seen = run_ranks(hybrid(), lambda g, d: (d, g.rank))
    assert seen == [[(d, r) for r in range(4)] for d in range(2)]
    with pytest.raises(ValueError, match="needs 8 CUDA devices"):
        make_hybrid_mesh(2, 4)  # devices=None: every visible card (none here)


def test_sharded_engine_hybrid_mesh_matches_single_device(model):
    """tests/test_multihost.py's first case."""
    _, _, tw = model
    tcfg = T.tiny_config()
    want = Engine(tcfg, tw, device="cpu", **KW).run(PROMPTS, max_new=6)
    eng = ShardedEngine(tcfg, tw, hybrid(), **KW)
    got = eng.run(PROMPTS, max_new=6)
    match_all(PROMPTS, want, got, port_margin(tcfg, tw))
    st = eng.stats
    assert st["done"] == len(PROMPTS) and st["blocks_free"] == st["blocks_total"] - 2
    assert eng.row_axes == ("ddp", "dp") and eng.num_shards == 2
    assert st["prefill_dispatches"] == 3  # two requests a round, one per row shard


def jax_margin(cfg, jw):
    """JAX's single-device top-2 margin after ``tokens`` (a prefill)."""
    def margin(tokens):
        n = len(tokens)
        logits, _ = J.forward_step(jw, J.init_cache(cfg, num_blocks=8, block_size=16), cfg,
                                   jnp.asarray(tokens, jnp.int32), jnp.asarray([n], jnp.int32),
                                   jnp.asarray([0, n], jnp.int32), jnp.asarray([list(range(8))], jnp.int32),
                                   is_prefill=True, max_seqlens_q=n)
        return top2_margin(np.asarray(logits, np.float32))
    return margin


def test_sharded_engine_hybrid_mesh_matches_jax_hybrid_engine(model):
    """The same prompts through JAX's ShardedEngine on its hybrid mesh of 8
    host devices (its interpret-mode kernels under one jit per step)."""
    cfg, jw, tw = model
    jmesh = jax_make_hybrid_mesh(dcn_dp=2, tp=4, dp=1, devices=jax.devices("cpu")[:8])
    want = JaxShardedEngine(cfg, jw, jmesh, **KW).run([list(p) for p in PROMPTS], max_new=6)
    got = ShardedEngine(T.tiny_config(), tw, hybrid(), **KW).run(PROMPTS, max_new=6)
    match_all(PROMPTS, want, got, jax_margin(cfg, jw))


def test_sharded_engine_chunked_prefill_matches_oneshot(model):
    """Chunks of 4 (decode rounds in between, each request pinned to its row
    shard) against the single-device Engine's one-shot prefill."""
    _, _, tw = model
    tcfg = T.tiny_config()
    prompts = [list(range(1, 12)), [7, 8, 9], list(range(20, 29)), [41, 42]]
    want = Engine(tcfg, tw, device="cpu", **KW).run(prompts, max_new=5)
    eng = ShardedEngine(tcfg, tw, hybrid(), prefill_chunk=4, **KW)
    match_all(prompts, want, eng.run(prompts, max_new=5), port_margin(tcfg, tw))
    assert eng.stats["prefill_dispatches"] > 2


def test_sharded_engine_multi_step_matches_single(model):
    """Fused rounds of 3 steps over the hybrid mesh (one run of the mesh a
    round) against the single-device Engine; surplus tokens dropped."""
    _, _, tw = model
    tcfg = T.tiny_config()
    prompts = PROMPTS[:4]
    want = Engine(tcfg, tw, device="cpu", **KW).run(prompts, max_new=5)
    eng = ShardedEngine(tcfg, tw, hybrid(), multi_step=3, **KW)
    got = eng.run(prompts, max_new=5)
    match_all(prompts, want, got, port_margin(tcfg, tw))
    assert all(len(g) == 5 for g in got)
    assert eng.stats["blocks_free"] == eng.stats["blocks_total"] - 2


def test_sharded_engine_rejects_oversized_request(model):
    _, _, tw = model
    eng = ShardedEngine(T.tiny_config(), tw, hybrid(), num_blocks=64, block_size=16, max_batch=2,
                        max_blocks_per_seq=2)
    with pytest.raises(ValueError, match="KV slots"):
        eng.add_request(list(range(100)), max_new=8)


def test_sharded_engine_stop_tokens(model):
    """A stop token ends a request on single-step and fused rounds: the
    Engine's tokens up to and including the first stop token."""
    _, _, tw = model
    tcfg = T.tiny_config()
    prompts = PROMPTS[:2]
    full = Engine(tcfg, tw, device="cpu", max_batch=2, num_blocks=64, block_size=16,
                  max_blocks_per_seq=4).run(prompts, max_new=6)
    stop = full[0][2]
    for ms in (1, 3):
        eng = ShardedEngine(tcfg, tw, hybrid(), num_blocks=64, block_size=16, max_batch=2,
                            max_blocks_per_seq=4, multi_step=ms, stop_tokens=[stop])
        got = eng.run(prompts, max_new=6)
        for want, out in zip(full, got):
            cut = next((i for i, t in enumerate(want) if t == stop), len(want) - 1)
            assert out == want[: cut + 1], ms


def test_sharded_engine_int8_kv(model):
    """The fused int8 K|V slab, its lanes split over tp, on the hybrid mesh
    against the single-device int8 Engine (JAX's weights of PRNGKey(1))."""
    cfg = J.tiny_config(int8_kv=True, kv_scale=0.02)
    tw = to_port(J.init_weights(jax.random.PRNGKey(1), cfg))
    tcfg = T.tiny_config(int8_kv=True, kv_scale=0.02)
    prompts = [[1, 2, 3], [7, 8], [9, 10, 11], [21]]
    want = Engine(tcfg, tw, device="cpu", **KW).run(prompts, max_new=4)
    got = ShardedEngine(tcfg, tw, hybrid(), **KW).run(prompts, max_new=4)
    match_all(prompts, want, got, port_margin(tcfg, tw))


def test_sharded_engine_logprobs(model):
    """One logprob an output token on single-step and fused rounds, within
    tests/test_multihost.py's 5e-2 of the single-device Engine's."""
    _, _, tw = model
    tcfg = T.tiny_config()
    prompts = [[1, 2, 3, 4], [7, 8]]
    kw = dict(num_blocks=64, block_size=16, max_batch=2, max_blocks_per_seq=4, logprobs=True)
    single = Engine(tcfg, tw, device="cpu", **kw)
    want = single.run(prompts, max_new=4)
    margin = port_margin(tcfg, tw)
    for ms in (1, 3):
        eng = ShardedEngine(tcfg, tw, hybrid(), multi_step=ms, **kw)
        got = eng.run(prompts, max_new=4)
        for i, j in enumerate(match_all(prompts, want, got, margin)):
            lp = eng.requests[i].logprobs
            assert len(lp) == len(got[i]) and all(v <= 0.0 for v in lp)
            np.testing.assert_allclose(lp[:j], single.requests[i].logprobs[:j], rtol=5e-2, atol=5e-2)


def test_sharded_engine_temperature_sampling(model):
    """Deterministic for a seed, diverse across steps, valid tokens, on both
    decode modes; and the rows are placed in JAX's order (least-loaded
    shard, shards ddp-major), so the hybrid mesh samples what a (dp 2, tp 4)
    mesh of the same row shards samples from the same seed."""
    _, _, tw = model
    tcfg = T.tiny_config()
    prompts = [[1, 2, 3], [7, 8]]
    kw = dict(num_blocks=64, block_size=16, max_batch=2, max_blocks_per_seq=4, temperature=1.0, seed=11)
    for ms in (1, 3):
        runs = [ShardedEngine(tcfg, tw, hybrid(), multi_step=ms, **kw).run(prompts, max_new=8)
                for _ in range(2)]
        assert runs[0] == runs[1], f"ms={ms} not deterministic"
        for o in runs[0]:
            assert len(o) == 8 and all(0 <= t < tcfg.vocab for t in o)
            assert len(set(o)) >= 3, f"degenerate: {o}"
        flat = make_mesh(tp=4, dp=2, devices=["cpu"] * 8)
        assert ShardedEngine(tcfg, tw, flat, multi_step=ms, **kw).run(prompts, max_new=8) == runs[0]


def collective_inputs(ws, n, h, seed):
    rng = np.random.RandomState(seed)
    xs = [torch.from_numpy(rng.randn(n, h).astype(np.float32) * 0.5).to(torch.bfloat16) for _ in range(ws)]
    res = torch.from_numpy(rng.randn(n, h).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.rand(h).astype(np.float32) + 0.5)
    return xs, res, w


@pytest.mark.parametrize("bf16_norm", [False, True])
@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
@pytest.mark.parametrize("ws", [1, 2, 4, 8])
def test_per_rank_plain_path_equals_one_launch_plain_path(ws, mode, bf16_norm):
    """Each rank's share of the rows (one_shot rows r, r + ws, ...; two_shot
    its chunk), written into every rank's outputs rank by rank, equals the
    one-launch form's plain version bit for bit: every row is summed in the
    same absolute rank order. n = 37 leaves one_shot's shares ragged."""
    n, h = (37 if mode == "one_shot" else 64), 264
    xs, res, w = collective_inputs(ws, n, h, seed=ws)
    want = _allreduce_rmsnorm_ref(xs, res, w, 1e-5, mode, bf16_norm)
    one = [torch.empty((n, h), dtype=torch.bfloat16) for _ in range(2 * ws)]
    allreduce_rmsnorm(xs, [res] * ws, [w] * ws, one[:ws], one[ws:], 1e-5, mode, bf16_norm)
    outs = [torch.full((n, h), float("nan"), dtype=torch.bfloat16) for _ in range(2 * ws)]
    for r in range(ws):
        allreduce_rmsnorm_rank(xs, [res] * ws, [w] * ws, outs[:ws], outs[ws:], 1e-5, mode, bf16_norm, r)
    for o, o_res, a, a_res in zip(outs[:ws], outs[ws:], one[:ws], one[ws:]):
        assert torch.equal(o, want[0]) and torch.equal(o_res, want[1])
        assert torch.equal(o, a) and torch.equal(o_res, a_res)


@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
def test_per_device_switch_runs_the_per_rank_path_on_every_group(mode):
    """The mesh's private switch sends both tp groups of the hybrid mesh
    through the per-device action; each group's outputs equal the plain
    version's, and the groups stay apart."""
    mesh = hybrid()
    mesh._per_device = True
    assert all(g[0].rendezvous.per_device for g in mesh._runtime()[1])
    ins = [collective_inputs(4, 32, 128, seed=10 + d) for d in range(2)]
    outs = run_ranks(mesh, lambda g, d: collective_rmsnorm(g, ins[d][0][g.rank], ins[d][1], ins[d][2], 1e-6,
                                                           mode, bf16_norm=False))
    for d in range(2):
        want = _allreduce_rmsnorm_ref(ins[d][0], ins[d][1], ins[d][2], 1e-6, mode, False)
        for o, o_res in outs[d]:
            assert torch.equal(o, want[0]) and torch.equal(o_res, want[1])
    assert not torch.equal(outs[0][0][0], outs[1][0][0])


def test_layouts_over_distinct_devices_are_checked(monkeypatch):
    """A mesh over distinct CUDA devices: a rank a device, or a tp group a
    device; any other mix, a device this process does not see, or a pair
    without peer access raises ValueError, before anything is staged."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    with pytest.raises(ValueError, match="not visible"):
        make_mesh(tp=2, devices=cuda[:2])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="one rank on a device"):
        make_mesh(tp=4, devices=[cuda[0], cuda[0], cuda[1], cuda[1]])
    with pytest.raises(ValueError, match="one rank on a device"):
        make_hybrid_mesh(2, 2, devices=[cuda[0], cuda[1], cuda[0], cuda[1]])
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    with pytest.raises(ValueError, match="cuda:0 cannot access cuda:1"):
        make_hybrid_mesh(2, 2, devices=[cuda[0], cuda[0], cuda[1], cuda[1]])  # a group a device
    with pytest.raises(ValueError, match="no peer access"):
        make_mesh(tp=4, devices=cuda)  # a rank a device
    with pytest.raises(ValueError, match="end in 'tp'"):
        M.Mesh(np.empty((2, 2), dtype=object), ("tp", "dp"))
