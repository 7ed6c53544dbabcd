"""The port's tensor-parallel Llama (``shard_weights``, ``make_sharded_step``)
on CPU ranks against the JAX package.

JAX's weights (``init_weights(PRNGKey(7), tiny_config(...))``) are carried
over bit-exactly. Tolerances:

  * the column repacks and ``shard_weights_for_tp``: bit-equal to JAX's;
  * ``make_sharded_step`` on a (dp 2, tp 4) mesh against JAX's single-device
    ``forward_step`` on the same requests: atol 0.3 / rtol 0.1, the tolerance
    of tests/test_model.py:160-208 (the tp step normalises the float32 sum of
    the ranks' bf16 partials where one device rounds each residual to bf16
    first; the MoE quantises its activations per dp shard). JAX's MoE runs
    its plain jnp form there, as in tests/test_torch_moe_bw.py (its
    interpret-mode row-gather kernels cost seconds a call): ``impl="ref"``
    for the fp8 experts, a dense jnp blockwise MoE for ``blockwise_int8``;
  * against JAX's own ``make_sharded_step`` on the 8 host devices, and
    ``int8_kv`` / ``dense_int8`` under tp against the port's single-device
    ``forward_step``: the same 0.3 / 0.1.
"""

import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as J
from hpc_ops_tpu.ops import moe as JM
from hpc_ops_tpu.parallel import make_mesh as jax_make_mesh
from hpc_ops_tpu.utils.common import set_interpret_override
from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.parallel import make_mesh
from hpc_ops_tpu_torch.utils.testing import assert_allclose
from test_torch_moe_bw import dense_blockwise_moe

torch.set_num_threads(1)

TP, DP = 4, 2
ATOL, RTOL = 0.3, 0.1


def configs(moe=None, **kw):
    """(JAX config, port config) of tiny_config with ``moe`` as the scheme."""
    pair = []
    for pkg in (J, T):
        cfg = pkg.tiny_config(moe=moe is not None, **kw)
        pair.append(cfg._replace(moe=cfg.moe._replace(scheme=moe)) if moe else cfg)
    return pair


def carried(moe=None, qkv_bias=False, **kw):
    cfg, tcfg = configs(moe, qkv_bias=qkv_bias, **kw)
    jw = J.init_weights(jax.random.PRNGKey(7), cfg)
    if qkv_bias:  # JAX's init_weights draws none; a seeded bias on every layer
        rng = np.random.RandomState(1)
        jw = {**jw, "layers": [{**layer, "qkv_bias": jnp.asarray(rng.randn(cfg.qkv_out) * 0.5, jnp.float32)}
                               for layer in jw["layers"]]}
    return cfg, jw, tcfg, T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")


def same_bits(t: torch.Tensor, j) -> bool:
    jn = np.ascontiguousarray(np.asarray(j))
    tn = t.contiguous().view(torch.uint8).numpy() if t.element_size() == 1 else (
        t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy())
    return tuple(t.shape) == jn.shape and np.array_equal(tn.reshape(-1).view(np.uint8),
                                                         jn.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("tp", [2, 4])
def test_repacks_and_shard_weights_for_tp_equal_jax(tp):
    """Every leaf of ``shard_weights_for_tp`` (qkv bias, W8A8 weights and
    scales included) and both repacks bit-equal to JAX's on the same arrays;
    ``shard_weights``'s rank shards concatenate back to the repacked leaf."""
    cfg, jw, tcfg, tw = carried(qkv_bias=True, dense_int8=True)
    jr = J.shard_weights_for_tp(jw, cfg, tp)
    tr = T.shard_weights_for_tp(tw, tcfg, tp)
    for jl, tl in zip(jr["layers"], tr["layers"]):
        assert set(jl) == set(tl)
        for k in jl:
            assert same_bits(tl[k], jl[k]), k
    layer = tw["layers"][0]
    assert same_bits(T.repack_qkv_for_tp(layer["wqkv"], tcfg, tp),
                     J.repack_qkv_for_tp(jw["layers"][0]["wqkv"], cfg, tp))
    assert same_bits(T.repack_gate_up_for_tp(layer["w_gate_up"], tp),
                     J.repack_gate_up_for_tp(jw["layers"][0]["w_gate_up"], tp))
    ranks = T.shard_weights(tw, tcfg, make_mesh(tp=tp, devices=["cpu"] * tp))
    specs = T.shard_weights_specs(tcfg)["layers"][0]
    for li, lt in enumerate(tr["layers"]):
        for k, v in lt.items():
            parts = [r["layers"][li][k] for r in ranks]
            if specs[k] is None:
                assert all(p is v or torch.equal(p, v) for p in parts), k
            else:
                assert torch.equal(torch.cat(parts, dim=specs[k]), v), k
    # W8A8 matrices keep the column-major layout of quantize_w8
    assert ranks[1]["layers"][0]["wo"].stride() == (1, tcfg.q_heads * tcfg.head_dim // tp)


@pytest.mark.parametrize("kw", [dict(), dict(qkv_bias=True, dense_int8=True),
                                dict(moe="pertensor_fp8"), dict(moe="pertensor_int8"),
                                dict(moe="blockwise_int8")])
def test_shard_weights_specs_match_jax(kw):
    cfg, tcfg = configs(kw.pop("moe", None), **kw)
    want = J.shard_weights_specs(cfg)
    got = T.shard_weights_specs(tcfg)

    def dim(p):
        return next((i for i, a in enumerate(p) if a == "tp"), None)

    assert {k: dim(v) for k, v in want.items() if k != "layers"} == {
        k: v for k, v in got.items() if k != "layers"}
    assert [{k: dim(v) for k, v in layer.items()} for layer in want["layers"]] == got["layers"]


def sharded_decode(tcfg, tw, dp=DP, tp=TP, caches=None):
    """JAX's test_sharded_step_tp_dp step: one decode token for each of 2
    requests per dp shard, each shard a local pool of 4 pages."""
    mesh = make_mesh(tp=tp, dp=dp, devices=["cpu"] * (tp * dp))
    weights = T.shard_weights(tw, tcfg, mesh)
    if caches is None:
        caches = [[T.init_cache(tcfg, 4, 16, tp=tp, device="cpu") for _ in range(tp)] for _ in range(dp)]
    step = T.make_sharded_step(mesh, tcfg, is_prefill=False, max_seqlens_q=1)
    b = 2 * dp
    out, caches = step(weights, caches, torch.arange(1, b + 1, dtype=torch.int32),
                       torch.ones(b, dtype=torch.int32),
                       torch.from_numpy(np.tile(np.int32([0, 1, 2]), dp)),
                       torch.from_numpy(np.tile(np.int32([[0, 1], [2, 3]]), (dp, 1))))
    return out, caches


def jax_single_decode(cfg, jw, dp=DP):
    b = 2 * dp
    forward = J.forward_step
    if cfg.moe is None or cfg.moe.scheme != "pertensor_fp8":  # the fp8 MoE's impl="ref" runs eagerly
        forward = jax.jit(forward, static_argnames=("cfg", "is_prefill", "max_seqlens_q"))
    want, _ = forward(
        jw, J.init_cache(cfg, num_blocks=2 * b, block_size=16), cfg,
        jnp.arange(1, b + 1, dtype=jnp.int32), jnp.ones((b,), jnp.int32),
        jnp.arange(b + 1, dtype=jnp.int32), jnp.arange(2 * b, dtype=jnp.int32).reshape(b, 2),
        is_prefill=False, max_seqlens_q=1)
    return np.asarray(want, np.float32)


@pytest.mark.parametrize("moe", [None, "pertensor_fp8", "blockwise_int8", "pertensor_int8"])
def test_sharded_step_matches_jax_single_device(moe, monkeypatch):
    """A (dp 2, tp 4) step of the port against JAX's single-device
    forward_step; under MoE each tp rank runs its experts (rank_ep)."""
    monkeypatch.setattr(J, "fuse_moe_pertensor_fp8", functools.partial(JM.fuse_moe_pertensor_fp8,
                                                                       impl="ref"))
    monkeypatch.setattr(JM, "fuse_moe_blockwise_int8", dense_blockwise_moe)
    cfg, jw, tcfg, tw = carried(moe)
    got, caches = sharded_decode(tcfg, tw)
    assert tuple(got.shape) == (2 * DP, cfg.vocab)
    assert len(caches) == DP and all(len(row) == TP for row in caches)
    assert tuple(caches[1][3][0]["k"].shape) == (cfg.kv_heads // TP, 4, 16, cfg.head_dim)
    assert_allclose(got.float(), jax_single_decode(cfg, jw), atol=ATOL, rtol=RTOL,
                    name=f"sharded {moe} vs jax single device")


def test_sharded_step_matches_jax_sharded_step():
    """The dense case against JAX's own make_sharded_step on the 8 host
    devices (JAX's test_sharded_step_tp_dp)."""
    cfg, jw, tcfg, tw = carried()
    got, _ = sharded_decode(tcfg, tw)
    set_interpret_override(True)
    try:
        mesh = jax_make_mesh(tp=TP, dp=DP, devices=jax.devices("cpu"))
        step = jax.jit(J.make_sharded_step(mesh, cfg, is_prefill=False, max_seqlens_q=1))
        b = 2 * DP
        want, _ = step(J.shard_weights_for_tp(jw, cfg, TP), J.init_cache(cfg, num_blocks=4 * DP, block_size=16),
                       jnp.arange(1, b + 1, dtype=jnp.int32), jnp.ones((b,), jnp.int32),
                       jnp.asarray(np.tile([0, 1, 2], DP), jnp.int32),
                       jnp.asarray(np.tile(np.int32([[0, 1], [2, 3]]), (DP, 1))))
    finally:
        set_interpret_override(None)
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=ATOL, rtol=RTOL,
                    name="sharded vs jax sharded")


@pytest.mark.parametrize("kw", [dict(int8_kv=True, kv_scale=0.02), dict(dense_int8=True)])
def test_int8_kv_and_w8a8_under_tp_match_the_single_device_port(kw):
    """A prefill (7 and 5 tokens) then a decode step on a (dp 1, tp 2) mesh
    against the port's single-device forward_step: the int8 NHD_FUSED slab is
    split along its lanes, the W8A8 weights and scales with their matrices."""
    tcfg = T.tiny_config(**kw)
    tw = T.init_weights(tcfg, torch.Generator().manual_seed(2), device="cpu")
    mesh = make_mesh(tp=2, devices=["cpu"] * 2)
    weights = T.shard_weights(tw, tcfg, mesh)
    caches = [[T.init_cache(tcfg, 8, 16, tp=2, device="cpu") for _ in range(2)]]
    single = T.init_cache(tcfg, 8, 16, device="cpu")
    if tcfg.int8_kv:
        assert tuple(caches[0][1][0]["kv"].shape) == (8, 32, tcfg.kv_heads // 2 * tcfg.head_dim)
    t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    tbl = t([[0, 1, -1], [2, 3, -1]])
    steps = [(True, t(list(range(12))), t([7, 5]), t([0, 7, 12]), 7),
             (False, t([3, 5]), t([8, 6]), t([0, 1, 2]), 1)]
    for is_prefill, tok, lens, qi, mq in steps:
        got, caches = T.make_sharded_step(mesh, tcfg, is_prefill, max_seqlens_q=mq)(
            weights, caches, tok, lens, qi, tbl)
        want, single = T.forward_step(tw, single, tcfg, tok, lens, qi, tbl, is_prefill, max_seqlens_q=mq)
        assert_allclose(got.float(), want.float(), atol=ATOL, rtol=RTOL,
                        name=f"{kw} {'prefill' if is_prefill else 'decode'}")


def test_sharded_multi_step_matches_jax_and_the_single_device_loop():
    """make_sharded_multi_step on a (dp 1, tp 2) mesh of CPU ranks, 3 greedy
    steps with logprobs, against JAX's make_sharded_multi_step on 2 host
    devices and the port's single-device decode_multi on the same inputs:
    each row's tokens by assert_greedy_match (a flip only where JAX's top-2
    margin, teacher-forced on JAX's tokens, is below 0.15), the logprobs
    before any flip within this file's 0.3 / 0.1."""
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

    cfg, jw, tcfg, tw = carried()
    n, b, tp = 3, 4, 2
    last = np.arange(1, b + 1, dtype=np.int32)
    lens = np.ones((b,), np.int32)
    tbl = np.arange(2 * b, dtype=np.int32).reshape(b, 2)
    set_interpret_override(True)
    try:
        jmesh = jax_make_mesh(tp=tp, dp=1, devices=jax.devices("cpu")[:tp])
        (jt, jl), _ = jax.jit(J.make_sharded_multi_step(jmesh, cfg, n, return_logprobs=True))(
            J.shard_weights_for_tp(jw, cfg, tp), J.init_cache(cfg, num_blocks=2 * b, block_size=16),
            jnp.asarray(last), jnp.asarray(lens), jnp.asarray(tbl), jnp.int32(0))
    finally:
        set_interpret_override(None)
    want, want_lp = np.asarray(jt), np.asarray(jl)

    def jax_margin(i, j):
        """JAX's top-2 margin of row i at step j, its own tokens fed back."""
        caches, toks, ln = J.init_cache(cfg, num_blocks=2 * b, block_size=16), jnp.asarray(last), lens
        for s in range(j + 1):
            logits, caches = J.forward_step(jw, caches, cfg, toks, jnp.asarray(ln + s),
                                            jnp.arange(b + 1, dtype=jnp.int32), jnp.asarray(tbl),
                                            is_prefill=False, max_seqlens_q=1)
            toks = jnp.asarray(want[s])
        return top2_margin(np.asarray(logits, np.float32)[i])

    mesh = make_mesh(tp=tp, devices=["cpu"] * tp)
    step = T.make_sharded_multi_step(mesh, tcfg, n, return_logprobs=True)
    caches = [[T.init_cache(tcfg, 2 * b, 16, tp=tp, device="cpu") for _ in range(tp)]]
    weights = T.shard_weights(tw, tcfg, mesh)
    (got, got_lp), _ = step(weights, caches, torch.from_numpy(last), torch.from_numpy(lens),
                            torch.from_numpy(tbl), 0)
    (single, single_lp), _ = T.decode_multi(tw, T.init_cache(tcfg, 2 * b, 16, device="cpu"), tcfg,
                                            torch.from_numpy(last), torch.from_numpy(lens),
                                            torch.from_numpy(tbl), n, return_logprobs=True)
    assert tuple(got.shape) == (n, b) and got.dtype == torch.int32
    for ref, ref_lp in ((want, want_lp), (single.numpy(), single_lp.numpy())):
        for i in range(b):
            j = assert_greedy_match(list(ref[:, i]), got[:, i].tolist(), lambda j, i=i: jax_margin(i, j),
                                    0.15)
            assert_allclose(got_lp[:j, i], ref_lp[:j, i], atol=ATOL, rtol=RTOL, name=f"row {i} logprobs")
    other = [[T.init_cache(tcfg, 2 * b, 16, tp=tp, device="cpu") for _ in range(tp)]]
    with pytest.raises(ValueError, match="of its first call"):  # one graph: its caches' addresses
        step(weights, other, last, lens, tbl, 0)
    held = weakref.ref(caches[0][0][0]["k"])
    del step, caches, other
    alive = held() is not None
    assert not alive, "the step outlives its last reference (a reference cycle)"
