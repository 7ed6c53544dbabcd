"""The port's ring attention against JAX's (``jax.shard_map`` over 8 host CPU
devices) and against the float64 numpy oracle of tests/test_ring_attention.py,
on ws 4 and 8 ranks of the CPU (threads under ``run_ranks``), causal and
not, and on the zigzag schedule.

Tolerances: 2e-4 max abs against the oracle, the JAX test's own bar (both
packages sum in float32); 2e-5 against JAX's output (the same float32
online-softmax recurrence, einsum orders aside).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from hpc_ops_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from hpc_ops_tpu.parallel.ring_attention import zigzag_layout as jax_zigzag_layout
from hpc_ops_tpu.parallel.ring_attention import zigzag_unlayout as jax_zigzag_unlayout
from hpc_ops_tpu_torch.parallel import make_mesh, ring_attention
from hpc_ops_tpu_torch.parallel.mesh import run_ranks
from hpc_ops_tpu_torch.parallel.ring_attention import zigzag_layout, zigzag_unlayout

torch.set_num_threads(1)

ORACLE_TOL, JAX_TOL = 2e-4, 2e-5


def np_attention(q, k, v, causal, group):
    b, s, hq, d = q.shape
    out = np.zeros_like(q, dtype=np.float32)
    for h in range(hq):
        kh = h // group
        sc = (q[:, :, h].astype(np.float64)
              @ k[:, :, kh].astype(np.float64).transpose(0, 2, 1)) / np.sqrt(d)
        if causal:
            sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
        w = np.exp(sc - sc.max(-1, keepdims=True))
        w = w / w.sum(-1, keepdims=True)
        out[:, :, h] = (w @ v[:, :, kh].astype(np.float64)).astype(np.float32)
    return out


def inputs(seed, s, b=2, hkv=2, group=2, d=64):
    rng = np.random.RandomState(seed)
    hq = hkv * group
    return (rng.randn(b, s, hq, d).astype(np.float32), rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32))


def port_ring(q, k, v, ws, **kw):
    """The port's ring attention with the sequence axis of q, k, v split over
    ws CPU ranks; the ranks' outputs concatenated back."""
    mesh = make_mesh(tp=ws, devices=["cpu"] * ws)
    shards = [torch.chunk(torch.from_numpy(np.ascontiguousarray(x)), ws, dim=1) for x in (q, k, v)]
    outs = run_ranks(mesh, lambda g, _: ring_attention(shards[0][g.rank], shards[1][g.rank],
                                                       shards[2][g.rank], g, **kw))[0]
    return torch.cat(outs, dim=1).numpy()


def jax_ring(q, k, v, ws, **kw):
    cpus = jax.devices("cpu")
    if len(cpus) < ws:
        pytest.skip(f"need {ws} virtual CPU devices")
    mesh = JaxMesh(np.array(cpus[:ws]), ("sp",))
    f = jax.jit(jax.shard_map(lambda q_, k_, v_: jax_ring_attention(q_, k_, v_, "sp", **kw),
                              mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp")))
    return np.asarray(f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("ws", [4, 8])
def test_ring_attention_matches_dense_and_jax(causal, ws):
    q, k, v = inputs(7, ws * 8)
    got = port_ring(q, k, v, ws, causal=causal)
    assert np.abs(got - np_attention(q, k, v, causal, 2)).max() < ORACLE_TOL
    assert np.abs(got - jax_ring(q, k, v, ws, causal=causal)).max() < JAX_TOL


@pytest.mark.parametrize("ws", [4, 8])
def test_ring_attention_zigzag_matches_dense_and_jax(ws):
    """Zigzag: lay out, compute, unlay: dense causal attention."""
    q, k, v = inputs(3, ws * 2 * 4)
    qz, kz, vz = (zigzag_layout(torch.from_numpy(x), ws).numpy() for x in (q, k, v))
    got = zigzag_unlayout(torch.from_numpy(port_ring(qz, kz, vz, ws, causal=True,
                                                     schedule="zigzag")), ws).numpy()
    assert np.abs(got - np_attention(q, k, v, True, 2)).max() < ORACLE_TOL
    want = np.asarray(jax_zigzag_unlayout(
        jnp.asarray(jax_ring(qz, kz, vz, ws, causal=True, schedule="zigzag")), ws))
    assert np.abs(got - want).max() < JAX_TOL


def test_zigzag_layout_roundtrip_and_equals_jax():
    x = torch.arange(48).reshape(1, 48, 1)
    assert torch.equal(zigzag_unlayout(zigzag_layout(x, 4), 4), x)
    want = np.asarray(jax_zigzag_layout(jnp.arange(48).reshape(1, 48, 1), 4))
    assert np.array_equal(zigzag_layout(x, 4).numpy(), want)
    with pytest.raises(ValueError, match="2p=8"):
        zigzag_layout(torch.zeros(1, 12, 1), 4)


def test_ring_attention_bf16_gqa_and_errors():
    """bf16 inputs with a GQA group of 4 and an sm_scale: float32 sums, the
    output in bf16 within one bf16 step of the oracle; zigzag without causal,
    an unknown schedule and a non-RankGroup axis raise."""
    q, k, v = inputs(11, 32, b=1, hkv=1, group=4, d=32)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    mesh = make_mesh(tp=4, devices=["cpu"] * 4)
    shards = [torch.chunk(x, 4, dim=1) for x in (qb, kb, vb)]
    outs = run_ranks(mesh, lambda g, _: ring_attention(*(s[g.rank] for s in shards), g,
                                                       sm_scale=0.125 / 2 ** 0.5))[0]
    got = torch.cat(outs, dim=1)
    assert got.dtype == torch.bfloat16
    qf, kf, vf = (x.float().numpy() for x in (qb, kb, vb))
    want = np_attention(qf * (0.125 / 2 ** 0.5) * 32 ** 0.5, kf, vf, True, 4)
    assert np.abs(got.float().numpy() - want).max() < 2 ** -7 * max(1.0, np.abs(want).max())
    with pytest.raises(ValueError, match="causal"):
        run_ranks(mesh, lambda g, _: ring_attention(*(s[g.rank] for s in shards), g, causal=False,
                                                    schedule="zigzag"))
    with pytest.raises(ValueError, match="schedule"):
        run_ranks(mesh, lambda g, _: ring_attention(*(s[g.rank] for s in shards), g,
                                                    schedule="tree"))
    with pytest.raises(TypeError, match="RankGroup"):
        ring_attention(qb, kb, vb, "sp")
