"""Parity of the port's paged varlen prefill attention against the JAX package.

Inputs are made with numpy from a seed; the JAX prefill runs its Pallas
kernel in interpret mode on the CPU. Tolerance 4e-2 atol/rtol on the rows
that belong to a request, as tests/test_attention_prefill.py uses (the JAX
kernel's bf16 exp2 argument is a deliberate deviation the port does not
copy). Rows past cu_seqlens_q[-1] are zeros in the port. For the NHD_FUSED
slab, 2e-2 in bf16 and 8e-2 in int8, the JAX package's tolerances there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops.attention.prefill import attention_prefill_bf16 as jax_prefill_packed
from hpc_ops_tpu.ops.attention.prefill import attention_with_kvcache_prefill as jax_prefill
from hpc_ops_tpu.ops.attention.reference import mha_varlen_prefill_ref as jax_mha_ref
from hpc_ops_tpu_torch.ops.attention.prefill import (
    attention_prefill_bf16,
    attention_with_kvcache_prefill,
)
from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused_nhd
from hpc_ops_tpu_torch.ops.attention.reference import mha_varlen_prefill_ref
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

BS = 16


def rand_bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)


def make_case(seed, q_lens, kv_lens, hq=8, hkv=2, d=128, layout="HND", pad_rows=0):
    """Packed q (plus pad_rows past the last request), paged caches holding
    each request's kv_len tokens, a shuffled -1 padded page table."""
    rng = np.random.RandomState(seed)
    b = len(q_lens)
    max_blocks = max(kv_lens) // BS + 2
    nb = b * max_blocks + 2
    perm = rng.permutation(nb)
    tbl = -np.ones((b, max_blocks), np.int32)
    off = 0
    for i, n in enumerate(kv_lens):
        k = -(-n // BS)
        tbl[i, :k] = perm[off : off + k]
        off += k
    shape = (hkv, nb, BS, d) if layout == "HND" else (nb, BS, hkv, d)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return (rand_bf16(rng, int(cu[-1]) + pad_rows, hq, d), rand_bf16(rng, *shape),
            rand_bf16(rng, *shape), torch.from_numpy(cu), torch.from_numpy(tbl),
            torch.tensor(kv_lens, dtype=torch.int32))


def jax_of(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16) if t.is_floating_point() else jnp.asarray(t.numpy())


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_prefill_matches_jax(layout):
    """Three requests, unaligned starts (cu = 0, 13, 20, 45), prefixes already
    in the cache (kv_len > q_len), a page boundary, and padded tail rows."""
    q_lens, kv_lens = [13, 7, 25], [13, 39, 64]
    q, k, v, cu, tbl, kv = make_case(3, q_lens, kv_lens, layout=layout, pad_rows=5)
    want = np.asarray(jax_prefill(jax_of(q), jax_of(k), jax_of(v), jax_of(cu), jax_of(tbl),
                                  jax_of(kv), max(q_lens), cache_layout=layout), np.float32)
    got = attention_with_kvcache_prefill(q, k, v, cu, tbl, kv, max(q_lens), cache_layout=layout)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    n = int(cu[-1])
    assert_allclose(got[:n].float(), want[:n], atol=4e-2, rtol=4e-2, name="prefill")
    assert not got[n:].float().any()


def test_prefill_packed_matches_jax():
    q_lens = [9, 30]
    rng = np.random.RandomState(4)
    total = sum(q_lens)
    q, k, v = rand_bf16(rng, total, 8, 128), rand_bf16(rng, total, 2, 128), rand_bf16(rng, total, 2, 128)
    cu = torch.tensor([0, 9, 39], dtype=torch.int32)
    lens = torch.tensor(q_lens, dtype=torch.int32)
    want = np.asarray(jax_prefill_packed(jax_of(q), jax_of(k), jax_of(v), jax_of(lens),
                                         jax_of(cu), 30), np.float32)
    got = attention_prefill_bf16(q, k, v, lens, cu, 30)
    assert_allclose(got.float(), want, atol=4e-2, rtol=4e-2, name="packed")


def test_mha_varlen_ref_matches_jax():
    rng = np.random.RandomState(5)
    q = rng.randn(12, 4, 64).astype(np.float32)
    k = rng.randn(2, 10, 2, 64).astype(np.float32)
    v = rng.randn(2, 10, 2, 64).astype(np.float32)
    args = ([5, 7], [0, 5, 12], [8, 10])
    want = np.asarray(jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  *(jnp.asarray(a) for a in args)))
    got = mha_varlen_prefill_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 *(torch.tensor(a) for a in args))
    assert_allclose(got, want, atol=1e-5, rtol=1e-5, name="mha_ref")


def test_prefill_aligned_seq_starts_is_checked():
    q, k, v, cu, tbl, kv = make_case(6, [5, 3], [5, 3])
    with pytest.raises(ValueError, match="multiple of 8"):
        attention_with_kvcache_prefill(q, k, v, cu, tbl, kv, 5, cache_layout="HND",
                                       aligned_seq_starts=True)
    with pytest.raises(ValueError, match="block_mask"):  # a mask must be [B, Hq, n_tm, n_tkv]
        attention_with_kvcache_prefill(q, k, v, cu, tbl, kv, 5, cache_layout="HND",
                                       block_mask=torch.ones(1))



def fused_slab(k, v, int8_seed=None):
    """HND caches -> an NHD_FUSED slab; with int8_seed, random int8 codes instead."""
    slab = pack_kv_fused_nhd(k, v)
    if int8_seed is not None:
        rng = np.random.RandomState(int8_seed)
        slab = torch.from_numpy(rng.randint(-127, 128, tuple(slab.shape)).astype(np.int8))
    return slab


def jax_slab(slab):
    return jnp.asarray(slab.numpy()) if slab.dtype == torch.int8 else jax_of(slab)


@pytest.mark.parametrize(
    "q_lens,kv_extra",
    [([64], [0]), ([33, 129, 7], [0, 0, 0]),
     ([16, 40], [70, 9])],  # chunked prefill: kv history before q
)
def test_prefill_nhd_fused_bf16_matches_jax(q_lens, kv_extra):
    """The JAX package's NHD_FUSED cases at its 2e-2 tolerance."""
    kv_lens = [q + e for q, e in zip(q_lens, kv_extra)]
    q, k, v, cu, tbl, kv = make_case(43, q_lens, kv_lens)
    slab = fused_slab(k, v)
    want = np.asarray(jax_prefill(jax_of(q), jax_slab(slab), None, jax_of(cu), jax_of(tbl),
                                  jax_of(kv), max(q_lens), cache_layout="NHD_FUSED", tq=64),
                      np.float32)
    got = attention_with_kvcache_prefill(q, slab, None, cu, tbl, kv, max(q_lens),
                                         cache_layout="NHD_FUSED")
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert_allclose(got.float(), want, atol=2e-2, rtol=2e-2, name="nhd_fused_prefill")


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_prefill_nhd_fused_int8_matches_jax(impl):
    """int8 codes with per-tensor scales, chunked (history before q), padded
    rows past cu[-1] zero; 8e-2, the JAX package's int8 tolerance."""
    q_lens, kv_lens = [16, 40], [86, 49]
    q, k, v, cu, tbl, kv = make_case(44, q_lens, kv_lens, pad_rows=3)
    slab = fused_slab(k, v, int8_seed=44)
    ks, vs = np.array([0.019], np.float32), np.array([0.011], np.float32)
    want = np.asarray(jax_prefill(jax_of(q), jax_slab(slab), None, jax_of(cu), jax_of(tbl),
                                  jax_of(kv), max(q_lens), kscale=jnp.asarray(ks),
                                  vscale=jnp.asarray(vs), cache_layout="NHD_FUSED", tq=64),
                      np.float32)
    got = attention_with_kvcache_prefill(q, slab, None, cu, tbl, kv, max(q_lens),
                                         kscale=torch.from_numpy(ks), vscale=torch.from_numpy(vs),
                                         cache_layout="NHD_FUSED", impl=impl)
    n = int(cu[-1])
    assert_allclose(got[:n].float(), want[:n], atol=8e-2, rtol=8e-2, name="nhd_fused_int8")
    assert not got[n:].float().any()
