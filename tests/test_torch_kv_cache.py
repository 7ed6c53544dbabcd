"""Parity of the port's paged-cache helpers against the JAX package.

The out-of-range sentinel of ``flat_slot_ids`` must be dropped by the stores
(JAX's ``mode="drop"``): torch indexing would wrap or raise, so the port
masks. Exact equality: the helpers only move bf16 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import kv_cache as J
from hpc_ops_tpu.ops.attention.paging import hnd_to_nhd as jax_hnd_to_nhd
from hpc_ops_tpu.ops.attention.paging import nhd_to_hnd as jax_nhd_to_hnd
from hpc_ops_tpu_torch.ops import kv_cache as T
from hpc_ops_tpu_torch.ops.attention.paging import hnd_to_nhd, nhd_to_hnd

torch.set_num_threads(1)

NB, BS, H, D = 6, 4, 2, 8


def case(seed, layout):
    rng = np.random.RandomState(seed)
    shape = (H, NB, BS, D) if layout == "HND" else (NB, BS, H, D)
    k = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(torch.bfloat16)
    rows = 7
    k_new = torch.from_numpy(rng.randn(rows, H, D).astype(np.float32)).to(torch.bfloat16)
    v_new = torch.from_numpy(rng.randn(rows, H, D).astype(np.float32)).to(torch.bfloat16)
    tbl = np.array([[3, 0, -1], [5, -1, -1]], np.int32)
    # valid rows, a row on a -1 page, a row past the table, an invalid row
    pos = np.array([0, 5, 3, 1, 4, 11, 2], np.int32)
    req = np.array([0, 0, 1, 1, 1, 0, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    return k, v, k_new, v_new, tbl, pos, req, valid


def jnp_of(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_store_kv_drops_oob_like_jax(layout):
    k, v, k_new, v_new, tbl, pos, req, valid = case(0, layout)
    js = J.flat_slot_ids(jnp.asarray(pos), jnp.asarray(req), jnp.asarray(tbl), BS, jnp.asarray(valid))
    ts = T.flat_slot_ids(torch.from_numpy(pos), torch.from_numpy(req), torch.from_numpy(tbl), BS,
                         torch.from_numpy(valid))
    assert (ts.numpy()[np.asarray(js) < NB * BS] == np.asarray(js)[np.asarray(js) < NB * BS]).all()
    assert (ts.numpy() >= NB * BS).sum() == 3  # -1 page, past the table, invalid
    want = J.store_kv(J.PagedKVCache(jnp_of(k), jnp_of(v)), jnp_of(k_new), jnp_of(v_new), js, layout)
    got = T.store_kv(T.PagedKVCache(k, v), k_new, v_new, ts, layout)
    assert got.k is k  # in place
    np.testing.assert_array_equal(got.k.float().numpy(), np.asarray(want.k, np.float32))
    np.testing.assert_array_equal(got.v.float().numpy(), np.asarray(want.v, np.float32))


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_zero_block_tails_like_jax(layout):
    k, v, *_ = case(1, layout)
    tbl = np.array([[3, 0, -1], [5, -1, -1], [1, 2, 4]], np.int32)
    lens = np.array([6, 0, 12], np.int32)
    want = J.zero_block_tails(J.PagedKVCache(jnp_of(k), jnp_of(v)), jnp.asarray(lens),
                              jnp.asarray(tbl), layout)
    got = T.zero_block_tails(T.PagedKVCache(k, v), torch.from_numpy(lens), torch.from_numpy(tbl), layout)
    np.testing.assert_array_equal(got.k.float().numpy(), np.asarray(want.k, np.float32))
    np.testing.assert_array_equal(got.v.float().numpy(), np.asarray(want.v, np.float32))


def test_gather_kv_and_layouts_like_jax():
    k, v, *_ = case(2, "NHD")
    tbl = np.array([[3, 0, -1], [5, -1, -1]], np.int32)
    wk, wv = J.gather_kv(J.PagedKVCache(jnp_of(k), jnp_of(v)), jnp.asarray(tbl), 10)
    gk, gv = T.gather_kv(T.PagedKVCache(k, v), torch.from_numpy(tbl), 10)
    np.testing.assert_array_equal(gk.float().numpy(), np.asarray(wk, np.float32))
    np.testing.assert_array_equal(gv.float().numpy(), np.asarray(wv, np.float32))
    hnd = nhd_to_hnd(k)
    np.testing.assert_array_equal(hnd.float().numpy(), np.asarray(jax_nhd_to_hnd(jnp_of(k)), np.float32))
    np.testing.assert_array_equal(hnd_to_nhd(hnd).float().numpy(),
                                  np.asarray(jax_hnd_to_nhd(jax_nhd_to_hnd(jnp_of(k))), np.float32))


def test_alloc_paged_cache():
    c = T.alloc_paged_cache(3, 4, 2, 8, device="cpu")
    assert c.k.shape == (3, 4, 2, 8) and c.v.dtype == torch.bfloat16
    assert (c.num_blocks, c.block_size, c.num_kv_heads) == (3, 4, 2)
    assert not c.k.any()
