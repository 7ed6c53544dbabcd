"""Head shapes of fault F5 and the split-KV plan of the decode kernel, on the CPU.

The port's prefill at head_dim 96 and 256 and at a GQA group of 128 (Hq 128
over Hkv 1), and its decode at G 32 with 4 draft tokens, against the JAX
package with inputs made by numpy from a seed. JAX's prefill and decode run
their Pallas kernels in interpret mode, as tests/test_torch_prefill.py and
tests/test_torch_decode.py run them; on the CPU the port's wrappers take
their plain versions (the card tests in tests/test_torch_cuda.py hold the
kernels to those). Tolerances are those files': prefill 4e-2 atol/rtol on
the rows of a request, decode 3e-2.

``decode_splits`` is a pure function of host integers (batch and the page
table's width x page size): the tests pin its rule with no tensor at all.
"""

import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops.attention import attention_decode as jax_decode
from hpc_ops_tpu.ops.attention.prefill import attention_with_kvcache_prefill as jax_prefill
from hpc_ops_tpu_torch.ops.attention.decode import attention_decode, decode_splits
from hpc_ops_tpu_torch.ops.attention.prefill import attention_with_kvcache_prefill
from hpc_ops_tpu_torch.utils.testing import assert_allclose
from tests.test_torch_decode import jax_of
from tests.test_torch_decode import make_case as decode_case
from tests.test_torch_prefill import make_case as prefill_case

torch.set_num_threads(1)


@pytest.mark.parametrize("d,hq,hkv", [(256, 4, 2), (96, 4, 2), (64, 128, 1)])
def test_prefill_head_shapes_match_jax(d, hq, hkv):
    """head_dim 256 and 96 and Hq 128 over Hkv 1: unaligned starts, a
    prefix already in the cache, padded tail rows (zeros in the port)."""
    q_lens, kv_lens = [13, 7], [13, 39]
    q, k, v, cu, tbl, kv = prefill_case(11, q_lens, kv_lens, hq=hq, hkv=hkv, d=d, pad_rows=3)
    want = np.asarray(jax_prefill(jax_of(q), jax_of(k), jax_of(v), jax_of(cu), jax_of(tbl),
                                  jax_of(kv), max(q_lens), cache_layout="HND"), np.float32)
    got = attention_with_kvcache_prefill(q, k, v, cu, tbl, kv, max(q_lens), cache_layout="HND")
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    n = int(cu[-1])
    assert_allclose(got[:n].float(), want[:n], atol=4e-2, rtol=4e-2, name=f"prefill d={d} hq={hq}")
    assert not got[n:].float().any()


def test_decode_group_32_with_4_draft_tokens_matches_jax():
    """G * sq = 160 rows a kv head (G 32, mtp 4): the decode kernel's
    shared memory grew with these rows before it was rebuilt."""
    kv_lens, mtp = [40, 77], 4
    q, k, v, tbl, lens = decode_case(12, kv_lens, hq=32, hkv=1, d=64, sq=mtp + 1)
    kw = dict(mtp=mtp, new_kv_included=True, cache_layout="HND")
    want = np.asarray(jax_decode(jax_of(q), jax_of(k), jax_of(v), jax_of(tbl), jax_of(lens), **kw),
                      np.float32)
    got = attention_decode(q, k, v, tbl, lens, **kw)
    assert_allclose(got.float(), want, atol=3e-2, rtol=3e-2, name="decode G 32 mtp 4")
    assert torch.equal(attention_decode(q, k, v, tbl, lens, splitk=False, **kw), got)


@pytest.mark.parametrize("batch,positions,splitk,want", [
    (8, 4160, True, 16),      # check_decode's table: 65 tiles, the reference's 16 at batch <= 32
    (32, 8192, True, 16),
    (33, 8192, True, 4),      # past batch 32: the reference's 4
    (8, 300, True, 5),        # never more than the tiles the table spans
    (8, 64, True, 1),         # one tile: nothing to split
    (1, 65536, True, 16),     # one 64K request
    (8, 4160, False, 1),      # splitk=False: one block per (request, kv head)
])
def test_decode_splits_follows_the_reference_rule(batch, positions, splitk, want):
    assert decode_splits(batch, positions, splitk) == want


def test_decode_splits_reads_only_host_integers():
    """The plan takes ints and returns an int: serving keeps its one
    device-to-host copy a step."""
    got = decode_splits(8, 512 * 16)
    assert type(got) is int and got == 16
