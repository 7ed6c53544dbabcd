"""Parity of the port's paged decode attention against the JAX package.

Inputs are made with numpy from a seed; the JAX decode runs its Pallas kernel
in interpret mode on the CPU. Tolerance 3e-2 atol/rtol for HND and NHD, as
tests/test_attention_decode.py uses (the JAX kernel rounds the scaled q and
the probabilities to bf16; the port stays in float32); for the NHD_FUSED
slab 2e-2 in bf16 and 8e-2 in int8, the JAX package's tolerances there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops.attention import attention_decode as jax_decode
from hpc_ops_tpu_torch.ops.attention.decode import attention_decode, attention_decode_bf16
from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused_nhd
from hpc_ops_tpu_torch.ops.attention.scheduler import assign_attention_decode_task
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

BS = 16


def make_case(seed, kv_lens, hq=8, hkv=2, d=128, sq=1, layout="HND", extra_blocks=2):
    """bf16 q/caches, a shuffled page table padded with -1, the given lengths."""
    rng = np.random.RandomState(seed)
    b = len(kv_lens)
    max_blocks = max(kv_lens) // BS + extra_blocks
    nb = b * max_blocks + 2
    perm = rng.permutation(nb)
    tbl = -np.ones((b, max_blocks), np.int32)
    off = 0
    for i, n in enumerate(kv_lens):
        k = -(-n // BS)
        tbl[i, :k] = perm[off : off + k]
        off += k
    shape = (hkv, nb, BS, d) if layout == "HND" else (nb, BS, hkv, d)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    return t(b * sq, hq, d), t(*shape), t(*shape), torch.from_numpy(tbl), torch.tensor(kv_lens, dtype=torch.int32)


def jax_of(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16) if t.is_floating_point() else jnp.asarray(t.numpy())


# (layout, mtp, new_kv_included): every layout, mtp 0/1/2, both flags
CASES = [("HND", 0, True), ("HND", 1, False), ("HND", 2, True),
         ("NHD", 0, False), ("NHD", 1, True), ("NHD", 2, False)]


@pytest.mark.parametrize("layout,mtp,new_kv", CASES)
def test_decode_matches_jax(layout, mtp, new_kv):
    # effective kv_len: the shortest possible, page boundaries and ragged
    sq = mtp + 1
    q, k, v, tbl, kv_lens = make_case(7, [sq, 16, 33 + mtp, 70], sq=sq, layout=layout)
    nseq = kv_lens if new_kv else kv_lens - sq
    want = jax_decode(jax_of(q), jax_of(k), jax_of(v), jax_of(tbl), jax_of(nseq),
                      mtp=mtp, new_kv_included=new_kv, cache_layout=layout)
    got = attention_decode(q, k, v, tbl, nseq, mtp=mtp, new_kv_included=new_kv,
                           cache_layout=layout)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=3e-2, rtol=3e-2, name="decode")


def test_decode_ref_impl_and_bf16_alias_match_jax():
    """The port's impl="ref" honours sm_scale, as the JAX kernel path does
    (the JAX impl="ref" path drops it), so both are held against the latter."""
    q, k, v, tbl, nseq = make_case(8, [5, 40], layout="NHD")
    want = jax_decode(jax_of(q), jax_of(k), jax_of(v), jax_of(tbl), jax_of(nseq),
                      new_kv_included=True, sm_scale=0.05)
    for fn, kw in ((attention_decode, {"impl": "ref"}), (attention_decode_bf16, {})):
        got = fn(q, k, v, tbl, nseq, new_kv_included=True, sm_scale=0.05, **kw)
        assert_allclose(got.float(), np.asarray(want, np.float32), atol=3e-2, rtol=3e-2, name="ref")



def fused_case(seed, kv_lens, sq=1, int8=False, hq=8, hkv=2, d=128):
    """q and an NHD_FUSED slab [nb, 2*BS, Hkv*D] (bf16, or int8 codes)."""
    q, k, v, tbl, kv_lens_t = make_case(seed, kv_lens, hq=hq, hkv=hkv, d=d, sq=sq)
    slab = pack_kv_fused_nhd(k, v)
    if int8:
        rng = np.random.RandomState(seed + 100)
        slab = torch.from_numpy(rng.randint(-127, 128, tuple(slab.shape)).astype(np.int8))
    return q, slab, tbl, kv_lens_t


def jax_slab(slab):
    return jnp.asarray(slab.numpy()) if slab.dtype == torch.int8 else jax_of(slab)


# (kv_lens, mtp): the JAX package's NHD_FUSED cases, tests/test_attention_decode.py
FUSED_CASES = [([33], 0), ([128, 17, 255, 64], 0), ([40, 300], 2), ([1100, 40], 0)]


@pytest.mark.parametrize("kv_lens,mtp", FUSED_CASES)
def test_decode_nhd_fused_bf16_matches_jax(kv_lens, mtp):
    """bf16 slab at 2e-2, the JAX package's tolerance for this layout."""
    sq = mtp + 1
    q, slab, tbl, lens = fused_case(23, kv_lens, sq=sq)
    want = jax_decode(jax_of(q), jax_slab(slab), None, jax_of(tbl), jax_of(lens), mtp=mtp,
                      new_kv_included=True, cache_layout="NHD_FUSED")
    got = attention_decode(q, slab, None, tbl, lens, mtp=mtp, new_kv_included=True,
                           cache_layout="NHD_FUSED")
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2, name="nhd_fused")


@pytest.mark.parametrize("kv_lens,mtp,impl", [([100, 37, 260], 0, "auto"), ([40, 300], 2, "auto"),
                                              ([100, 37, 260], 0, "ref")])
def test_decode_nhd_fused_int8_matches_jax(kv_lens, mtp, impl):
    """int8 codes with per-tensor scales at 8e-2, the JAX package's int8
    tolerance: logits scaled by sm_scale * kscale, the output by vscale."""
    sq = mtp + 1
    q, slab, tbl, lens = fused_case(7, kv_lens, sq=sq, int8=True)
    ks, vs = np.array([0.021], np.float32), np.array([0.013], np.float32)
    want = jax_decode(jax_of(q), jax_slab(slab), None, jax_of(tbl), jax_of(lens), mtp=mtp,
                      new_kv_included=True, cache_layout="NHD_FUSED", kscale=jnp.asarray(ks),
                      vscale=jnp.asarray(vs))
    got = attention_decode(q, slab, None, tbl, lens, mtp=mtp, new_kv_included=True,
                           cache_layout="NHD_FUSED", kscale=torch.from_numpy(ks),
                           vscale=torch.from_numpy(vs), impl=impl)
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=8e-2, rtol=8e-2, name="int8")


def test_decode_nhd_fused_later_slices_raise():
    q, slab, tbl, lens = fused_case(9, [5])
    # the task-map decode reads the slab in place, over tiles of whole pages
    tm = assign_attention_decode_task(lens, 2, tile=24, capacity=4, impl="np")
    with pytest.raises(ValueError, match="multiple of the page size"):
        attention_decode(q, slab, None, tbl, lens, cache_layout="NHD_FUSED", task_map=tm)
    # a quantised slab under QuantType 0 must bring its per-token K scales
    with pytest.raises(ValueError, match="need kscale"):
        attention_decode(q, slab.to(torch.int8), None, tbl, lens, cache_layout="NHD_FUSED",
                         quant_type=0)
