"""Parity of the port's RoPE + QK-norm + paged store against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the JAX
fused store runs its Pallas kernel in interpret mode on the CPU, as the JAX
package's own tests run it. Tolerances: q within 1e-2 (both compute in
float32 and round once to bf16); written cache slots within one bf16 ulp
(the norm's rsqrt may round differently); V slots and every untouched slot
bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops.rope import make_cos_sin_cache as jax_cos_sin
from hpc_ops_tpu.ops.rope import rope_norm_store_kv as jax_rope
from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache, rope_norm_store_kv
from hpc_ops_tpu_torch.ops.rope_kernel import rope_store_rows, rope_store_rows_ref
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

HQ, HKV, D, BS = 4, 2, 128, 16


def bf16(x):
    """float32 numpy -> (bf16-rounded float32 numpy, torch bf16)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return t.float().numpy(), t


def make_case(seed, req_lens, q_lens, layout, pad_rows=0):
    rng = np.random.RandomState(seed)
    num_req = len(req_lens)
    rows = sum(q_lens) + pad_rows
    qkv, qkv_t = bf16(rng.randn(rows, (HQ + 2 * HKV) * D))
    max_blocks = max(req_lens) // BS + 2
    total_blocks = num_req * max_blocks + 3
    perm = rng.permutation(total_blocks)
    tbl = -np.ones((num_req, max_blocks), np.int32)
    off = 0
    for i, n in enumerate(req_lens):
        nb = -(-n // BS)
        tbl[i, :nb] = perm[off : off + nb]
        off += nb
    shape = (HKV, total_blocks, BS, D) if layout == "HND" else (total_blocks, BS, HKV, D)
    k0, k0_t = bf16(rng.randn(*shape))
    v0, v0_t = bf16(rng.randn(*shape))
    return dict(
        qkv=qkv, qkv_t=qkv_t, k0=k0, k0_t=k0_t, v0=v0, v0_t=v0_t, tbl=tbl,
        seq=np.asarray(req_lens, np.int32),
        q_index=np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32),
        qw=(rng.rand(D) + 0.5).astype(np.float32),
        kw=(rng.rand(D) + 0.5).astype(np.float32),
        cos_sin=np.array(jax_cos_sin(max(req_lens) + 8, D)),
    )


def run_both(c, layout, policy, impl, store_to_cache=True):
    want = jax_rope(
        jnp.asarray(c["k0"], jnp.bfloat16), jnp.asarray(c["v0"], jnp.bfloat16),
        jnp.asarray(c["qkv"], jnp.bfloat16), jnp.asarray(c["cos_sin"]),
        jnp.asarray(c["seq"]), jnp.asarray(c["q_index"]), jnp.asarray(c["tbl"]), False,
        jnp.asarray(c["qw"]), jnp.asarray(c["kw"]), qk_norm_policy=policy,
        store_to_cache=store_to_cache, cache_layout=layout, impl=impl,
    )
    got = rope_norm_store_kv(
        c["k0_t"].clone(), c["v0_t"].clone(), c["qkv_t"], torch.from_numpy(c["cos_sin"]),
        torch.from_numpy(c["seq"]), torch.from_numpy(c["q_index"]), torch.from_numpy(c["tbl"]),
        False, torch.from_numpy(c["qw"]), torch.from_numpy(c["kw"]), qk_norm_policy=policy,
        store_to_cache=store_to_cache, cache_layout=layout, impl=impl,
    )
    return [np.asarray(w, np.float32) for w in want], [g.float().numpy() for g in got]


def check_cache(got, want, before, name):
    changed = want != before
    # untouched slots: bit-identical to what was there before
    np.testing.assert_array_equal(got[~changed], before[~changed], err_msg=f"{name} untouched")
    # written slots: within one bf16 ulp
    assert_allclose(got[changed], want[changed], atol=1e-6, rtol=2.0**-7, name=name)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("policy", [0, 1, 2])
@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_rope_store_decode_matches_jax(layout, policy, impl):
    """Decode batch of 8 rows (one token per request)."""
    c = make_case(1, [34, 8, 17, 1, 40, 16, 9, 32], [1] * 8, layout)
    (wq, wk, wv), (gq, gk, gv) = run_both(c, layout, policy, impl)
    assert_allclose(gq, wq, atol=1e-2, rtol=1e-2, name="q")
    check_cache(gk, wk, c["k0"], "k")
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_rope_store_prefill_matches_jax(layout):
    """Prefill with a prefix in the cache, unaligned starts and padded rows
    past q_index[-1] (dropped by the plain formulation)."""
    c = make_case(2, [33, 7, 21], [13, 7, 5], layout, pad_rows=3)
    (wq, wk, wv), (gq, gk, gv) = run_both(c, layout, 1, "xla")
    assert_allclose(gq, wq, atol=1e-2, rtol=1e-2, name="q")
    assert not gq[-3:].any()
    check_cache(gk, wk, c["k0"], "k")
    np.testing.assert_array_equal(gv, wv)


def test_rope_no_store_matches_jax():
    c = make_case(3, [5, 9], [5, 9], "NHD", pad_rows=2)
    want, got = run_both(c, "NHD", 2, "xla", store_to_cache=False)
    for name, g, w in zip("qkv", got, want):
        assert_allclose(g, w, atol=1e-2, rtol=1e-2, name=name)


@pytest.mark.parametrize(
    "scaling",
    [None, {"rope_type": "linear", "factor": 4.0},
     {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}],
)
def test_cos_sin_cache_matches_jax(scaling):
    want = np.asarray(jax_cos_sin(4096, 128, 500000.0, scaling))
    got = make_cos_sin_cache(4096, 128, 500000.0, scaling, device="cpu").numpy()
    assert_allclose(got, want, atol=2e-4, rtol=1e-5, name="cos_sin")


def test_rope_kernel_wrapper_cpu_is_plain():
    """On CPU tensors the wrapper runs its plain version (and counts nothing)."""
    c = make_case(4, [20, 3], [1, 1], "HND")
    args = (c["qkv_t"], torch.from_numpy(c["cos_sin"]), torch.from_numpy(c["seq"]),
            torch.from_numpy(c["q_index"]), torch.from_numpy(c["tbl"]), None, None)
    kw = dict(hq=HQ, hkv=HKV, d=D, dv=D, block_size=BS, qk_norm_policy=0, head_major=True)
    flat = lambda t: t.clone().view(HKV, -1, D)  # noqa: E731
    before = rope_store_rows.launches
    q1, k1, v1 = rope_store_rows(*args, flat(c["k0_t"]), flat(c["v0_t"]), **kw)
    q2, k2, v2 = rope_store_rows_ref(*args, flat(c["k0_t"]), flat(c["v0_t"]), **kw)
    assert rope_store_rows.launches == before
    for a, b in ((q1, q2), (k1, k2), (v1, v2)):
        assert torch.equal(a, b)
