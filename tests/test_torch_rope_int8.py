"""Parity of the port's quantising RoPE store (``rope_norm_store_kv_int8``)
against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the JAX
fused store runs its Pallas kernel in interpret mode on the CPU. Tolerances:
int8 codes equal, except that at most 0.1% of the written codes may differ
by one (a product rounded in another order lands on the other side of a
rounding tie); q within one bf16 ulp; every slab byte that no row addresses
bit-identical; rows of an invalid token zero in q on the plain-scatter path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops.attention.paging import pack_kv_fused_nhd as jax_pack_nhd
from hpc_ops_tpu.ops.rope import make_cos_sin_cache as jax_cos_sin
from hpc_ops_tpu.ops.rope import rope_norm_store_kv_int8 as jax_rope_int8
from hpc_ops_tpu_torch.ops.rope import rope_norm_store_kv_int8
from hpc_ops_tpu_torch.ops.rope_kernel import rope_store_rows_int8, row_slots
from hpc_ops_tpu_torch.utils.testing import max_bf16_ulp_err

torch.set_num_threads(1)

HQ, HKV, D, BS = 4, 2, 128, 16
K_SCALE, V_SCALE = 0.011, 0.017


def make_case(seed, req_lens, q_lens, layout, pad_rows=0):
    rng = np.random.RandomState(seed)
    num_req = len(req_lens)
    rows = sum(q_lens) + pad_rows
    qkv = torch.from_numpy(rng.randn(rows, (HQ + 2 * HKV) * D).astype(np.float32)).to(torch.bfloat16)
    max_blocks = max(req_lens) // BS + 2
    nb = num_req * max_blocks + 3
    perm = rng.permutation(nb)
    tbl = -np.ones((num_req, max_blocks), np.int32)
    off = 0
    for i, n in enumerate(req_lens):
        k = -(-n // BS)
        tbl[i, :k] = perm[off : off + k]
        off += k
    shape = (nb, 2 * BS, HKV * D) if layout == "NHD_FUSED" else (HKV, nb, 2 * BS, D)
    return dict(
        qkv=qkv, slab=rng.randint(-5, 5, shape).astype(np.int8), tbl=tbl,
        seq=np.asarray(req_lens, np.int32),
        q_index=np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32),
        qw=(rng.rand(D) + 0.5).astype(np.float32), kw=(rng.rand(D) + 0.5).astype(np.float32),
        cos_sin=np.array(jax_cos_sin(max(req_lens) + 8, D)),
    )


def run_both(c, layout, policy, impl):
    kw = dict(qk_norm_policy=policy, impl=impl, cache_layout=layout)
    if layout == "NHD_FUSED":
        kw["num_kv_heads"] = HKV
    jq, jslab = jax_rope_int8(
        jnp.asarray(c["slab"]), jnp.asarray(c["qkv"].float().numpy(), jnp.bfloat16),
        jnp.asarray(c["cos_sin"]), jnp.asarray(c["seq"]), jnp.asarray(c["q_index"]),
        jnp.asarray(c["tbl"]), False, jnp.array([K_SCALE], jnp.float32),
        jnp.array([V_SCALE], jnp.float32), jnp.asarray(c["qw"]), jnp.asarray(c["kw"]), **kw,
    )
    slab = torch.from_numpy(c["slab"].copy())
    tq, tslab = rope_norm_store_kv_int8(
        slab, c["qkv"], torch.from_numpy(c["cos_sin"]), torch.from_numpy(c["seq"]),
        torch.from_numpy(c["q_index"]), torch.from_numpy(c["tbl"]), False,
        torch.tensor([K_SCALE]), torch.tensor([V_SCALE]), torch.from_numpy(c["qw"]),
        torch.from_numpy(c["kw"]), **kw,
    )
    assert tslab is slab and tq.dtype == torch.bfloat16 and tslab.dtype == torch.int8
    return (np.asarray(jq, np.float32), np.asarray(jslab)), (tq.float().numpy(), tslab.numpy())


def written_mask(c, layout):
    """The slab entries that the valid rows address (K and V rows)."""
    mask = np.zeros(c["slab"].shape, bool)
    for r, (n, q0, q1) in enumerate(zip(c["seq"], c["q_index"][:-1], c["q_index"][1:])):
        for pos in range(n - (q1 - q0), n):
            page, off = c["tbl"][r, pos // BS], pos % BS
            for s in (off, BS + off):
                if layout == "NHD_FUSED":
                    mask[page, s] = True
                else:
                    mask[:, page, s] = True
    return mask


def check_slab(got, want, before, mask):
    np.testing.assert_array_equal(got[~mask], before[~mask], err_msg="untouched slab bytes")
    diff = np.abs(got[mask].astype(np.int32) - want[mask].astype(np.int32))
    assert diff.max() <= 1, f"codes differ by {diff.max()}"
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} of the codes differ by one"


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("policy", [0, 1, 2])
def test_int8_store_nhd_fused_decode_matches_jax(policy, impl):
    """A decode batch of 8 rows, one token per request (the engine's step)."""
    c = make_case(21, [34, 8, 17, 21, 40, 12, 9, 30], [1] * 8, "NHD_FUSED")
    (jq, jslab), (tq, tslab) = run_both(c, "NHD_FUSED", policy, impl)
    assert max_bf16_ulp_err(tq, jq) <= 1.0
    check_slab(tslab, jslab, c["slab"], written_mask(c, "NHD_FUSED"))


@pytest.mark.parametrize("layout", ["NHD_FUSED", "FUSED"])
def test_int8_store_prefill_matches_jax(layout):
    """Prefill with a prefix before q, unaligned starts and 3 padded rows past
    q_index[-1]: the plain scatter drops them and zeroes their q rows."""
    c = make_case(22, [33, 7, 21], [13, 7, 5], layout, pad_rows=3)
    (jq, jslab), (tq, tslab) = run_both(c, layout, 1, "xla")
    assert max_bf16_ulp_err(tq[:-3], jq[:-3]) <= 1.0
    assert not tq[-3:].any() and not jq[-3:].any()
    check_slab(tslab, jslab, c["slab"], written_mask(c, layout))


def test_int8_store_head_major_fused_matches_jax_kernel():
    """The head-major FUSED layout runs the plain scatter in the port; the JAX
    package runs its interpret-mode kernel there. Same codes."""
    c = make_case(23, [34, 8, 17, 21, 40, 12, 9, 30], [1] * 8, "FUSED")
    (jq, jslab), (tq, tslab) = run_both(c, "FUSED", 2, "pallas")
    assert max_bf16_ulp_err(tq, jq) <= 1.0
    check_slab(tslab, jslab, c["slab"], written_mask(c, "FUSED"))
    # the same store into NHD_FUSED writes the same codes, repacked
    c2 = dict(c, slab=np.asarray(jax_pack_nhd(c["slab"][:, :, :BS], c["slab"][:, :, BS:])))
    _, (_, nhd) = run_both(c2, "NHD_FUSED", 2, "pallas")
    np.testing.assert_array_equal(nhd, np.asarray(jax_pack_nhd(tslab[:, :, :BS], tslab[:, :, BS:])))


def test_int8_store_kernel_path_sends_invalid_rows_to_the_last_page_rows():
    """The kernel's contract (its plain version here): a row past q_index[-1]
    is computed and written to K slot nb*2*bs - 1 - bs, so its V row is the
    slab's last slot and nothing lands past the slab."""
    c = make_case(24, [20, 3], [1, 1], "NHD_FUSED", pad_rows=1)
    slab = torch.from_numpy(c["slab"].copy())
    nb = slab.shape[0]
    args = (c["qkv"], torch.from_numpy(c["cos_sin"]), torch.from_numpy(c["seq"]),
            torch.from_numpy(c["q_index"]), torch.from_numpy(c["tbl"]), None, None)
    scales = torch.tensor([K_SCALE]), torch.tensor([V_SCALE])
    q, _ = rope_store_rows_int8(*args, slab, *scales, hq=HQ, hkv=HKV, d=D, block_size=BS,
                                qk_norm_policy=0)
    _, slots = row_slots(3, *args[2:5], BS, nb * 2 * BS, fused=True)
    assert int(slots[2]) == nb * 2 * BS - 1 - BS
    flat = slab.view(-1, HKV * D)
    assert q[2].abs().sum() > 0
    # K and V codes of the pad row are where the contract says
    k_codes = flat[nb * 2 * BS - 1 - BS]
    v_codes = flat[nb * 2 * BS - 1]
    v_want = torch.round(c["qkv"][2, (HQ + HKV) * D :].float() / V_SCALE).clamp(-127, 127)
    assert torch.equal(v_codes.float(), v_want) and not torch.equal(
        k_codes, torch.from_numpy(c["slab"]).view(-1, HKV * D)[nb * 2 * BS - 1 - BS])
