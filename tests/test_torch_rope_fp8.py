"""Parity of the port's fp8 RoPE store (``rope_norm_store_kv_fp8``) against
the JAX package.

Inputs are made with numpy from a seed and fed to both packages (both run
plain array code here: the JAX function has no Pallas path). Both compute in
float32 with IEEE division and round to e4m3 to nearest even, so the
comparison is for equality: without QK-norm the q codes, the cache codes and
``q_scale`` agree bit for bit. With a QK-norm policy the two packages'
``rsqrt`` of the RMSNorm differ in the last float32 bit, so there a scale may
differ by rtol 1e-6 and at most 0.1% of the codes may sit one e4m3 step
apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops.rope import make_cos_sin_cache as jax_cos_sin
from hpc_ops_tpu.ops.rope import rope_norm_store_kv_fp8 as jax_rope_fp8
from hpc_ops_tpu_torch.ops.rope import rope_norm_store_kv_fp8

torch.set_num_threads(1)

HQ, HKV, D, BS = 4, 2, 128, 16
FP8 = torch.float8_e4m3fn


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
    shape = (HKV, nb, BS, D) if layout == "HND" else (nb, BS, HKV, D)
    # caches start as finite e4m3 codes (bytes below 0x78), so untouched slots are checkable
    return dict(
        qkv=qkv, k0=rng.randint(0, 0x78, shape).astype(np.uint8),
        v0=rng.randint(0, 0x78, shape).astype(np.uint8), tbl=tbl,
        seq=np.asarray(req_lens, np.int32),
        q_index=np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32),
        qw=(rng.rand(D) + 0.5).astype(np.float32), kw=(rng.rand(D) + 0.5).astype(np.float32),
        cos_sin=np.array(jax_cos_sin(max(req_lens) + 8, D)),
    )


def codes(x) -> np.ndarray:
    """e4m3 array (either package's) -> its bytes."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def ordinals(b: np.ndarray) -> np.ndarray:
    """e4m3 bytes -> integers ordered like the values (one step = one code)."""
    b = b.astype(np.int32)
    return np.where(b >= 128, -(b & 0x7F), b & 0x7F)


def assert_codes_equal(got, want, name, exact):
    """Equal bytes; unless ``exact``, 0.1% of them may be one e4m3 step apart."""
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    d = np.abs(ordinals(got) - ordinals(want))
    assert d.max() <= 1, f"{name}: codes {d.max()} steps apart"
    assert (d > 0).mean() <= 1e-3, f"{name}: {(d > 0).mean():.3%} of the codes differ"


def run_both(c, layout, is_prefill, policy, quant_policy=1, max_seqlens=0, zero_tails=True,
             upper_max=None, k_scale=1.0, v_scale=1.0, q_scale_inv=None):
    kw = dict(max_seqlens=max_seqlens, upper_max=upper_max, qk_norm_policy=policy,
              cache_layout=layout, zero_tails=zero_tails)
    jq, jqs, jflag, jk, jv = jax_rope_fp8(
        jnp.asarray(c["k0"].view(jnp.float8_e4m3fn)), jnp.asarray(c["v0"].view(jnp.float8_e4m3fn)),
        jnp.asarray(c["qkv"].float().numpy(), jnp.bfloat16), jnp.asarray(c["cos_sin"]),
        jnp.asarray(c["seq"]), jnp.asarray(c["q_index"]), jnp.asarray(c["tbl"]), is_prefill,
        jnp.array([k_scale], jnp.float32), jnp.array([v_scale], jnp.float32), quant_policy,
        q_scale_inv=None if q_scale_inv is None else jnp.array([q_scale_inv], jnp.float32),
        q_norm_weight=jnp.asarray(c["qw"]), k_norm_weight=jnp.asarray(c["kw"]), **kw,
    )
    k = torch.from_numpy(c["k0"].copy()).view(FP8)
    v = torch.from_numpy(c["v0"].copy()).view(FP8)
    tq, tqs, tflag, tk, tv = rope_norm_store_kv_fp8(
        k, v, c["qkv"], torch.from_numpy(c["cos_sin"]), torch.from_numpy(c["seq"]),
        torch.from_numpy(c["q_index"]), torch.from_numpy(c["tbl"]), is_prefill,
        torch.tensor([k_scale]), torch.tensor([v_scale]), quant_policy,
        q_scale_inv=None if q_scale_inv is None else torch.tensor([q_scale_inv]),
        q_norm_weight=torch.from_numpy(c["qw"]), k_norm_weight=torch.from_numpy(c["kw"]), **kw,
    )
    assert tk is k and tv is v and tq.dtype == FP8 and tk.dtype == FP8
    assert tuple(tflag.shape) == tuple(jflag.shape) and not tflag.any()
    return (jq, jqs, jk, jv), (tq, tqs, tk, tv)


def check(j, t, name, exact):
    """``exact``: the case runs without QK-norm (see the module docstring)."""
    jq, jqs, jk, jv = j
    tq, tqs, tk, tv = t
    assert_codes_equal(codes(tq), codes(jq), f"{name} q", exact)
    assert_codes_equal(codes(tk), codes(jk), f"{name} K cache", exact)
    np.testing.assert_array_equal(codes(tv), codes(jv), err_msg=f"{name} V cache")
    if jqs is None:
        assert tqs is None
    else:
        assert tuple(tqs.shape) == tuple(jqs.shape)
        np.testing.assert_allclose(tqs.numpy(), np.asarray(jqs), rtol=0 if exact else 1e-6,
                                   atol=0, err_msg=f"{name} q_scale")


@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("policy", [0, 1, 2])
def test_fp8_store_decode_matches_jax(layout, policy):
    """A decode batch of 8 rows, one token per request (the engine's step):
    q codes, q_scale [rows, Hq] and the cache codes."""
    c = make_case(31, [34, 8, 17, 21, 40, 12, 9, 30], [1] * 8, layout)
    j, t = run_both(c, layout, False, policy, zero_tails=False)
    assert tuple(t[1].shape) == (8, HQ)
    check(j, t, f"decode {layout}", exact=policy == 0)


@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_fp8_store_prefill_matches_jax(layout):
    """Prefill with a prefix before q, unaligned starts and 3 padded rows past
    q_index[-1]: q_scale is scattered to [num_req, Hq, 128], the padded rows
    are dropped, their q codes are zero and the block tails are zeroed."""
    c = make_case(32, [33, 7, 21], [13, 7, 5], layout, pad_rows=3)
    j, t = run_both(c, layout, True, 1, max_seqlens=13)
    assert tuple(t[1].shape) == (3, HQ, 128)
    check(j, t, f"prefill {layout}", exact=False)
    assert not codes(t[0])[-3:].any() and not codes(j[0])[-3:].any()
    # positions past each request's q_len hold no scale
    assert not t[1][1, :, 7:].any() and t[1][0, :, :13].all()


def test_fp8_store_decode_zeroes_invalid_rows():
    """On decode a row past q_index[-1] gets a q_scale of 0, zero q codes and
    writes nothing."""
    c = make_case(33, [20, 3], [1, 1], "HND", pad_rows=2)
    j, t = run_both(c, "HND", False, 0, zero_tails=False)
    check(j, t, "decode with padded rows", exact=True)
    assert not t[1][2:].any() and not codes(t[0])[2:].any()
    untouched = np.ones(c["k0"].shape, bool)
    for r, n in enumerate(c["seq"]):
        untouched[:, c["tbl"][r, (n - 1) // BS], (n - 1) % BS] = False
    np.testing.assert_array_equal(codes(t[2])[untouched], c["k0"][untouched])
    np.testing.assert_array_equal(codes(t[3])[untouched], c["v0"][untouched])


def test_fp8_store_static_policy_and_upper_max_match_jax():
    """QuantPolicy.STATIC_Q_STATIC_KV (q * q_scale_inv, no q_scale) with K/V
    scales other than 1 and a lowered saturation bound."""
    c = make_case(34, [34, 8, 17, 21], [1] * 4, "NHD")
    j, t = run_both(c, "NHD", False, 0, quant_policy=2, q_scale_inv=90.0, k_scale=0.011,
                    v_scale=0.017, upper_max=240.0, zero_tails=False)
    check(j, t, "static", exact=True)
    assert np.abs(t[0].float().numpy()).max() == 240.0  # saturated at upper_max


def test_fp8_store_prefill_truncates_scales_past_max_seqlens_pad():
    """A request longer than round_up(max_seqlens, 128) keeps only the scales
    of its first pad positions, as in the JAX package."""
    c = make_case(35, [140], [140], "HND")
    j, t = run_both(c, "HND", True, 0, max_seqlens=100)
    assert tuple(t[1].shape) == (1, HQ, 128)
    check(j, t, "truncated scales", exact=True)
