"""Parity of the port's Stem mask generator (ops/stem.py) against the JAX
package, and the Stem -> block-sparse prefill chain.

Inputs are made with numpy from a seed (tests/test_stem.py's). Tolerances:
K_flat and Q_flat are bf16 sums of 8 float32 rows, so another summation
order may move an entry by one bf16 step (2^-8 relative); V_bias 1e-5; the
block logits, from the same bf16 inputs, within one bf16 step. stem_tpd is
held exactly (same logits in, same mask out, ties included), and so is the
whole pipeline's mask on these inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import stem as J
from hpc_ops_tpu.ops.attention.prefill import attention_with_kvcache_prefill as jax_prefill
from hpc_ops_tpu_torch.ops import stem as T
from hpc_ops_tpu_torch.ops.attention import attention_with_kvcache_prefill
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

BF16_STEP = dict(atol=1e-6, rtol=2.0**-8)


def jj(fn, **kw):
    """A JAX function compiled whole (its keywords fixed): one compilation
    instead of one per operation. Not for stem_oam_prep_paged_kv: compiled
    whole, XLA reorders its scaled sums, which moves K_flat entries that
    nearly cancel by more than a bf16 step of their own size."""
    return jax.jit(functools.partial(fn, **kw))
FP8 = torch.float8_e4m3fn


def e4m3(x):
    """float32 -> (torch e4m3, jax e4m3) holding the same bytes."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).clamp(-448, 448).to(FP8)
    return t, jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))


def f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def tt(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jt(x):
    """A torch tensor as a JAX array (bf16 stays bf16)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def paged_case(seed, kv_lens, hkv=2, d=128, bs=64, max_blocks=4):
    rng = np.random.RandomState(seed)
    b = len(kv_lens)
    nb = b * max_blocks
    k8, jk8 = e4m3(rng.randn(nb, bs, hkv, d) / np.sqrt(d))
    v8, jv8 = e4m3(rng.randn(nb, bs, hkv, d))
    kv_idx = rng.permutation(nb).astype(np.int32).reshape(b, max_blocks)
    return dict(k8=k8, jk8=jk8, v8=v8, jv8=jv8, idx=kv_idx, lens=np.asarray(kv_lens, np.int32))


@pytest.mark.parametrize("scales", ["one", "pertensor"])
def test_prep_paged_kv_matches_jax(scales):
    c = paged_case(41, [200, 130])
    ks, vs = (1.0, 1.0) if scales == "one" else (0.7, 1.9)
    kf, vb = T.stem_oam_prep_paged_kv(c["k8"], c["v8"], torch.tensor([ks]), torch.tensor([vs]),
                                      tt(c["idx"]), tt(c["lens"]))
    jkf, jvb = J.stem_oam_prep_paged_kv(c["jk8"], c["jv8"], jnp.asarray([ks], jnp.float32),
                                        jnp.asarray([vs], jnp.float32), jnp.asarray(c["idx"]),
                                        jnp.asarray(c["lens"]))
    assert kf.dtype == torch.bfloat16 and tuple(kf.shape) == jkf.shape == (2, 2, 2, 16 * 128)
    assert_allclose(kf.float(), f32(jkf), **BF16_STEP, name="kflat")
    assert_allclose(vb, f32(jvb), atol=1e-5, rtol=1e-5, name="vbias")


def test_prep_paged_kv_quant_type0_and_bf16_match_jax():
    """Per-token-per-head K scales (QuantType 0, grouped along D) and a V
    scale per head; then a bf16 cache, which ignores its scales."""
    c = paged_case(5, [100, 256])
    rng = np.random.RandomState(6)
    ks = rng.rand(8, 64, 2, 4).astype(np.float32) + 0.5
    vs = rng.rand(2).astype(np.float32) + 0.5
    qt0 = 0
    kf, vb = T.stem_oam_prep_paged_kv(c["k8"], c["v8"], tt(ks), tt(vs), tt(c["idx"]), tt(c["lens"]),
                                      quant_type=qt0)
    jkf, jvb = J.stem_oam_prep_paged_kv(c["jk8"], c["jv8"], jnp.asarray(ks), jnp.asarray(vs),
                                        jnp.asarray(c["idx"]), jnp.asarray(c["lens"]), quant_type=qt0)
    assert_allclose(kf.float(), f32(jkf), **BF16_STEP, name="kflat qt0")
    assert_allclose(vb, f32(jvb), atol=1e-5, rtol=1e-5, name="vbias qt0")
    kb, vbf = c["k8"].float().to(torch.bfloat16), c["v8"].float().to(torch.bfloat16)
    kf, vb = T.stem_oam_prep_paged_kv(kb, vbf, None, None, tt(c["idx"]), tt(c["lens"]))
    jkf, jvb = J.stem_oam_prep_paged_kv(jt(kb), jt(vbf), None, None, jnp.asarray(c["idx"]),
                                        jnp.asarray(c["lens"]))
    assert_allclose(kf.float(), f32(jkf), **BF16_STEP, name="kflat bf16")
    assert_allclose(vb, f32(jvb), atol=1e-5, rtol=1e-5, name="vbias bf16")


def test_prep_paged_kv_reads_only_the_tables_pages():
    """A pool with as many spare pages again, their codes and K scales NaN,
    gives the same K_flat and V_bias bit for bit: only the pages the table
    names are read (and dequantised)."""
    c = paged_case(7, [100, 256])
    rng = np.random.RandomState(8)
    ks = torch.from_numpy(rng.rand(8, 64, 2, 4).astype(np.float32) + 0.5)
    vs = torch.from_numpy(rng.rand(2).astype(np.float32) + 0.5)
    args = (tt(c["idx"]), tt(c["lens"]))
    kf, vb = T.stem_oam_prep_paged_kv(c["k8"], c["v8"], ks, vs, *args, quant_type=0)

    def spare(x):
        return torch.cat([x, torch.full_like(x.float(), float("nan")).to(x.dtype)])

    kf2, vb2 = T.stem_oam_prep_paged_kv(spare(c["k8"]), spare(c["v8"]), spare(ks), vs, *args,
                                        quant_type=0)
    assert torch.equal(kf, kf2) and torch.equal(vb, vb2)


def test_prep_varlen_q_matches_jax():
    rng = np.random.RandomState(3)
    q_lens = [130, 7, 256]
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    q8, jq8 = e4m3(rng.randn(int(cu[-1]) + 5, 4, 128) * 4)  # 5 rows past the last request
    qscale = (rng.rand(3, 4, 300) + 0.5).astype(np.float32)
    got = T.stem_oam_prep_varlen_q(q8, tt(qscale), tt(np.asarray(q_lens, np.int32)), tt(cu))
    want = jj(J.stem_oam_prep_varlen_q)(jq8, jnp.asarray(qscale), jnp.asarray(q_lens, jnp.int32),
                                        jnp.asarray(cu))
    assert tuple(got.shape) == want.shape == (3, 4, 3, 16 * 128)
    assert_allclose(got.float(), f32(want), **BF16_STEP, name="qflat")


@pytest.mark.parametrize("causal", [True, False])
def test_oam_gemm_matches_jax(causal):
    """The block logits from the same bf16 Q_flat, K_flat and V_bias, over
    requests with a kv prefix (kv > q) and ragged block counts."""
    rng = np.random.RandomState(3)
    b, hq, hkv, qb, kb, f = 2, 4, 2, 3, 5, 16 * 128
    qflat = torch.from_numpy(rng.randn(b, hq, qb, f) / 40).to(torch.bfloat16)
    kflat = torch.from_numpy(rng.randn(b, hkv, kb, f) / 40).to(torch.bfloat16)
    vbias = torch.from_numpy(rng.rand(b, hkv, kb).astype(np.float32))
    q_lens, kv_lens = np.array([3 * 128 - 10, 200], np.int32), np.array([5 * 128 - 50, 300], np.int32)
    got = T.stem_oam_gemm(qflat, kflat, vbias, tt(q_lens), tt(kv_lens), causal=causal)
    want = f32(jj(J.stem_oam_gemm, causal=causal)(jt(qflat), jt(kflat), jt(vbias), jnp.asarray(q_lens),
                                                  jnp.asarray(kv_lens)))
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    assert np.array_equal(np.isinf(g), np.isinf(want))
    fin = np.isfinite(want)
    assert_allclose(g[fin], want[fin], **BF16_STEP, name="block logits")


def tpd_logits(rng, b, hq, qb, kb, q_lens, kv_lens, ties=False):
    """Random bf16 block logits, -inf past each request's causal diagonal."""
    lg = rng.randn(b, hq, qb, kb).astype(np.float32)
    if ties:
        lg = np.round(lg * 2) / 2  # many equal values: ties at the threshold
    for bi in range(b):
        off = -(-(kv_lens[bi] - q_lens[bi]) // 128)
        for q in range(qb):
            lg[bi, :, q, q + off + 1 :] = -np.inf
    return torch.from_numpy(lg).to(torch.bfloat16)


@pytest.mark.parametrize("gqa_groups", [1, 2])
@pytest.mark.parametrize("regime", ["small", "medium", "large"])
def test_tpd_is_exact(regime, gqa_groups):
    """The same logits give JAX's mask bit for bit, in each regime of the
    budget schedule (prompts under 56 blocks, under 160, above), with ties
    at the threshold, chunked prefill (kv > q) and rows past a request."""
    kb = {"small": 40, "medium": 120, "large": 200}[regime]
    rng = np.random.RandomState(kb + gqa_groups)
    q_lens = np.array([3 * 128, 2 * 128 - 5], np.int32)
    kv_lens = np.array([kb * 128, kb * 128 - 300], np.int32)
    prompt = kv_lens + np.array([0, 700], np.int32)
    lg = tpd_logits(rng, 2, 4, 3, kb, q_lens, kv_lens, ties=True)
    kw = dict(initial_blocks=2, window_size=3, gqa_groups=gqa_groups)
    got = T.stem_tpd(lg, tt(q_lens), tt(kv_lens), tt(prompt), **kw)
    want = np.asarray(jj(J.stem_tpd, **kw)(jt(lg), jnp.asarray(q_lens), jnp.asarray(kv_lens),
                                           jnp.asarray(prompt)))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def stem_inputs(seed, seq, hq, hkv, d=128, bs=64):
    """tests/test_stem.py's end-to-end inputs: one fresh prompt, e4m3 q, K, V."""
    rng = np.random.RandomState(seed)
    nb = seq // bs
    q8, jq8 = e4m3(rng.randn(seq, hq, d) / np.sqrt(d))
    k8, jk8 = e4m3(rng.randn(nb, bs, hkv, d) / np.sqrt(d))
    v8, jv8 = e4m3(rng.randn(nb, bs, hkv, d) / (8 if seq > 512 else 1))
    idx = np.arange(nb, dtype=np.int32).reshape(1, nb)
    return dict(q8=q8, jq8=jq8, k8=k8, jk8=jk8, v8=v8, jv8=jv8, idx=idx,
                qscale=np.ones((1, hq, seq), np.float32), cu=np.array([0, seq], np.int32),
                lens=np.array([seq], np.int32))


@functools.lru_cache(maxsize=None)
def stem_both(inputs, budget="default"):
    """Both packages' Stem masks of ``stem_inputs(*inputs)`` (the port's as
    a tensor, JAX's as an array), computed once per case."""
    c = stem_inputs(*inputs)
    kw = SPARSE_BUDGET if budget == "sparse" else {}
    one = np.ones(1, np.float32)
    got = T.stem_paged_kv(c["q8"], c["k8"], c["v8"], tt(c["qscale"]), tt(one), tt(one), tt(c["idx"]),
                          tt(c["cu"]), tt(c["lens"]), tt(c["lens"]), **kw)
    want = jj(J.stem_paged_kv, **kw)(
        c["jq8"], c["jk8"], c["jv8"], jnp.asarray(c["qscale"]), jnp.asarray(one), jnp.asarray(one),
        jnp.asarray(c["idx"]), jnp.asarray(c["cu"]), jnp.asarray(c["lens"]), jnp.asarray(c["lens"]))
    return got, np.asarray(want)


SPARSE_BUDGET = dict(k_block_num_rate_medium=0.3, k_block_num_bias_medium=1,
                     k_block_num_rate_large=0.2, k_block_num_bias_large=1,
                     initial_blocks=1, window_size=1)


CASES = {"default": (5, 512, 2, 1), "sparse": (11, 1024, 2, 1)}  # tests/test_stem.py:163, :201


@pytest.mark.parametrize("budget", ["default", "sparse"])
def test_stem_paged_kv_mask_equals_jax(budget):
    """The whole pipeline on tests/test_stem.py's inputs gives JAX's mask."""
    got, want = stem_both(CASES[budget], budget)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_stem_mask_drives_blocksparse_prefill():
    """tests/test_stem.py:201: Stem builds the mask that the sparse prefill
    consumes. The port's mask equals JAX's; the port's output (its kernel
    path, the plain version here) matches JAX's oracle under that mask at
    that test's 5e-2."""
    c = stem_inputs(*CASES["sparse"])
    got_mask, want_mask = stem_both(CASES["sparse"], "sparse")
    assert np.array_equal(got_mask.numpy(), want_mask)
    assert 0 < want_mask.mean() < 1
    one = np.ones(1, np.float32)
    kw = dict(qscale=tt(c["qscale"]), kscale=tt(one), vscale=tt(one), mask_tile_q=128,
              mask_tile_kv=128)
    args = (c["q8"], c["k8"], c["v8"], tt(c["cu"]), tt(c["idx"]), tt(c["lens"]), 1024)
    out = attention_with_kvcache_prefill(*args, block_mask=got_mask, **kw).float()
    jkw = dict(qscale=jnp.asarray(c["qscale"]), kscale=jnp.asarray(one), vscale=jnp.asarray(one),
               mask_tile_q=128, mask_tile_kv=128)
    jargs = (c["jq8"], c["jk8"], c["jv8"], jnp.asarray(c["cu"]), jnp.asarray(c["idx"]),
             jnp.asarray(c["lens"]), 1024)
    want = np.asarray(jax_prefill(*jargs, block_mask=jnp.asarray(want_mask), impl="ref", **jkw),
                      np.float32)
    assert_allclose(out, want, atol=5e-2, rtol=5e-2, name="stem -> sparse prefill")
