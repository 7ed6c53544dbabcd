"""Parity of the port's fp8 attention (decode and prefill over e4m3 caches)
against the JAX package.

Inputs are made with numpy from a seed, quantised once (amax -> 448, as
tests/test_attention_decode.py does) and handed to both packages as the same
e4m3 bytes. Each case is held against two JAX paths:

  * ``impl="ref"``, tightly (atol = rtol = 1e-2, one bf16 step of the
    output): both sides then compute in float32 from exactly decoded codes.
    The port's default path on the CPU is its kernels' plain version behind
    the wrappers' scale folding, which rounds ``q * qscale`` to bf16 before
    the product as the JAX wrapper does (2e-2);
  * the Pallas kernel in interpret mode, loosely (the JAX package's own fp8
    tolerance, atol 0.12 / rtol 0.08): on the CPU that kernel's e4m3 decode
    flushes every subnormal code (|x| < 2^-6) to zero, and it rounds q, the
    probabilities and the output to bf16. One test zeroes the subnormal codes
    in the inputs and then matches the kernel path at 3e-2 too.

No ``sm_scale`` is passed to the JAX ``impl="ref"`` (it drops it); the port
honours it, which its own test below checks against the JAX kernel path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.config import QuantType as JQuantType
from hpc_ops_tpu.ops.attention import attention_decode as jax_decode
from hpc_ops_tpu.ops.attention import attention_with_kvcache_prefill as jax_prefill
from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.ops.attention import (
    attention_decode,
    attention_decode_fp8,
    attention_with_kvcache_prefill,
    attention_with_kvcache_prefill_fp8,
    unpack_tailrow_kscale,
)
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

BS = 16
FP8 = torch.float8_e4m3fn
QT0 = QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD
TIGHT = dict(atol=1e-2, rtol=1e-2)
FOLDED = dict(atol=2e-2, rtol=2e-2)
KERNEL = dict(atol=0.12, rtol=0.08)


def e4m3(x: np.ndarray) -> np.ndarray:
    """float32 -> e4m3 bytes (round to nearest even, saturating)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).clamp(-448, 448).to(FP8)
    return t.view(torch.uint8).numpy()


def flush_subnormals(b: np.ndarray) -> np.ndarray:
    """Zero every code with |x| < 2^-6 (exponent field 0)."""
    return np.where((b & 0x78) == 0, b & 0x80, b).astype(np.uint8)


def t8(b):  # bytes -> torch e4m3
    return torch.from_numpy(np.ascontiguousarray(b)).view(FP8)


def j8(b):  # bytes -> jax e4m3
    return jnp.asarray(np.ascontiguousarray(b).view(jnp.float8_e4m3fn))


def to_layout(k_nhd, v_nhd, layout):
    """NHD bytes [nb, bs, H, D] -> (kcache, vcache) bytes in ``layout``."""
    if layout == "NHD":
        return k_nhd, v_nhd
    if layout == "HND":
        return k_nhd.transpose(2, 0, 1, 3), v_nhd.transpose(2, 0, 1, 3)
    nb, bs, h, d = k_nhd.shape  # NHD_FUSED: K rows then V rows, every head in a row
    return np.concatenate([k_nhd.reshape(nb, bs, h * d), v_nhd.reshape(nb, bs, h * d)], axis=1), None


def page_table(rng, kv_lens, extra_blocks=2):
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
    return tbl, nb


def decode_case(seed, kv_lens, sq=1, hq=8, hkv=2, d=128, flush=False):
    """Per-tensor quantised decode inputs: q codes with a scale per (row,
    head), K/V codes (NHD bytes) with one scale each."""
    rng = np.random.RandomState(seed)
    tbl, nb = page_table(rng, kv_lens)
    q = rng.randn(len(kv_lens) * sq, hq, d).astype(np.float32)
    kf = rng.randn(nb, BS, hkv, d).astype(np.float32)
    vf = rng.randn(nb, BS, hkv, d).astype(np.float32)
    qscale = np.maximum(np.abs(q).max(-1) / 448.0, 1e-12).astype(np.float32)
    kscale = np.array([np.abs(kf).max() / 448.0], np.float32)
    vscale = np.array([np.abs(vf).max() / 448.0], np.float32)
    q8, k8, v8 = e4m3(q / qscale[..., None]), e4m3(kf / kscale), e4m3(vf / vscale)
    if flush:
        q8, k8, v8 = flush_subnormals(q8), flush_subnormals(k8), flush_subnormals(v8)
    return dict(q8=q8, k8=k8, v8=v8, qscale=qscale, kscale=kscale, vscale=vscale, tbl=tbl,
                lens=np.asarray(kv_lens, np.int32))


def jax_decode_out(c, layout, mtp, impl, **kw):
    kj, vj = to_layout(c["k8"], c["v8"], layout)
    want = jax_decode(
        j8(c["q8"]).astype(jnp.bfloat16), j8(kj), None if vj is None else j8(vj),
        jnp.asarray(c["tbl"]), jnp.asarray(c["lens"]), mtp=mtp, new_kv_included=True,
        qscale=jnp.asarray(c["qscale"]), kscale=jnp.asarray(c["kscale"]),
        vscale=jnp.asarray(c["vscale"]), cache_layout=layout, impl=impl, **kw,
    )
    return np.asarray(want, np.float32)


def torch_decode_out(c, layout, mtp, impl="auto", **kw):
    kj, vj = to_layout(c["k8"], c["v8"], layout)
    got = attention_decode_fp8(
        t8(c["q8"]), t8(kj), None if vj is None else t8(vj), torch.from_numpy(c["tbl"]),
        torch.from_numpy(c["lens"]), torch.from_numpy(c["qscale"]), torch.from_numpy(c["kscale"]),
        torch.from_numpy(c["vscale"]), mtp=mtp, new_kv_included=True, cache_layout=layout,
        impl=impl, **kw,
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == c["q8"].shape
    return got.float()


@pytest.mark.parametrize("layout", ["NHD", "HND", "NHD_FUSED"])
@pytest.mark.parametrize("mtp", [0, 2])
def test_decode_fp8_pertensor_matches_jax(layout, mtp):
    """e4m3 caches with per-tensor K/V scales and a per-(row, head) q scale:
    kv_len at its minimum, at a page boundary and ragged."""
    sq = mtp + 1
    c = decode_case(41, [sq, 16, 33 + mtp, 70], sq=sq)
    jax_ref = jax_decode_out(c, layout, mtp, "ref")
    got = torch_decode_out(c, layout, mtp)
    assert_allclose(torch_decode_out(c, layout, mtp, "ref"), jax_ref, **TIGHT, name="ref vs jax ref")
    assert_allclose(got, jax_ref, **FOLDED, name="auto vs jax ref")
    assert_allclose(got, jax_decode_out(c, layout, mtp, "auto"), **KERNEL,
                    name="auto vs jax kernel")


@pytest.mark.parametrize("layout", ["HND", "NHD_FUSED"])
def test_decode_fp8_without_subnormal_codes_matches_jax_kernel(layout):
    """With every subnormal code zeroed in the inputs the JAX kernel's flush
    changes nothing, and the two kernel paths agree at 3e-2 (the bf16
    roundings of the JAX kernel)."""
    c = decode_case(42, [40, 300], flush=True)
    assert_allclose(torch_decode_out(c, layout, 0), jax_decode_out(c, layout, 0, "auto"),
                    atol=3e-2, rtol=3e-2, name="flushed inputs")


def test_decode_fp8_sm_scale_and_bf16_q():
    """``sm_scale`` is honoured (held against the JAX kernel path, which
    honours it too), and a bf16 q without qscale is taken as it is."""
    c = decode_case(43, [37, 100])
    got = torch_decode_out(c, "HND", 0, sm_scale=0.05)
    assert_allclose(got, jax_decode_out(c, "HND", 0, "auto", sm_scale=0.05), **KERNEL,
                    name="sm_scale")
    assert_allclose(got, torch_decode_out(c, "HND", 0, "ref", sm_scale=0.05).numpy(), **FOLDED,
                    name="sm_scale auto vs ref")
    k, v = to_layout(c["k8"], c["v8"], "HND")
    qb = (t8(c["q8"]).float() * torch.from_numpy(c["qscale"])[..., None]).to(torch.bfloat16)
    plain_q = attention_decode(qb, t8(k), t8(v), torch.from_numpy(c["tbl"]),
                               torch.from_numpy(c["lens"]), new_kv_included=True,
                               kscale=torch.from_numpy(c["kscale"]),
                               vscale=torch.from_numpy(c["vscale"]), cache_layout="HND",
                               sm_scale=0.05)
    assert torch.equal(plain_q.float(), got)


def qt0_case(seed, kv_lens, s_groups, sq=1, hkv=2, g=4, d=128, bs=BS):
    """QuantType-0 inputs: K codes with a scale per (token, head, D-group),
    V codes with a scale per head; bf16 q."""
    rng = np.random.RandomState(seed)
    b = len(kv_lens)
    max_blocks = int(max(-(-n // bs) for n in kv_lens))
    nb = b * max_blocks + 2
    q = torch.from_numpy(rng.randn(b * sq, hkv * g, d).astype(np.float32)).to(torch.bfloat16)
    kf = rng.randn(nb, bs, hkv, d).astype(np.float32)
    vf = rng.randn(nb, bs, hkv, d).astype(np.float32)
    kg = kf.reshape(nb, bs, hkv, s_groups, d // s_groups)
    kscale = (np.abs(kg).max(-1) / 448.0 + 1e-6).astype(np.float32)
    vscale = (np.abs(vf).max(axis=(0, 1, 3)) / 448.0 + 1e-6).astype(np.float32)
    k8 = e4m3(kf / np.repeat(kscale, d // s_groups, axis=-1))
    v8 = e4m3(vf / vscale[None, None, :, None])
    perm = rng.permutation(nb)
    tbl = np.stack([perm[i * max_blocks : (i + 1) * max_blocks] for i in range(b)]).astype(np.int32)
    return dict(q=q, k8=k8, v8=v8, kscale=kscale, vscale=vscale, tbl=tbl,
                lens=np.asarray(kv_lens, np.int32))


def jq(q):
    return jnp.asarray(q.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("s_groups,layout,mtp", [(1, "NHD", 0), (1, "HND", 2), (4, "NHD", 0)])
def test_decode_fp8_pertoken_k_matches_jax(s_groups, layout, mtp):
    """QuantType 0: one K scale per (token, kv head) takes the QuantType-0
    kernel (its plain version here; the JAX side its Pallas kernel); scales
    in 4 groups along D take the reference in both packages. atol = rtol =
    4e-2 against the JAX kernel path is the JAX package's own tolerance."""
    sq = mtp + 1
    c = qt0_case(17, [40, 16, 64], s_groups, sq=sq)
    k, v = to_layout(c["k8"], c["v8"], layout)
    jargs = (jq(c["q"]), j8(k), j8(v), jnp.asarray(c["tbl"]), jnp.asarray(c["lens"]))
    jkw = dict(mtp=mtp, new_kv_included=True, kscale=jnp.asarray(c["kscale"]),
               vscale=jnp.asarray(c["vscale"]), cache_layout=layout,
               quant_type=JQuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD)
    got = attention_decode(
        c["q"], t8(k), t8(v), torch.from_numpy(c["tbl"]), torch.from_numpy(c["lens"]), mtp=mtp,
        new_kv_included=True, kscale=torch.from_numpy(c["kscale"]),
        vscale=torch.from_numpy(c["vscale"]), quant_type=QT0, cache_layout=layout,
    ).float()
    assert_allclose(got, np.asarray(jax_decode(*jargs, impl="ref", **jkw), np.float32), **TIGHT,
                    name="qt0 vs jax ref")
    assert_allclose(got, np.asarray(jax_decode(*jargs, **jkw), np.float32), atol=4e-2, rtol=4e-2,
                    name="qt0 vs jax kernel path")


def test_decode_fp8_tailrow_kscale_matches_separate_scales_and_jax():
    """The serving layout with the per-token K scales in the tail rows of the
    K pages decodes exactly as the separate-scale form, from fp8-typed pages
    and from their int8 byte view, and as the JAX package decodes it."""
    bs, d, hkv = 32, 128, 2
    sr = bs * 4 // d
    c = qt0_case(23, [40, 16, 64], 1, bs=bs)
    nb = c["k8"].shape[0]
    tail = (np.ascontiguousarray(c["kscale"][..., 0].transpose(0, 2, 1)).view(np.uint8)
            .reshape(nb, hkv, sr, d).transpose(0, 2, 1, 3))
    k_pages = np.concatenate([c["k8"], tail], axis=1)  # [nb, bs + sr, H, D] bytes
    v_pages = np.concatenate([c["v8"], np.zeros_like(tail)], axis=1)
    data, scales = unpack_tailrow_kscale(t8(k_pages))
    assert torch.equal(data.view(torch.uint8), torch.from_numpy(c["k8"]))
    assert torch.equal(scales, torch.from_numpy(c["kscale"]))
    common = (torch.from_numpy(c["tbl"]), torch.from_numpy(c["lens"]))
    kw = dict(new_kv_included=True, vscale=torch.from_numpy(c["vscale"]), quant_type=QT0)
    want = attention_decode(c["q"], t8(c["k8"]), t8(c["v8"]), *common,
                            kscale=torch.from_numpy(c["kscale"]), **kw)
    for view in (t8, lambda b: torch.from_numpy(np.ascontiguousarray(b)).view(torch.int8)):
        pages = view(k_pages)
        got = attention_decode(c["q"], pages, view(v_pages), *common, kscale=pages[:, bs:], **kw)
        assert torch.equal(got, want)
    jk = jnp.asarray(k_pages.view(np.int8))
    jwant = jax_decode(jq(c["q"]), jk, jnp.asarray(v_pages.view(np.int8)), jnp.asarray(c["tbl"]),
                       jnp.asarray(c["lens"]), new_kv_included=True, kscale=jk[:, bs:],
                       vscale=jnp.asarray(c["vscale"]), impl="ref",
                       quant_type=JQuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD)
    assert_allclose(want.float(), np.asarray(jwant, np.float32), **TIGHT, name="tail rows vs jax")


# ------------------------------------------------------------------ prefill
def prefill_case(seed, q_lens, kv_lens, hq=8, hkv=2, d=128, pad_rows=0, flush=False):
    """Per-tensor quantised prefill inputs; qscale is [B, Hq, 128], scattered
    from the packed rows as the fp8 RoPE store returns it."""
    rng = np.random.RandomState(seed)
    tbl, nb = page_table(rng, kv_lens)
    total = sum(q_lens) + pad_rows
    q = rng.randn(total, hq, d).astype(np.float32)
    kf = rng.randn(nb, BS, hkv, d).astype(np.float32)
    vf = rng.randn(nb, BS, hkv, d).astype(np.float32)
    row_scale = np.maximum(np.abs(q).max(-1) / 448.0, 1e-12).astype(np.float32)
    q8 = e4m3(q / row_scale[..., None])
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    qscale = np.zeros((len(q_lens), hq, 128), np.float32)
    for b, (s, n) in enumerate(zip(cu[:-1], q_lens)):
        qscale[b, :, :n] = row_scale[s : s + n].T
    q8[cu[-1]:] = 0
    kscale = np.array([np.abs(kf).max() / 448.0], np.float32)
    vscale = np.array([np.abs(vf).max() / 448.0], np.float32)
    k8, v8 = e4m3(kf / kscale), e4m3(vf / vscale)
    if flush:
        q8, k8, v8 = flush_subnormals(q8), flush_subnormals(k8), flush_subnormals(v8)
    return dict(q8=q8, k8=k8, v8=v8, qscale=qscale, kscale=kscale, vscale=vscale, tbl=tbl, cu=cu,
                lens=np.asarray(kv_lens, np.int32), max_q=max(q_lens), n_real=int(cu[-1]))


def jax_prefill_out(c, layout, impl, vscale=None):
    kj, vj = to_layout(c["k8"], c["v8"], layout)
    want = jax_prefill(
        j8(c["q8"]).astype(jnp.bfloat16), j8(kj), None if vj is None else j8(vj),
        jnp.asarray(c["cu"]), jnp.asarray(c["tbl"]), jnp.asarray(c["lens"]), c["max_q"],
        qscale=jnp.asarray(c["qscale"]), kscale=jnp.asarray(c["kscale"]),
        vscale=jnp.asarray(c["vscale"] if vscale is None else vscale), cache_layout=layout,
        impl=impl,
    )
    return np.asarray(want, np.float32)[: c["n_real"]]


def torch_prefill_out(c, layout, impl="auto", vscale=None):
    kj, vj = to_layout(c["k8"], c["v8"], layout)
    got = attention_with_kvcache_prefill_fp8(
        t8(c["q8"]), t8(kj), None if vj is None else t8(vj), torch.from_numpy(c["qscale"]),
        torch.from_numpy(c["kscale"]), torch.from_numpy(c["vscale"] if vscale is None else vscale),
        torch.from_numpy(c["cu"]), torch.from_numpy(c["tbl"]), torch.from_numpy(c["lens"]),
        c["max_q"], cache_layout=layout, impl=impl,
    )
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == c["q8"].shape
    n = c["n_real"]
    assert not got[n:].any()  # rows of no request come back as zeros
    return got.float()[:n]


@pytest.mark.parametrize("layout", ["NHD", "HND", "NHD_FUSED"])
def test_prefill_fp8_pertensor_matches_jax(layout):
    """e4m3 caches, per-tensor K/V scales, qscale [B, Hq, pad] gathered onto
    packed rows: a prefix before q (chunked prefill), unaligned starts and 5
    rows past cu[-1]."""
    c = prefill_case(51, [13, 40, 7], [45, 40, 71], pad_rows=5)
    jax_ref = jax_prefill_out(c, layout, "ref")
    got = torch_prefill_out(c, layout)
    assert_allclose(torch_prefill_out(c, layout, "ref"), jax_ref, **TIGHT, name="ref vs jax ref")
    assert_allclose(got, jax_ref, **FOLDED, name="auto vs jax ref")
    assert_allclose(got, jax_prefill_out(c, layout, "auto"), **KERNEL, name="auto vs jax kernel")


def test_prefill_fp8_without_subnormal_codes_matches_jax_kernel():
    c = prefill_case(52, [33, 20], [33, 52], flush=True)
    assert_allclose(torch_prefill_out(c, "HND"), jax_prefill_out(c, "HND", "auto"), atol=3e-2,
                    rtol=3e-2, name="flushed inputs")


def test_prefill_fp8_per_head_vscale_matches_jax_kernel_path():
    """A V scale per kv head is folded per q-head group (``fold_vscale``).
    The JAX reference takes per-tensor scales only, so this is held against
    the JAX kernel path and against the port's own reference."""
    c = prefill_case(53, [21, 9], [21, 30])
    vs = (c["vscale"][0] * np.array([1.0, 0.5], np.float32))
    got = torch_prefill_out(c, "HND", vscale=vs)
    assert_allclose(got, jax_prefill_out(c, "HND", "auto", vscale=vs), **KERNEL,
                    name="per-head vscale vs jax kernel")
    assert_allclose(got, torch_prefill_out(c, "HND", "ref", vscale=vs).numpy(), **FOLDED,
                    name="per-head vscale auto vs ref")


@pytest.mark.parametrize("s_groups", [1, 4])
def test_prefill_fp8_pertoken_k_matches_jax(s_groups):
    """QuantType 0 in prefill: one K scale per (token, kv head) multiplies
    the logit columns (``pertoken_ks``; the plain version here, the Pallas
    kernel in JAX); 4 groups along D take the reference in both. Per-head V
    scale. bf16 q."""
    c = qt0_case(19, [40, 16, 64], s_groups)
    q_lens = [24, 16, 5]
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(int(cu[-1]), 8, 128).astype(np.float32)).to(torch.bfloat16)
    jargs = (jq(q), j8(c["k8"]), j8(c["v8"]), jnp.asarray(cu), jnp.asarray(c["tbl"]),
             jnp.asarray(c["lens"]), max(q_lens))
    jkw = dict(kscale=jnp.asarray(c["kscale"]), vscale=jnp.asarray(c["vscale"]),
               quant_type=JQuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD)
    got = attention_with_kvcache_prefill(
        q, t8(c["k8"]), t8(c["v8"]), torch.from_numpy(cu), torch.from_numpy(c["tbl"]),
        torch.from_numpy(c["lens"]), max(q_lens), kscale=torch.from_numpy(c["kscale"]),
        vscale=torch.from_numpy(c["vscale"]), quant_type=QT0,
    ).float()
    assert_allclose(got, np.asarray(jax_prefill(*jargs, impl="ref", **jkw), np.float32), **TIGHT,
                    name="qt0 prefill vs jax ref")
    assert_allclose(got, np.asarray(jax_prefill(*jargs, **jkw), np.float32), atol=4e-2, rtol=4e-2,
                    name="qt0 prefill vs jax kernel path")


QT3 = QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD_QKHADAMARD


@pytest.mark.parametrize("s_groups", [2, 4])
@pytest.mark.parametrize("qt", [0, 3])
@pytest.mark.parametrize("op,layout", [("decode", "NHD"), ("decode", "HND"), ("prefill", "NHD"),
                                       ("prefill_sparse", "HND")])
def test_k_scales_grouped_along_d_take_the_kernel_path_match_jax(s_groups, qt, op, layout):
    """QuantTypes 0 and 3 with G = 2 or 4 K scales per (token, kv head),
    each over D/G columns: the port's entry points take the QuantType-0
    kernel's path (its plain version on these CPU tensors, which the kernel
    is held to on the card), JAX its reference. Against JAX ``impl="ref"``
    at atol = rtol = 1e-2, the tolerance of the QuantType-0 parity tests
    above; the sparse case runs the JAX test's mask (a random half of the
    64 x 64 tiles plus each q tile's diagonal one) through both references."""
    quant = QT0 if qt == 0 else QT3
    jquant = JQuantType(int(quant))
    c = qt0_case(29 + s_groups, [40, 16, 64], s_groups)
    k, v = to_layout(c["k8"], c["v8"], layout)
    common = dict(kscale=torch.from_numpy(c["kscale"]), vscale=torch.from_numpy(c["vscale"]),
                  quant_type=quant, cache_layout=layout)
    jcommon = dict(kscale=jnp.asarray(c["kscale"]), vscale=jnp.asarray(c["vscale"]),
                   quant_type=jquant, cache_layout=layout, impl="ref")
    tbl, lens = c["tbl"], c["lens"]
    if op == "decode":
        got = attention_decode(c["q"], t8(k), t8(v), torch.from_numpy(tbl), torch.from_numpy(lens),
                               new_kv_included=True, **common)
        want = jax_decode(jq(c["q"]), j8(k), j8(v), jnp.asarray(tbl), jnp.asarray(lens),
                          new_kv_included=True, **jcommon)
    else:
        q_lens = [24, 16, 5]
        cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
        q = torch.from_numpy(np.random.RandomState(7).randn(int(cu[-1]), 8, 128).astype(np.float32))
        q = q.to(torch.bfloat16)
        mask = {}
        if op == "prefill_sparse":
            rng = np.random.RandomState(8)
            n_tkv = -(-int(lens.max()) // 64)
            m = (rng.rand(3, 8, 1, n_tkv) < 0.5).astype(np.uint8)
            for bi, (ql, kl) in enumerate(zip(q_lens, lens)):
                m[bi, :, 0, (kl - ql) // 64] = 1
            mask = dict(mask_tile_q=64, mask_tile_kv=64)
            got = attention_with_kvcache_prefill(
                q, t8(k), t8(v), torch.from_numpy(cu), torch.from_numpy(tbl), torch.from_numpy(lens),
                max(q_lens), block_mask=torch.from_numpy(m), **mask, **common)
            mask["block_mask"] = jnp.asarray(m)
        else:
            got = attention_with_kvcache_prefill(
                q, t8(k), t8(v), torch.from_numpy(cu), torch.from_numpy(tbl), torch.from_numpy(lens),
                max(q_lens), **common)
        want = jax_prefill(jq(q), j8(k), j8(v), jnp.asarray(cu), jnp.asarray(tbl), jnp.asarray(lens),
                           max(q_lens), **mask, **jcommon)
    assert_allclose(got.float(), np.asarray(want, np.float32), **TIGHT,
                    name=f"{op} G={s_groups} QuantType {qt} vs jax ref")


def test_fp8_attention_still_raises_for_later_slices():
    c = decode_case(44, [5])
    k, v = to_layout(c["k8"], c["v8"], "HND")
    args = (t8(c["q8"]), t8(k), t8(v), torch.from_numpy(c["tbl"]), torch.from_numpy(c["lens"]))
    with pytest.raises(ValueError, match="block_mask"):  # a mask must be [B, Hq, n_tm, n_tkv]
        attention_with_kvcache_prefill(args[0], args[1], args[2], torch.tensor([0, 1]), args[3],
                                       args[4], 1, cache_layout="HND", block_mask=torch.ones(1))
    with pytest.raises(ValueError, match="need kscale"):
        attention_decode(*args, cache_layout="HND", quant_type=QT0)
