"""Parity of the port's block-sparse paged prefill against the JAX package.

Inputs are made with numpy from a seed. The JAX sparse kernel runs in
interpret mode on the CPU; its first call at a shape compiles for about 20 s
and later calls at that shape take a fraction of a second, so every case
against it shares one geometry (the cases of
tests/test_attention_prefill.py:239-353: Hq 4, Hkv 2, D 128, pages of 16,
q lengths 128 and 77 on kv lengths 192 and 77, 64 x 64 mask tiles). The
other cases are held against JAX's ``impl="ref"``.

Tolerance 4e-2 atol/rtol, the JAX tests' own: the JAX kernel rounds q (with
the scale folded in) and the probabilities to bf16. Against ``impl="ref"``
over the same float32 math, 1e-2 (one bf16 step of the output) where q
reaches the kernel as it is, 2e-2 where the port folds a q scale into q and
rounds it to bf16 first. Rows with no kept key: the port's kernel path (and
the JAX kernel) write 0, the references average V; each side is checked.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.config import QuantType as JQuantType
from hpc_ops_tpu.ops.attention import attention_with_kvcache_blocksparse_prefill_fp8 as jax_sparse_fp8
from hpc_ops_tpu.ops.attention import attention_with_kvcache_prefill as jax_prefill
from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.ops.attention import (
    attention_with_kvcache_blocksparse_prefill_fp8,
    attention_with_kvcache_prefill,
)
from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused_nhd
from hpc_ops_tpu_torch.ops.attention.prefill import _prefill_sparse_ref, paged_prefill_sparse
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

HQ, HKV, D, BS = 4, 2, 128, 16
Q_LENS, KV_LENS = [128, 77], [192, 77]
MT = 64
QT0 = QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD
JAX_TOL = dict(atol=4e-2, rtol=4e-2)
TIGHT = dict(atol=1e-2, rtol=1e-2)
FOLDED = dict(atol=2e-2, rtol=2e-2)


def build_paged(rng, kv_lens, hkv=HKV, d=D, bs=BS):
    """Per-request K/V of N(0, 1) scattered into a shuffled NHD cache; returns
    (k, v) float32 [nb, bs, hkv, d] and the -1 padded page table."""
    nblocks = [-(-n // bs) for n in kv_lens]
    nb = sum(nblocks) + 3
    perm = rng.permutation(nb)
    tbl = -np.ones((len(kv_lens), max(nblocks) + 1), np.int32)
    k = np.zeros((nb, bs, hkv, d), np.float32)
    v = np.zeros((nb, bs, hkv, d), np.float32)
    off = 0
    for i, n in enumerate(kv_lens):
        tbl[i, : nblocks[i]] = perm[off : off + nblocks[i]]
        off += nblocks[i]
        for pos in range(n):
            k[tbl[i, pos // bs], pos % bs] = rng.randn(hkv, d)
            v[tbl[i, pos // bs], pos % bs] = rng.randn(hkv, d)
    return k, v, tbl


def random_mask(rng, q_lens, kv_lens, mtq=MT, mtkv=MT, keep=0.5, hq=HQ):
    """A random tile mask that keeps each q tile's causal diagonal tile."""
    n_tm = -(-max(q_lens) // mtq)
    n_tkv = -(-max(kv_lens) // mtkv)
    mask = (rng.rand(len(q_lens), hq, n_tm, n_tkv) < keep).astype(np.uint8)
    for bi, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        for t in range(-(-ql // mtq)):
            mask[bi, :, t, (kl - ql + t * mtq) // mtkv] = 1
    return mask


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


def jbf16(x):
    return jnp.asarray(np.asarray(x, np.float32), jnp.bfloat16)


def in_layout(k, v, layout):
    """NHD torch caches -> (kcache, vcache) in ``layout``."""
    if layout == "NHD":
        return k, v
    kh, vh = k.permute(2, 0, 1, 3).contiguous(), v.permute(2, 0, 1, 3).contiguous()
    if layout == "HND":
        return kh, vh
    if k.element_size() == 1:  # 1-byte caches are packed as bytes
        return pack_kv_fused_nhd(kh.view(torch.uint8), vh.view(torch.uint8)).view(k.dtype), None
    return pack_kv_fused_nhd(kh, vh), None


@functools.lru_cache(maxsize=None)
def bf16_case(seed):
    """The JAX test's bf16 case (tests/test_attention_prefill.py:306): q, K,
    V, the table, the mask, and JAX's kernel and reference outputs."""
    rng = np.random.RandomState(41 + seed)
    q = rng.randn(sum(Q_LENS), HQ, D).astype(np.float32)
    k, v, tbl = build_paged(rng, KV_LENS)
    mask = random_mask(rng, Q_LENS, KV_LENS)
    return dict(q=q, k=k, v=v, tbl=tbl, mask=mask, **jax_outputs(q, k, v, tbl, mask))


def jax_outputs(q, k, v, tbl, mask, mtq=MT):
    cu = np.concatenate([[0], np.cumsum(Q_LENS)]).astype(np.int32)
    args = (jbf16(q), jbf16(k), jbf16(v), jnp.asarray(cu), jnp.asarray(tbl),
            jnp.asarray(KV_LENS, jnp.int32), max(Q_LENS))
    kw = dict(block_mask=jnp.asarray(mask), mask_tile_q=mtq, mask_tile_kv=MT, tq=MT)
    return dict(jax_kernel=np.asarray(jax_prefill(*args, **kw), np.float32),
                jax_ref=np.asarray(jax_prefill(*args, impl="ref", **kw), np.float32))


def port_args(q, k, v, tbl, layout, kv_lens=KV_LENS, q_lens=Q_LENS):
    kc, vc = in_layout(k, v, layout)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return (q, kc, vc, torch.from_numpy(cu), torch.from_numpy(tbl),
            torch.tensor(kv_lens, dtype=torch.int32), max(q_lens))


@pytest.mark.parametrize("layout", ["NHD", "HND", "NHD_FUSED"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_prefill_matches_jax_kernel(seed, layout):
    """bf16 caches in each layout against the JAX sparse kernel and its
    ``impl="ref"``; the sparse kernel's wrapper runs, the dense one does not."""
    c = bf16_case(seed)
    args = port_args(bf16(c["q"]), bf16(c["k"]), bf16(c["v"]), c["tbl"], layout)
    before = kernels.launch_counts()
    got = attention_with_kvcache_prefill(*args, block_mask=torch.from_numpy(c["mask"]),
                                         mask_tile_q=MT, mask_tile_kv=MT, cache_layout=layout).float()
    assert kernels.launch_counts() == before  # CPU tensors: plain versions, no launch
    assert_allclose(got, c["jax_kernel"], **JAX_TOL, name=f"sparse {layout} vs jax kernel")
    assert_allclose(got, c["jax_ref"], **TIGHT, name=f"sparse {layout} vs jax ref")
    ref = attention_with_kvcache_prefill(*args, block_mask=torch.from_numpy(c["mask"]),
                                         mask_tile_q=MT, mask_tile_kv=MT, cache_layout=layout,
                                         impl="ref").float()
    assert_allclose(ref, c["jax_ref"], atol=1e-3, rtol=1e-3, name=f"impl=ref {layout}")


def test_rows_with_no_kept_key_are_zero_in_the_kernel_path():
    """Head 1's first q tile of request 0 keeps no tile, and the mask has one
    q-tile row where both requests need two: the JAX kernel and the port's
    kernel path write 0 for those rows; the references average V over head
    1's, and read the mask's last row for the second q tiles (JAX's clamped
    gather)."""
    c = bf16_case(0)
    mask = c["mask"][:, :, :1].copy()
    mask[0, 1, 0] = 0
    j = jax_outputs(c["q"], c["k"], c["v"], c["tbl"], mask)
    args = port_args(bf16(c["q"]), bf16(c["k"]), bf16(c["v"]), c["tbl"], "HND")
    kw = dict(block_mask=torch.from_numpy(mask), mask_tile_q=MT, mask_tile_kv=MT, cache_layout="HND")
    got = attention_with_kvcache_prefill(*args, **kw).float()
    ref = attention_with_kvcache_prefill(*args, impl="ref", **kw).float()
    dead = np.zeros((sum(Q_LENS), HQ), bool)
    dead[:64, 1] = True  # head 1, q tile 0 of request 0
    dead[64:128, :] = True  # the second q tiles: past the mask's one row
    dead[128 + 64 :, :] = True
    assert not got[torch.from_numpy(dead)].any()
    assert not np.any(j["jax_kernel"][dead])
    assert_allclose(got, j["jax_kernel"], **JAX_TOL, name="dead rows vs jax kernel")
    assert_allclose(ref, j["jax_ref"], atol=1e-3, rtol=1e-3, name="dead rows: impl=ref vs jax ref")
    assert ref[:64, 1].abs().amax() > 0  # the references average V there
    live = torch.from_numpy(~dead)
    assert_allclose(got[live], ref[live], **TIGHT, name="live rows: kernel path vs ref")


def qt0_inputs(rng, hq=HQ, hkv=HKV, q_lens=Q_LENS, kv_lens=KV_LENS):
    """e4m3 caches with one K scale per (token, kv head) and a V scale per
    kv head, quantised from N(0, 1) at amax -> 448 (tests/test_attention_prefill.py:251)."""
    k, v, tbl = build_paged(rng, kv_lens, hkv)
    kscale = (np.abs(k).max(axis=-1, keepdims=True) / 448.0 + 1e-6).astype(np.float32)
    vscale = (np.abs(v).max(axis=(0, 1, 3)) / 448.0 + 1e-6).astype(np.float32)
    k8 = torch.from_numpy(k / kscale).clamp(-448, 448).to(torch.float8_e4m3fn)
    v8 = torch.from_numpy(v / vscale[None, None, :, None]).clamp(-448, 448).to(torch.float8_e4m3fn)
    return k8, v8, tbl, kscale, vscale


def j8(t):
    return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))


def test_sparse_prefill_qt0_matches_jax_kernel():
    """QuantType 0 (one e4m3 K scale per token and kv head, a V scale per
    head) with a mask: the JAX kernel's ``pertoken_ks`` form."""
    rng = np.random.RandomState(23)
    q = rng.randn(sum(Q_LENS), HQ, D).astype(np.float32)
    k8, v8, tbl, kscale, vscale = qt0_inputs(rng)
    mask = random_mask(rng, Q_LENS, KV_LENS)
    cu = np.concatenate([[0], np.cumsum(Q_LENS)]).astype(np.int32)
    jargs = (jbf16(q), j8(k8), j8(v8), jnp.asarray(cu), jnp.asarray(tbl),
             jnp.asarray(KV_LENS, jnp.int32), max(Q_LENS))
    jkw = dict(qscale=None, kscale=jnp.asarray(kscale), vscale=jnp.asarray(vscale),
               quant_type=JQuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD,
               block_mask=jnp.asarray(mask), mask_tile_q=MT, mask_tile_kv=MT, tq=MT)
    want_kernel = np.asarray(jax_prefill(*jargs, **jkw), np.float32)
    want_ref = np.asarray(jax_prefill(*jargs, impl="ref", **jkw), np.float32)
    for layout in ("NHD", "HND", "NHD_FUSED"):
        args = port_args(bf16(q), k8, v8, tbl, layout)
        got = attention_with_kvcache_prefill(
            *args, kscale=torch.from_numpy(kscale), vscale=torch.from_numpy(vscale),
            quant_type=QT0, block_mask=torch.from_numpy(mask), mask_tile_q=MT, mask_tile_kv=MT,
            cache_layout=layout).float()
        assert_allclose(got, want_kernel, **JAX_TOL, name=f"qt0 sparse {layout} vs jax kernel")
        assert_allclose(got, want_ref, **TIGHT, name=f"qt0 sparse {layout} vs jax ref")


@pytest.mark.parametrize("layout", ["HND", "NHD_FUSED"])
@pytest.mark.parametrize("kind", ["int8", "e4m3"])
def test_sparse_prefill_quantised_caches_match_jax_ref(kind, layout):
    """Per-tensor scales over int8 codes and e4m3 caches, an e4m3 q with a
    scale per (token, head), chunked prefill (kv prefixes longer than q),
    and 128 x 64 mask tiles, through the blocksparse entry point."""
    rng = np.random.RandomState(7 if kind == "int8" else 8)
    q_lens, kv_lens = [40, 130, 9], [100, 130, 200]
    k, v, tbl = build_paged(rng, kv_lens)
    if kind == "int8":
        k8 = torch.from_numpy(np.clip(np.rint(k * 40), -127, 127).astype(np.int8))
        v8 = torch.from_numpy(np.clip(np.rint(v * 40), -127, 127).astype(np.int8))
        jk, jv = jnp.asarray(k8.numpy()), jnp.asarray(v8.numpy())
    else:
        k8 = torch.from_numpy(k * 40).clamp(-448, 448).to(torch.float8_e4m3fn)
        v8 = torch.from_numpy(v * 40).clamp(-448, 448).to(torch.float8_e4m3fn)
        jk, jv = j8(k8), j8(v8)
    ks, vs = np.float32(1 / 40), np.float32(0.02)
    qf = rng.randn(sum(q_lens), HQ, D).astype(np.float32)
    row_scale = np.abs(qf).max(-1) / 448.0  # [rows, Hq]
    q8 = torch.from_numpy(qf / row_scale[..., None]).clamp(-448, 448).to(torch.float8_e4m3fn)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    qscale = np.zeros((3, HQ, 256), np.float32)
    for r, (s, n) in enumerate(zip(cu[:-1], q_lens)):
        qscale[r, :, :n] = row_scale[s : s + n].T
    mask = random_mask(rng, q_lens, kv_lens, mtq=128, mtkv=64)
    jargs = (j8(q8), jk, jv, jnp.asarray(qscale), jnp.asarray([ks]), jnp.asarray([vs]),
             jnp.asarray(cu), jnp.asarray(tbl), jnp.asarray(kv_lens, jnp.int32), max(q_lens))
    want = np.asarray(jax_sparse_fp8(*jargs, block_mask=jnp.asarray(mask), mask_tile_q=128,
                                     mask_tile_kv=64, impl="ref"), np.float32)
    kc, vc = in_layout(k8, v8, layout)
    got = attention_with_kvcache_blocksparse_prefill_fp8(
        q8, kc, vc, torch.from_numpy(qscale), torch.tensor([ks]), torch.tensor([vs]),
        torch.from_numpy(cu), torch.from_numpy(tbl), torch.tensor(kv_lens, dtype=torch.int32),
        max(q_lens), block_mask=torch.from_numpy(mask), mask_tile_q=128, mask_tile_kv=64,
        cache_layout=layout).float()
    assert_allclose(got, want, **FOLDED, name=f"{kind} {layout} sparse vs jax ref")


@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (32, 16), (16, 48)])
def test_any_mask_tile_gives_the_reference_function(tiles):
    """Mask tiles that are and are not multiples of the kernel's tiles (64/G
    rows, 64 columns): the kernel path equals the port's reference, which
    equals JAX's (on these masks every row keeps a key)."""
    mtq, mtkv = tiles
    rng = np.random.RandomState(mtq + mtkv)
    q_lens, kv_lens = [70, 33], [150, 33]
    q = rng.randn(sum(q_lens), HQ, D).astype(np.float32)
    k, v, tbl = build_paged(rng, kv_lens)
    mask = random_mask(rng, q_lens, kv_lens, mtq, mtkv)
    args = port_args(bf16(q), bf16(k), bf16(v), tbl, "HND", kv_lens, q_lens)
    kw = dict(block_mask=torch.from_numpy(mask), mask_tile_q=mtq, mask_tile_kv=mtkv,
              cache_layout="HND")
    got = attention_with_kvcache_prefill(*args, **kw).float()
    ref = attention_with_kvcache_prefill(*args, impl="ref", **kw).float()
    assert_allclose(got, ref, **TIGHT, name=f"tiles {tiles}: kernel path vs ref")
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    want = jax_prefill(jbf16(q), jbf16(k).transpose(2, 0, 1, 3), jbf16(v).transpose(2, 0, 1, 3),
                       jnp.asarray(cu), jnp.asarray(tbl), jnp.asarray(kv_lens, jnp.int32),
                       max(q_lens), block_mask=jnp.asarray(mask), mask_tile_q=mtq,
                       mask_tile_kv=mtkv, cache_layout="HND", impl="ref")
    assert_allclose(ref, np.asarray(want, np.float32), atol=1e-3, rtol=1e-3, name="ref vs jax ref")


def test_plain_version_in_chunks_equals_one_pass():
    """The plain version's q chunking (how it bounds memory at 32K tokens)
    changes nothing, and a sub-request cut at a mask-row boundary (a
    prefix of its keys, the mask rows from there on) gives the same rows:
    the check chip_smoke.py makes at long lengths."""
    c = bf16_case(1)
    q, k, v = bf16(c["q"]), bf16(c["k"]), bf16(c["v"])
    args = port_args(q, k, v, c["tbl"], "NHD")
    mask = torch.from_numpy(c["mask"])
    whole = _prefill_sparse_ref(*args, 0.1, "NHD", mask, MT, MT)
    chunked = _prefill_sparse_ref(*args, 0.1, "NHD", mask, MT, MT, chunk=7)
    assert torch.equal(whole, chunked)
    r0 = 64  # request 0's second q tile: rows 64..127 at positions 128..191
    sub = _prefill_sparse_ref(q[r0:128], k, v, torch.tensor([0, 64], dtype=torch.int32),
                              torch.from_numpy(c["tbl"][:1]), torch.tensor([192], dtype=torch.int32),
                              64, 0.1, "NHD", mask[:1, :, r0 // MT:], MT, MT)
    assert torch.equal(sub, whole[r0:128])


def test_malformed_masks_raise():
    c = bf16_case(0)
    args = port_args(bf16(c["q"]), bf16(c["k"]), bf16(c["v"]), c["tbl"], "HND")
    mask = torch.from_numpy(c["mask"])
    for bad, match in ((mask[0], "must be"), (mask[:, :2], "must be"),
                       (torch.ones((2, HQ, 2, 40), dtype=torch.uint8), "page table")):
        with pytest.raises(ValueError, match=match):
            attention_with_kvcache_prefill(*args, block_mask=bad, mask_tile_q=MT, mask_tile_kv=MT,
                                           cache_layout="HND")
    with pytest.raises(ValueError, match="at least 1"):
        paged_prefill_sparse(*args, 0.1, "HND", mask, 0, MT)
