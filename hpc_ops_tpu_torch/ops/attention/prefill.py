"""Varlen causal prefill attention over a paged cache (port of
``ops/attention/prefill.py``, dense path).

q is read from, and the output written to, packed ``[total_q, Hq*D]`` rows
through ``cu_seqlens_q``; query i of request b sits at position
``seqlens_kvcache[b] - q_len[b] + i``, so a prefix already in the cache
(chunked prefill) is attended. Rows past ``cu_seqlens_q[-1]`` belong to no
request and come back as zeros (the kernel writes them). The kernel is
``csrc/prefill.cu``; it needs no alignment of ``cu_seqlens_q``.

Caches are bf16, int8 codes or e4m3 (``torch.float8_e4m3fn``) in HND, NHD or
the NHD_FUSED slab ``[num_blocks, 2*block_size, Hkv*D]`` (``vcache``
unused). With per-tensor ``kscale``/``vscale`` the logits are scaled by
``sm_scale * kscale`` and the output by ``vscale`` (one scale, or one per kv
head); a per-token-per-head ``qscale`` ``[B, Hq, pad]`` is gathered onto the
packed rows and folded into q, rounded to bf16, before the kernel. With
QuantTypes 0 and 3 and G K scales per (token, kv head), paged
``[num_blocks, block_size, Hkv, G]``, the kernel multiplies each logit
column by its token's scale (G = 1) or sums each group's float32 partial
product over its D/G columns times its token's scale for that group (G > 1;
the JAX package sends those to its reference). Also ``sm_scale`` and
``impl="ref"``. The kernel multiplies on the tensor cores in 16 bits
(bf16 q and K; P and V in bf16 for bf16 caches, fp16 for int8 and e4m3
codes, which convert exactly) with float32 sums.

A ``block_mask`` ``[B, Hq, n_tm, n_tkv]`` (uint8 or bool, one row of tiles
per q head) selects the block-sparse path, :func:`paged_prefill_sparse`:
the same kernel skips every 64-column KV tile that no head of a block's
GQA group keeps and masks the logits of each head by its own tiles, for
any ``mask_tile_q``/``mask_tile_kv``, over every cache layout, type and
scale scheme above. Rows with no kept key are 0, as the JAX kernel writes
them; ``impl="ref"`` keeps the JAX reference's semantics (such a row
averages V).
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.ops.attention.decode import (
    _PERTOKEN_K,
    _check_rows_aligned,
    _check_slab,
    _kv_type,
    _nhd,
    _page_strides,
    _ptr,
    _scale_tensor,
)
from hpc_ops_tpu_torch.ops.attention.paging import nhd_fused_views
from hpc_ops_tpu_torch.ops.attention.reference import (
    _gather_pages,
    _tile_keep,
    attention_with_kvcache_prefill_ref,
)
from hpc_ops_tpu_torch.utils.common import cdiv


def _prefill_ref(q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale,
                 cache_layout, kscale=None, vscale=None, ktok=None):
    """Plain PyTorch version of :func:`paged_prefill_attention` (float32)."""
    pertoken = ktok is not None
    return attention_with_kvcache_prefill_ref(
        q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), cu_seqlens_q,
        block_ids, kv_lens, max_seqlens_q, kscale=ktok if pertoken else kscale, vscale=vscale,
        quant_type=(QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD if pertoken
                    else QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR),
        sm_scale=scale,
    )


KERNEL_HEAD_DIMS = (64, 96, 128, 256)  # csrc/prefill.cu's instances (96: zero-padded to 128)
MAX_GQA_GROUP = 128  # query heads a kv head: 128 / G tokens a block, one at G 128


def _check_heads(name, d, hq, hkv):
    """Raises ``ValueError`` for a head shape the kernel has no instance for."""
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim {', '.join(map(str, KERNEL_HEAD_DIMS))}")
    if hkv < 1 or hq % hkv or hq // hkv > MAX_GQA_GROUP:
        raise ValueError(f"{name}: unsupported GQA group (at most {MAX_GQA_GROUP} q heads a kv head)")


def _split_cache_launch_args(name, q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens, cache_layout,
                             kscale, vscale, ktok, *more):
    """Checks shared by the wrappers over split K and V caches (``more``:
    other tensors that must lie on q's device). Returns the launchers' common
    arguments: (kv_type, k and v strides, the three scale pointers, cu,
    lengths and table as contiguous int32, page_size, hkv, per-head vscale,
    K scale groups)."""
    kv_type = _kv_type(name, kcache, vcache)
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16")
    for t in (kcache, vcache, cu_seqlens_q, block_ids, kv_lens, *more):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    hq, d = q.shape[1], q.shape[2]
    hkv = kcache.shape[0] if cache_layout == "HND" else kcache.shape[2]
    nb = kcache.shape[1] if cache_layout == "HND" else kcache.shape[0]
    page_size = kcache.shape[2] if cache_layout == "HND" else kcache.shape[1]
    _check_heads(name, d, hq, hkv)
    if vcache.shape[3] != d or kcache.shape[3] != d:
        raise ValueError(f"{name}: q, K and V must share one head_dim")
    k_st = _page_strides(kcache, cache_layout)
    v_st = _page_strides(vcache, cache_layout)
    _check_rows_aligned(name, (kcache, k_st), (vcache, v_st))
    groups = 1
    if ktok is not None:
        if kscale is not None:
            raise ValueError(f"{name}: per-token K scales replace the per-tensor kscale")
        groups = ktok.shape[-1]
        if (ktok.device != q.device or ktok.dim() != 4 or tuple(ktok.shape[:3]) != (nb, page_size, hkv)
                or groups > 8 or d % groups or (groups > 1 and d in (96, 256) and (d // groups) % 16)):
            raise ValueError(f"{name}: K scales must be [{nb}, {page_size}, {hkv}, G] on q's device, "
                             "G <= 8 dividing D (at D 96 and 256 into groups of a multiple of 16)")
        ktok = ktok.float().contiguous()
    per_head = vscale is not None and hkv > 1 and torch.as_tensor(vscale).numel() == hkv
    scales = (_scale_tensor(kscale, q.device), _scale_tensor(vscale, q.device, hkv if per_head else 1),
              ktok)
    tables = tuple(t.to(torch.int32).contiguous() for t in (cu_seqlens_q, kv_lens, block_ids))
    return kv_type, k_st, v_st, scales, tables, page_size, hkv, per_head, groups


def paged_prefill_attention(
    q: torch.Tensor,  # [total_q, Hq, D] bf16 (rows past cu[-1] allowed)
    kcache: torch.Tensor,
    vcache: torch.Tensor,
    cu_seqlens_q: torch.Tensor,  # [B+1]
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B]
    max_seqlens_q: int,
    scale: float,
    cache_layout: str,
    kscale=None,  # [1] f32 per-tensor K scale (None: 1)
    vscale=None,  # [1] f32 per-tensor, or [Hkv] per-head, V scale (None: 1)
    ktok=None,  # [num_blocks, block_size, Hkv, G] f32 per-token K scales, in place of kscale
) -> torch.Tensor:
    """Causal varlen prefill over paged K and V caches (HND or NHD; bf16,
    int8 or e4m3); returns [total_q, Hq, D] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type == "cpu":
        return _prefill_ref(
            q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale, cache_layout,
            kscale, vscale, ktok,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device {q.device}")
    kv_type, k_st, v_st, scales, (cu, lens, tbl), page_size, hkv, per_head, groups = (
        _split_cache_launch_args("paged_prefill_attention", q, kcache, vcache, cu_seqlens_q, block_ids,
                                 kv_lens, cache_layout, kscale, vscale, ktok))
    total_q, hq, d = q.shape
    out = torch.empty((total_q, hq, d), dtype=torch.bfloat16, device=q.device)  # every row written
    rc = kernels.lib().hpc_paged_prefill(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), kv_type, *k_st, *v_st,
        *(_ptr(t) for t in scales), cu.data_ptr(), lens.data_ptr(), tbl.data_ptr(), out.data_ptr(),
        total_q, lens.shape[0], tbl.shape[1], page_size, hq, hkv, d, int(max_seqlens_q), int(per_head),
        groups, float(scale), kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_prefill")
    kernels.count(paged_prefill_attention)
    return out


paged_prefill_attention.launches = 0


def _prefill_nhd_fused_ref(q, kv, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale,
                           kscale, vscale):
    """Plain PyTorch version of :func:`paged_prefill_nhd_fused` (float32): the
    reference over NHD views of the slab, dequantised by ``_dequant_kv``."""
    k, v = nhd_fused_views(kv, kv.shape[2] // q.shape[2])
    return attention_with_kvcache_prefill_ref(
        q, k, v, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, kscale=kscale,
        vscale=vscale, sm_scale=scale,
    )


def paged_prefill_nhd_fused(
    q: torch.Tensor,  # [total_q, Hq, D] bf16 (rows past cu[-1] allowed)
    kv: torch.Tensor,  # [num_blocks, 2*block_size, Hkv*D] bf16, int8 or e4m3
    cu_seqlens_q: torch.Tensor,  # [B+1]
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B]
    max_seqlens_q: int,
    scale: float,
    kscale=None,  # [1] f32 per-tensor K scale (None: 1)
    vscale=None,  # [1] f32 per-tensor V scale (None: 1)
) -> torch.Tensor:
    """Causal varlen prefill over an NHD_FUSED slab; returns [total_q, Hq, D] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type == "cpu":
        return _prefill_nhd_fused_ref(
            q, kv, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale, kscale, vscale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_nhd_fused: unsupported device {q.device}")
    total_q, hq, d = q.shape
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("paged_prefill_nhd_fused: q must be contiguous bf16")
    hkv = kv.shape[2] // d
    _check_heads("paged_prefill_nhd_fused", d, hq, hkv)
    kv_type = _kv_type("paged_prefill_nhd_fused", kv)
    _check_slab("paged_prefill_nhd_fused", kv, hkv, d)
    ks, vs = _scale_tensor(kscale, q.device), _scale_tensor(vscale, q.device)
    for t in (kv, cu_seqlens_q, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError("paged_prefill_nhd_fused: all tensors must be on one device")
    cu = cu_seqlens_q.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    tbl = block_ids.to(torch.int32).contiguous()
    out = torch.empty((total_q, hq, d), dtype=torch.bfloat16, device=q.device)  # every row written
    rc = kernels.lib().hpc_paged_prefill_nhd_fused(
        q.data_ptr(), kv.data_ptr(), kv_type, _ptr(ks), _ptr(vs),
        cu.data_ptr(), lens.data_ptr(), tbl.data_ptr(), out.data_ptr(), total_q,
        lens.shape[0], tbl.shape[1], kv.shape[1] // 2, hq, hkv, d, int(max_seqlens_q),
        float(scale), kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_prefill_nhd_fused")
    kernels.count(paged_prefill_nhd_fused)
    return out


paged_prefill_nhd_fused.launches = 0


def _check_block_mask(block_mask, b, hq, max_blocks, page_size, mask_tile_q, mask_tile_kv):
    """The mask as contiguous uint8 ``[B, Hq, n_tm, n_tkv]``; raises
    ``ValueError`` on another shape, on tiles below 1 token, or on a mask
    with a column wholly past the page table (JAX asserts there)."""
    if mask_tile_q < 1 or mask_tile_kv < 1:
        raise ValueError("block_mask: mask_tile_q and mask_tile_kv must be at least 1")
    if block_mask.dim() != 4 or tuple(block_mask.shape[:2]) != (b, hq) or 0 in block_mask.shape:
        raise ValueError(f"block_mask must be [{b}, {hq}, n_tm, n_tkv], got {tuple(block_mask.shape)}")
    n_tkv = block_mask.shape[3]
    if n_tkv > cdiv(max_blocks * page_size, mask_tile_kv):
        raise ValueError(
            f"block_mask covers {n_tkv} kv tiles of {mask_tile_kv} but the page table holds "
            f"{max_blocks * page_size} positions: check mask_tile_kv against the mask"
        )
    return (block_mask != 0).to(torch.uint8).contiguous()


def _gather_request(cache, tbl_row, n):
    """One request's first ``n`` cache rows, [n, H, X] float32 (pages below 0 read 0)."""
    raw = cache.view(torch.uint8) if cache.element_size() == 1 else cache
    rows = _gather_pages(raw, tbl_row[None], n)[0]
    return (rows.view(cache.dtype) if cache.element_size() == 1 else rows).float()


def _prefill_sparse_ref(q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale,
                        cache_layout, block_mask, mask_tile_q, mask_tile_kv, kscale=None,
                        vscale=None, ktok=None, chunk=1024):
    """Plain PyTorch version of :func:`paged_prefill_sparse` (float32), as
    the JAX kernel computes: each head's logits are kept where the causal
    mask and its own mask tile allow (tiles past the mask's edge are 0), a
    row with no kept key is 0, and so are rows past ``cu_seqlens_q[-1]``.
    Request by request, ``chunk`` q rows at a time."""
    del max_seqlens_q
    total_q, hq, d = q.shape
    kn, vn = _nhd(kcache, cache_layout), _nhd(vcache, cache_layout)
    hkv = kn.shape[2]
    g = hq // hkv
    out = torch.zeros((total_q, hq, vn.shape[3]), dtype=torch.float32, device=q.device)
    cu = [int(x) for x in cu_seqlens_q.tolist()]
    lens = [int(x) for x in kv_lens.tolist()]
    kv_cap = block_ids.shape[1] * kn.shape[1]
    for bi, kv_len in enumerate(lens):
        q0, q_len = cu[bi], cu[bi + 1] - cu[bi]
        kl = min(kv_len, kv_cap)
        if q_len == 0 or kl <= 0:
            continue
        k = _gather_request(kn, block_ids[bi], kl)
        v = _gather_request(vn, block_ids[bi], kl)
        if ktok is not None:  # [kl, Hkv, G] scales, each over D/G columns
            ks = _gather_request(ktok, block_ids[bi], kl)
            k = k * ks.repeat_interleave(d // ks.shape[-1], dim=-1)
        elif kscale is not None:
            k = k * torch.as_tensor(kscale, dtype=torch.float32, device=k.device).reshape(())
        if vscale is not None:
            v = v * torch.as_tensor(vscale, dtype=torch.float32, device=v.device).reshape(-1)[None, :, None]
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        kpos = torch.arange(kl, device=q.device)
        for r0 in range(0, q_len, chunk):
            rows = torch.arange(r0, min(q_len, r0 + chunk), device=q.device)
            s = torch.einsum("qhd,khd->hqk", q[q0 + rows].float(), k) * scale
            keep = (kpos[None, :] <= (kv_len - q_len + rows)[:, None])[None] & _tile_keep(
                block_mask[bi], rows, kl, mask_tile_q, mask_tile_kv, pad_missing=True)
            s = s.masked_fill(~keep, float("-inf"))
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m.masked_fill(m == float("-inf"), 0.0))
            l = p.sum(dim=-1, keepdim=True)
            o = torch.einsum("hqk,khd->qhd", p / l.masked_fill(l == 0, 1.0), v)
            out[q0 + rows] = o
    return out.to(torch.bfloat16)


def paged_prefill_sparse(
    q: torch.Tensor,  # [total_q, Hq, D] bf16 (rows past cu[-1] allowed)
    kcache: torch.Tensor,
    vcache: torch.Tensor,
    cu_seqlens_q: torch.Tensor,  # [B+1]
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B]
    max_seqlens_q: int,
    scale: float,
    cache_layout: str,
    block_mask: torch.Tensor,  # [B, Hq, n_tm, n_tkv] uint8 or bool
    mask_tile_q: int,
    mask_tile_kv: int,
    kscale=None,  # [1] f32 per-tensor K scale (None: 1)
    vscale=None,  # [1] f32 per-tensor, or [Hkv] per-head, V scale (None: 1)
    ktok=None,  # [num_blocks, block_size, Hkv, G] f32 per-token K scales, in place of kscale
) -> torch.Tensor:
    """Block-sparse causal varlen prefill over paged K and V caches (HND or
    NHD, strided views of an NHD_FUSED slab included; bf16, int8 or e4m3);
    returns [total_q, Hq, D] bf16. Row i of request b, head h attends key
    position p where p is causal and ``block_mask[b, h, i // mask_tile_q, p
    // mask_tile_kv]`` is set (0 past the mask's edge); rows with no such key
    are 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    name = "paged_prefill_sparse"
    total_q, hq, d = q.shape
    page_size = kcache.shape[2] if cache_layout == "HND" else kcache.shape[1]
    mask = _check_block_mask(block_mask, kv_lens.shape[0], hq, block_ids.shape[1], page_size,
                             mask_tile_q, mask_tile_kv)
    if q.device.type == "cpu":
        return _prefill_sparse_ref(
            q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale,
            cache_layout, mask, mask_tile_q, mask_tile_kv, kscale, vscale, ktok,
        )
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    kv_type, k_st, v_st, scales, (cu, lens, tbl), page_size, hkv, per_head, groups = (
        _split_cache_launch_args(name, q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens,
                                 cache_layout, kscale, vscale, ktok, mask))
    out = torch.empty((total_q, hq, d), dtype=torch.bfloat16, device=q.device)  # every row written
    rc = kernels.lib().hpc_paged_prefill_sparse(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), kv_type, *k_st, *v_st,
        *(_ptr(t) for t in scales), cu.data_ptr(), lens.data_ptr(), tbl.data_ptr(), mask.data_ptr(),
        out.data_ptr(), total_q,
        lens.shape[0], tbl.shape[1], page_size, hq, hkv, d, int(max_seqlens_q), int(per_head),
        groups, mask.shape[2], mask.shape[3], int(mask_tile_q), int(mask_tile_kv), float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_prefill_sparse")
    kernels.count(paged_prefill_sparse)
    return out


paged_prefill_sparse.launches = 0


def attention_with_kvcache_prefill(
    q,
    kcache,
    vcache,
    cu_seqlens_q,
    block_ids,
    seqlens_kvcache,
    max_seqlens_q: int,
    qscale=None,
    kscale=None,
    vscale=None,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
    block_mask=None,
    *,
    mask_tile_q: int = 128,
    mask_tile_kv: int = 128,
    sm_scale: float | None = None,
    tq: int | None = None,
    pages_per_compute_block: int | None = None,
    cache_layout: str = "NHD",
    impl: str = "auto",
    aligned_seq_starts: bool = False,
):
    """Paged-cache varlen prefill over a bf16, int8 or e4m3 cache. Returns
    bf16 [total_q, Hq, Dv].

    ``q`` is bf16, or quantised with ``qscale`` [B, Hq, max_q_pad]. A bf16
    cache ignores ``kscale``/``vscale``, as in the JAX package. The kernel
    applies ``sm_scale`` and the scales in float32 (the JAX wrapper folds
    ``sm_scale`` into q before its rounding to bf16 and scales a bf16 output).

    ``aligned_seq_starts=True`` asserts that every ``cu_seqlens_q`` entry is a
    multiple of 8 (the JAX package's packing contract); it is checked here,
    although this kernel needs no alignment. ``block_mask`` selects the
    block-sparse path (see the module docstring). ``tq`` and
    ``pages_per_compute_block`` are TPU tuning knobs, accepted and unused.
    """
    del tq, pages_per_compute_block
    if aligned_seq_starts:
        cu_list = [int(x) for x in cu_seqlens_q.tolist()]
        if any(x % 8 for x in cu_list):
            raise ValueError(
                "aligned_seq_starts=True requires every cu_seqlens_q entry "
                f"to be a multiple of 8, got {cu_list}; pass "
                "aligned_seq_starts=False for arbitrary packing"
            )
    if cache_layout not in ("NHD", "HND", "NHD_FUSED"):
        raise ValueError(f"cache_layout={cache_layout!r} is not a prefill cache layout")
    total_q, hq, d = q.shape
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    quantised = kcache.dtype != torch.bfloat16
    pertoken_k = quantised and QuantType(quant_type) in _PERTOKEN_K
    if not quantised:
        kscale = vscale = None
    if pertoken_k and kscale is None:
        raise ValueError("per-token K scales (QuantType 0, 3) need kscale")
    sparse = block_mask is not None
    if cache_layout == "NHD_FUSED" and (pertoken_k or sparse or impl == "ref"):
        # the split-cache kernels read the slab in place through NHD views
        kcache, vcache = nhd_fused_views(kcache, kcache.shape[2] // d)
        cache_layout = "NHD"
    if impl == "ref":
        return attention_with_kvcache_prefill_ref(
            q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), cu_seqlens_q, block_ids,
            seqlens_kvcache, max_seqlens_q, qscale=qscale, kscale=kscale, vscale=vscale,
            quant_type=quant_type, block_mask=block_mask, mask_tile_q=mask_tile_q,
            mask_tile_kv=mask_tile_kv, sm_scale=scale,
        )
    if qscale is not None:
        # gather the per-(request, head, position) scale onto the packed rows
        b = seqlens_kvcache.shape[0]
        cu = cu_seqlens_q.long()
        row = torch.arange(total_q, dtype=torch.int64, device=q.device)
        req = torch.searchsorted(cu[1:].contiguous(), row, right=True).clamp(max=b - 1)
        pos = (row - cu[req]).clamp(0, qscale.shape[-1] - 1)
        qb = (q.float() * qscale[req, :, pos][..., None].float()).to(torch.bfloat16)
    else:
        qb = q.to(torch.bfloat16).contiguous()
    if cache_layout == "NHD_FUSED":
        return paged_prefill_nhd_fused(
            qb, kcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, scale, kscale,
            vscale,
        )
    if pertoken_k:
        kscale, ktok = None, kscale
    else:
        ktok = None
    if sparse:
        return paged_prefill_sparse(
            qb, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, scale,
            cache_layout, block_mask, mask_tile_q, mask_tile_kv, kscale, vscale, ktok,
        )
    return paged_prefill_attention(
        qb, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, scale,
        cache_layout, kscale, vscale, ktok,
    )


def attention_with_kvcache_prefill_bf16(
    q, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, **kw
):
    """BF16 paged prefill. See :func:`attention_with_kvcache_prefill`."""
    return attention_with_kvcache_prefill(
        q, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, **kw
    )


def attention_with_kvcache_prefill_fp8(
    q, kcache, vcache, qscale, kscale, vscale, cu_seqlens_q, block_ids, seqlens_kvcache,
    max_seqlens_q,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR, **kw,
):
    """FP8 paged prefill (the JAX package's argument order). See :func:`attention_with_kvcache_prefill`."""
    return attention_with_kvcache_prefill(
        q, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q,
        qscale=qscale, kscale=kscale, vscale=vscale, quant_type=quant_type, **kw,
    )


def attention_with_kvcache_blocksparse_prefill_fp8(
    q, kcache, vcache, qscale, kscale, vscale, cu_seqlens_q, block_ids, seqlens_kvcache,
    max_seqlens_q,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR, block_mask=None,
    **kw,
):
    """Dense or block-sparse fp8 paged prefill (the JAX package's argument
    order): ``block_mask`` [B, Hq, n_tm, n_tkv] uint8, 1 = tile computed.
    See :func:`attention_with_kvcache_prefill`."""
    return attention_with_kvcache_prefill(
        q, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q,
        qscale=qscale, kscale=kscale, vscale=vscale, quant_type=quant_type,
        block_mask=block_mask, **kw,
    )


def attention_prefill_bf16(q, k, v, seqlens_q, cu_seqlens_q, max_seqlens_q, *, tq: int = 128, **kw):
    """Dense packed-varlen prefill: K/V packed like Q ([total, Hkv, D]).

    Stages K/V into per-request pages of 128 slots (NHD) and runs the paged
    prefill over them.
    """
    total, hkv, d = k.shape
    dv = v.shape[-1]
    b = seqlens_q.shape[0]
    page = 128
    max_blocks = cdiv(int(max_seqlens_q), page)
    nb = b * max_blocks
    dev = q.device
    block_ids = (
        torch.arange(b, dtype=torch.int32, device=dev)[:, None] * max_blocks
        + torch.arange(max_blocks, dtype=torch.int32, device=dev)[None, :]
    )
    cu = cu_seqlens_q.long()
    row = torch.arange(total, dtype=torch.int64, device=dev)
    req = torch.searchsorted(cu[1:].contiguous(), row, right=True).clamp(max=b - 1)
    pos = row - cu[req]
    valid = (row < cu[b]) & (pos < max_blocks * page)
    slot = (req * (max_blocks * page) + pos)[valid]
    k_pages = torch.zeros((nb * page, hkv, d), dtype=k.dtype, device=dev)
    v_pages = torch.zeros((nb * page, hkv, dv), dtype=v.dtype, device=dev)
    k_pages[slot] = k[valid]
    v_pages[slot] = v[valid]
    return attention_with_kvcache_prefill(
        q, k_pages.view(nb, page, hkv, d), v_pages.view(nb, page, hkv, dv),
        cu_seqlens_q, block_ids, seqlens_q, max_seqlens_q, tq=tq, **kw,
    )


__all__ = [
    "attention_prefill_bf16",
    "attention_with_kvcache_prefill",
    "attention_with_kvcache_prefill_bf16",
    "attention_with_kvcache_prefill_fp8",
    "attention_with_kvcache_blocksparse_prefill_fp8",
    "paged_prefill_attention",
    "paged_prefill_nhd_fused",
    "paged_prefill_sparse",
]
