"""Varlen causal prefill attention over a paged cache (port of
``ops/attention/prefill.py``, dense path).

q is read from, and the output written to, packed ``[total_q, Hq*D]`` rows
through ``cu_seqlens_q``; query i of request b sits at position
``seqlens_kvcache[b] - q_len[b] + i``, so a prefix already in the cache
(chunked prefill) is attended. Rows past ``cu_seqlens_q[-1]`` belong to no
request and come back as zeros. The kernel is ``csrc/prefill.cu``; it needs
no alignment of ``cu_seqlens_q``.

Caches are bf16, int8 codes or e4m3 (``torch.float8_e4m3fn``) in HND, NHD or
the NHD_FUSED slab ``[num_blocks, 2*block_size, Hkv*D]`` (``vcache``
unused). With per-tensor ``kscale``/``vscale`` the logits are scaled by
``sm_scale * kscale`` and the output by ``vscale`` (one scale, or one per kv
head); a per-token-per-head ``qscale`` ``[B, Hq, pad]`` is gathered onto the
packed rows and folded into q, rounded to bf16, before the kernel. With
QuantTypes 0 and 3 and one K scale per (token, kv head), paged
``[num_blocks, block_size, Hkv, 1]``, the kernel multiplies each logit
column by its token's scale; scales grouped along D take the plain
reference, as in the JAX package. Also ``sm_scale`` and ``impl="ref"``.
Block-sparse masks are a later slice and raise ``NotImplementedError``.
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
from hpc_ops_tpu_torch.ops.attention.reference import attention_with_kvcache_prefill_ref
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
    ktok=None,  # [num_blocks, block_size, Hkv, 1] f32 per-token K scales, in place of kscale
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
    name = "paged_prefill_attention"
    kv_type = _kv_type(name, kcache, vcache)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: q must be bf16")
    for t in (kcache, vcache, cu_seqlens_q, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError("paged_prefill_attention: all tensors must be on one device")
    total_q, hq, d = q.shape
    hkv = kcache.shape[0] if cache_layout == "HND" else kcache.shape[2]
    nb = kcache.shape[1] if cache_layout == "HND" else kcache.shape[0]
    page_size = kcache.shape[2] if cache_layout == "HND" else kcache.shape[1]
    if d not in (64, 128) or vcache.shape[3] != d or kcache.shape[3] != d:
        raise ValueError("paged_prefill_attention: the CUDA kernel takes head_dim 64 or 128")
    if hq % hkv or hq // hkv > 64:
        raise ValueError("paged_prefill_attention: unsupported GQA group")
    if not q.is_contiguous():
        raise ValueError("paged_prefill_attention: q must be contiguous")
    k_st = _page_strides(kcache, cache_layout)
    v_st = _page_strides(vcache, cache_layout)
    _check_rows_aligned("paged_prefill_attention", (kcache, k_st), (vcache, v_st))
    if ktok is not None:
        if kscale is not None:
            raise ValueError(f"{name}: per-token K scales replace the per-tensor kscale")
        if ktok.device != q.device or tuple(ktok.shape) != (nb, page_size, hkv, 1):
            raise ValueError(f"{name}: K scales must be [{nb}, {page_size}, {hkv}, 1] on q's device")
        ktok = ktok.float().contiguous()
    ks = _scale_tensor(kscale, q.device)
    per_head = vscale is not None and hkv > 1 and torch.as_tensor(vscale).numel() == hkv
    vs = _scale_tensor(vscale, q.device, hkv if per_head else 1)
    cu = cu_seqlens_q.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    tbl = block_ids.to(torch.int32).contiguous()
    out = torch.zeros((total_q, hq, d), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_prefill(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), kv_type, *k_st, *v_st,
        _ptr(ks), _ptr(vs), _ptr(ktok),
        cu.data_ptr(), lens.data_ptr(), tbl.data_ptr(), out.data_ptr(),
        lens.shape[0], tbl.shape[1], page_size, hq, hkv, d, int(max_seqlens_q), int(per_head),
        float(scale), kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_prefill")
    paged_prefill_attention.launches += 1
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
    if d not in (64, 128):
        raise ValueError("paged_prefill_nhd_fused: the CUDA kernel takes head_dim 64 or 128")
    hkv = kv.shape[2] // d
    if hkv == 0 or hq % hkv or hq // hkv > 64:
        raise ValueError("paged_prefill_nhd_fused: unsupported GQA group")
    kv_type = _kv_type("paged_prefill_nhd_fused", kv)
    _check_slab("paged_prefill_nhd_fused", kv, hkv, d)
    ks, vs = _scale_tensor(kscale, q.device), _scale_tensor(vscale, q.device)
    for t in (kv, cu_seqlens_q, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError("paged_prefill_nhd_fused: all tensors must be on one device")
    cu = cu_seqlens_q.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    tbl = block_ids.to(torch.int32).contiguous()
    out = torch.zeros((total_q, hq, d), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_prefill_nhd_fused(
        q.data_ptr(), kv.data_ptr(), kv_type, _ptr(ks), _ptr(vs),
        cu.data_ptr(), lens.data_ptr(), tbl.data_ptr(), out.data_ptr(),
        lens.shape[0], tbl.shape[1], kv.shape[1] // 2, hq, hkv, d, int(max_seqlens_q),
        float(scale), kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_prefill_nhd_fused")
    paged_prefill_nhd_fused.launches += 1
    return out


paged_prefill_nhd_fused.launches = 0


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
    although this kernel needs no alignment. ``tq``, ``mask_tile_*`` and
    ``pages_per_compute_block`` are TPU tuning knobs, accepted and unused.
    """
    del mask_tile_q, mask_tile_kv, tq, pages_per_compute_block
    if aligned_seq_starts:
        cu_list = [int(x) for x in cu_seqlens_q.tolist()]
        if any(x % 8 for x in cu_list):
            raise ValueError(
                "aligned_seq_starts=True requires every cu_seqlens_q entry "
                f"to be a multiple of 8, got {cu_list}; pass "
                "aligned_seq_starts=False for arbitrary packing"
            )
    if block_mask is not None:
        raise NotImplementedError("block-sparse prefill arrives with ROADMAP queue 1 item 6")
    if cache_layout not in ("NHD", "HND", "NHD_FUSED"):
        raise NotImplementedError(
            f"cache_layout={cache_layout!r} is not a prefill cache layout"
        )
    total_q, hq, d = q.shape
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    quantised = kcache.dtype != torch.bfloat16
    pertoken_k = quantised and QuantType(quant_type) in _PERTOKEN_K
    if not quantised:
        kscale = vscale = None
    if pertoken_k and kscale is None:
        raise ValueError("per-token K scales (QuantType 0, 3) need kscale")
    if cache_layout == "NHD_FUSED" and (pertoken_k or impl == "ref"):
        kcache, vcache = nhd_fused_views(kcache, kcache.shape[2] // d)
        cache_layout = "NHD"
    if impl == "ref" or (pertoken_k and kscale.shape[-1] != 1):
        # QuantType 0 has a kernel path for one scale per (token, kv head)
        # only; scales grouped along D take the reference, as in the JAX package
        return attention_with_kvcache_prefill_ref(
            q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), cu_seqlens_q, block_ids,
            seqlens_kvcache, max_seqlens_q, qscale=qscale, kscale=kscale, vscale=vscale,
            quant_type=quant_type, sm_scale=scale,
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
    "paged_prefill_attention",
    "paged_prefill_nhd_fused",
]
