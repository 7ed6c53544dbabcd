"""Varlen causal prefill attention over a paged bf16 cache (port of
``ops/attention/prefill.py``, dense path).

q is read from, and the output written to, packed ``[total_q, Hq*D]`` rows
through ``cu_seqlens_q``; query i of request b sits at position
``seqlens_kvcache[b] - q_len[b] + i``, so a prefix already in the cache
(chunked prefill) is attended. Rows past ``cu_seqlens_q[-1]`` belong to no
request and come back as zeros. The kernel is ``csrc/prefill.cu``; it needs
no alignment of ``cu_seqlens_q``.

Ported here: bf16 caches in HND and NHD, and the NHD_FUSED slab
``[num_blocks, 2*block_size, Hkv*D]`` (``vcache`` unused) in bf16 or as
int8 codes with per-tensor ``kscale``/``vscale`` (logits scaled by
``sm_scale * kscale``, the output by ``vscale``); ``sm_scale`` and
``impl="ref"``. fp8 caches and block-sparse masks are later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.ops.attention.decode import (
    _check_rows_aligned,
    _check_slab,
    _nhd,
    _page_strides,
    _scale_tensor,
)
from hpc_ops_tpu_torch.ops.attention.paging import nhd_fused_views
from hpc_ops_tpu_torch.ops.attention.reference import attention_with_kvcache_prefill_ref
from hpc_ops_tpu_torch.utils.common import cdiv


def _prefill_ref(q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale, cache_layout):
    """Plain PyTorch version of :func:`paged_prefill_attention` (float32)."""
    return attention_with_kvcache_prefill_ref(
        q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), cu_seqlens_q,
        block_ids, kv_lens, max_seqlens_q, sm_scale=scale,
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
) -> torch.Tensor:
    """Causal varlen prefill; returns [total_q, Hq, D] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type == "cpu":
        return _prefill_ref(
            q, kcache, vcache, cu_seqlens_q, block_ids, kv_lens, max_seqlens_q, scale, cache_layout
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device {q.device}")
    if not (q.dtype == kcache.dtype == vcache.dtype == torch.bfloat16):
        raise NotImplementedError("paged_prefill_attention: the CUDA kernel reads bf16 only")
    for t in (kcache, vcache, cu_seqlens_q, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError("paged_prefill_attention: all tensors must be on one device")
    total_q, hq, d = q.shape
    hkv = kcache.shape[0] if cache_layout == "HND" else kcache.shape[2]
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
    cu = cu_seqlens_q.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    tbl = block_ids.to(torch.int32).contiguous()
    out = torch.zeros((total_q, hq, d), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_prefill_bf16(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), *k_st, *v_st,
        cu.data_ptr(), lens.data_ptr(), tbl.data_ptr(), out.data_ptr(),
        lens.shape[0], tbl.shape[1], page_size, hq, hkv, d, int(max_seqlens_q),
        float(scale), kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_prefill_bf16")
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
    kv: torch.Tensor,  # [num_blocks, 2*block_size, Hkv*D] bf16 or int8
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
        q.data_ptr(), kv.data_ptr(), int(kv.dtype == torch.int8),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
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
    """Paged-cache varlen prefill. Returns bf16 [total_q, Hq, Dv].

    bf16 caches in NHD or HND, or an NHD_FUSED slab (bf16, or int8 codes
    with per-tensor ``kscale``/``vscale``).

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
    fused = cache_layout == "NHD_FUSED"
    if qscale is not None or (not fused and (kcache.dtype != torch.bfloat16 or kscale is not None)):
        raise NotImplementedError("fp8 prefill arrives with ROADMAP queue 1 item 2 (quantized KV)")
    if QuantType(quant_type) not in (
        QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
        QuantType.QPERTENSOR_KPERTENSOR_VPERTENSOR,
    ):
        raise NotImplementedError("per-token K scales arrive with ROADMAP queue 1 item 5")
    d = q.shape[-1]
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    if fused:
        # as in the JAX package, a bf16 slab ignores the scales
        if kcache.dtype == torch.bfloat16:
            kscale = vscale = None
        if impl == "ref":
            return _prefill_nhd_fused_ref(
                q, kcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, scale,
                kscale, vscale,
            )
        return paged_prefill_nhd_fused(
            q.to(torch.bfloat16).contiguous(), kcache, cu_seqlens_q, block_ids, seqlens_kvcache,
            max_seqlens_q, scale, kscale, vscale,
        )
    if impl == "ref":
        return _prefill_ref(
            q, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q,
            scale, cache_layout,
        )
    return paged_prefill_attention(
        q.to(torch.bfloat16).contiguous(), kcache, vcache, cu_seqlens_q, block_ids,
        seqlens_kvcache, max_seqlens_q, scale, cache_layout,
    )


def attention_with_kvcache_prefill_bf16(
    q, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, **kw
):
    """BF16 paged prefill. See :func:`attention_with_kvcache_prefill`."""
    return attention_with_kvcache_prefill(
        q, kcache, vcache, cu_seqlens_q, block_ids, seqlens_kvcache, max_seqlens_q, **kw
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
    "paged_prefill_attention",
    "paged_prefill_nhd_fused",
]
