"""Paged GQA decode attention (port of ``ops/attention/decode.py``).

``attention_decode`` keeps the JAX package's arguments: q ``[B*Sq, Hq, D]``
with Sq = mtp + 1, caches NHD ``[num_blocks, block_size, Hkv, D]`` (default)
or HND ``[Hkv, num_blocks, block_size, D]``, or one slot-leading K|V slab
NHD_FUSED ``[num_blocks, 2*block_size, Hkv*D]`` (``vcache`` unused). The
kernels (``csrc/decode.cu``) take the cache strides, so every layout is read
in place with no transpose and no padding of the query rows.

Ported here: bf16 HND and NHD caches, and bf16 or int8 NHD_FUSED slabs with
per-tensor ``kscale``/``vscale`` (logits scaled by ``sm_scale * kscale``, the
output by ``vscale``); mtp 0..4, ``new_kv_included``, ``sm_scale`` and
``impl="ref"``. fp8 caches, the head-major FUSED layout, per-token scales
and the task-map mode are later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.ops.attention.paging import hnd_to_nhd, nhd_fused_views
from hpc_ops_tpu_torch.ops.attention.reference import attention_decode_ref


def _nhd(cache, cache_layout):
    return hnd_to_nhd(cache) if cache_layout == "HND" else cache


def _page_strides(cache, cache_layout):
    """Element strides (head, page, slot) of a 4-D cache; the last dim must be dense."""
    if cache.stride(3) != 1:
        raise ValueError("paged cache: the head_dim axis must have stride 1")
    if cache_layout == "HND":
        return cache.stride(0), cache.stride(1), cache.stride(2)
    return cache.stride(2), cache.stride(0), cache.stride(1)


def _check_rows_aligned(name, *caches_and_strides):
    """The kernels move K/V rows as 16-byte vectors."""
    for cache, strides in caches_and_strides:
        per16 = 16 // cache.element_size()  # elements per 16 bytes
        if cache.data_ptr() % 16 or cache.shape[-1] % per16 or any(s % per16 for s in strides):
            raise ValueError(f"{name}: cache rows must be 16-byte aligned")


def _check_slab(name, kv, num_kv_heads, d):
    """An NHD_FUSED slab the kernels read: contiguous, bf16 or int8, 16-byte rows."""
    if kv.dtype not in (torch.bfloat16, torch.int8):
        raise NotImplementedError(
            f"{name}: {kv.dtype} slabs (fp8) arrive with ROADMAP queue 1 item 2 (quantized KV)"
        )
    if kv.dim() != 3 or kv.shape[1] % 2 or kv.shape[2] != num_kv_heads * d:
        raise ValueError(f"{name}: the slab must be [nb, 2*bs, {num_kv_heads * d}]")
    if not kv.is_contiguous():
        raise ValueError(f"{name}: the slab must be contiguous")
    _check_rows_aligned(name, (kv, (d,)))


def _scale_tensor(scale, device):
    """A per-tensor scale as a [1] float32 tensor on ``device`` (None stays None)."""
    if scale is None:
        return None
    return torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(1).contiguous()


def _decode_ref(q, kcache, vcache, block_ids, kv_lens, sq, scale, cache_layout):
    """Plain PyTorch version of :func:`paged_decode_attention` (float32)."""
    return attention_decode_ref(
        q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), block_ids,
        kv_lens, mtp=sq - 1, new_kv_included=True, sm_scale=scale,
    )


def paged_decode_attention(
    q: torch.Tensor,  # [B*sq, Hq, D] bf16
    kcache: torch.Tensor,
    vcache: torch.Tensor,
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B] effective KV length (new tokens included)
    sq: int,
    scale: float,
    cache_layout: str,
) -> torch.Tensor:
    """Decode attention over a paged bf16 cache; returns [B*sq, Hq, Dv] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type == "cpu":
        return _decode_ref(q, kcache, vcache, block_ids, kv_lens, sq, scale, cache_layout)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    if not (q.dtype == kcache.dtype == vcache.dtype == torch.bfloat16):
        raise NotImplementedError("paged_decode_attention: the CUDA kernel reads bf16 only")
    for t in (kcache, vcache, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError("paged_decode_attention: all tensors must be on one device")
    b = kv_lens.shape[0]
    bsq, hq, d = q.shape
    if bsq != b * sq or not q.is_contiguous():
        raise ValueError(f"paged_decode_attention: q must be contiguous [{b * sq}, Hq, D]")
    hkv = kcache.shape[0] if cache_layout == "HND" else kcache.shape[2]
    page_size = kcache.shape[2] if cache_layout == "HND" else kcache.shape[1]
    dv = vcache.shape[3]
    if hq % hkv or kcache.shape[3] != d or d % 8:
        raise ValueError("paged_decode_attention: unsupported head geometry")
    k_st = _page_strides(kcache, cache_layout)
    v_st = _page_strides(vcache, cache_layout)
    _check_rows_aligned("paged_decode_attention", (kcache, k_st), (vcache, v_st))
    tbl = block_ids.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((bsq, hq, dv), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_decode_bf16(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), *k_st, *v_st,
        tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, tbl.shape[1], page_size, sq, hq, hkv, d, dv, float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode_bf16")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _decode_nhd_fused_ref(q, kv, block_ids, kv_lens, sq, scale, kscale, vscale):
    """Plain PyTorch version of :func:`paged_decode_nhd_fused` (float32): the
    reference over NHD views of the slab, dequantised by ``_dequant_kv``."""
    k, v = nhd_fused_views(kv, kv.shape[2] // q.shape[2])
    return attention_decode_ref(
        q, k, v, block_ids, kv_lens, mtp=sq - 1, new_kv_included=True, kscale=kscale,
        vscale=vscale, sm_scale=scale,
    )


def paged_decode_nhd_fused(
    q: torch.Tensor,  # [B*sq, Hq, D] bf16
    kv: torch.Tensor,  # [num_blocks, 2*block_size, Hkv*D] bf16 or int8
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B] effective KV length (new tokens included)
    sq: int,
    scale: float,
    kscale=None,  # [1] f32 per-tensor K scale (None: 1)
    vscale=None,  # [1] f32 per-tensor V scale (None: 1)
) -> torch.Tensor:
    """Decode attention over an NHD_FUSED slab; returns [B*sq, Hq, D] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type == "cpu":
        return _decode_nhd_fused_ref(q, kv, block_ids, kv_lens, sq, scale, kscale, vscale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_nhd_fused: unsupported device {q.device}")
    b = kv_lens.shape[0]
    bsq, hq, d = q.shape
    if q.dtype != torch.bfloat16 or bsq != b * sq or not q.is_contiguous():
        raise ValueError(f"paged_decode_nhd_fused: q must be contiguous bf16 [{b * sq}, Hq, D]")
    hkv = kv.shape[2] // d
    if hkv == 0 or hq % hkv:
        raise ValueError("paged_decode_nhd_fused: unsupported head geometry")
    _check_slab("paged_decode_nhd_fused", kv, hkv, d)
    ks, vs = _scale_tensor(kscale, q.device), _scale_tensor(vscale, q.device)
    for t in (kv, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError("paged_decode_nhd_fused: all tensors must be on one device")
    tbl = block_ids.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((bsq, hq, d), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_decode_nhd_fused(
        q.data_ptr(), kv.data_ptr(), int(kv.dtype == torch.int8),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, tbl.shape[1], kv.shape[1] // 2, sq, hq, hkv, d, float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode_nhd_fused")
    paged_decode_nhd_fused.launches += 1
    return out


paged_decode_nhd_fused.launches = 0


def attention_decode(
    q,
    kcache,
    vcache,
    block_ids,
    num_seq_kvcache,
    mtp: int = 0,
    new_kv_included: bool = False,
    qscale=None,
    kscale=None,
    vscale=None,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
    splitk: bool = True,
    task_map=None,
    *,
    sm_scale: float | None = None,
    pages_per_compute_block: int | None = None,
    task_tile: int = 512,
    cache_layout: str = "NHD",
    impl: str = "auto",
):
    """Paged GQA decode attention. Returns [B*Sq, Hq, Dv] bf16.

    bf16 caches in NHD or HND, or an NHD_FUSED slab (bf16, or int8 codes
    with per-tensor ``kscale``/``vscale``). ``splitk``,
    ``pages_per_compute_block`` and ``task_tile`` are TPU tuning knobs,
    accepted for call compatibility and unused.
    """
    del splitk, pages_per_compute_block, task_tile
    if task_map is not None:
        raise NotImplementedError("task-map decode arrives with ROADMAP queue 1 item 5")
    if cache_layout not in ("NHD", "HND", "NHD_FUSED"):
        raise NotImplementedError(
            f"cache_layout={cache_layout!r} arrives with ROADMAP queue 1 item 5 (FUSED decode)"
        )
    if QuantType(quant_type) not in (
        QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
        QuantType.QPERTENSOR_KPERTENSOR_VPERTENSOR,
    ):
        raise NotImplementedError("per-token K scales arrive with ROADMAP queue 1 item 5")
    fused = cache_layout == "NHD_FUSED"
    if qscale is not None or (not fused and (kcache.dtype != torch.bfloat16 or kscale is not None)):
        raise NotImplementedError("fp8 decode arrives with ROADMAP queue 1 item 2 (quantized KV)")
    sq = mtp + 1
    d = q.shape[2]
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    kv_lens = num_seq_kvcache.to(torch.int32)
    if not new_kv_included:
        kv_lens = kv_lens + sq
    if fused:
        # as in the JAX package, a bf16 slab ignores the scales
        if kcache.dtype == torch.bfloat16:
            kscale = vscale = None
        if impl == "ref":
            return _decode_nhd_fused_ref(q, kcache, block_ids, kv_lens, sq, scale, kscale, vscale)
        return paged_decode_nhd_fused(
            q.to(torch.bfloat16).contiguous(), kcache, block_ids, kv_lens, sq, scale, kscale,
            vscale,
        )
    if impl == "ref":
        return _decode_ref(q, kcache, vcache, block_ids, kv_lens, sq, scale, cache_layout)
    return paged_decode_attention(
        q.to(torch.bfloat16).contiguous(), kcache, vcache, block_ids, kv_lens, sq,
        scale, cache_layout,
    )


def attention_decode_bf16(
    q,
    kcache,
    vcache,
    block_ids,
    num_seq_kvcache,
    mtp: int = 0,
    new_kv_included: bool = False,
    splitk: bool = True,
    task_map=None,
    **kw,
):
    """BF16 decode. See :func:`attention_decode`."""
    return attention_decode(
        q, kcache, vcache, block_ids, num_seq_kvcache, mtp, new_kv_included,
        splitk=splitk, task_map=task_map, **kw,
    )


__all__ = [
    "attention_decode",
    "attention_decode_bf16",
    "paged_decode_attention",
    "paged_decode_nhd_fused",
]
