"""Paged GQA decode attention, bf16 (port of ``ops/attention/decode.py``).

``attention_decode`` keeps the JAX package's arguments: q ``[B*Sq, Hq, D]``
with Sq = mtp + 1, caches NHD ``[num_blocks, block_size, Hkv, D]`` (default)
or HND ``[Hkv, num_blocks, block_size, D]``. The kernel
(``csrc/decode.cu``) takes the cache strides, so both layouts are read in
place with no transpose and no padding of the query rows.

Ported here: the bf16 cache, HND and NHD, mtp 0..4, ``new_kv_included``,
``sm_scale`` and ``impl="ref"``. The fp8 scales, the FUSED layouts and the
task-map mode are later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.ops.attention.paging import hnd_to_nhd
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
        if cache.data_ptr() % 16 or cache.shape[-1] % 8 or any(s % 8 for s in strides):
            raise ValueError(f"{name}: cache rows must be 16-byte aligned")


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
    """Paged GQA decode attention over a bf16 cache. Returns [B*Sq, Hq, Dv] bf16.

    ``splitk``, ``pages_per_compute_block`` and ``task_tile`` are TPU tuning
    knobs, accepted for call compatibility and unused.
    """
    del splitk, pages_per_compute_block, task_tile
    if task_map is not None:
        raise NotImplementedError("task-map decode arrives with ROADMAP queue 1 item 5")
    if cache_layout not in ("NHD", "HND"):
        raise NotImplementedError(
            f"cache_layout={cache_layout!r} arrives with ROADMAP queue 1 item 2 (quantized KV)"
        )
    if kcache.dtype != torch.bfloat16 or qscale is not None or kscale is not None:
        raise NotImplementedError("fp8 decode arrives with ROADMAP queue 1 item 2 (quantized KV)")
    del vscale, quant_type
    sq = mtp + 1
    d = q.shape[2]
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    kv_lens = num_seq_kvcache.to(torch.int32)
    if not new_kv_included:
        kv_lens = kv_lens + sq
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


__all__ = ["attention_decode", "attention_decode_bf16", "paged_decode_attention"]
