"""Paged GQA decode attention (port of ``ops/attention/decode.py``).

``attention_decode`` keeps the JAX package's arguments: q ``[B*Sq, Hq, D]``
with Sq = mtp + 1, caches NHD ``[num_blocks, block_size, Hkv, D]`` (default)
or HND ``[Hkv, num_blocks, block_size, D]``, or one slot-leading K|V slab
NHD_FUSED ``[num_blocks, 2*block_size, Hkv*D]`` (``vcache`` unused). The
kernels (``csrc/decode.cu``) take the cache strides, so every layout is read
in place with no transpose and no padding of the query rows.

Caches are bf16, int8 codes or e4m3 (``torch.float8_e4m3fn``). With
per-tensor ``kscale``/``vscale`` the logits are scaled by ``sm_scale *
kscale`` and the output by ``vscale``; a per-token-per-head ``qscale``
``[B*Sq, Hq]`` is folded into q, rounded to bf16, before the kernel, as the
JAX wrapper does. QuantTypes 0 and 3 carry one K scale per (token, kv head),
paged like the cache (``[num_blocks, block_size, Hkv, 1]``) or in the tail
rows of the K pages (:func:`unpack_tailrow_kscale`), and a per-head
``vscale``: their own kernel (:func:`paged_decode_qt0`); scales grouped
along D take the plain reference, as in the JAX package. Also mtp 0..4,
``new_kv_included``, ``sm_scale`` and ``impl="ref"``. The head-major FUSED
layout and the task-map mode are later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import FP8_DTYPE, QuantType
from hpc_ops_tpu_torch.ops.attention.paging import hnd_to_nhd, nhd_fused_views
from hpc_ops_tpu_torch.ops.attention.reference import attention_decode_ref

# the launchers' kv_type argument
_KV_TYPES = {torch.bfloat16: 0, torch.int8: 1, FP8_DTYPE: 2}
_PERTOKEN_K = (
    QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD,
    QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD_QKHADAMARD,
)


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


def _kv_type(name, *caches):
    """The launchers' code of the caches' one element type."""
    if any(c.dtype != caches[0].dtype for c in caches) or caches[0].dtype not in _KV_TYPES:
        raise ValueError(f"{name}: caches must share one of bf16, int8 and float8_e4m3fn")
    return _KV_TYPES[caches[0].dtype]


def _check_slab(name, kv, num_kv_heads, d):
    """An NHD_FUSED slab the kernels read: contiguous, 16-byte rows."""
    if kv.dim() != 3 or kv.shape[1] % 2 or kv.shape[2] != num_kv_heads * d:
        raise ValueError(f"{name}: the slab must be [nb, 2*bs, {num_kv_heads * d}]")
    if not kv.is_contiguous():
        raise ValueError(f"{name}: the slab must be contiguous")
    _check_rows_aligned(name, (kv, (d,)))


def _scale_tensor(scale, device, numel=1):
    """A scale as a [numel] float32 tensor on ``device`` (None stays None)."""
    if scale is None:
        return None
    return torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(numel).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _split_cache_geometry(name, q, kcache, vcache, block_ids, kv_lens, sq, cache_layout):
    """Checks shared by the wrappers over split K and V caches. Returns
    ``(hkv, page_size, dv, k_strides, v_strides, block_ids, kv_lens)``, the
    tables as contiguous int32."""
    for t in (kcache, vcache, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    b = kv_lens.shape[0]
    bsq, hq, d = q.shape
    if q.dtype != torch.bfloat16 or bsq != b * sq or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16 [{b * sq}, Hq, D]")
    hkv = kcache.shape[0] if cache_layout == "HND" else kcache.shape[2]
    page_size = kcache.shape[2] if cache_layout == "HND" else kcache.shape[1]
    if hq % hkv or kcache.shape[3] != d:
        raise ValueError(f"{name}: unsupported head geometry")
    k_st = _page_strides(kcache, cache_layout)
    v_st = _page_strides(vcache, cache_layout)
    _check_rows_aligned(name, (kcache, k_st), (vcache, v_st))
    return (hkv, page_size, vcache.shape[3], k_st, v_st,
            block_ids.to(torch.int32).contiguous(), kv_lens.to(torch.int32).contiguous())


def _decode_ref(q, kcache, vcache, block_ids, kv_lens, sq, scale, cache_layout, kscale=None,
                vscale=None):
    """Plain PyTorch version of :func:`paged_decode_attention` (float32)."""
    return attention_decode_ref(
        q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), block_ids,
        kv_lens, mtp=sq - 1, new_kv_included=True, kscale=kscale, vscale=vscale, sm_scale=scale,
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
    kscale=None,  # [1] f32 per-tensor K scale (None: 1)
    vscale=None,  # [1] f32 per-tensor V scale (None: 1)
) -> torch.Tensor:
    """Decode attention over paged K and V caches (HND or NHD; bf16, int8 or
    e4m3); returns [B*sq, Hq, Dv] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type == "cpu":
        return _decode_ref(q, kcache, vcache, block_ids, kv_lens, sq, scale, cache_layout,
                           kscale, vscale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    name = "paged_decode_attention"
    kv_type = _kv_type(name, kcache, vcache)
    hkv, page_size, dv, k_st, v_st, tbl, lens = _split_cache_geometry(
        name, q, kcache, vcache, block_ids, kv_lens, sq, cache_layout)
    ks, vs = _scale_tensor(kscale, q.device), _scale_tensor(vscale, q.device)
    bsq, hq, d = q.shape
    out = torch.empty((bsq, hq, dv), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_decode(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), kv_type, *k_st, *v_st,
        _ptr(ks), _ptr(vs), tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        lens.shape[0], tbl.shape[1], page_size, sq, hq, hkv, d, dv, float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _decode_qt0_ref(q, kcache, vcache, ktok, vhead, block_ids, kv_lens, sq, scale, cache_layout):
    """Plain PyTorch version of :func:`paged_decode_qt0` (float32): K
    dequantised token by token, then the reference."""
    return attention_decode_ref(
        q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), block_ids, kv_lens,
        mtp=sq - 1, new_kv_included=True, kscale=ktok, vscale=vhead,
        quant_type=QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD, sm_scale=scale,
    )


def paged_decode_qt0(
    q: torch.Tensor,  # [B*sq, Hq, D] bf16
    kcache: torch.Tensor,  # e4m3, HND or NHD
    vcache: torch.Tensor,
    ktok: torch.Tensor,  # [num_blocks, block_size, Hkv, 1] f32: one K scale per token and kv head
    vhead,  # [Hkv] f32 per-head V scale (None: 1)
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B] effective KV length (new tokens included)
    sq: int,
    scale: float,
    cache_layout: str,
) -> torch.Tensor:
    """QuantType-0 decode attention: each KV token's scale multiplies its
    logit after the q.k product, the per-head V scale the output; the scales
    are read paged, through the page table. Returns [B*sq, Hq, Dv] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if q.device.type == "cpu":
        return _decode_qt0_ref(q, kcache, vcache, ktok, vhead, block_ids, kv_lens, sq, scale,
                               cache_layout)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_qt0: unsupported device {q.device}")
    name = "paged_decode_qt0"
    if kcache.dtype != FP8_DTYPE or vcache.dtype != FP8_DTYPE:
        raise ValueError(f"{name}: caches must be float8_e4m3fn")
    hkv, page_size, dv, k_st, v_st, tbl, lens = _split_cache_geometry(
        name, q, kcache, vcache, block_ids, kv_lens, sq, cache_layout)
    nb = kcache.shape[1] if cache_layout == "HND" else kcache.shape[0]
    if ktok.device != q.device or tuple(ktok.shape) != (nb, page_size, hkv, 1):
        raise ValueError(f"{name}: K scales must be [{nb}, {page_size}, {hkv}, 1] on q's device")
    ktok = ktok.float().contiguous()
    vs = _scale_tensor(vhead, q.device, hkv)
    bsq, hq, d = q.shape
    out = torch.empty((bsq, hq, dv), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_decode_qt0(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), *k_st, *v_st,
        ktok.data_ptr(), _ptr(vs), tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        lens.shape[0], tbl.shape[1], page_size, sq, hq, hkv, d, dv, float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode_qt0")
    paged_decode_qt0.launches += 1
    return out


paged_decode_qt0.launches = 0


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
    kv: torch.Tensor,  # [num_blocks, 2*block_size, Hkv*D] bf16, int8 or e4m3
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
    kv_type = _kv_type("paged_decode_nhd_fused", kv)
    _check_slab("paged_decode_nhd_fused", kv, hkv, d)
    ks, vs = _scale_tensor(kscale, q.device), _scale_tensor(vscale, q.device)
    for t in (kv, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError("paged_decode_nhd_fused: all tensors must be on one device")
    tbl = block_ids.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((bsq, hq, d), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_decode_nhd_fused(
        q.data_ptr(), kv.data_ptr(), kv_type, _ptr(ks), _ptr(vs),
        tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, tbl.shape[1], kv.shape[1] // 2, sq, hq, hkv, d, float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode_nhd_fused")
    paged_decode_nhd_fused.launches += 1
    return out


paged_decode_nhd_fused.launches = 0


def unpack_tailrow_kscale(kcache_with_tail: torch.Tensor):
    """Split a tail-row-scale page array into (data, scales).

    In this serving layout each NHD page carries ``block_size +
    block_size*4/D`` rows; the tail rows are the page's per-(token, head)
    float32 K scales stored as raw bytes (f32 [nb, H, bs] -> bytes ->
    [nb, scale_rows, H, D] rows appended to the page). The page array is
    float8_e4m3fn, or int8/uint8 as a view of its bytes.

    Returns (kcache [nb, bs, H, D] e4m3, a view of the pages; kscale
    [nb, bs, H, 1] f32, a copy).
    """
    nb, rows, h, d = kcache_with_tail.shape
    bs = rows * d // (d + 4)
    if bs + bs * 4 // d != rows:
        raise ValueError(f"rows={rows} is not block_size + block_size*4/{d}")
    bits = kcache_with_tail.view(torch.uint8)
    # [nb, sr, H, D] -> [nb, H, sr, D] -> [nb, H, bs, 4] bytes -> f32 [nb, H, bs, 1]
    tail = bits[:, bs:].permute(0, 2, 1, 3).reshape(nb, h, bs, 4)
    return bits[:, :bs].view(FP8_DTYPE), tail.view(torch.float32).permute(0, 2, 1, 3)


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
    """Paged GQA decode attention over a bf16, int8 or e4m3 cache. Returns
    [B*Sq, Hq, Dv] bf16.

    ``q`` is bf16, or quantised with ``qscale`` [B*Sq, Hq]. A bf16 cache
    ignores ``kscale``/``vscale``, as in the JAX package. The kernels apply
    the V scale in float32 before the one rounding to bf16 (the JAX wrapper
    scales a bf16 output). ``splitk``, ``pages_per_compute_block`` and
    ``task_tile`` are TPU tuning knobs, accepted for call compatibility and
    unused.
    """
    del splitk, pages_per_compute_block, task_tile
    if task_map is not None:
        raise NotImplementedError("task-map decode arrives with ROADMAP queue 1 item 5")
    if cache_layout not in ("NHD", "HND", "NHD_FUSED"):
        raise NotImplementedError(
            f"cache_layout={cache_layout!r} arrives with ROADMAP queue 1 item 5 (FUSED decode)"
        )
    sq = mtp + 1
    b = num_seq_kvcache.shape[0]
    hq, d = q.shape[1], q.shape[2]
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    kv_lens = num_seq_kvcache.to(torch.int32)
    if not new_kv_included:
        kv_lens = kv_lens + sq
    quantised = kcache.dtype != torch.bfloat16
    pertoken_k = quantised and QuantType(quant_type) in _PERTOKEN_K
    if not quantised:
        kscale = vscale = None
    if pertoken_k:
        if kscale is None:
            raise ValueError("per-token K scales (QuantType 0, 3) need kscale")
        if kscale.dim() == 4 and kscale.dtype == kcache.dtype:
            # serving layout: the scales live in the tail rows of the K pages
            # themselves (kscale is the tail view or the whole page array)
            if cache_layout != "NHD":
                raise ValueError("tail-row scales are an NHD contract")
            kcache, kscale = unpack_tailrow_kscale(kcache)
            vcache = vcache.view(FP8_DTYPE)[:, : kcache.shape[1]]
        elif cache_layout == "NHD_FUSED":
            kcache, vcache = nhd_fused_views(kcache, kcache.shape[2] // d)
            cache_layout = "NHD"
    if impl == "ref" or (pertoken_k and kscale.shape[-1] != 1):
        # QuantType 0 has a kernel for one scale per (token, kv head) only;
        # scales grouped along D take the reference, as in the JAX package
        if cache_layout == "NHD_FUSED":
            kcache, vcache = nhd_fused_views(kcache, kcache.shape[2] // d)
            cache_layout = "NHD"
        return attention_decode_ref(
            q, _nhd(kcache, cache_layout), _nhd(vcache, cache_layout), block_ids, kv_lens,
            mtp=mtp, new_kv_included=True, qscale=qscale, kscale=kscale, vscale=vscale,
            quant_type=quant_type, sm_scale=scale,
        )
    if qscale is not None:
        qb = (q.float() * qscale.reshape(b * sq, hq)[..., None].float()).to(torch.bfloat16)
    else:
        qb = q.to(torch.bfloat16).contiguous()
    if pertoken_k:
        return paged_decode_qt0(qb, kcache, vcache, kscale, vscale, block_ids, kv_lens, sq,
                                scale, cache_layout)
    if cache_layout == "NHD_FUSED":
        return paged_decode_nhd_fused(qb, kcache, block_ids, kv_lens, sq, scale, kscale, vscale)
    return paged_decode_attention(qb, kcache, vcache, block_ids, kv_lens, sq, scale,
                                  cache_layout, kscale, vscale)


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


def attention_decode_fp8(
    q,
    kcache,
    vcache,
    block_ids,
    num_seq_kvcache,
    qscale,
    kscale,
    vscale,
    mtp: int = 0,
    new_kv_included: bool = False,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
    splitk: bool = True,
    task_map=None,
    **kw,
):
    """FP8 decode. See :func:`attention_decode`."""
    return attention_decode(
        q, kcache, vcache, block_ids, num_seq_kvcache, mtp, new_kv_included,
        qscale=qscale, kscale=kscale, vscale=vscale, quant_type=quant_type,
        splitk=splitk, task_map=task_map, **kw,
    )


__all__ = [
    "attention_decode",
    "attention_decode_bf16",
    "attention_decode_fp8",
    "paged_decode_attention",
    "paged_decode_nhd_fused",
    "paged_decode_qt0",
    "unpack_tailrow_kscale",
]
