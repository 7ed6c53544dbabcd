"""Paged GQA decode attention (port of ``ops/attention/decode.py``).

``attention_decode`` keeps the JAX package's arguments: q ``[B*Sq, Hq, D]``
with Sq = mtp + 1, caches NHD ``[num_blocks, block_size, Hkv, D]`` (default)
or HND ``[Hkv, num_blocks, block_size, D]``, or one K|V slab, head-major
FUSED ``[Hkv, num_blocks, 2*block_size, D]`` or slot-leading NHD_FUSED
``[num_blocks, 2*block_size, Hkv*D]`` (``vcache`` unused). The kernels
(``csrc/decode.cu``) take the cache strides, so every layout is read in
place with no transpose and no padding of the query rows.

Caches are bf16, int8 codes or e4m3 (``torch.float8_e4m3fn``). With
per-tensor ``kscale``/``vscale`` the logits are scaled by ``sm_scale *
kscale`` and the output by ``vscale``; a per-token-per-head ``qscale``
``[B*Sq, Hq]`` is folded into q, rounded to bf16, before the kernel, as the
JAX wrapper does. QuantTypes 0 and 3 carry one K scale per (token, kv head),
paged like the cache (``[num_blocks, block_size, Hkv, 1]``) or in the tail
rows of the K pages (:func:`unpack_tailrow_kscale`), or G scales per
(token, kv head) grouped along D (``[num_blocks, block_size, Hkv, G]``, each
over D/G consecutive columns), and a per-head ``vscale``: their own kernel
(:func:`paged_decode_qt0`; the JAX package sends grouped scales to its
reference, the port's kernel takes them). Also mtp 0..4,
``new_kv_included``, ``sm_scale`` and ``impl="ref"``.

``task_map`` (a :class:`~hpc_ops_tpu_torch.ops.attention.scheduler.TaskMap`)
selects the split-KV mode: one block per task over a contiguous KV range of
one (request, kv head) writes float32 partials (:func:`paged_decode_tasks`),
then one block per (request, kv head) merges them
(:func:`decode_combine`): two launches and no read back to the host. Every
layout is read in place in this mode too.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import FP8_DTYPE, QuantType
from hpc_ops_tpu_torch.ops.attention.paging import (
    hnd_to_nhd,
    nhd_fused_views,
    nhd_to_hnd,
    unpack_kv_fused,
    unpack_kv_fused_nhd,
)
from hpc_ops_tpu_torch.ops.attention.reference import attention_decode_ref

# the launchers' kv_type argument
_KV_TYPES = {torch.bfloat16: 0, torch.int8: 1, FP8_DTYPE: 2}
_PERTOKEN_K = (
    QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD,
    QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD_QKHADAMARD,
)


def _nhd(cache, cache_layout):
    return hnd_to_nhd(cache) if cache_layout == "HND" else cache


def _hnd_views(kcache, vcache, cache_layout, d):
    """K and V of any layout as [Hkv, nb, bs, D] strided views (no copy)."""
    if cache_layout == "HND":
        return kcache, vcache
    if cache_layout == "NHD":
        return nhd_to_hnd(kcache), nhd_to_hnd(vcache)
    if cache_layout == "FUSED":
        return unpack_kv_fused(kcache)
    if cache_layout == "NHD_FUSED":
        return unpack_kv_fused_nhd(kcache, kcache.shape[2] // d)
    raise ValueError(f"attention_decode: unknown cache_layout {cache_layout!r}")


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


def _slab_args(name, q, kv, block_ids, kv_lens, sq, hkv):
    """Checks shared by the wrappers over one K|V slab. Returns ``(kv_type,
    block_ids, kv_lens)``, the tables as contiguous int32."""
    for t in (kv, block_ids, kv_lens):
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    b = kv_lens.shape[0]
    bsq, hq, _ = q.shape
    if q.dtype != torch.bfloat16 or bsq != b * sq or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous bf16 [{b * sq}, Hq, D]")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: unsupported head geometry")
    return (_kv_type(name, kv), block_ids.to(torch.int32).contiguous(),
            kv_lens.to(torch.int32).contiguous())


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
    kernels.count(paged_decode_attention)
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
    ktok: torch.Tensor,  # [num_blocks, block_size, Hkv, G] f32: K scales per token, kv head and D-group
    vhead,  # [Hkv] f32 per-head V scale (None: 1)
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B] effective KV length (new tokens included)
    sq: int,
    scale: float,
    cache_layout: str,
) -> torch.Tensor:
    """QuantType-0 decode attention: each KV token's G scales multiply the
    partial q.k products of their D/G columns (G = 1: the token's scale
    multiplies its logit), the per-head V scale the output; the scales are
    read paged, through the page table. G divides D into groups of a multiple
    of 16 columns. Returns [B*sq, Hq, Dv] bf16.

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
    bsq, hq, d = q.shape
    groups = ktok.shape[-1]
    if (ktok.device != q.device or tuple(ktok.shape[:3]) != (nb, page_size, hkv) or ktok.dim() != 4
            or d % groups or (d // groups) % 16):
        raise ValueError(f"{name}: K scales must be [{nb}, {page_size}, {hkv}, G] on q's device, "
                         "G groups of a multiple of 16 columns")
    ktok = ktok.float().contiguous()
    vs = _scale_tensor(vhead, q.device, hkv)
    out = torch.empty((bsq, hq, dv), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_decode_qt0(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), *k_st, *v_st,
        ktok.data_ptr(), _ptr(vs), tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        lens.shape[0], tbl.shape[1], page_size, sq, hq, hkv, d, dv, groups, float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode_qt0")
    kernels.count(paged_decode_qt0)
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
    bsq, hq, d = q.shape
    hkv = kv.shape[2] // d
    kv_type, tbl, lens = _slab_args("paged_decode_nhd_fused", q, kv, block_ids, kv_lens, sq, hkv)
    _check_slab("paged_decode_nhd_fused", kv, hkv, d)
    ks, vs = _scale_tensor(kscale, q.device), _scale_tensor(vscale, q.device)
    out = torch.empty((bsq, hq, d), dtype=torch.bfloat16, device=q.device)
    rc = kernels.lib().hpc_paged_decode_nhd_fused(
        q.data_ptr(), kv.data_ptr(), kv_type, _ptr(ks), _ptr(vs),
        tbl.data_ptr(), lens.data_ptr(), out.data_ptr(),
        lens.shape[0], tbl.shape[1], kv.shape[1] // 2, sq, hq, hkv, d, float(scale),
        kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode_nhd_fused")
    kernels.count(paged_decode_nhd_fused)
    return out


paged_decode_nhd_fused.launches = 0


def _decode_tasks_ref(q, kcache, vcache, block_ids, kv_lens, task_map, sq, scale, kscale=None):
    """Plain PyTorch version of :func:`paged_decode_tasks` (float32): each
    task's positions gathered through the page table, masked, and reduced to
    the partials (o, m, l) relative to the task's own row maxima."""
    hkv, _, bs, d = kcache.shape
    dv = vcache.shape[3]
    bsq, hq, _ = q.shape
    b, g = kv_lens.shape[0], hq // hkv
    rows = g * sq
    dev = q.device
    real = task_map.batch >= 0
    bt = task_map.batch.long().clamp(min=0)
    ht = task_map.head.long()
    lo = task_map.tile_start.long() * task_map.tile
    kv_t = kv_lens.long()[bt]
    hi = torch.minimum(lo + task_map.num_tiles.long() * task_map.tile,
                       kv_t.clamp(max=block_ids.shape[1] * bs))
    hi = torch.where(real, torch.maximum(hi, lo), lo)
    span = int((hi - lo).max()) if task_map.capacity else 0
    pos = lo[:, None] + torch.arange(span, device=dev)[None]  # [T, span]
    inside = pos < hi[:, None]
    blk = (pos // bs).clamp(max=block_ids.shape[1] - 1)
    page = block_ids.long()[bt[:, None], blk].clamp(min=0)
    slot = pos % bs
    k = kcache[ht[:, None], page, slot].float()  # [T, span, D]
    v = vcache[ht[:, None], page, slot].float().masked_fill(~inside[..., None], 0.0)
    ks = 1.0 if kscale is None else torch.as_tensor(kscale, dtype=torch.float32, device=dev).reshape(())
    # query rows of (b, h): row r = g * sq + s
    q4 = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(b, hkv, rows, d)
    s = torch.einsum("trd,tjd->trj", q4[bt, ht], k) * (scale * ks)
    limit = kv_t[:, None] - sq + torch.arange(rows, device=dev)[None] % sq  # [T, rows]
    seen = inside[:, None, :] & (pos[:, None, :] <= limit[:, :, None])
    s = s.masked_fill(~seen, float("-inf"))
    m = s.amax(-1) if span else torch.full((task_map.capacity, rows), float("-inf"), device=dev)
    p = torch.where(seen, torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None]), 0.0)
    o = torch.einsum("trj,tjd->trd", p, v)
    return o.reshape(-1, rows, dv), m, p.sum(-1)


def paged_decode_tasks(
    q: torch.Tensor,  # [B*sq, Hq, D] bf16
    kcache: torch.Tensor,  # [Hkv, nb, bs, D] view of any layout: bf16, int8 or e4m3
    vcache: torch.Tensor,  # [Hkv, nb, bs, Dv] view, same type
    block_ids: torch.Tensor,  # [B, max_blocks], -1 padded
    kv_lens: torch.Tensor,  # [B] effective KV length (new tokens included)
    task_map,  # TaskMap; its tile a multiple of bs
    sq: int,
    scale: float,
    kscale=None,  # [1] f32 per-tensor K scale (None: 1)
):
    """The task-map decode's first stage: for each task of the map, the
    unnormalised float32 partials ``o [cap, G*sq, Dv]``, ``m`` and ``l``
    ``[cap, G*sq]`` of its KV range (a row that saw no key, and every
    sentinel task, has m = -inf, l = 0, o = 0). The caches are head-major
    strided views, so HND, NHD and both fused slabs are read in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    page_size = kcache.shape[2]
    if task_map.tile % page_size:
        raise ValueError(f"paged_decode_tasks: task tile {task_map.tile} is not a multiple of "
                         f"the page size {page_size}")
    if q.device.type == "cpu":
        return _decode_tasks_ref(q, kcache, vcache, block_ids, kv_lens, task_map, sq, scale, kscale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_tasks: unsupported device {q.device}")
    name = "paged_decode_tasks"
    kv_type = _kv_type(name, kcache, vcache)
    hkv, page_size, dv, k_st, v_st, tbl, lens = _split_cache_geometry(
        name, q, kcache, vcache, block_ids, kv_lens, sq, "HND")
    arrays = [task_map.batch, task_map.head, task_map.tile_start, task_map.num_tiles]
    if any(a.device != q.device or a.dtype != torch.int32 or not a.is_contiguous() for a in arrays):
        raise ValueError(f"{name}: the task map must be contiguous int32 on q's device")
    ks = _scale_tensor(kscale, q.device)
    bsq, hq, d = q.shape
    cap, rows = task_map.capacity, hq // hkv * sq
    o = torch.empty((cap, rows, dv), dtype=torch.float32, device=q.device)
    m = torch.empty((cap, rows), dtype=torch.float32, device=q.device)
    l = torch.empty((cap, rows), dtype=torch.float32, device=q.device)
    rc = kernels.lib().hpc_paged_decode_tasks(
        q.data_ptr(), kcache.data_ptr(), vcache.data_ptr(), kv_type, *k_st, *v_st, _ptr(ks),
        *(a.data_ptr() for a in arrays), cap, task_map.tile, tbl.data_ptr(), lens.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), tbl.shape[1], page_size, sq, hq, hkv, d, dv,
        float(scale), kernels.stream_ptr(q),
    )
    kernels.check(rc, "hpc_paged_decode_tasks")
    kernels.count(paged_decode_tasks)
    return o, m, l


paged_decode_tasks.launches = 0


def _decode_combine_ref(o, m, l, task_map, sq, hq, vscale=None):
    """Plain PyTorch version of :func:`decode_combine` (float32): segment
    max and sums, as the JAX package's ``_segment_combine``."""
    cap, rows, dv = o.shape
    s_count = task_map.num_segs
    hkv = hq // (rows // sq)
    b = s_count // hkv
    seg = task_map.seg.long()
    m = torch.where((task_map.batch >= 0)[:, None], m, float("-inf"))
    m_g = torch.full((s_count, rows), float("-inf"), device=o.device).scatter_reduce(
        0, seg[:, None].expand(cap, rows), m, "amax")
    m_safe = torch.where(torch.isfinite(m_g), m_g, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe[seg]), 0.0)
    l_g = torch.zeros((s_count, rows), device=o.device).index_add_(0, seg, l * alpha)
    o_g = torch.zeros((s_count, rows, dv), device=o.device).index_add_(0, seg, o * alpha[..., None])
    out = torch.where(l_g[..., None] == 0, 0.0, o_g / l_g[..., None])
    if vscale is not None:
        out = out * torch.as_tensor(vscale, dtype=torch.float32, device=o.device).reshape(())
    g = rows // sq
    out = out.reshape(b, hkv, g, sq, dv).permute(0, 3, 1, 2, 4).reshape(b * sq, hq, dv)
    return out.to(torch.bfloat16)


def decode_combine(
    o: torch.Tensor,  # [cap, G*sq, Dv] f32 partials of paged_decode_tasks
    m: torch.Tensor,  # [cap, G*sq] f32
    l: torch.Tensor,  # [cap, G*sq] f32
    task_map,  # the TaskMap that produced them
    sq: int,
    hq: int,
    vscale=None,  # [1] f32 per-tensor V scale (None: 1)
) -> torch.Tensor:
    """The task-map decode's second stage: merges each (request, kv head)
    segment's partials, each weighted by exp(m - the segment's max m), into
    ``[B*sq, Hq, Dv]`` bf16, times ``vscale`` before the one rounding.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if o.device.type == "cpu":
        return _decode_combine_ref(o, m, l, task_map, sq, hq, vscale)
    if o.device.type != "cuda":
        raise ValueError(f"decode_combine: unsupported device {o.device}")
    cap, rows, dv = o.shape
    if rows % sq or hq % (rows // sq) or task_map.num_segs % (hq // (rows // sq)):
        raise ValueError("decode_combine: partials do not match the head geometry")
    hkv = hq // (rows // sq)
    b = task_map.num_segs // hkv
    parts = [t.contiguous() for t in (o, m, l)]
    if any(t.dtype != torch.float32 for t in parts) or tuple(m.shape) != (cap, rows) or tuple(
            l.shape) != (cap, rows) or task_map.capacity != cap:
        raise ValueError("decode_combine: partials must be float32 [cap, rows(, Dv)] of the map")
    arrays = [task_map.batch, task_map.seg]
    if any(a.device != o.device or a.dtype != torch.int32 or not a.is_contiguous() for a in arrays):
        raise ValueError("decode_combine: the task map must be contiguous int32 on the partials' device")
    vs = _scale_tensor(vscale, o.device)
    out = torch.empty((b * sq, hq, dv), dtype=torch.bfloat16, device=o.device)
    rc = kernels.lib().hpc_decode_combine(
        *(t.data_ptr() for t in parts), *(a.data_ptr() for a in arrays), cap, _ptr(vs),
        out.data_ptr(), b, sq, hq, hkv, dv, kernels.stream_ptr(o),
    )
    kernels.check(rc, "hpc_decode_combine")
    kernels.count(decode_combine)
    return out


decode_combine.launches = 0


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
    scales a bf16 output). ``task_map`` runs the split-KV mode over the map's
    own tile, which must be a multiple of the page size; QuantTypes 0 and 3
    ignore the map and take their grid kernel (the JAX package's reference
    gives the same output), and ``impl="ref"`` ignores it too. ``splitk``, ``pages_per_compute_block`` and ``task_tile`` (a map
    carries its own tile) are accepted for call compatibility and unused.
    """
    del splitk, pages_per_compute_block, task_tile
    if cache_layout not in ("NHD", "HND", "NHD_FUSED", "FUSED"):
        raise ValueError(f"attention_decode: unknown cache_layout {cache_layout!r}")
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
        elif cache_layout in ("FUSED", "NHD_FUSED"):
            kcache, vcache = _hnd_views(kcache, vcache, cache_layout, d)
            cache_layout = "HND"
    if impl == "ref":
        kv_k, kv_v = _hnd_views(kcache, vcache, cache_layout, d)
        return attention_decode_ref(
            q, hnd_to_nhd(kv_k), hnd_to_nhd(kv_v), block_ids, kv_lens,
            mtp=mtp, new_kv_included=True, qscale=qscale, kscale=kscale, vscale=vscale,
            quant_type=quant_type, sm_scale=scale,
        )
    if qscale is not None:
        qb = (q.float() * qscale.reshape(b * sq, hq)[..., None].float()).to(torch.bfloat16)
    else:
        qb = q.to(torch.bfloat16).contiguous()
    if pertoken_k:  # a task map changes only the schedule: the grid kernel serves it
        return paged_decode_qt0(qb, kcache, vcache, kscale, vscale, block_ids, kv_lens, sq,
                                scale, cache_layout)
    if task_map is not None:
        kv_k, kv_v = _hnd_views(kcache, vcache, cache_layout, d)
        o, m, l = paged_decode_tasks(qb, kv_k, kv_v, block_ids, kv_lens, task_map, sq, scale,
                                     kscale)
        return decode_combine(o, m, l, task_map, sq, hq, vscale)
    if cache_layout == "FUSED":  # strided views of the slab, read in place
        kcache, vcache = _hnd_views(kcache, vcache, cache_layout, d)
        cache_layout = "HND"
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
    "decode_combine",
    "paged_decode_attention",
    "paged_decode_nhd_fused",
    "paged_decode_qt0",
    "paged_decode_tasks",
    "unpack_tailrow_kscale",
]
