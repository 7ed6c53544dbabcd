"""Plain PyTorch reference attention (port of ``ops/attention/reference.py``).

The oracle for the attention kernels: varlen dense prefill, paged-cache
prefill and paged decode with draft tokens (MTP), over bf16 caches or
quantised ones with the scale schemes of ``QuantType``. All math in float32.
Caches passed here are NHD ``[num_blocks, block_size, H_kv, D]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from hpc_ops_tpu_torch.config import QuantType

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _dequant_kv(kcache, vcache, kscale, vscale, quant_type: QuantType):
    """Caches -> float32. A bf16 cache is read as it is. An int8 or fp8 cache
    with per-tensor scales (QuantType 1, 2) is ``k * kscale``, ``v * vscale``
    (a scale of None multiplies by 1; ``vscale`` may also be ``[H_kv]``). With per-token K scales (QuantType 0,
    3) ``kscale`` is paged like the cache, ``[num_blocks, bs, H_kv, S]`` with
    S = 1 (one scale per token and head) or S groups along D, and ``vscale``
    is ``[H_kv]``."""
    k, v = kcache.float(), vcache.float()
    if kcache.dtype == torch.bfloat16:
        return k, v
    if QuantType(quant_type) in (
        QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
        QuantType.QPERTENSOR_KPERTENSOR_VPERTENSOR,
    ):
        if kscale is not None:
            k = k * torch.as_tensor(kscale, dtype=torch.float32, device=k.device).reshape(())
        if vscale is not None:  # [1], or one per kv head
            vs = torch.as_tensor(vscale, dtype=torch.float32, device=v.device)
            v = v * vs.reshape(-1)[None, None, :, None]
        return k, v
    ks = kscale.float()
    k = k * ks.repeat_interleave(k.shape[-1] // ks.shape[-1], dim=-1)
    if vscale is not None:
        v = v * vscale.float()[None, None, :, None]
    return k, v


def _gather_pages(cache, block_ids, max_len):
    """[num_blocks, bs, H, D] + [B, max_blocks] -> [B, max_len, H, D]."""
    bs = cache.shape[1]
    nblk = -(-max_len // bs)
    ids = block_ids[:, :nblk].long()
    out = cache[ids.clamp(min=0)]  # [B, nblk, bs, H, D]
    out = out.masked_fill((ids < 0)[:, :, None, None, None], 0)
    b = block_ids.shape[0]
    return out.reshape(b, nblk * bs, *cache.shape[2:])[:, :max_len]


def _tile_keep(block_mask, rows, kv_len, mask_tile_q, mask_tile_kv, pad_missing=False):
    """One request's block mask ``[Hq, n_tm, n_tkv]`` expanded to the bool
    ``[Hq, len(rows), kv_len]`` keep mask of its q rows ``rows``: row i lies
    in q tile ``i // mask_tile_q`` (counted from the request's first q row),
    key position p in kv tile ``p // mask_tile_kv`` (counted from position
    0). Tiles past the mask's edge take its last row or column, as JAX's
    clamped gather does in the reference; with ``pad_missing`` they are 0, as
    in the kernels."""
    dev = block_mask.device
    tq = rows.to(dev) // mask_tile_q
    tk = torch.arange(kv_len, device=dev) // mask_tile_kv
    n_tm, n_tkv = block_mask.shape[-2:]
    keep = block_mask[:, tq.clamp(max=n_tm - 1)][:, :, tk.clamp(max=n_tkv - 1)] != 0
    if pad_missing:
        keep = keep & (tq < n_tm)[None, :, None] & (tk < n_tkv)[None, None, :]
    return keep


def mha_varlen_prefill_ref(
    q,  # [total_q, Hq, D]
    k,  # [B, max_kv, Hkv, D] float32 (already gathered)
    v,
    seqlens_q,  # [B]
    cu_seqlens_q,  # [B+1]
    seqlens_kv,  # [B] total kv length (>= seqlens_q; causal offset = kv - q)
    q_scale=None,  # [B, Hq, max_q_pad] per-token-per-head scale of q, or None
    block_mask=None,
    mask_tile_q: int = 128,
    mask_tile_kv: int = 128,
    sm_scale: Optional[float] = None,
    causal: bool = True,
):
    """Varlen causal attention over per-request KV; returns [total_q, Hq, Dv]
    float32. Query i of request b sits at position ``kv_len - q_len + i``.
    With ``block_mask`` ``[B, Hq, n_tm, n_tkv]`` the logits of tiles whose
    entry is 0 become ``MASK_VALUE`` after the causal mask (see
    :func:`_tile_keep`), as in the JAX reference: a row with no kept key
    averages V over the request's keys (the docstring there says NaN)."""
    total_q, hq, d = q.shape
    b, _, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    qf = q.float()
    out = torch.zeros((total_q, hq, dv), dtype=torch.float32, device=q.device)
    cu = [int(x) for x in cu_seqlens_q.tolist()]
    lq = [int(x) for x in seqlens_q.tolist()]
    lkv = [int(x) for x in seqlens_kv.tolist()]
    for bi in range(b):
        q_start, q_len, kv_len = cu[bi], lq[bi], lkv[bi]
        if q_len == 0:
            continue
        qi = qf[q_start : q_start + q_len]
        if q_scale is not None:
            qi = qi * q_scale[bi, :, :q_len].float().T[:, :, None]
        ki = k[bi, :kv_len].float().repeat_interleave(g, dim=1)  # [kv, Hq, D]
        vi = v[bi, :kv_len].float().repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", qi, ki) * scale
        if causal:
            qpos = kv_len - q_len + torch.arange(q_len, device=q.device)
            kpos = torch.arange(kv_len, device=q.device)
            s = s.masked_fill(~(kpos[None, :] <= qpos[:, None])[None], MASK_VALUE)
        if block_mask is not None:
            keep = _tile_keep(block_mask[bi].to(q.device), torch.arange(q_len), kv_len, mask_tile_q,
                              mask_tile_kv)
            s = s.masked_fill(~keep, MASK_VALUE)
        p = torch.softmax(s, dim=-1)
        out[q_start : q_start + q_len] = torch.einsum("hqk,khd->qhd", p, vi)
    return out


def attention_prefill_bf16_ref(q, k, v, seqlens_q, cu_seqlens_q, max_seqlens_q):
    """Dense packed-varlen prefill: K/V packed like Q. Returns bf16."""
    b = seqlens_q.shape[0]
    hkv, d, dv = k.shape[1], k.shape[2], v.shape[2]
    max_kv = int(max_seqlens_q)
    kb = torch.zeros((b, max_kv, hkv, d), dtype=torch.float32, device=q.device)
    vb = torch.zeros((b, max_kv, hkv, dv), dtype=torch.float32, device=q.device)
    cu = cu_seqlens_q.tolist()
    lq = seqlens_q.tolist()
    for bi in range(b):
        s, n = int(cu[bi]), int(lq[bi])
        kb[bi, :n] = k[s : s + n].float()
        vb[bi, :n] = v[s : s + n].float()
    out = mha_varlen_prefill_ref(q, kb, vb, seqlens_q, cu_seqlens_q, seqlens_q)
    return out.to(torch.bfloat16)


def attention_with_kvcache_prefill_ref(
    q,
    kcache,
    vcache,
    cu_seqlens_q,
    block_ids,
    seqlens_kvcache,
    max_seqlens_q,
    qscale=None,
    kscale=None,
    vscale=None,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
    block_mask=None,
    mask_tile_q: int = 128,
    mask_tile_kv: int = 128,
    sm_scale: Optional[float] = None,
):
    """Paged-cache varlen prefill over an NHD cache, bf16 or quantised
    (``qscale`` [B, Hq, max_q_pad] dequantises q). Returns bf16. With
    ``block_mask`` the semantics of :func:`mha_varlen_prefill_ref`."""
    seqlens_q = cu_seqlens_q[1:] - cu_seqlens_q[:-1]
    max_kv = int(seqlens_kvcache.max())
    kf, vf = _dequant_kv(kcache, vcache, kscale, vscale, quant_type)
    kb = _gather_pages(kf, block_ids, max_kv)
    vb = _gather_pages(vf, block_ids, max_kv)
    out = mha_varlen_prefill_ref(
        q, kb, vb, seqlens_q, cu_seqlens_q, seqlens_kvcache, q_scale=qscale,
        block_mask=block_mask, mask_tile_q=mask_tile_q, mask_tile_kv=mask_tile_kv, sm_scale=sm_scale,
    )
    return out.to(torch.bfloat16)


def attention_decode_ref(
    q,  # [B*Sq, Hq, D] bf16
    kcache,
    vcache,
    block_ids,
    num_seq_kvcache,
    mtp: int = 0,
    new_kv_included: bool = True,
    qscale=None,  # [B*Sq, Hq] per-token-per-head scale of q (fp8 path)
    kscale=None,
    vscale=None,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
    sm_scale: Optional[float] = None,
):
    """Paged decode attention with MTP draft tokens over an NHD cache.

    With ``new_kv_included=False`` the effective KV length is
    ``num_seq_kvcache + mtp + 1``. Returns [B*Sq, Hq, Dv] bf16.
    """
    sq = mtp + 1
    b = num_seq_kvcache.shape[0]
    hq, d = q.shape[1], q.shape[2]
    kv_len = num_seq_kvcache.long() + (0 if new_kv_included else sq)
    max_kv = int(kv_len.max())
    kf, vf = _dequant_kv(kcache, vcache, kscale, vscale, quant_type)
    kb = _gather_pages(kf, block_ids, max_kv)  # [B, max_kv, Hkv, D]
    vb = _gather_pages(vf, block_ids, max_kv)
    g = hq // kb.shape[2]
    qf = q.float().reshape(b, sq, hq, d)
    if qscale is not None:
        qf = qf * qscale.float().reshape(b, sq, hq)[..., None]
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    kbg = kb.repeat_interleave(g, dim=2)
    vbg = vb.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kbg) * scale
    kpos = torch.arange(max_kv, device=q.device)[None, None, None, :]
    qpos = (kv_len[:, None] - sq + torch.arange(sq, device=q.device)[None, :])[:, None, :, None]
    s = s.masked_fill(~(kpos <= qpos), MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vbg)
    return o.reshape(b * sq, hq, -1).to(torch.bfloat16)


__all__ = [
    "MASK_VALUE",
    "mha_varlen_prefill_ref",
    "attention_prefill_bf16_ref",
    "attention_with_kvcache_prefill_ref",
    "attention_decode_ref",
]
