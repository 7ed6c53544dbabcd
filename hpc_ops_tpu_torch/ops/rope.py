"""RoPE + optional QK-RMSNorm + paged KV store (port of ``ops/rope.py``):
bf16 caches (:func:`rope_norm_store_kv`), the int8 fused K|V slabs
(:func:`rope_norm_store_kv_int8`) and e4m3 caches with an e4m3 q
(:func:`rope_norm_store_kv_fp8`, plain PyTorch as in the JAX package).

Two formulations, chosen by ``impl`` as in the JAX package:
  * "auto" / "xla": plain PyTorch gather + elementwise + masked store; it
    tolerates padded rows (rows past ``q_index[-1]`` are dropped);
  * "pallas": the fused store kernel (``ops/rope_kernel.py``, CUDA on the
    card). The caller promises that every qkv row is a real token.

The name "pallas" is kept so one call serves both packages. Caches are
updated IN PLACE and returned (the JAX versions return new caches).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hpc_ops_tpu_torch.config import FP8_MAX, QKNormPolicy, QuantPolicy
from hpc_ops_tpu_torch.ops.kv_cache import (
    OOB_SLOT,
    PagedKVCache,
    flat_slot_ids,
    store_kv,
    zero_block_tails,
)
from hpc_ops_tpu_torch.ops.rope_kernel import (
    _head_rmsnorm,
    _rotate_neox,
    _row_mapping,
    quantize_int8,
    rope_store_rows,
    rope_store_rows_int8,
)
from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast, round_up


def can_use_rope_kernel(cache_dtype, qkv_dtype, cache_layout: str, store_to_cache: bool) -> bool:
    """True when the fused store kernel applies: bf16 qkv and cache, NHD or
    HND, storing to the cache. Unlike the TPU kernel there is no condition on
    the row count, and HND is served directly."""
    return (
        store_to_cache
        and cache_layout in ("NHD", "HND")
        and cache_dtype == torch.bfloat16
        and qkv_dtype == torch.bfloat16
    )


def make_cos_sin_cache(
    max_position: int,
    head_dim: int,
    base: float = 10000.0,
    rope_scaling: dict | None = None,
    device="cuda",
):
    """[max_position, head_dim] float32 table: first half cos(t*f), second half sin,
    on ``device`` (the card unless the caller asks for the CPU).

    ``rope_scaling`` supports ``{"rope_type": "linear", "factor": f}`` and
    Llama-3.1's ``{"rope_type": "llama3", "factor", "low_freq_factor",
    "high_freq_factor", "original_max_position_embeddings"}``.
    """
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    )
    if rope_scaling is not None:
        kind = rope_scaling.get("rope_type") or rope_scaling.get("type")
        factor = float(rope_scaling["factor"])
        if kind == "linear":
            inv_freq = inv_freq / factor
        elif kind == "llama3":
            lo_f = float(rope_scaling["low_freq_factor"])
            hi_f = float(rope_scaling["high_freq_factor"])
            orig = float(rope_scaling["original_max_position_embeddings"])
            wavelen = 2.0 * math.pi / inv_freq
            smooth = ((orig / wavelen - lo_f) / (hi_f - lo_f)).clamp(0.0, 1.0)
            scaled = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
            inv_freq = torch.where(
                wavelen < orig / hi_f,  # high-frequency band: unscaled
                inv_freq,
                torch.where(wavelen > orig / lo_f, inv_freq / factor, scaled),
            )
        else:
            raise ValueError(f"unsupported rope_scaling type: {kind!r}")
    t = torch.arange(max_position, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1).to(device)


def _split_qkv(qkv, num_q_heads, num_kv_heads, qk_dim, v_dim):
    rows = qkv.shape[0]
    q_end = num_q_heads * qk_dim
    k_end = q_end + num_kv_heads * qk_dim
    q = qkv[:, :q_end].reshape(rows, num_q_heads, qk_dim)
    k = qkv[:, q_end:k_end].reshape(rows, num_kv_heads, qk_dim)
    v = qkv[:, k_end:].reshape(rows, num_kv_heads, v_dim)
    return q, k, v


def _rope_norm_core(
    qkv, cos_sin, num_seqlen_per_req, q_index, q_norm_weight, k_norm_weight,
    qk_norm_policy, num_kv_heads, qk_dim, v_dim,
):
    """Split, (norm), rope, (norm). Returns f32 q, k, the raw v and the mapping."""
    rows, hidden = qkv.shape
    num_q_heads = (hidden - num_kv_heads * (qk_dim + v_dim)) // qk_dim
    q, k, v = _split_qkv(qkv, num_q_heads, num_kv_heads, qk_dim, v_dim)
    m = _row_mapping(rows, num_seqlen_per_req, q_index)
    cs = cos_sin[m.positions.clamp(0, cos_sin.shape[0] - 1)].float()
    q, k = q.float(), k.float()
    policy = QKNormPolicy(qk_norm_policy)
    if policy == QKNormPolicy.NORM_THEN_ROPE:
        q, k = _head_rmsnorm(q, q_norm_weight), _head_rmsnorm(k, k_norm_weight)
    q, k = _rotate_neox(q, cs), _rotate_neox(k, cs)
    if policy == QKNormPolicy.ROPE_THEN_NORM:
        q, k = _head_rmsnorm(q, q_norm_weight), _head_rmsnorm(k, k_norm_weight)
    return q, k, v, m


def rope_norm_store_kv(
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    qkv: torch.Tensor,
    cos_sin: torch.Tensor,
    num_seqlen_per_req: torch.Tensor,
    q_index: torch.Tensor,
    kvcache_indices: torch.Tensor,
    is_prefill: bool,
    q_norm_weight: Optional[torch.Tensor] = None,
    k_norm_weight: Optional[torch.Tensor] = None,
    qk_norm_policy: int = 0,
    store_to_cache: bool = True,
    cache_layout: str = "NHD",
    zero_tails: bool = True,
    impl: str = "auto",
    interpret: bool | None = None,
):
    """RoPE + optional QK RMSNorm + paged-KV store (bf16).

    Returns ``(q_rotated [rows, Hq, Dqk] bf16, key_cache, value_cache)`` with
    the caches written in place, or with ``store_to_cache=False`` the
    buffers ``(q, k_out, v_out)`` instead. ``interpret`` is the TPU kernel's
    interpret-mode switch: accepted and ignored.
    """
    del is_prefill, interpret  # one path: positions come from the scalar tables
    if cache_layout == "HND":
        num_kv_heads, qk_dim = key_cache.shape[0], key_cache.shape[3]
    else:
        num_kv_heads, qk_dim = key_cache.shape[2], key_cache.shape[3]
    v_dim = value_cache.shape[3]
    if impl == "pallas" and can_use_rope_kernel(
        key_cache.dtype, qkv.dtype, cache_layout, store_to_cache
    ):
        return _rope_store_kernel_path(
            key_cache, value_cache, qkv, cos_sin, num_seqlen_per_req, q_index,
            kvcache_indices, q_norm_weight, k_norm_weight, qk_norm_policy,
            num_kv_heads, qk_dim, v_dim, cache_layout, zero_tails,
        )
    q, k, v, m = _rope_norm_core(
        qkv, cos_sin, num_seqlen_per_req, q_index, q_norm_weight, k_norm_weight,
        qk_norm_policy, num_kv_heads, qk_dim, v_dim,
    )
    keep = m.valid[:, None, None]
    q_out = torch.where(keep, q, 0.0).to(torch.bfloat16)
    if not store_to_cache:
        k_out = torch.where(keep, k, 0.0).to(torch.bfloat16)
        v_out = torch.where(keep, v.float(), 0.0).to(torch.bfloat16)
        return q_out, k_out, v_out
    cache = PagedKVCache(key_cache, value_cache)
    blk = key_cache.shape[2] if cache_layout == "HND" else key_cache.shape[1]
    slots = flat_slot_ids(m.positions, m.req_ids, kvcache_indices, blk, m.valid)
    store_kv(cache, k, v, slots, layout=cache_layout)
    if zero_tails:
        zero_block_tails(cache, num_seqlen_per_req, kvcache_indices, layout=cache_layout)
    return q_out, key_cache, value_cache


def _rope_store_kernel_path(
    key_cache, value_cache, qkv, cos_sin, num_seqlen_per_req, q_index,
    kvcache_indices, q_norm_weight, k_norm_weight, qk_norm_policy,
    num_kv_heads, qk_dim, v_dim, cache_layout, zero_tails,
):
    """Fused-kernel store path. Every qkv row must be a real token."""
    rows, hidden = qkv.shape
    num_q_heads = (hidden - num_kv_heads * (qk_dim + v_dim)) // qk_dim
    if cache_layout == "HND":
        h, nb, bs, _ = key_cache.shape
        kflat = key_cache.view(h, nb * bs, qk_dim)
        vflat = value_cache.view(h, nb * bs, v_dim)
    else:
        nb, bs, h, _ = key_cache.shape
        kflat = key_cache.view(nb * bs, h, qk_dim)
        vflat = value_cache.view(nb * bs, h, v_dim)
    q_out, _, _ = rope_store_rows(
        qkv, cos_sin, num_seqlen_per_req, q_index, kvcache_indices, q_norm_weight,
        k_norm_weight, kflat, vflat, hq=num_q_heads, hkv=num_kv_heads, d=qk_dim, dv=v_dim,
        block_size=bs, qk_norm_policy=qk_norm_policy, head_major=cache_layout == "HND",
    )
    if zero_tails:
        zero_block_tails(
            PagedKVCache(key_cache, value_cache), num_seqlen_per_req,
            kvcache_indices, layout=cache_layout,
        )
    return q_out.view(rows, num_q_heads, qk_dim), key_cache, value_cache


def rope_norm_store_kv_int8(
    kv_cache: torch.Tensor,
    qkv: torch.Tensor,
    cos_sin: torch.Tensor,
    num_seqlen_per_req: torch.Tensor,
    q_index: torch.Tensor,
    kvcache_indices: torch.Tensor,
    is_prefill: bool,
    k_scale,
    v_scale,
    q_norm_weight: Optional[torch.Tensor] = None,
    k_norm_weight: Optional[torch.Tensor] = None,
    qk_norm_policy: int = 0,
    impl: str = "auto",
    interpret: bool | None = None,
    cache_layout: str = "FUSED",
    num_kv_heads: int | None = None,
):
    """RoPE + optional QK-norm + symmetric int8 quantisation + fused-page KV store.

    Writes ``clip(round(x / scale), +-127)`` codes of K (after rope/norm) and
    of V into each token's (page, slot) rows of an int8 fused cache: the
    head-major "FUSED" ``[Hkv, nb, 2*bs, D]`` or, with ``num_kv_heads``, the
    slot-leading "NHD_FUSED" ``[nb, 2*bs, Hkv*D]``; a page's V rows sit bs
    rows after its K rows. ``k_scale``/``v_scale`` are [1] float32 scales;
    the codes multiply by their float32 inverses.

    ``impl="pallas"`` with NHD_FUSED takes the fused store
    (:func:`~hpc_ops_tpu_torch.ops.rope_kernel.rope_store_rows_int8`, the
    CUDA kernel on the card) under the all-rows-real contract: an invalid
    row is written to the slab's last page rows and its q row is computed
    like any other. Otherwise the plain scatter runs: invalid rows are
    dropped and their q rows are zeros, as in the JAX package.

    Returns ``(q_rot [rows, Hq, D] bf16, kv_cache)``, the cache written in place.
    ``interpret`` is the TPU kernel's interpret-mode switch: accepted and
    ignored.
    """
    del is_prefill, interpret  # one path: positions come from the scalar tables
    if cache_layout == "NHD_FUSED":
        if num_kv_heads is None:
            raise ValueError("rope_norm_store_kv_int8: NHD_FUSED needs num_kv_heads")
        nb, bs2, hd = kv_cache.shape
        h = num_kv_heads
        d = hd // h
    elif cache_layout == "FUSED":
        h, nb, bs2, d = kv_cache.shape
    else:
        raise ValueError(f"rope_norm_store_kv_int8: unknown cache_layout {cache_layout!r}")
    bs = bs2 // 2
    rows, hidden = qkv.shape
    num_q_heads = (hidden - 2 * h * d) // d
    k_scale = torch.as_tensor(k_scale, dtype=torch.float32, device=qkv.device).reshape(1)
    v_scale = torch.as_tensor(v_scale, dtype=torch.float32, device=qkv.device).reshape(1)
    if impl == "pallas" and cache_layout == "NHD_FUSED":
        q_out, _ = rope_store_rows_int8(
            qkv, cos_sin, num_seqlen_per_req, q_index, kvcache_indices, q_norm_weight,
            k_norm_weight, kv_cache, k_scale, v_scale, hq=num_q_heads, hkv=h, d=d, block_size=bs,
            qk_norm_policy=qk_norm_policy,
        )
        return q_out.view(rows, num_q_heads, d), kv_cache
    q, k, v, m = _rope_norm_core(
        qkv, cos_sin, num_seqlen_per_req, q_index, q_norm_weight, k_norm_weight,
        qk_norm_policy, h, d, d,
    )
    k_q = quantize_int8(k, 1.0 / k_scale.reshape(()))
    v_q = quantize_int8(v.float(), 1.0 / v_scale.reshape(()))
    slots = flat_slot_ids(m.positions, m.req_ids, kvcache_indices, bs, m.valid)
    good = slots != OOB_SLOT
    sk = slots[good]
    sk = sk + sk // bs * bs  # page * bs + off -> page * 2 * bs + off
    if cache_layout == "NHD_FUSED":
        kvflat = kv_cache.view(nb * bs2, h * d)
        kvflat[sk] = k_q[good].reshape(-1, h * d)
        kvflat[sk + bs] = v_q[good].reshape(-1, h * d)
    else:
        kvflat = kv_cache.view(h, nb * bs2, d)
        kvflat[:, sk] = k_q[good].transpose(0, 1)
        kvflat[:, sk + bs] = v_q[good].transpose(0, 1)
    q_out = torch.where(m.valid[:, None, None], q, 0.0).to(torch.bfloat16)
    return q_out, kv_cache


def rope_norm_store_kv_fp8(
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    qkv: torch.Tensor,
    cos_sin: torch.Tensor,
    num_seqlen_per_req: torch.Tensor,
    q_index: torch.Tensor,
    kvcache_indices: torch.Tensor,
    is_prefill: bool,
    k_scale,
    v_scale,
    quant_policy: int,
    max_seqlens: int = 0,
    upper_max: Optional[float] = None,
    q_scale_inv=None,
    q_norm_weight: Optional[torch.Tensor] = None,
    k_norm_weight: Optional[torch.Tensor] = None,
    qk_norm_policy: int = 0,
    cache_layout: str = "NHD",
    zero_tails: bool = True,
):
    """FP8 variant: quantises q (dynamic per token and head, or static) and
    stores K/V into e4m3 caches with static per-tensor scales. Dequantisation
    is ``x = x_fp8 * scale`` throughout.

    Plain PyTorch that reads no tensor on the host (with ``zero_tails=False``),
    so a decode step adds no device-to-host copy. Rows past ``q_index[-1]``
    are dropped and their q rows and scales are zeros.

    Returns ``(q_fp8 [rows, Hq, Dqk], q_scale, split_k_flag [num_req, Hkv]
    zeros, key_cache, value_cache)``, the caches written in place. ``q_scale``
    is [num_req, Hq, round_up(max_seqlens, 128)] on prefill (a transposed
    view), [rows, Hq] on decode, or None with ``quant_policy`` STATIC.
    """
    upper = FP8_MAX if upper_max is None else float(upper_max)
    if cache_layout == "HND":
        num_kv_heads, qk_dim = key_cache.shape[0], key_cache.shape[3]
    else:
        num_kv_heads, qk_dim = key_cache.shape[2], key_cache.shape[3]
    v_dim = value_cache.shape[3]
    num_req = num_seqlen_per_req.shape[0]
    dev = qkv.device
    q, k, v, m = _rope_norm_core(
        qkv, cos_sin, num_seqlen_per_req, q_index, q_norm_weight, k_norm_weight,
        qk_norm_policy, num_kv_heads, qk_dim, v_dim,
    )
    num_q_heads = q.shape[1]

    def scalar(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())

    if QuantPolicy(quant_policy) == QuantPolicy.DYNAMIC_Q_STATIC_KV:
        scale_rowhead = (q.abs().amax(dim=-1) / upper).clamp(min=1e-12)  # [rows, Hq]
        q_fp8 = fp8_saturate_cast(q / scale_rowhead[..., None], upper)
        if is_prefill:
            pad = round_up(max(int(max_seqlens), 1), 128)
            ok = m.valid & (m.pos_in_q < pad)
            # scatter [rows, Hq] scales to [num_req, pad, Hq]; rows that do not
            # count aim at a spare last row, which is cut off
            flat = torch.zeros((num_req * pad + 1, num_q_heads), dtype=torch.float32, device=dev)
            flat[torch.where(ok, m.req_ids * pad + m.pos_in_q, num_req * pad)] = scale_rowhead
            q_scale = flat[:-1].view(num_req, pad, num_q_heads).transpose(1, 2)
        else:
            q_scale = torch.where(m.valid[:, None], scale_rowhead, 0.0)
    else:
        if q_scale_inv is None:
            raise ValueError("quant_policy=2 requires q_scale_inv")
        q_fp8 = fp8_saturate_cast(q * scalar(q_scale_inv), upper)
        q_scale = None
    # zero the rows of no request (bytes: zero is code 0)
    q_fp8 = (q_fp8.view(torch.uint8) * m.valid[:, None, None]).view(q_fp8.dtype)

    k_q = fp8_saturate_cast(k / scalar(k_scale), upper)
    v_q = fp8_saturate_cast(v.float() / scalar(v_scale), upper)
    cache = PagedKVCache(key_cache, value_cache)
    blk = key_cache.shape[2] if cache_layout == "HND" else key_cache.shape[1]
    slots = flat_slot_ids(m.positions, m.req_ids, kvcache_indices, blk, m.valid)
    store_kv(cache, k_q, v_q, slots, layout=cache_layout)
    if zero_tails:
        zero_block_tails(cache, num_seqlen_per_req, kvcache_indices, layout=cache_layout)
    split_k_flag = torch.zeros((num_req, num_kv_heads), dtype=torch.int32, device=dev)
    return q_fp8, q_scale, split_k_flag, key_cache, value_cache


__all__ = [
    "can_use_rope_kernel",
    "make_cos_sin_cache",
    "rope_norm_store_kv",
    "rope_norm_store_kv_fp8",
    "rope_norm_store_kv_int8",
]
