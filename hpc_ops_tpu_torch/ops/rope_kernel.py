"""Fused RoPE + QK-RMSNorm + paged KV store: the CUDA kernel and its plain version.

Port of ``ops/rope_kernel.py`` (kernel source: ``csrc/rope_store.cu``):
:func:`rope_store_rows` stores into bf16 caches, :func:`rope_store_rows_int8`
quantises into the int8 NHD_FUSED slab (the int8 branch of the TPU kernel).
One difference at this function: the JAX wrapper computes each row's
position and slot and gathers its cos|sin row before the kernel; this one
passes the step's tables (``seq_lens``, ``q_index``, the page table) and the
whole cos|sin table, and the kernel maps each row itself, so a decode layer
launches one kernel instead of a few dozen small PyTorch operations.

Contract (as in the JAX package): every row of qkv is a real token. A row
that maps to no valid slot is written to the cache's last slot, as the JAX
package's clip does. The caches are updated IN PLACE.
"""

from __future__ import annotations

import torch

from typing import NamedTuple

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import QKNormPolicy
from hpc_ops_tpu_torch.ops.kv_cache import OOB_SLOT, flat_slot_ids

_NORM_EPS = 1e-6


class _Varlen(NamedTuple):
    req_ids: torch.Tensor  # [rows]
    positions: torch.Tensor  # [rows] logical position in the sequence
    pos_in_q: torch.Tensor  # [rows] index within the request's new tokens
    valid: torch.Tensor  # [rows]


def _row_mapping(num_rows: int, num_seqlen_per_req, q_index) -> _Varlen:
    """row -> (request, absolute position). q_index: [num_req+1] prefix sums."""
    q_index = q_index.long()
    row = torch.arange(num_rows, dtype=torch.int64, device=q_index.device)
    req = torch.searchsorted(q_index[1:].contiguous(), row, right=True)
    num_req = num_seqlen_per_req.shape[0]
    req_c = req.clamp(max=num_req - 1)
    q_start = q_index[req_c]
    q_len = q_index[req_c + 1] - q_start
    seqlen = num_seqlen_per_req.long()[req_c]
    pos_in_q = row - q_start
    pos = seqlen - q_len + pos_in_q
    valid = (row < q_index[num_req]) & (pos >= 0) & (q_len > 0)
    return _Varlen(req_c, pos, pos_in_q, valid)


def row_slots(rows, seq_lens, q_index, block_ids, block_size, num_slots, fused=False):
    """(positions, flat slots) of each row, slots clipped into the cache: what
    the kernel computes for itself.

    ``fused``: the flat slots of an NHD_FUSED slab (``num_slots`` =
    nb * 2 * block_size), where a page spans 2 * block_size slots. The slot
    returned is the K row's; V is block_size slots later, so the clip target
    of an invalid row is ``num_slots - 1 - block_size``.
    """
    m = _row_mapping(rows, seq_lens, q_index)
    slots = flat_slot_ids(m.positions, m.req_ids, block_ids, block_size, m.valid)
    if fused:
        num_slots -= block_size
        # page * bs + off -> page * 2 * bs + off
        slots = torch.where(slots == OOB_SLOT, slots, slots + slots // block_size * block_size)
    return m.positions, slots.clamp(0, num_slots - 1)


def _rotate_neox(x, cs):
    """NeoX RoPE: x [rows, H, D], cs [rows, D] -> rotated [rows, H, D] f32."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cs[:, None, :h], cs[:, None, h:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _head_rmsnorm(x, w, eps: float = _NORM_EPS):
    """Per-head RMSNorm over head_dim (f32). w: [D]."""
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope_rows_f32(qkv, cos_sin, positions, q_norm_weight, k_norm_weight, hq, hkv, d, dv,
                   qk_norm_policy):
    """Split each row, then (norm), rope, (norm): float32 q, k and v."""
    rows = qkv.shape[0]
    x = qkv.float()
    q = x[:, : hq * d].reshape(rows, hq, d)
    k = x[:, hq * d : (hq + hkv) * d].reshape(rows, hkv, d)
    v = x[:, (hq + hkv) * d :].reshape(rows, hkv, dv)
    cs = cos_sin[positions.long().clamp(0, cos_sin.shape[0] - 1)].float()
    policy = QKNormPolicy(qk_norm_policy)
    if policy == QKNormPolicy.NORM_THEN_ROPE:
        q, k = _head_rmsnorm(q, q_norm_weight), _head_rmsnorm(k, k_norm_weight)
    q, k = _rotate_neox(q, cs), _rotate_neox(k, cs)
    if policy == QKNormPolicy.ROPE_THEN_NORM:
        q, k = _head_rmsnorm(q, q_norm_weight), _head_rmsnorm(k, k_norm_weight)
    return q, k, v


def quantize_int8(x, inv):
    """int8 codes clip(round(x * inv), +-127); round is half to even."""
    return torch.round(x * inv).clamp(-127, 127).to(torch.int8)


def rope_store_rows_ref(
    qkv, cos_sin, seq_lens, q_index, block_ids, q_norm_weight, k_norm_weight, kflat, vflat,
    *, hq, hkv, d, dv, block_size, qk_norm_policy, head_major,
):
    """Plain PyTorch version of :func:`rope_store_rows` (float32 math)."""
    rows = qkv.shape[0]
    num_slots = kflat.shape[1] if head_major else kflat.shape[0]
    positions, slots = row_slots(rows, seq_lens, q_index, block_ids, block_size, num_slots)
    q, k, v = _rope_rows_f32(qkv, cos_sin, positions, q_norm_weight, k_norm_weight, hq, hkv, d,
                             dv, qk_norm_policy)
    s = slots.long()
    if head_major:
        kflat[:, s] = k.transpose(0, 1).to(kflat.dtype)
        vflat[:, s] = v.transpose(0, 1).to(vflat.dtype)
    else:
        kflat[s] = k.to(kflat.dtype)
        vflat[s] = v.to(vflat.dtype)
    return q.reshape(rows, hq * d).to(torch.bfloat16), kflat, vflat


def rope_store_rows(
    qkv: torch.Tensor,  # [rows, (hq + 2*hkv) * d] bf16, every row a real token
    cos_sin: torch.Tensor,  # [max_position, d] f32 table (cos | sin)
    seq_lens: torch.Tensor,  # [num_req] tokens per request incl. the new rows
    q_index: torch.Tensor,  # [num_req + 1] prefix sums of new rows per request
    block_ids: torch.Tensor,  # [num_req, max_blocks] page table, -1 padded
    q_norm_weight: torch.Tensor | None,
    k_norm_weight: torch.Tensor | None,
    kflat: torch.Tensor,  # head_major: [hkv, S, d]; else [S, hkv, d]
    vflat: torch.Tensor,
    *,
    hq: int,
    hkv: int,
    d: int,
    dv: int,
    block_size: int,
    qk_norm_policy: int,
    head_major: bool,
):
    """Rotate/normalise q and k and store each row's K and V at its slot.

    Returns ``(q_out [rows, hq*d] bf16, kflat, vflat)``; the caches are
    written in place. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.
    """
    if qkv.device.type == "cpu":
        return rope_store_rows_ref(
            qkv, cos_sin, seq_lens, q_index, block_ids, q_norm_weight, k_norm_weight, kflat,
            vflat, hq=hq, hkv=hkv, d=d, dv=dv, block_size=block_size,
            qk_norm_policy=qk_norm_policy, head_major=head_major,
        )
    rows = qkv.shape[0]
    policy = int(QKNormPolicy(qk_norm_policy))
    if qkv.device.type != "cuda":
        raise ValueError(f"rope_store_rows: unsupported device {qkv.device}")
    if qkv.dtype != torch.bfloat16 or kflat.dtype != torch.bfloat16 or vflat.dtype != torch.bfloat16:
        raise ValueError(
            "rope_store_rows: the CUDA kernel stores bf16 caches only (the int8 "
            "NHD_FUSED slab takes rope_store_rows_int8, e4m3 caches the plain "
            "rope_norm_store_kv_fp8)"
        )
    if dv != d:
        raise ValueError("rope_store_rows: the CUDA kernel needs dv == d")
    if qkv.shape[1] != (hq + 2 * hkv) * d or not qkv.is_contiguous():
        raise ValueError(f"rope_store_rows: qkv must be contiguous [rows, {(hq + 2 * hkv) * d}]")
    if not (kflat.is_contiguous() and vflat.is_contiguous()):
        raise ValueError("rope_store_rows: caches must be contiguous")
    cos_sin = cos_sin.float().contiguous()
    if cos_sin.shape[1] != d:
        raise ValueError("rope_store_rows: cos_sin must be [max_position, d]")
    seq_lens, q_index, block_ids = _check_tables("rope_store_rows", seq_lens, q_index, block_ids)
    if policy != 0:
        q_norm_weight = q_norm_weight.float().contiguous()
        k_norm_weight = k_norm_weight.float().contiguous()
    for t in (cos_sin, seq_lens, q_index, block_ids, kflat, vflat):
        if t.device != qkv.device:
            raise ValueError("rope_store_rows: all tensors must be on one device")
    # element strides of (head, slot) in the flat cache views
    k_st = (kflat.stride(0), kflat.stride(1)) if head_major else (kflat.stride(1), kflat.stride(0))
    v_st = (vflat.stride(0), vflat.stride(1)) if head_major else (vflat.stride(1), vflat.stride(0))
    q_out = torch.empty((rows, hq * d), dtype=torch.bfloat16, device=qkv.device)
    num_slots = kflat.shape[1] if head_major else kflat.shape[0]
    rc = kernels.lib().hpc_rope_store_bf16(
        qkv.data_ptr(), cos_sin.data_ptr(), seq_lens.data_ptr(), q_index.data_ptr(),
        block_ids.data_ptr(),
        q_norm_weight.data_ptr() if policy else None,
        k_norm_weight.data_ptr() if policy else None,
        q_out.data_ptr(), kflat.data_ptr(), vflat.data_ptr(),
        rows, hq, hkv, d, cos_sin.shape[0], seq_lens.shape[0], block_ids.shape[1],
        block_size, num_slots, k_st[0], k_st[1], v_st[0], v_st[1],
        policy, kernels.stream_ptr(qkv),
    )
    kernels.check(rc, "hpc_rope_store_bf16")
    kernels.count(rope_store_rows)
    return q_out, kflat, vflat


rope_store_rows.launches = 0


def _check_tables(name, seq_lens, q_index, block_ids):
    seq_lens = seq_lens.to(torch.int32).contiguous()
    q_index = q_index.to(torch.int32).contiguous()
    block_ids = block_ids.to(torch.int32).contiguous()
    if q_index.shape[0] != seq_lens.shape[0] + 1 or block_ids.shape[0] != seq_lens.shape[0]:
        raise ValueError(f"{name}: seq_lens, q_index and block_ids disagree on requests")
    return seq_lens, q_index, block_ids


def rope_store_rows_int8_ref(
    qkv, cos_sin, seq_lens, q_index, block_ids, q_norm_weight, k_norm_weight, kv_slab,
    k_scale, v_scale, *, hq, hkv, d, block_size, qk_norm_policy,
):
    """Plain PyTorch version of :func:`rope_store_rows_int8` (float32 math)."""
    rows = qkv.shape[0]
    kvflat = kv_slab.view(-1, hkv, d)
    positions, slots = row_slots(rows, seq_lens, q_index, block_ids, block_size,
                                 kvflat.shape[0], fused=True)
    q, k, v = _rope_rows_f32(qkv, cos_sin, positions, q_norm_weight, k_norm_weight, hq, hkv, d,
                             d, qk_norm_policy)
    s = slots.long()
    kvflat[s] = quantize_int8(k, 1.0 / k_scale.reshape(()).float())
    kvflat[s + block_size] = quantize_int8(v, 1.0 / v_scale.reshape(()).float())
    return q.reshape(rows, hq * d).to(torch.bfloat16), kv_slab


def rope_store_rows_int8(
    qkv: torch.Tensor,  # [rows, (hq + 2*hkv) * d] bf16, every row a real token
    cos_sin: torch.Tensor,  # [max_position, d] f32 table (cos | sin)
    seq_lens: torch.Tensor,  # [num_req] tokens per request incl. the new rows
    q_index: torch.Tensor,  # [num_req + 1] prefix sums of new rows per request
    block_ids: torch.Tensor,  # [num_req, max_blocks] page table, -1 padded
    q_norm_weight: torch.Tensor | None,
    k_norm_weight: torch.Tensor | None,
    kv_slab: torch.Tensor,  # [nb, 2*block_size, hkv*d] int8 NHD_FUSED
    k_scale: torch.Tensor,  # [1] f32
    v_scale: torch.Tensor,  # [1] f32
    *,
    hq: int,
    hkv: int,
    d: int,
    block_size: int,
    qk_norm_policy: int,
):
    """Rotate/normalise q and k and store each row's int8 K and V codes,
    ``clip(round(x * (1 / scale)), +-127)``, at its slots of the NHD_FUSED slab.

    Returns ``(q_out [rows, hq*d] bf16, kv_slab)``; the slab is written in
    place, and only the addressed rows. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.
    """
    if qkv.device.type == "cpu":
        return rope_store_rows_int8_ref(
            qkv, cos_sin, seq_lens, q_index, block_ids, q_norm_weight, k_norm_weight, kv_slab,
            k_scale, v_scale, hq=hq, hkv=hkv, d=d, block_size=block_size,
            qk_norm_policy=qk_norm_policy,
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"rope_store_rows_int8: unsupported device {qkv.device}")
    policy = int(QKNormPolicy(qk_norm_policy))
    if qkv.dtype != torch.bfloat16 or kv_slab.dtype != torch.int8:
        raise ValueError("rope_store_rows_int8: needs bf16 qkv and an int8 slab")
    if qkv.shape[1] != (hq + 2 * hkv) * d or not qkv.is_contiguous():
        raise ValueError(
            f"rope_store_rows_int8: qkv must be contiguous [rows, {(hq + 2 * hkv) * d}]"
        )
    nb = kv_slab.shape[0]
    if kv_slab.shape != (nb, 2 * block_size, hkv * d) or not kv_slab.is_contiguous():
        raise ValueError(
            f"rope_store_rows_int8: the slab must be contiguous [nb, {2 * block_size}, {hkv * d}]"
        )
    cos_sin = cos_sin.float().contiguous()
    if cos_sin.shape[1] != d:
        raise ValueError("rope_store_rows_int8: cos_sin must be [max_position, d]")
    seq_lens, q_index, block_ids = _check_tables(
        "rope_store_rows_int8", seq_lens, q_index, block_ids
    )
    if policy != 0:
        q_norm_weight = q_norm_weight.float().contiguous()
        k_norm_weight = k_norm_weight.float().contiguous()
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError("rope_store_rows_int8: scales must be [1] float32")
    for t in (cos_sin, seq_lens, q_index, block_ids, kv_slab, k_scale, v_scale):
        if t.device != qkv.device:
            raise ValueError("rope_store_rows_int8: all tensors must be on one device")
    rows = qkv.shape[0]
    q_out = torch.empty((rows, hq * d), dtype=torch.bfloat16, device=qkv.device)
    rc = kernels.lib().hpc_rope_store_int8(
        qkv.data_ptr(), cos_sin.data_ptr(), seq_lens.data_ptr(), q_index.data_ptr(),
        block_ids.data_ptr(),
        q_norm_weight.data_ptr() if policy else None,
        k_norm_weight.data_ptr() if policy else None,
        k_scale.data_ptr(), v_scale.data_ptr(), q_out.data_ptr(), kv_slab.data_ptr(),
        rows, hq, hkv, d, cos_sin.shape[0], seq_lens.shape[0], block_ids.shape[1],
        block_size, nb, policy, kernels.stream_ptr(qkv),
    )
    kernels.check(rc, "hpc_rope_store_int8")
    kernels.count(rope_store_rows_int8)
    return q_out, kv_slab


rope_store_rows_int8.launches = 0

__all__ = [
    "quantize_int8",
    "rope_store_rows",
    "rope_store_rows_int8",
    "rope_store_rows_int8_ref",
    "rope_store_rows_ref",
    "row_slots",
]
