"""Paged KV-cache layout and update helpers (PyTorch port of ``ops/kv_cache.py``).

Caches are ``[num_blocks, block_size, H_kv, D]`` ("NHD") or
``[H_kv, num_blocks, block_size, D]`` ("HND").

Unlike the JAX package, whose updates are functional and return new caches,
every update here writes the caches IN PLACE and returns the same tensors.

Out-of-range slots are dropped, never wrapped: ``flat_slot_ids`` maps invalid
rows to the sentinel ``2**31 - 1`` and the stores mask every slot outside the
cache before indexing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hpc_ops_tpu_torch.config import FP8_DTYPE
from hpc_ops_tpu_torch.utils.common import cdiv

OOB_SLOT = 2**31 - 1


class PagedKVCache(NamedTuple):
    """A pair of paged caches (NHD geometry for the properties)."""

    k: torch.Tensor  # [num_blocks, block_size, H_kv, D_qk]
    v: torch.Tensor  # [num_blocks, block_size, H_kv, D_v]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[0]

    @property
    def block_size(self) -> int:
        return self.k.shape[1]

    @property
    def num_kv_heads(self) -> int:
        return self.k.shape[2]


def alloc_paged_cache(
    num_blocks: int,
    block_size: int,
    num_kv_heads: int,
    qk_dim: int,
    v_dim: int | None = None,
    dtype=torch.bfloat16,
    device="cuda",
) -> PagedKVCache:
    v_dim = qk_dim if v_dim is None else v_dim
    return PagedKVCache(
        k=torch.zeros((num_blocks, block_size, num_kv_heads, qk_dim), dtype=dtype, device=device),
        v=torch.zeros((num_blocks, block_size, num_kv_heads, v_dim), dtype=dtype, device=device),
    )


def flat_slot_ids(
    positions: torch.Tensor,  # [rows] logical position within the sequence
    req_ids: torch.Tensor,  # [rows] request index per row
    block_ids: torch.Tensor,  # [num_req, max_blocks] page table
    block_size: int,
    valid: torch.Tensor | None = None,  # [rows] bool
) -> torch.Tensor:
    """Map (request, position) -> flat slot ``block*block_size + offset``.

    Invalid rows, negative page ids and positions past the table map to
    ``OOB_SLOT`` so the stores drop them. Returns int64.
    """
    positions = positions.long()
    max_blocks = block_ids.shape[1]
    blk = torch.div(positions, block_size, rounding_mode="floor")
    off = positions - blk * block_size
    in_table = (blk >= 0) & (blk < max_blocks)
    phys = block_ids[req_ids.long(), blk.clamp(0, max_blocks - 1)].long()
    bad = (phys < 0) | ~in_table
    if valid is not None:
        bad = bad | ~valid
    slots = phys * block_size + off
    return torch.where(bad, torch.full_like(slots, OOB_SLOT), slots)


def _keep(slots: torch.Tensor, num_slots: int) -> torch.Tensor:
    return (slots >= 0) & (slots < num_slots)


def _kept_rows(slots: torch.Tensor, num_slots: int):
    """Row and slot indices that make an indexed store drop the rows with a
    slot outside the cache, with no mask whose size the host would have to
    read: a dropped row repeats the first kept row (writing one slot twice
    with the same values is harmless). Returns ``(rows, slots, any_kept)``;
    with no kept row at all every row aims at slot 0 and the caller writes
    back what is there."""
    keep = _keep(slots, num_slots)
    first = torch.argmax(keep.to(torch.uint8))
    rows = torch.where(keep, torch.arange(slots.shape[0], device=slots.device), first)
    return rows, slots[rows].clamp(0, num_slots - 1), keep.any()


def store_kv(
    cache: PagedKVCache,
    k_new: torch.Tensor,  # [rows, H_kv, D_qk]
    v_new: torch.Tensor,  # [rows, H_kv, D_v]
    slots: torch.Tensor,  # [rows] flat slot ids (from flat_slot_ids)
    layout: str = "NHD",
) -> PagedKVCache:
    """Write new K/V rows into the paged cache in place (OOB slots dropped).
    Nothing is read on the host, so a decode step stays free of device-to-host
    copies."""
    if slots.shape[0] == 0:
        return cache
    if layout == "HND":
        h, nb, bs, dk = cache.k.shape
        flats = (cache.k.view(h, nb * bs, dk), cache.v.view(h, nb * bs, cache.v.shape[-1]))
    else:
        nb, bs, h, dk = cache.k.shape
        flats = (cache.k.view(nb * bs, h, dk), cache.v.view(nb * bs, h, cache.v.shape[-1]))
    rows, s, any_kept = _kept_rows(slots, nb * bs)
    for flat, new in zip(flats, (k_new, v_new)):
        new = new[rows].to(flat.dtype)
        if flat.dtype == FP8_DTYPE:  # indexed stores move fp8 as bytes
            flat, new = flat.view(torch.uint8), new.view(torch.uint8)
        if layout == "HND":
            flat[:, s] = torch.where(any_kept, new.transpose(0, 1), flat[:, s])
        else:
            flat[s] = torch.where(any_kept, new, flat[s])
    return cache


def zero_block_tails(
    cache: PagedKVCache,
    seq_lens: torch.Tensor,  # [num_req] total tokens now in cache per request
    block_ids: torch.Tensor,  # [num_req, max_blocks]
    layout: str = "NHD",
) -> PagedKVCache:
    """Zero the unused slots of each request's last block, in place."""
    num_req = seq_lens.shape[0]
    bs = cache.k.shape[1] if layout == "NHD" else cache.k.shape[2]
    seq_lens = seq_lens.long()
    last_pos = (seq_lens - 1).clamp(min=0)
    last_blk = torch.div(last_pos, bs, rounding_mode="floor")
    last_off = last_pos - last_blk * bs
    phys = block_ids[torch.arange(num_req, device=block_ids.device), last_blk].long()
    offs = torch.arange(bs, device=block_ids.device)[None, :]
    ok = (seq_lens > 0)[:, None] & (phys >= 0)[:, None] & (offs > last_off[:, None])
    slots = torch.where(ok, phys[:, None] * bs + offs, torch.full_like(offs, OOB_SLOT))
    slots = slots.reshape(-1)
    # zero bytes are zeros in every cache type; fp8 is indexed as bytes
    kc, vc = (t.view(torch.uint8) if t.dtype == FP8_DTYPE else t for t in cache)
    if layout == "HND":
        h, nb, _, dk = kc.shape
        keep = _keep(slots, nb * bs)
        s = slots[keep]
        kc.view(h, nb * bs, dk)[:, s] = 0
        vc.view(h, nb * bs, vc.shape[-1])[:, s] = 0
        return cache
    nb, _, h, dk = kc.shape
    keep = _keep(slots, nb * bs)
    s = slots[keep]
    kc.view(nb * bs, h, dk)[s] = 0
    vc.view(nb * bs, h, vc.shape[-1])[s] = 0
    return cache


def gather_kv(
    cache: PagedKVCache,
    block_ids: torch.Tensor,  # [num_req, max_blocks]
    max_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather per-request contiguous K/V ``[num_req, max_len, H, D]`` (NHD)."""
    bs = cache.block_size
    num_req = block_ids.shape[0]
    nblk = cdiv(max_len, bs)
    ids = block_ids[:, :nblk].long()
    dead = (ids < 0)[:, :, None, None, None]
    safe = ids.clamp(min=0)
    k = cache.k[safe].masked_fill(dead, 0)
    v = cache.v[safe].masked_fill(dead, 0)
    k = k.reshape(num_req, nblk * bs, *cache.k.shape[2:])[:, :max_len]
    v = v.reshape(num_req, nblk * bs, *cache.v.shape[2:])[:, :max_len]
    return k, v


__all__ = [
    "OOB_SLOT",
    "PagedKVCache",
    "alloc_paged_cache",
    "flat_slot_ids",
    "store_kv",
    "zero_block_tails",
    "gather_kv",
]
