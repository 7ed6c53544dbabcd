"""Paged-cache layout conversions (PyTorch port of ``ops/attention/paging.py``).

"HND" is ``[num_kv_heads, num_blocks, block_size, head_dim]``; "NHD" is
``[num_blocks, block_size, num_kv_heads, head_dim]``. The fused layouts keep
a page's K rows and V rows in one slab: "FUSED" is head-major
``[H, num_blocks, 2*block_size, D]`` and "NHD_FUSED" slot-leading
``[num_blocks, 2*block_size, H*D]`` (rows ``[0:bs]`` K, ``[bs:2bs]`` V).
``nhd_to_hnd``/``hnd_to_nhd`` and the unpackers return views; the packers
copy.
"""

from __future__ import annotations

import torch


def nhd_to_hnd(cache: torch.Tensor) -> torch.Tensor:
    """[num_blocks, bs, H, D] -> [H, num_blocks, bs, D] (a strided view)."""
    return cache.permute(2, 0, 1, 3)


def hnd_to_nhd(cache: torch.Tensor) -> torch.Tensor:
    """[H, num_blocks, bs, D] -> [num_blocks, bs, H, D] (a strided view)."""
    return cache.permute(1, 2, 0, 3)


def pack_kv_fused(k_pages: torch.Tensor, v_pages: torch.Tensor) -> torch.Tensor:
    """[H, nb, bs, D] x2 -> FUSED [H, nb, 2*bs, D]: rows [0:bs] K, [bs:2bs] V."""
    return torch.cat([k_pages, v_pages], dim=2)


def unpack_kv_fused(kv_pages: torch.Tensor):
    """FUSED [H, nb, 2*bs, D] -> (K, V), each [H, nb, bs, D] (views)."""
    bs = kv_pages.shape[2] // 2
    return kv_pages[:, :, :bs], kv_pages[:, :, bs:]


def pack_kv_fused_nhd(k_pages: torch.Tensor, v_pages: torch.Tensor) -> torch.Tensor:
    """[H, nb, bs, D] x2 -> NHD_FUSED [nb, 2*bs, H*D]: a token's row holds
    every head, and a page's K rows precede its V rows."""
    h, nb, bs, d = k_pages.shape
    k = k_pages.permute(1, 2, 0, 3).reshape(nb, bs, h * d)
    v = v_pages.permute(1, 2, 0, 3).reshape(nb, bs, h * d)
    return torch.cat([k, v], dim=1)


def unpack_kv_fused_nhd(kv_pages: torch.Tensor, num_kv_heads: int):
    """NHD_FUSED [nb, 2*bs, H*D] -> (K, V), each [H, nb, bs, D] (views)."""
    k, v = nhd_fused_views(kv_pages, num_kv_heads)
    return nhd_to_hnd(k), nhd_to_hnd(v)


def nhd_fused_views(kv_pages: torch.Tensor, num_kv_heads: int):
    """NHD_FUSED [nb, 2*bs, H*D] -> NHD views (K, V), each [nb, bs, H, D]:
    the oracle's reading of the slab, a slice and a reshape with no copy."""
    nb, bs2, hd = kv_pages.shape
    bs = bs2 // 2
    d = hd // num_kv_heads
    return (kv_pages[:, :bs].unflatten(2, (num_kv_heads, d)),
            kv_pages[:, bs:].unflatten(2, (num_kv_heads, d)))


__all__ = [
    "nhd_to_hnd",
    "hnd_to_nhd",
    "pack_kv_fused",
    "unpack_kv_fused",
    "pack_kv_fused_nhd",
    "unpack_kv_fused_nhd",
    "nhd_fused_views",
]
