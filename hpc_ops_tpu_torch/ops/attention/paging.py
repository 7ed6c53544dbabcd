"""Paged-cache layout conversions (PyTorch port of ``ops/attention/paging.py``).

"HND" is ``[num_kv_heads, num_blocks, block_size, head_dim]``; "NHD" is
``[num_blocks, block_size, num_kv_heads, head_dim]``. Both return views.
"""

from __future__ import annotations

import torch


def nhd_to_hnd(cache: torch.Tensor) -> torch.Tensor:
    """[num_blocks, bs, H, D] -> [H, num_blocks, bs, D] (a strided view)."""
    return cache.permute(2, 0, 1, 3)


def hnd_to_nhd(cache: torch.Tensor) -> torch.Tensor:
    """[H, num_blocks, bs, D] -> [num_blocks, bs, H, D] (a strided view)."""
    return cache.permute(1, 2, 0, 3)


__all__ = ["nhd_to_hnd", "hnd_to_nhd"]
