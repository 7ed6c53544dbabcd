"""Shared helpers: shape math and the saturating fp8 cast."""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch.config import FP8_DTYPE, FP8_MAX


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def fp8_saturate_cast(x: torch.Tensor, upper_max: float = FP8_MAX) -> torch.Tensor:
    """Clamp to +-upper_max, then cast to float8_e4m3fn (round to nearest even)."""
    return x.float().clamp(-upper_max, upper_max).to(FP8_DTYPE)


__all__ = ["cdiv", "round_up", "fp8_saturate_cast"]
