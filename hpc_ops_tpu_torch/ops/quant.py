"""fp8 and int8 quantization helpers (port of ``ops/quant.py``), plain PyTorch.

fp8 is stored as ``torch.float8_e4m3fn`` through the saturating cast of
:func:`hpc_ops_tpu_torch.utils.common.fp8_saturate_cast`; int8 codes are
``clip(round(x / scale), +-127)`` with ``torch.round`` (half to even, as
``jnp.round``). Scales are float32.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch.config import BLOCKWISE_GROUP, FP8_DTYPE, FP8_MAX
from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused
from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast


def _scalar_scale(scale: torch.Tensor) -> torch.Tensor:
    return scale.reshape(()).float()


def _check_group(c: int, group: int) -> None:
    if c % group:
        raise ValueError(f"last dim {c} not a multiple of {group}")


def scaled_fp8_quant(x: torch.Tensor, scale: torch.Tensor | None = None):
    """Per-tensor fp8: y = x / scale, scale = max|x| / FP8_MAX when None.
    Returns (y float8_e4m3fn, scale [1] f32)."""
    xf = x.float()
    if scale is None:
        scale = (xf.abs().max() / FP8_MAX).reshape(1)
    inv = 1.0 / _scalar_scale(scale)
    return fp8_saturate_cast(xf * inv), scale.reshape(1).float()


def scaled_int8_quant(x: torch.Tensor, scale: torch.Tensor | None = None):
    """Per-tensor symmetric int8: y = clip(round(x / s), +-127), s = max|x| / 127
    (+1e-30) when None. Returns (y int8, scale [1] f32)."""
    xf = x.float()
    if scale is None:
        scale = (xf.abs().max() / 127.0 + 1e-30).reshape(1)
    inv = 1.0 / _scalar_scale(scale)
    y = torch.round(xf * inv).clamp(-127, 127).to(torch.int8)
    return y, scale.reshape(1).float()


def fp8_dequant(y: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """x = y * scale."""
    return (y.float() * _scalar_scale(scale)).to(dtype)


def blockwise_fp8_quant(x: torch.Tensor, group: int = BLOCKWISE_GROUP):
    """Per-group (last dim, width ``group``) fp8: scale = max|x_g| / FP8_MAX,
    y = x / (scale + 1e-8). Returns (y [..., C], scales [..., C // group])."""
    *lead, c = x.shape
    _check_group(c, group)
    xf = x.float().reshape(*lead, c // group, group)
    scale = xf.abs().amax(dim=-1) / FP8_MAX
    y = xf / (scale[..., None] + 1e-8)
    return fp8_saturate_cast(y.reshape(*lead, c)), scale


def blockwise_fp8_dequant(
    y: torch.Tensor, scales: torch.Tensor, group: int = BLOCKWISE_GROUP, dtype=torch.float32
) -> torch.Tensor:
    """Inverse of :func:`blockwise_fp8_quant` (the 1e-8 guard included)."""
    *lead, c = y.shape
    yf = y.float().reshape(*lead, c // group, group)
    return (yf * (scales[..., None] + 1e-8)).reshape(*lead, c).to(dtype)


def blockwise_int8_quant(x: torch.Tensor, group: int = BLOCKWISE_GROUP):
    """Per-group symmetric int8: scale = max|x_g| / 127,
    y = clip(round(x / (scale + 1e-30)), +-127). Returns (y int8, scales f32)."""
    *lead, c = x.shape
    _check_group(c, group)
    xf = x.float().reshape(*lead, c // group, group)
    scale = xf.abs().amax(dim=-1) / 127.0
    y = torch.round(xf / (scale[..., None] + 1e-30)).clamp(-127, 127)
    return y.reshape(*lead, c).to(torch.int8), scale


def per_token_per_head_fp8_quant(x: torch.Tensor, upper_max: float = FP8_MAX):
    """fp8 with one scale per (token, head) over the last dim:
    scale = max(max|x| / upper_max, 1e-12), y = x / scale."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / upper_max).clamp(min=1e-12)
    return fp8_saturate_cast(xf / scale[..., None], upper_max), scale


def quantize_kv_fused_int8(k_pages, v_pages, kscale=None, vscale=None):
    """HND [Hkv, nb, bs, D] K and V -> (FUSED int8 [Hkv, nb, 2*bs, D],
    kscale [1], vscale [1])."""
    k8, ks = scaled_int8_quant(k_pages, kscale)
    v8, vs = scaled_int8_quant(v_pages, vscale)
    return pack_kv_fused(k8, v8), ks, vs


__all__ = [
    "scaled_fp8_quant",
    "scaled_int8_quant",
    "quantize_kv_fused_int8",
    "fp8_dequant",
    "blockwise_fp8_quant",
    "blockwise_fp8_dequant",
    "blockwise_int8_quant",
    "per_token_per_head_fp8_quant",
    "FP8_DTYPE",
    "FP8_MAX",
]
