"""Configuration enums and constants (PyTorch port of ``hpc_ops_tpu.config``).

The enums carry the same names and values as the JAX package so that a call
can be written once and sent to either package.
"""

from __future__ import annotations

import enum

import torch


class QuantType(enum.IntEnum):
    """FP8 attention quantization schemes (same values as the JAX package)."""

    QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD = 0
    QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR = 1
    QPERTENSOR_KPERTENSOR_VPERTENSOR = 2
    QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD_QKHADAMARD = 3


class SoftmaxPolicy(enum.IntEnum):
    """Where (if anywhere) the fused sampler runs softmax."""

    NONE = 0
    BEFORE_TOPK = 1
    AFTER_TOPK = 2


class QKNormPolicy(enum.IntEnum):
    """RMSNorm placement relative to RoPE."""

    NONE = 0
    ROPE_THEN_NORM = 1
    NORM_THEN_ROPE = 2


class QuantPolicy(enum.IntEnum):
    """Q quantization mode for the fp8 RoPE store."""

    DYNAMIC_Q_STATIC_KV = 1
    STATIC_Q_STATIC_KV = 2


# FP8 E4M3 saturation bound (finfo(float8_e4m3fn).max == 448).
FP8_MAX = 448.0
FP8_DTYPE = torch.float8_e4m3fn

# Default blockwise-quantization group width.
BLOCKWISE_GROUP = 128

# Minimum work tile of the dynamic decode scheduler in KV tokens.
DECODE_SCHED_TILE = 256

__all__ = [
    "QuantType",
    "SoftmaxPolicy",
    "QKNormPolicy",
    "QuantPolicy",
    "FP8_MAX",
    "FP8_DTYPE",
    "BLOCKWISE_GROUP",
    "DECODE_SCHED_TILE",
]
