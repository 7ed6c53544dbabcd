"""Paged attention of the PyTorch port: decode, prefill and their references."""

from hpc_ops_tpu_torch.ops.attention.decode import (
    attention_decode,
    attention_decode_bf16,
    attention_decode_fp8,
    unpack_tailrow_kscale,
)
from hpc_ops_tpu_torch.ops.attention.prefill import (
    attention_prefill_bf16,
    attention_with_kvcache_prefill,
    attention_with_kvcache_prefill_bf16,
    attention_with_kvcache_prefill_fp8,
)

__all__ = [
    "attention_decode",
    "attention_decode_bf16",
    "attention_decode_fp8",
    "attention_prefill_bf16",
    "attention_with_kvcache_prefill",
    "attention_with_kvcache_prefill_bf16",
    "attention_with_kvcache_prefill_fp8",
    "unpack_tailrow_kscale",
]
