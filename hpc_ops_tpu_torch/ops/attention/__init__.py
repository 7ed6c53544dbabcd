"""Paged attention of the PyTorch port: decode, prefill, their references and
the decode task scheduler."""

from hpc_ops_tpu_torch.ops.attention.decode import (
    attention_decode,
    attention_decode_bf16,
    attention_decode_fp8,
    unpack_tailrow_kscale,
)
from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused, unpack_kv_fused
from hpc_ops_tpu_torch.ops.attention.prefill import (
    attention_prefill_bf16,
    attention_with_kvcache_blocksparse_prefill_fp8,
    attention_with_kvcache_prefill,
    attention_with_kvcache_prefill_bf16,
    attention_with_kvcache_prefill_fp8,
)
from hpc_ops_tpu_torch.ops.attention.reference import (
    attention_decode_ref,
    attention_prefill_bf16_ref,
    attention_with_kvcache_prefill_ref,
    mha_varlen_prefill_ref,
)
from hpc_ops_tpu_torch.ops.attention.scheduler import (
    TaskMap,
    assign_attention_decode_task,
    get_attention_decode_task_workspace,
    print_attention_decode_task,
    select_decode_mode,
    task_capacity,
)

__all__ = [
    "attention_decode",
    "attention_decode_bf16",
    "attention_decode_fp8",
    "unpack_tailrow_kscale",
    "pack_kv_fused",
    "unpack_kv_fused",
    "attention_prefill_bf16",
    "attention_with_kvcache_prefill",
    "attention_with_kvcache_prefill_bf16",
    "attention_with_kvcache_prefill_fp8",
    "attention_with_kvcache_blocksparse_prefill_fp8",
    "attention_decode_ref",
    "attention_prefill_bf16_ref",
    "attention_with_kvcache_prefill_ref",
    "mha_varlen_prefill_ref",
    "TaskMap",
    "task_capacity",
    "select_decode_mode",
    "get_attention_decode_task_workspace",
    "assign_attention_decode_task",
    "print_attention_decode_task",
]
