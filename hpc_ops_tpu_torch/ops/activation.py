"""Fused activation + quantization family (port of ``ops/activation.py``).

  - act_mul_and_quant:        y = silu(gate) * up * scale           -> fp8
    (or int8 with ``out_dtype=torch.int8``);
  - masked_act_mul_and_quant: same, but rows beyond num_per_expert within
    each expert's padded slab are zeroed;
  - masked_act_mul_and_blockwise_quant: per-128-group scales
    (scale = max|y|/448, y = y / (scale+1e-8)), masked rows -> 0.
``use_bf16_mul`` rounds silu (computed in float32) to bf16 and multiplies it
with the bf16 up value as a bf16 product before the float32 scaling.

``act_mul_and_quant`` runs the CUDA kernel of ``csrc/activation.cu`` through
:func:`act_quant` (its plain version :func:`act_quant_ref` for CPU tensors);
the two masked variants are plain tensor code here as they are plain jnp in
the JAX package.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import BLOCKWISE_GROUP, FP8_DTYPE, FP8_MAX
from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast


def _act_mul(gate_up: torch.Tensor, use_bf16_mul: bool) -> torch.Tensor:
    """silu(gate) * up in float32, with optional bf16 rounding of the product."""
    c = gate_up.shape[-1] // 2
    gate = gate_up[..., :c].float()
    up = gate_up[..., c:]
    act = gate * torch.sigmoid(gate)
    if use_bf16_mul:
        return (act.to(torch.bfloat16) * up.to(torch.bfloat16)).float()
    return act * up.float()


def _quantise(prod: torch.Tensor, out_dtype) -> torch.Tensor:
    if out_dtype == torch.int8:
        return torch.round(prod).clamp(-127, 127).to(torch.int8)
    return fp8_saturate_cast(prod)


# ---------------------------------------------------------------- references


def act_mul_and_quant_ref(gate_up, scale, use_bf16_mul=True):
    return _quantise(_act_mul(gate_up, use_bf16_mul) * scale.reshape(()).float(), FP8_DTYPE)


def _row_valid(n: int, num_per_expert: torch.Tensor) -> torch.Tensor:
    rows_per_expert = n // num_per_expert.shape[0]
    row = torch.arange(n, dtype=torch.int32, device=num_per_expert.device)
    owner = (row // rows_per_expert).long()
    return (row % rows_per_expert) < num_per_expert[owner]


def masked_act_mul_and_quant_ref(gate_up, scale, num_per_expert, use_bf16_mul=True):
    out = act_mul_and_quant_ref(gate_up, scale, use_bf16_mul)
    valid = _row_valid(gate_up.shape[0], num_per_expert)
    return torch.where(valid[:, None], out.float(), 0.0).to(FP8_DTYPE)


def masked_act_mul_and_blockwise_quant_ref(gate_up, num_per_expert):
    n, two_c = gate_up.shape
    c = two_c // 2
    g = BLOCKWISE_GROUP
    grp = _act_mul(gate_up, use_bf16_mul=False).reshape(n, c // g, g)
    scales = grp.abs().amax(dim=-1) / FP8_MAX
    y = fp8_saturate_cast((grp / (scales[..., None] + 1e-8)).reshape(n, c))
    valid = _row_valid(n, num_per_expert)
    return torch.where(valid[:, None], y.float(), 0.0).to(FP8_DTYPE), scales


# ---------------------------------------------------------------- kernel path


def act_quant_ref(gate_up, scale, use_bf16_mul=True, out_dtype=FP8_DTYPE, num_valid=None):
    """Plain PyTorch version of :func:`act_quant`. Rows at or past
    ``num_valid`` are unspecified in the kernel's output; here they are 0."""
    out = _quantise(_act_mul(gate_up, use_bf16_mul) * scale.reshape(()).float(), out_dtype)
    if num_valid is None:
        return out
    nv = torch.as_tensor(num_valid, device=gate_up.device).reshape(())
    keep = torch.arange(gate_up.shape[0], device=gate_up.device) < nv
    if out_dtype == torch.int8:
        return torch.where(keep[:, None], out, torch.zeros_like(out))
    return torch.where(keep[:, None], out.float(), 0.0).to(out_dtype)


def act_quant(
    gate_up: torch.Tensor,  # [N, 2*C] bf16
    scale: torch.Tensor,  # [1] f32
    use_bf16_mul: bool = True,
    out_dtype=FP8_DTYPE,
    num_valid=None,  # [1] int32 on the device: rows at or past it are skipped
) -> torch.Tensor:
    """silu(gate) * up * scale -> [N, C] float8_e4m3fn or int8.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Rows at or past ``num_valid`` hold anything on the card.
    """
    if gate_up.device.type == "cpu":
        return act_quant_ref(gate_up, scale, use_bf16_mul, out_dtype, num_valid)
    if gate_up.device.type != "cuda":
        raise ValueError(f"act_quant: unsupported device {gate_up.device}")
    if out_dtype not in (FP8_DTYPE, torch.int8):
        raise ValueError(f"act_quant: out_dtype must be float8_e4m3fn or int8, not {out_dtype}")
    n, two_c = gate_up.shape
    c = two_c // 2
    if gate_up.dtype != torch.bfloat16 or not gate_up.is_contiguous() or two_c % 16:
        raise ValueError("act_quant: gate_up must be contiguous bf16 [N, 2*C] with C % 8 == 0")
    sc = scale.reshape(1).to(device=gate_up.device, dtype=torch.float32).contiguous()
    nv_ptr = None
    if num_valid is not None:
        # stays on the device: the kernel reads the count through the pointer
        nv = torch.as_tensor(num_valid, device=gate_up.device).reshape(1)
        nv = nv.to(torch.int32).contiguous()
        nv_ptr = nv.data_ptr()
    out = torch.empty((n, c), dtype=out_dtype, device=gate_up.device)
    rc = kernels.lib().hpc_act_mul_quant(
        gate_up.data_ptr(), sc.data_ptr(), nv_ptr, out.data_ptr(), n, c, int(bool(use_bf16_mul)),
        int(out_dtype == torch.int8), kernels.stream_ptr(gate_up),
    )
    kernels.check(rc, "hpc_act_mul_quant")
    kernels.count(act_quant)
    return out


act_quant.launches = 0


# ---------------------------------------------------------------- public API


def act_mul_and_quant(
    gate_up, scale, use_bf16_mul=True, *, out_dtype=FP8_DTYPE, impl="auto", num_valid=None,
):
    """silu(gate) * up * scale -> fp8_e4m3 (or int8 with out_dtype=torch.int8).

    Args:
      gate_up: [N, 2*C] bfloat16 (gate = first half, up = second half).
      scale: [1] float32 multiplier applied before quantization.
      use_bf16_mul: round the silu(gate)*up product through bf16.
      num_valid: rows at or past it are alignment padding and are skipped
        (``impl="ref"`` computes every row, as the JAX package's does).

    Returns: [N, C] float8_e4m3fn (or int8).
    """
    if impl == "ref":
        return act_quant_ref(gate_up, scale, use_bf16_mul, out_dtype)
    return act_quant(gate_up, scale, use_bf16_mul, out_dtype, num_valid)


def masked_act_mul_and_quant(gate_up, scale, num_per_expert, use_bf16_mul=True):
    """Per-expert-masked act_mul_and_quant.

    gate_up is [num_expert * rows_per_expert, 2*C]; rows at index >=
    num_per_expert[e] within expert e's slab produce 0.
    """
    return masked_act_mul_and_quant_ref(gate_up, scale, num_per_expert, use_bf16_mul)


def masked_act_mul_and_blockwise_quant(gate_up, num_per_expert):
    """Masked act-mul with per-128-group blockwise FP8 quantization.

    Returns (y_fp8 [N, C], scales [N, C//128] float32).
    """
    return masked_act_mul_and_blockwise_quant_ref(gate_up, num_per_expert)


__all__ = [
    "act_mul_and_quant",
    "act_quant",
    "act_quant_ref",
    "masked_act_mul_and_quant",
    "masked_act_mul_and_blockwise_quant",
    "act_mul_and_quant_ref",
    "masked_act_mul_and_quant_ref",
    "masked_act_mul_and_blockwise_quant_ref",
]
