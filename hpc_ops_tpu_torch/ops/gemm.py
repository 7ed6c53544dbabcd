"""Route GEMM: a float32-accurate product through split bf16 weights (port
of ``ops/gemm.py``).

The float32 weight is split as ``w_high = bf16(w)``, ``w_low = bf16((w -
w_high) / scale)`` with scale 2^-8, and ``gemm_bf16xfp32`` computes ``x @
(w_high + scale * w_low)^T`` as two bf16 products with float32 sums, fed by
one load of each x tile (``csrc/gemm.cu``, :func:`route_gemm`): MoE router
projections, where a bf16 weight would misroute tokens.

``use_splitk``, ``split_flag``, ``tm``, ``tn`` and ``tk`` are accepted for
the JAX package's signature and unused.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.utils.common import cdiv


def gemm_bf16xfp32_ref(x, w_high, w_low, scale, use_fp32_output=False):
    """The JAX package's reference: ``x @ (w_high + w_low * scale)^T`` in float32."""
    w = w_high.float() + w_low.float() * torch.as_tensor(scale, dtype=torch.float32,
                                                          device=w_low.device).reshape(())
    out = x.float() @ w.T
    return out if use_fp32_output else out.to(torch.bfloat16)


def _route_gemm_ref(x, w_high, w_low, scale, use_fp32_output):
    """Plain PyTorch version of :func:`route_gemm`: two float32 products
    (sums of exact bf16 products) and ``hi + scale * lo``, as the kernel."""
    xf = x.float()
    out = xf @ w_high.float().T + scale.float().reshape(()) * (xf @ w_low.float().T)
    return out if use_fp32_output else out.to(torch.bfloat16)


def route_gemm(
    x: torch.Tensor,  # [m, k] bf16
    w_high: torch.Tensor,  # [n, k] bf16
    w_low: torch.Tensor,  # [n, k] bf16
    scale: torch.Tensor,  # [1] float32
    use_fp32_output: bool,
) -> torch.Tensor:
    """``x @ w_high^T + scale * (x @ w_low^T)`` with float32 sums; [m, n]
    bf16, or float32 with ``use_fp32_output``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    name = "route_gemm"
    if x.device.type == "cpu":
        return _route_gemm_ref(x, w_high, w_low, scale, use_fp32_output)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    m, k = x.shape
    n = w_high.shape[0]
    for t in (x, w_high, w_low):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: x and the weights must be contiguous, 16-byte aligned bf16")
    if tuple(w_high.shape) != (n, k) or tuple(w_low.shape) != (n, k) or k % 8:
        raise ValueError(f"{name}: weights must be [n, {k}] with k a multiple of 8")
    for t in (w_high, w_low, scale):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    sc = scale.reshape(-1)[:1].float().contiguous()
    out = torch.empty((m, n), dtype=torch.float32 if use_fp32_output else torch.bfloat16,
                      device=x.device)
    rc = kernels.lib().hpc_route_gemm(
        x.data_ptr(), w_high.data_ptr(), w_low.data_ptr(), sc.data_ptr(), out.data_ptr(), m, n, k,
        int(bool(use_fp32_output)), kernels.stream_ptr(x),
    )
    kernels.check(rc, "hpc_route_gemm")
    kernels.count(route_gemm)
    return out


route_gemm.launches = 0


def gemm_bf16xfp32(
    x,
    w_high,
    w_low,
    scale,
    use_fp32_output: bool = False,
    use_splitk: bool = True,
    split_flag=None,
    *,
    tm: int = 256,
    tn: int = 256,
    tk: int = 512,
    impl: str = "auto",
):
    """Float32-accurate GEMM through two fused bf16 GEMMs.

    Args:
      x: [m, k] bf16 activations.
      w_high: [n, k] bf16, the high bits of the float32 weight.
      w_low: [n, k] bf16, the residual divided by ``scale``.
      scale: a [1] float32 tensor or a number (typically 1/256).
      use_fp32_output: return float32 instead of bf16.
      use_splitk, split_flag, tm, tn, tk: accepted, unused.
      impl: "ref" runs the JAX package's reference.

    Returns: [m, n] bf16 or float32.
    """
    del use_splitk, split_flag, tm, tn, tk
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor([scale], dtype=torch.float32, device=x.device)
    if impl == "ref":
        return gemm_bf16xfp32_ref(x, w_high, w_low, scale, use_fp32_output)
    return route_gemm(x, w_high, w_low, scale, use_fp32_output)


def split_fp32_weight(w_fp32: torch.Tensor, scale: float = 1.0 / 256):
    """``(w_high, w_low, scale)`` from a float32 weight."""
    w_high = w_fp32.to(torch.bfloat16)
    w_low = ((w_fp32 - w_high.float()) / scale).to(torch.bfloat16)
    return w_high, w_low, torch.tensor([scale], dtype=torch.float32, device=w_fp32.device)


def get_gemm_bf16xfp32_workspace(max_weight_hidden_size: int, max_tokens: int = 131072,
                                 device="cuda"):
    """The reference's split-flag workspace, ``[cdiv(max_tokens, 16),
    cdiv(max_weight_hidden_size, 64)]`` int32 zeros on ``device`` (the card
    unless the caller asks for the CPU); this GEMM needs none."""
    return torch.zeros((cdiv(max_tokens, 16), cdiv(max_weight_hidden_size, 64)), dtype=torch.int32,
                       device=device)


__all__ = [
    "gemm_bf16xfp32",
    "gemm_bf16xfp32_ref",
    "split_fp32_weight",
    "get_gemm_bf16xfp32_workspace",
]
