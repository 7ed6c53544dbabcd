"""RMSNorm and the fused RMSNorm + scale -> fp8 (port of
``ops/normalization.py``).

``fused_rmsnorm_with_scale`` normalises each row in float32, ``norm = x *
rsqrt(mean(x^2) + eps) * weight``, and emits ``e4m3(clip(norm / scale[0],
+-448))``; with ``is_moe`` it returns ``(norm, e4m3(norm / scale[0]),
e4m3(norm / scale[1]))`` for the shared and routed MoE branches. On the
card the kernel is ``csrc/normalization.cu`` (:func:`rmsnorm_quant`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import FP8_DTYPE, FP8_MAX
from hpc_ops_tpu_torch.ops.rope_kernel import _align

_F32_EPS = float(torch.finfo(torch.float32).eps)

NORM_THREADS = 256  # csrc/normalization.cu kThreads: one block a row


def rmsnorm_ref(x, weight, eps=1e-6):
    """Plain RMSNorm in float32: x * rsqrt(mean(x^2) + eps) * weight."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out


def fused_rmsnorm_with_scale_ref(a, weight, eps=_F32_EPS, scale=None, is_moe=False):
    """The JAX package's reference: RMSNorm, then ``norm / scale`` clipped to
    +-448 and cast to e4m3 (round to nearest even)."""
    if scale is None:
        scale = torch.ones((1,), dtype=torch.float32, device=a.device)
    norm = rmsnorm_ref(a, weight, eps)
    sc = scale.float()
    y0 = (norm / sc[0]).clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    if is_moe:
        y1 = (norm / sc[1]).clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
        return norm, y0, y1
    return y0


def _rmsnorm_quant_ref(a, weight, scale, eps, is_moe):
    """Plain PyTorch version of :func:`rmsnorm_quant`, as the JAX kernel
    computes: the row's sum of squares in float64 (each square of a bf16
    value has 16 significant bits, so the sum is exact, whatever its order,
    unless the row's squares span more than 53 bits), ``x * (1 / sqrt(mean +
    eps)) * weight`` in float32, then the product with the float32
    reciprocal of each scale."""
    xf = a.float()
    mean = ((xf.double() * xf.double()).sum(dim=-1, keepdim=True) / a.shape[-1]).float()
    norm = xf * (1.0 / torch.sqrt(mean + eps)) * weight.float()
    inv = 1.0 / scale.float()
    y0 = (norm * inv[0]).clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    if not is_moe:
        return y0
    return norm, y0, (norm * inv[1]).clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)


class NormForm(NamedTuple):
    vec: int  # elements a thread and load: 8 (16 bytes of bf16), 4, 2 or 1
    threads: int  # a block: one row
    blocks: int


@functools.lru_cache(maxsize=1024)
def norm_form(n: int, h: int, a_align: int = 16, w_align: int = 16, w_elem: int = 2) -> NormForm:
    """The RMSNorm + fp8 kernel's form for ``n`` rows of ``h`` (a multiple
    of 8) with ``a`` aligned to ``a_align`` bytes and the weight (``w_elem``
    bytes an element) to ``w_align``: ``vec`` is the widest word both
    pointers allow (a float32 weight's word loads at most 16 bytes at once),
    a block of NORM_THREADS threads a row, each thread every NORM_THREADS-th
    word of it (every multiple of 8 takes every word: ``h`` does not
    change the form)."""
    vec = next(v for v in (8, 4, 2, 1) if 2 * v <= a_align and min(16, w_elem * v) <= w_align)
    return NormForm(vec, NORM_THREADS, n)


def rmsnorm_quant(
    a: torch.Tensor,  # [n, h] bf16
    weight: torch.Tensor,  # [h] (or [1, h]) bf16 or float32
    scale: torch.Tensor,  # [1], or [2] with is_moe, float32
    eps: float,
    is_moe: bool,
):
    """RMSNorm + e4m3 quantisation of each row: ``e4m3(norm / scale[0])``, or
    with ``is_moe`` ``(norm float32, e4m3(norm / scale[0]), e4m3(norm /
    scale[1]))``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch a call) or raise. A bf16 or float32 weight is read in its own
    type; inputs already in the kernel's types and layouts pass unconverted.
    """
    name = "rmsnorm_quant"
    if not a.is_cuda:
        if a.device.type == "cpu":
            return _rmsnorm_quant_ref(a, weight, scale, eps, is_moe)
        raise ValueError(f"{name}: unsupported device {a.device}")
    if a.dim() != 2 or a.dtype != torch.bfloat16 or not a.is_contiguous():
        raise ValueError(f"{name}: a must be contiguous bf16 [n, h]")
    n, h = a.shape
    if h % 8 or weight.numel() != h or scale.numel() < (2 if is_moe else 1):
        raise ValueError(f"{name}: the kernel takes h a multiple of 8, weight [h] and one scale per output")
    dev = a.get_device()
    if weight.get_device() != dev or scale.get_device() != dev:
        raise ValueError(f"{name}: all tensors must be on one device")
    w = weight
    if w.dtype not in (torch.bfloat16, torch.float32) or not w.is_contiguous():
        w = w.float().contiguous()
    sc = scale
    if sc.dtype != torch.float32 or not sc.is_contiguous():
        sc = sc.float().contiguous()
    w_ptr = w.data_ptr()
    f = norm_form(n, h, _align(a.data_ptr()), _align(w_ptr), w.element_size())
    y0 = torch.empty((n, h), dtype=FP8_DTYPE, device=a.device)
    norm = y1 = None
    if is_moe:
        norm = torch.empty((n, h), dtype=torch.float32, device=a.device)
        y1 = torch.empty((n, h), dtype=FP8_DTYPE, device=a.device)
    rc = kernels.lib().hpc_rmsnorm_quant(
        a.data_ptr(), w_ptr, w.element_size() == 4, sc.data_ptr(), y0.data_ptr(),
        None if norm is None else norm.data_ptr(), None if y1 is None else y1.data_ptr(),
        n, h, float(eps), f.vec, kernels.stream_ptr(a),
    )
    kernels.check(rc, "hpc_rmsnorm_quant")
    kernels.count(rmsnorm_quant)
    return (norm, y0, y1) if is_moe else y0


rmsnorm_quant.launches = 0


def fused_rmsnorm_with_scale(a, weight, eps=_F32_EPS, scale=None, is_moe=False, *, impl="auto"):
    """RMSNorm, then divide by the scale(s), emitting e4m3.

    Args:
      a: [batch, hidden] bf16 input.
      weight: [hidden] (or [1, hidden]) RMSNorm gain.
      eps: variance epsilon (default: float32's machine epsilon).
      scale: [1] (is_moe=False) or [2] (is_moe=True) float32 divisors.
      is_moe: return (norm float32, e4m3(norm/scale[0]), e4m3(norm/scale[1])).
      impl: "ref" runs the JAX package's reference (a true division).

    Returns: the e4m3 tensor, or the 3-tuple with ``is_moe``.
    """
    if scale is None:
        scale = torch.ones((2 if is_moe else 1,), dtype=torch.float32, device=a.device)
    weight = weight.reshape(-1)
    if impl == "ref":
        return fused_rmsnorm_with_scale_ref(a, weight, eps, scale, is_moe)
    return rmsnorm_quant(a, weight, scale.reshape(-1), float(eps), bool(is_moe))


__all__ = ["fused_rmsnorm_with_scale", "fused_rmsnorm_with_scale_ref", "rmsnorm_ref"]
