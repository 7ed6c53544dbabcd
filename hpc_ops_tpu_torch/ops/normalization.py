"""RMSNorm (port of ``ops/normalization.py:rmsnorm_ref``).

The fused RMSNorm + fp8 kernel of the JAX package is a later slice.
"""

from __future__ import annotations

import torch


def rmsnorm_ref(x, weight, eps=1e-6):
    """Plain RMSNorm in float32: x * rsqrt(mean(x^2) + eps) * weight."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out


__all__ = ["rmsnorm_ref"]
