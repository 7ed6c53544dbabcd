"""Fused AllReduce + Residual-add + RMSNorm over a tensor-parallel group (port
of ``parallel/collectives.py``)::

    out_residual = sum_ranks(x) + residual
    out          = bf16(rmsnorm_f32(out_residual)) * weight

:func:`fuse_allreduce_rmsnorm` is the collective the tensor-parallel model
calls, once per rank (``axis_name`` is the rank's
:class:`~hpc_ops_tpu_torch.parallel.mesh.RankGroup`). On a card it launches
the kernel of ``parallel/collective_kernels.py`` with this module's epilogue
(the JAX ``_norm``: the normalised row rounded to bf16, then a bf16 product
with the bf16 weight), summing the partials in absolute rank order in both
modes where JAX's ``psum`` leaves the order open; on the CPU the ranks run
its plain version. :func:`fuse_allreduce_rmsnorm_sharded` drives it over a
mesh from the caller's thread, and :func:`fuse_allreduce_rmsnorm_ref` is the
oracle.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch.parallel.collective_kernels import collective_rmsnorm
from hpc_ops_tpu_torch.parallel.mesh import run_ranks


def _norm(x_f32, weight, eps):
    rms = torch.rsqrt((x_f32 * x_f32).mean(dim=-1, keepdim=True) + eps)
    return (x_f32 * rms).to(torch.bfloat16) * weight.reshape(1, -1).to(torch.bfloat16)


def fuse_allreduce_rmsnorm(
    x: torch.Tensor,
    residual: torch.Tensor,
    weight: torch.Tensor,
    rms_norm_eps: float,
    axis_name="tp",
    mode: str = "two_shot",
):
    """Collective fused allreduce + residual + rmsnorm, called by every rank
    of the group ``axis_name``.

    Args:
      x: [N, H] this rank's partial activations (summed over the group).
      residual: [N, H] replicated residual.
      weight: [H] norm gain.
      mode: "two_shot" (each rank reduces and normalises 1/ws of the rows,
        then every rank gets every chunk; N divisible by ws) or
        "one_shot" (every rank reduces and normalises every row).

    Returns (out [N, H] bf16, out_residual [N, H] bf16), equal on every rank.
    """
    return collective_rmsnorm(axis_name, x, residual, weight, rms_norm_eps, mode, bf16_norm=True)


def fuse_allreduce_rmsnorm_sharded(
    mesh,
    x_parts: torch.Tensor,  # [ws, N, H] per-rank partials (leading dim = ranks)
    residual: torch.Tensor,
    weight: torch.Tensor,
    rms_norm_eps: float = 1e-6,
    axis_name: str = "tp",
    mode: str = "two_shot",
):
    """Standalone entry point: rank r of every tp group of ``mesh`` takes
    ``x_parts[r]`` and runs the fused collective; returns the (out,
    out_residual) of dp shard 0's rank 0 (every rank's are equal)."""
    if axis_name != "tp":
        raise ValueError(f"the port's meshes reduce over the 'tp' axis, not {axis_name!r}")
    if x_parts.shape[0] != mesh.shape["tp"]:
        raise ValueError(f"x_parts holds {x_parts.shape[0]} partials for a tp axis of {mesh.shape['tp']}")

    def rank(group, _):
        dev = group.device
        return fuse_allreduce_rmsnorm(x_parts[group.rank].to(dev), residual.to(dev), weight.to(dev),
                                      rms_norm_eps, group, mode)

    return run_ranks(mesh, rank)[0][0]


def fuse_allreduce_rmsnorm_ref(x_parts, residual, weight, rms_norm_eps=1e-6):
    """Oracle: sum over the leading rank dim, add the residual, norm (float32)."""
    s = x_parts.float().sum(dim=0)
    out_res = s + residual.float()
    return _norm(out_res, weight, rms_norm_eps), out_res.to(torch.bfloat16)


__all__ = [
    "fuse_allreduce_rmsnorm",
    "fuse_allreduce_rmsnorm_sharded",
    "fuse_allreduce_rmsnorm_ref",
]
