"""Tensor-parallel serving over a (dp, tp) mesh (port of ``parallel/``):
meshes and rank groups, the fused all-reduce + residual + RMSNorm. JAX's
``__all__`` but ``ring_attention``, which is not ported (it raises)."""

from hpc_ops_tpu_torch.parallel.collective_kernels import fuse_allreduce_rmsnorm_pallas
from hpc_ops_tpu_torch.parallel.collectives import (
    fuse_allreduce_rmsnorm,
    fuse_allreduce_rmsnorm_ref,
    fuse_allreduce_rmsnorm_sharded,
)
from hpc_ops_tpu_torch.parallel.mesh import make_mesh, tp_sharding


def ring_attention(*args, **kwargs):
    """Ring attention over a sequence-parallel axis is not ported."""
    raise NotImplementedError("ring_attention is not ported yet: ROADMAP queue 1 item 8 (multi-GPU)")


__all__ = [
    "fuse_allreduce_rmsnorm",
    "fuse_allreduce_rmsnorm_pallas",
    "fuse_allreduce_rmsnorm_sharded",
    "fuse_allreduce_rmsnorm_ref",
    "make_mesh",
    "tp_sharding",
]
