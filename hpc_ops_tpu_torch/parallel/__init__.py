"""Tensor-parallel serving over a (dp, tp) mesh and sequence-parallel
attention (port of ``parallel/``): meshes and rank groups, the fused
all-reduce + residual + RMSNorm, and ring attention. JAX's ``__all__``."""

from hpc_ops_tpu_torch.parallel.collective_kernels import fuse_allreduce_rmsnorm_pallas
from hpc_ops_tpu_torch.parallel.collectives import (
    fuse_allreduce_rmsnorm,
    fuse_allreduce_rmsnorm_ref,
    fuse_allreduce_rmsnorm_sharded,
)
from hpc_ops_tpu_torch.parallel.mesh import make_mesh, tp_sharding
from hpc_ops_tpu_torch.parallel.ring_attention import ring_attention

__all__ = [
    "fuse_allreduce_rmsnorm",
    "fuse_allreduce_rmsnorm_pallas",
    "fuse_allreduce_rmsnorm_sharded",
    "fuse_allreduce_rmsnorm_ref",
    "make_mesh",
    "ring_attention",
    "tp_sharding",
]
