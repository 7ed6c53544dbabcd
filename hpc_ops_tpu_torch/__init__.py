"""hpc_ops_tpu_torch: the PyTorch/CUDA port of hpc_ops_tpu for NVIDIA Hopper.

The JAX package ``hpc_ops_tpu`` is the reference; this package mirrors its
module tree and public names. Plain tensor code is PyTorch; the kernels of
the serving path are CUDA C++ for ``sm_90a`` in ``csrc/``, built with nvcc
and bound with ctypes at first use (see :mod:`hpc_ops_tpu_torch.kernels`).
Every kernel wrapper runs its plain PyTorch version for CPU tensors and the
kernel for CUDA tensors.
"""

from hpc_ops_tpu_torch.config import (
    FP8_DTYPE,
    FP8_MAX,
    QKNormPolicy,
    QuantPolicy,
    QuantType,
    SoftmaxPolicy,
)

__version__ = "0.1.0.dev0"

__all__ = [
    "FP8_DTYPE",
    "FP8_MAX",
    "QKNormPolicy",
    "QuantPolicy",
    "QuantType",
    "SoftmaxPolicy",
    "__version__",
]
