"""hpc_ops_tpu_torch: the PyTorch/CUDA port of hpc_ops_tpu for NVIDIA Hopper.

The JAX package ``hpc_ops_tpu`` is the reference; this package mirrors its
module tree and public names: ``import hpc_ops_tpu_torch as hpc;
hpc.attention_decode`` re-exports the ``__all__`` of every ported op module,
as the JAX package's top level does. Plain tensor code is PyTorch; the
kernels of the serving path are CUDA C++ for ``sm_90a`` in ``csrc/``, built
with nvcc and bound with ctypes at first use (see
:mod:`hpc_ops_tpu_torch.kernels`). Every kernel wrapper runs its plain
PyTorch version for CPU tensors and the kernel for CUDA tensors.
"""

import importlib

from hpc_ops_tpu_torch.config import (
    FP8_DTYPE,
    FP8_MAX,
    QKNormPolicy,
    QuantPolicy,
    QuantType,
    SoftmaxPolicy,
)

__version__ = "0.1.0.dev0"

# the modules whose public names the top level re-exports, as the JAX
# package's top level re-exports its op modules and parallel
OP_MODULES = (
    "hpc_ops_tpu_torch.ops.activation",
    "hpc_ops_tpu_torch.ops.attention",
    "hpc_ops_tpu_torch.ops.gemm",
    "hpc_ops_tpu_torch.ops.group_gemm",
    "hpc_ops_tpu_torch.ops.kv_cache",
    "hpc_ops_tpu_torch.ops.moe",
    "hpc_ops_tpu_torch.ops.normalization",
    "hpc_ops_tpu_torch.ops.quant",
    "hpc_ops_tpu_torch.ops.rope",
    "hpc_ops_tpu_torch.ops.sampler",
    "hpc_ops_tpu_torch.ops.stem",
    "hpc_ops_tpu_torch.parallel",
)


def built_json() -> str:
    """Build provenance: the package version, torch's version and the CUDA
    version it was built for, the card torch sees (null without one)."""
    import json

    import torch

    return json.dumps(
        {
            "version": __version__,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
        }
    )


def _export_functions() -> list:
    """Re-export the public names of :data:`OP_MODULES`, the first module to
    name one wins."""
    exported = []
    g = globals()
    for modname in OP_MODULES:
        mod = importlib.import_module(modname)
        for name in mod.__all__:
            if not name.startswith("_") and name not in g:
                g[name] = getattr(mod, name)
                exported.append(name)
    return exported


__all__ = [
    "FP8_DTYPE",
    "FP8_MAX",
    "QKNormPolicy",
    "QuantPolicy",
    "QuantType",
    "SoftmaxPolicy",
    "built_json",
    "__version__",
] + _export_functions()
