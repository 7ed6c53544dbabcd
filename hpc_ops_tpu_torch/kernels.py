"""Build and bind the port's CUDA kernels.

The sources in ``csrc/*.cu`` each export a plain C launcher. At first use
they are compiled by ``nvcc`` for ``sm_90a`` (one process per source, all
started together) and linked into one shared library under
``<checkout>/build/kernels/``, named by a hash of the sources and flags so a
changed source is rebuilt and an unchanged one is loaded as it is. The
library is bound with ``ctypes``; nothing here includes PyTorch's headers.

Each launcher takes raw device pointers, sizes, strides and the CUDA stream
as Python ints and returns the ``cudaError_t`` of its launch; the wrappers in
the op modules raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("rope_store.cu", "decode.cu", "prefill.cu", "group_gemm.cu", "activation.cu", "moe.cu",
           "normalization.cu", "gemm.cu", "collective.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "hpc_rope_store_bf16": [_P] * 10 + [_I] * 8 + [_I64] * 5 + [_I, _P],
    "hpc_rope_store_int8": [_P] * 11 + [_I] * 8 + [_I64, _I, _P],
    "hpc_paged_decode": [_P] * 3 + [_I] + [_I64] * 6 + [_P] * 5 + [_I] * 8 + [_F, _P],
    "hpc_paged_decode_qt0": [_P] * 3 + [_I64] * 6 + [_P] * 5 + [_I] * 9 + [_F, _P],
    "hpc_paged_decode_nhd_fused": [_P, _P, _I] + [_P] * 5 + [_I] * 7 + [_F, _P],
    "hpc_paged_decode_tasks": ([_P] * 3 + [_I] + [_I64] * 6 + [_P] * 5 + [_I] * 2 + [_P] * 5
                               + [_I] * 7 + [_F, _P]),
    "hpc_decode_combine": [_P] * 5 + [_I] + [_P] * 2 + [_I] * 5 + [_P],
    "hpc_paged_prefill": [_P] * 3 + [_I] + [_I64] * 6 + [_P] * 7 + [_I] * 10 + [_F, _P],
    "hpc_paged_prefill_nhd_fused": [_P, _P, _I] + [_P] * 6 + [_I] * 8 + [_F, _P],
    "hpc_paged_prefill_sparse": [_P] * 3 + [_I] + [_I64] * 6 + [_P] * 8 + [_I] * 14 + [_F, _P],
    "hpc_gg_scatter_e4m3": [_P] * 7 + [_I] * 4 + [_P],
    "hpc_gg_scatter_i8": [_P] * 7 + [_I] * 4 + [_P],
    "hpc_gg_scatter_i8_act": [_P] * 8 + [_I] * 6 + [_P],
    "hpc_gg_pertensor": [_P] * 7 + [_I] * 5 + [_P],
    "hpc_gg_bw_scatter_i8": [_P] * 8 + [_I] * 6 + [_P],
    "hpc_gg_bw_scatter_e4m3": [_P] * 8 + [_I] * 6 + [_P],
    "hpc_gg_bw_aligned_i8": [_P] * 8 + [_I] * 6 + [_P],
    "hpc_gg_bw_aligned_e4m3": [_P] * 8 + [_I] * 6 + [_P],
    "hpc_act_mul_quant": [_P] * 4 + [_I] * 4 + [_P],
    "hpc_moe_reduce": [_P] * 5 + [_I] * 3 + [_P],
    "hpc_rmsnorm_quant": [_P] * 6 + [_I] * 2 + [_F, _P],
    "hpc_route_gemm": [_P] * 5 + [_I] * 4 + [_P],
    "hpc_allreduce_rmsnorm": [_P] * 6 + [ctypes.c_uint64, _P] + [_I] * 3 + [_F] + [_I] * 3 + [_P],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def find_nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libhpc_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile and link the kernels unless the library for these sources
    exists. Returns the library path."""
    so = library_path()
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC_DIR, name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, _, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so, *(o for _, o, _ in procs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        os.replace(tmp_so, so)
    return so


def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for fn, argtypes in _SIGNATURES.items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _LIB = handle
    return _LIB


_COUNT_LOCK = threading.Lock()


def count(wrapper) -> None:
    """Add one to a wrapper's ``launches`` (under a lock: tensor-parallel
    ranks launch from several threads)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def wrappers() -> dict:
    """The kernel wrappers by name; each carries a plain-int ``launches``."""
    from hpc_ops_tpu_torch.ops.attention.decode import (
        decode_combine,
        paged_decode_attention,
        paged_decode_nhd_fused,
        paged_decode_qt0,
        paged_decode_tasks,
    )
    from hpc_ops_tpu_torch.ops.attention.prefill import (
        paged_prefill_attention,
        paged_prefill_nhd_fused,
        paged_prefill_sparse,
    )
    from hpc_ops_tpu_torch.ops.activation import act_quant
    from hpc_ops_tpu_torch.ops.group_gemm import (
        gg_bw_aligned,
        gg_bw_scatter,
        gg_pertensor,
        gg_scatter,
        gg_scatter_i8,
        gg_scatter_i8_act,
    )
    from hpc_ops_tpu_torch.ops.gemm import route_gemm
    from hpc_ops_tpu_torch.ops.moe import moe_reduce
    from hpc_ops_tpu_torch.ops.normalization import rmsnorm_quant
    from hpc_ops_tpu_torch.ops.rope_kernel import rope_store_rows, rope_store_rows_int8
    from hpc_ops_tpu_torch.parallel.collective_kernels import allreduce_rmsnorm

    return {
        "rope_store": rope_store_rows,
        "paged_decode": paged_decode_attention,
        "paged_prefill": paged_prefill_attention,
        "rope_store_int8": rope_store_rows_int8,
        "paged_decode_nhd_fused": paged_decode_nhd_fused,
        "paged_prefill_nhd_fused": paged_prefill_nhd_fused,
        "gg_scatter": gg_scatter,
        "act_quant": act_quant,
        "moe_reduce": moe_reduce,
        "paged_decode_qt0": paged_decode_qt0,
        "gg_scatter_i8": gg_scatter_i8,
        "gg_scatter_i8_act": gg_scatter_i8_act,
        "gg_pertensor": gg_pertensor,
        "gg_bw_scatter": gg_bw_scatter,
        "gg_bw_aligned": gg_bw_aligned,
        "paged_decode_tasks": paged_decode_tasks,
        "decode_combine": decode_combine,
        "paged_prefill_sparse": paged_prefill_sparse,
        "rmsnorm_quant": rmsnorm_quant,
        "route_gemm": route_gemm,
        "allreduce_rmsnorm": allreduce_rmsnorm,
    }


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


__all__ = [
    "BUILD_DIR",
    "SOURCES",
    "build",
    "lib",
    "check",
    "count",
    "stream_ptr",
    "wrappers",
    "reset_launch_counts",
    "launch_counts",
]
