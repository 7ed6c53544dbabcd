"""Native host runtime of the port: the paged-KV block allocator and the
decode-task scheduler.

``block_allocator.cc`` and ``scheduler.cc`` (the port's own copies) are
compiled with ``g++`` at first use into one library under
``<checkout>/build/runtime/``, named by a hash of both sources, and loaded
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = tuple(os.path.join(_DIR, n) for n in ("block_allocator.cc", "scheduler.cc"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "runtime")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Werror", "-shared")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def build() -> str:
    """Compile the runtime library unless the one for these sources exists."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    so = os.path.join(BUILD_DIR, f"libhpc_runtime_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, "lib.so")
        r = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp_so, *_SOURCES],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError("building the native runtime failed\n" + r.stderr)
        os.replace(tmp_so, so)
    return so


def native_lib() -> ctypes.CDLL:
    """Load (building if needed) the native runtime library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        p32 = ctypes.POINTER(ctypes.c_int32)
        sigs = {
            "hpc_kv_allocator_create": (vp, [i32, i32]),
            "hpc_kv_allocator_destroy": (None, [vp]),
            "hpc_kv_num_free": (i32, [vp]),
            "hpc_kv_extend": (i32, [vp, i64, i64]),
            "hpc_kv_table": (i32, [vp, i64, p32, i32]),
            "hpc_kv_length": (i64, [vp, i64]),
            "hpc_kv_fork": (i32, [vp, i64, i64]),
            "hpc_kv_share_prefix": (i32, [vp, i64, i64, i32]),
            "hpc_kv_cow_last": (i32, [vp, i64, p32]),
            "hpc_kv_free": (i32, [vp, i64]),
            "hpc_assign_decode_tasks": (ctypes.c_int, [p32, *[ctypes.c_int] * 6, *[p32] * 5]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _LIB = lib
        return lib


class PagedBlockAllocator:
    """Paged-KV block allocator (native; see block_allocator.cc).

    Tracks physical cache pages for live sequences: O(1) grow/free,
    refcounted sharing (:meth:`fork`, :meth:`share_prefix`) and copy-on-write
    of a forked sequence's tail block (:meth:`cow_last`). The device caches
    never move; only the page tables handed to the kernels change.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self._lib = native_lib()
        self._h = self._lib.hpc_kv_allocator_create(num_blocks, block_size)
        self.num_blocks = num_blocks
        self.block_size = block_size

    def close(self) -> None:
        if getattr(self, "_h", None) is not None:
            self._lib.hpc_kv_allocator_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    @property
    def num_free(self) -> int:
        return int(self._lib.hpc_kv_num_free(self._h))

    def extend(self, seq: int, num_tokens: int) -> int:
        """Grow `seq` to cover `num_tokens`; returns its block count.

        Raises MemoryError when the pool is exhausted."""
        n = self._lib.hpc_kv_extend(self._h, seq, num_tokens)
        if n < 0:
            raise MemoryError(
                f"KV pool exhausted: seq {seq} needs blocks for "
                f"{num_tokens} tokens, {self.num_free} free"
            )
        return int(n)

    def table(self, seq: int, pad_to: int | None = None) -> np.ndarray:
        """Page table of `seq` as int32, padded to pad_to with -1.

        Padding is -1, not 0: page 0 is a real page, and every consumer (rope
        store, decode, prefill) drops or masks negative page ids."""
        n = self._lib.hpc_kv_table(self._h, seq, None, 0)
        if n < 0:
            raise KeyError(f"unknown sequence {seq}")
        out = np.full(max(n, pad_to or 0), -1, np.int32)
        self._lib.hpc_kv_table(
            self._h, seq, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n
        )
        return out

    def length(self, seq: int) -> int:
        n = self._lib.hpc_kv_length(self._h, seq)
        if n < 0:
            raise KeyError(f"unknown sequence {seq}")
        return int(n)

    def fork(self, parent: int, child: int) -> int:
        """Share all of parent's blocks with child (copy-on-write)."""
        n = self._lib.hpc_kv_fork(self._h, parent, child)
        if n < 0:
            raise KeyError(f"cannot fork {parent} -> {child}")
        return int(n)

    def share_prefix(self, parent: int, child: int, num_blocks: int) -> int:
        """Share parent's first num_blocks fully written blocks with a new
        sequence `child` (read-only for the child)."""
        n = self._lib.hpc_kv_share_prefix(self._h, parent, child, num_blocks)
        if n < 0:
            raise KeyError(f"cannot share {num_blocks} blocks of {parent} -> {child}")
        return int(n)

    def cow_last(self, seq: int) -> tuple[int, int]:
        """Make seq's tail block exclusive. Returns (block, copied_from);
        copied_from is -1 when no copy was needed."""
        src = ctypes.c_int32(-1)
        blk = self._lib.hpc_kv_cow_last(self._h, seq, ctypes.byref(src))
        if blk == -2:
            raise MemoryError("KV pool exhausted during copy-on-write")
        if blk < 0:
            raise KeyError(f"unknown or empty sequence {seq}")
        return int(blk), int(src.value)

    def free(self, seq: int) -> int:
        n = self._lib.hpc_kv_free(self._h, seq)
        if n < 0:
            raise KeyError(f"unknown sequence {seq}")
        return int(n)


__all__ = ["PagedBlockAllocator", "native_lib", "build"]
