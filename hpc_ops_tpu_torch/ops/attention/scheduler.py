"""Dynamic decode task scheduler (port of ``ops/attention/scheduler.py``):
flat-bin packing of (batch x kv head) KV ranges into uniform work tiles.

A task is a contiguous KV range of one (request, kv head): ``num_tiles``
work tiles of ``tile`` tokens from tile ``tile_start``. The task-map decode
(``attention_decode(task_map=...)``) runs one CUDA block per task, so a long
request is split across many blocks and short ones are not padded to it;
a combine kernel then merges each (request, kv head) segment's partials.

Three interchangeable schedulers give identical maps:
  * ``assign_decode_tasks_np``: numpy on the host (the reference loop);
  * ``assign_decode_tasks_native``: the port's C++ copy
    (``runtime/scheduler.cc``) through ctypes;
  * ``assign_decode_tasks_torch``: vectorised torch on the tensor's device,
    with ``num_tasks`` a 0-d tensor and no read back to the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from hpc_ops_tpu_torch.utils.common import cdiv


class TaskMap(NamedTuple):
    """Flat decode task list (capacity fixed, count on the device).

    Every tensor is int32 with leading dim = capacity; entries past
    ``num_tasks`` are sentinels (batch = -1).
    """

    batch: torch.Tensor  # [T] request index
    head: torch.Tensor  # [T] kv-head index
    tile_start: torch.Tensor  # [T] first work tile (units of tile tokens)
    num_tiles: torch.Tensor  # [T] tiles in this task
    seg: torch.Tensor  # [T] segment id = batch * H + head (for the combine)
    num_tasks: torch.Tensor  # [] int32
    num_segs: int  # B * H
    tile: int = 512  # tokens per work tile (what `tile_start` counts)

    @property
    def capacity(self) -> int:
        return self.batch.shape[0]


def task_capacity(
    max_num_batch: int,
    max_seqlen: int,
    num_head_kv: int,
    tile: int,
    min_tiles: int,
    num_tasks_target: int = 256,
) -> int:
    """Upper bound on the task count: splitting everything at ``min_tiles``
    granularity, or the target-capped packing of about ``num_tasks_target``
    tasks plus at most one partial task per (batch, head). Every sentinel
    task past the count still launches a block that writes neutral
    partials, so an oversized capacity costs time."""
    max_tiles = max_num_batch * num_head_kv * cdiv(max_seqlen, tile)
    fine = cdiv(max_tiles, max(min_tiles, 1)) + max_num_batch * num_head_kv
    packed = num_tasks_target + 2 * max_num_batch * num_head_kv
    return min(fine, packed)


def assign_decode_tasks_np(
    kv_lens: np.ndarray,
    num_head_kv: int,
    capacity: int,
    tile: int = 512,
    num_tasks_target: int = 256,
    min_process_len: int = 4096,
):
    """The scheduler in numpy on the host. Returns ``(batch, head,
    tile_start, num_tiles, seg, num_tasks)``, the arrays int32 [capacity]."""
    b = kv_lens.shape[0]
    tiles = np.maximum((kv_lens + tile - 1) // tile, 1)
    tpt = max(cdiv(int(tiles.sum()) * num_head_kv, num_tasks_target), min_process_len // tile, 1)

    batch = np.full(capacity, -1, np.int32)
    head = np.zeros(capacity, np.int32)
    tile_start = np.zeros(capacity, np.int32)
    num_tiles = np.zeros(capacity, np.int32)
    seg = np.zeros(capacity, np.int32)
    t = 0
    for bi in range(b):
        nb = int(tiles[bi])
        for h in range(num_head_kv):
            start = 0
            while start < nb:
                n = min(tpt, nb - start)
                batch[t] = bi
                head[t] = h
                tile_start[t] = start
                num_tiles[t] = n
                seg[t] = bi * num_head_kv + h
                start += n
                t += 1
    return batch, head, tile_start, num_tiles, seg, t


def assign_decode_tasks_torch(
    kv_lens: torch.Tensor,
    num_head_kv: int,
    capacity: int,
    tile: int = 512,
    num_tasks_target: int = 256,
    min_process_len: int = 4096,
) -> TaskMap:
    """The scheduler vectorised in torch on ``kv_lens``' device: the same
    maps as the numpy and native ones, with no read back to the host."""
    b = kv_lens.shape[0]
    dev = kv_lens.device
    tiles = torch.clamp((kv_lens.to(torch.int32) + tile - 1) // tile, min=1)  # [B]
    total = tiles.sum() * num_head_kv
    tpt = torch.clamp((total + num_tasks_target - 1) // num_tasks_target,
                      min=max(min_process_len // tile, 1)).to(torch.int32)

    # chunks per (b, h): cdiv(tiles[b], tpt), repeated per head
    nc = ((tiles + tpt - 1) // tpt).repeat_interleave(num_head_kv)  # [B*H], b-major
    cu = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                    torch.cumsum(nc, 0).to(torch.int32)])  # [B*H+1]
    num_tasks = cu[-1]

    t = torch.arange(capacity, dtype=torch.int32, device=dev)
    bh = torch.clamp(torch.searchsorted(cu[1:], t, right=True), max=b * num_head_kv - 1).to(torch.int32)
    chunk = t - cu[bh]
    bi = bh // num_head_kv
    hi = bh % num_head_kv
    start = chunk * tpt
    n = torch.minimum(tpt, tiles[bi] - start)
    valid = t < num_tasks
    zero = torch.zeros_like(t)
    return TaskMap(
        batch=torch.where(valid, bi, -1).to(torch.int32),
        head=torch.where(valid, hi, zero),
        tile_start=torch.where(valid, start, zero),
        num_tiles=torch.where(valid, n, zero),
        seg=torch.where(valid, bh, zero),
        num_tasks=num_tasks,
        num_segs=b * num_head_kv,
        tile=tile,
    )


def assign_decode_tasks_native(
    kv_lens: np.ndarray,
    num_head_kv: int,
    capacity: int,
    tile: int = 512,
    num_tasks_target: int = 256,
    min_process_len: int = 4096,
):
    """The C++ scheduler (``runtime/scheduler.cc``) through ctypes; returns
    what :func:`assign_decode_tasks_np` returns (a count of -1 on capacity
    overflow)."""
    from hpc_ops_tpu_torch.runtime import native_lib

    kv = np.ascontiguousarray(kv_lens, np.int32)
    out = [np.zeros(capacity, np.int32) for _ in range(5)]
    out[0][:] = -1

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    n = native_lib().hpc_assign_decode_tasks(
        ptr(kv), kv.shape[0], num_head_kv, capacity, tile, num_tasks_target,
        min_process_len, *map(ptr, out),
    )
    return (*out, n)


def assign_attention_decode_task(
    num_seq_kvcache,
    num_head_kv: int,
    mtp: int = 0,
    new_kv_included: bool = True,
    min_process_len: int = 4096,
    *,
    capacity: int | str | None = None,
    tile: int = 512,
    num_tasks_target: int = 256,
    impl: str = "jnp",
) -> TaskMap:
    """The public scheduler entry: a :class:`TaskMap` for the effective KV
    lengths ``num_seq_kvcache`` (+ mtp + 1 unless ``new_kv_included``).

    ``impl``: "jnp" or "torch" (the vectorised torch scheduler, on the
    lengths' device), "np" or "native" (host schedulers). ``capacity``: the
    task-array length; None bounds it for requests of up to 128K tokens;
    "tight" (host schedulers only: it reads the lengths on the host) sizes
    it to the task count rounded up to 32. The map's tensors lie on
    ``num_seq_kvcache``'s device when that is a tensor, else on the card.
    """
    sq = mtp + 1
    if isinstance(num_seq_kvcache, torch.Tensor):
        dev = num_seq_kvcache.device
        kv_lens = num_seq_kvcache.to(torch.int32)
    else:
        dev = torch.device("cuda")
        kv_lens = torch.as_tensor(np.asarray(num_seq_kvcache, np.int32))
    if not new_kv_included:
        kv_lens = kv_lens + sq
    b = kv_lens.shape[0]
    device_impl = impl in ("jnp", "torch")
    if not device_impl and impl not in ("np", "native"):
        raise ValueError(f"assign_attention_decode_task: unknown impl {impl!r}")
    tight = capacity == "tight"
    if tight:  # schedule at task_capacity's bound (in 32s), then cut to the count in 32s
        if device_impl:
            raise ValueError("capacity='tight' needs a host scheduler (impl='np' or 'native')")
        longest = int(kv_lens.max()) if b else 0
        capacity = cdiv(task_capacity(b, max(longest, 1), num_head_kv, tile, min_process_len // tile,
                                      num_tasks_target), 32) * 32
    if capacity is None:
        capacity = task_capacity(b, 128 * 1024, num_head_kv, tile, min_process_len // tile,
                                 num_tasks_target)
    if device_impl:
        return assign_decode_tasks_torch(kv_lens.to(dev), num_head_kv, capacity, tile,
                                         num_tasks_target, min_process_len)
    fn = assign_decode_tasks_native if impl == "native" else assign_decode_tasks_np
    *arrays, n = fn(kv_lens.cpu().numpy(), num_head_kv, capacity, tile, num_tasks_target,
                    min_process_len)
    if n < 0:
        raise ValueError(f"assign_attention_decode_task: more tasks than capacity {capacity}")
    if tight:
        arrays = [a[: cdiv(n, 32) * 32] for a in arrays]
    batch, head, tile_start, num_tiles, seg = (torch.from_numpy(a).to(dev) for a in arrays)
    return TaskMap(
        batch=batch,
        head=head,
        tile_start=tile_start,
        num_tiles=num_tiles,
        seg=seg,
        num_tasks=torch.tensor(n, dtype=torch.int32, device=dev),
        num_segs=b * num_head_kv,
        tile=tile,
    )


def select_decode_mode(
    kv_lens,
    num_head_kv: int,
    *,
    num_cores: int | None = None,
    skew_threshold: float = 4.0,
) -> str:
    """Choose "grid" or "taskmap" from the kv_lens histogram, with the JAX
    package's heuristic: taskmap iff max_len > skew_threshold * mean_len and
    either the shortest request is at most 512 tokens (a tiny tail) or the
    device has more than one core (``num_cores``; None reads the current
    CUDA device's SM count and raises without a card). The thresholds were
    tuned on a TPU; ``chip_smoke.py``'s decode_sched phase records whether
    the choice is the faster mode on an H100."""
    if num_cores is None:
        if not torch.cuda.is_available():
            raise RuntimeError("select_decode_mode: num_cores=None reads the CUDA device; none found")
        num_cores = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    if isinstance(kv_lens, torch.Tensor):
        kv_lens = kv_lens.cpu().numpy()
    lens = np.asarray(kv_lens, np.int64)
    if lens.size == 0:
        return "grid"
    skewed = lens.max() > skew_threshold * max(lens.mean(), 1.0)
    if num_cores > 1 and skewed:
        return "taskmap"
    if skewed and lens.min() <= 512:
        return "taskmap"
    return "grid"


def get_attention_decode_task_workspace(
    max_num_batch: int,
    max_seqlen: int,
    num_head_kv: int,
    tile: int = 512,
    min_tiles: int = 1,
    num_tasks_target: int = 256,
) -> dict:
    """Workspace accounting for a decode task map: its capacity, the shapes
    of its int32 arrays and their total bytes."""
    cap = task_capacity(
        max_num_batch, max_seqlen, num_head_kv, tile, min_tiles,
        num_tasks_target,
    )
    arrays = {
        "batch": (cap,),
        "head": (cap,),
        "tile_start": (cap,),
        "num_tiles": (cap,),
        "seg": (cap,),
    }
    return {
        "capacity": cap,
        "arrays": arrays,
        "total_bytes": sum(4 * s[0] for s in arrays.values()),
    }


def print_attention_decode_task(tm: TaskMap) -> None:
    """Debug printer of a task map (reads it on the host)."""
    n = int(tm.num_tasks)
    print(
        f"[decode task map] num_tasks={n} capacity={tm.capacity} "
        f"num_segs={tm.num_segs}"
    )
    cols = [x.cpu().tolist() for x in (tm.batch, tm.head, tm.tile_start, tm.num_tiles, tm.seg)]
    for t in range(n):
        bi, h, ts, nt, sg = (c[t] for c in cols)
        print(f"task:{t} ibatch:{bi} ihead_kv:{h} tile_start:{ts} num_tiles:{nt} seg:{sg}")


__all__ = [
    "TaskMap",
    "task_capacity",
    "assign_decode_tasks_np",
    "assign_decode_tasks_torch",
    "assign_decode_tasks_native",
    "assign_attention_decode_task",
    "select_decode_mode",
    "get_attention_decode_task_workspace",
    "print_attention_decode_task",
]
