"""Fused all-reduce + residual + RMSNorm over a tensor-parallel group (port
of ``parallel/collective_kernels.py``).

Each rank of a group holds a partial ``x`` [N, H]; every rank gets
``out_res = sum_s x_s + residual`` and ``out = rmsnorm(out_res) * weight``,
both [N, H] bf16 and bitwise equal across the ranks, from one of the TPU
kernel's two schedules:

  * ``one_shot``: every rank sums all partials in absolute rank order
    (0 + x_0 + x_1 + ...), adds the residual and normalises every row;
  * ``two_shot``: rank r owns rows [r*C, (r+1)*C), C = N / ws (N divisible
    by ws; :func:`fuse_allreduce_rmsnorm_pallas` asks for 8 * ws, as the TPU
    kernel does): it starts from its own partial, adds the others in absolute
    order skipping r, normalises its chunk and writes both outputs of the
    chunk into every rank's outputs.

On a card the kernel is ``csrc/collective.cu`` in one of two forms:

  * :func:`allreduce_rmsnorm`: one cooperative launch serves all ranks of a
    group that share the device (see :mod:`hpc_ops_tpu_torch.parallel.mesh`
    for the rank threads);
  * :func:`allreduce_rmsnorm_rank`, the per-device form, for a group whose
    ranks lie on more than one device (one launch cannot span devices): a
    launch a rank on the rank's stream, each reducing its share of the rows
    (one_shot rows r, r + ws, ...; two_shot its chunk) and reading its
    peers' partials in place. The streams are ordered by events: each
    launch after every rank's arrival, each rank's later work after every
    launch. The mesh's private ``_per_device`` switch forces this form over
    virtual ranks (tests and ``chip_smoke.py``).

In both, the block that reduces a row writes it into every rank's outputs,
so one_shot reads each partial once for the whole group, not once a rank,
and each row is summed in the same order, so the two forms agree bit for
bit. Their plain versions, :func:`_allreduce_rmsnorm_ref` and
:func:`_allreduce_rmsnorm_ref_rank`, repeat the kernel's order of every
float32 sum, so on the same inputs kernel and plain version agree bit for
bit; CPU ranks run them. Two epilogues: the TPU kernel's ``bf16((out_res * rms) * w)``, and
(``bf16_norm``) the one of ``parallel/collectives.py``, ``bf16(out_res *
rms) * bf16(w)`` in bf16.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from hpc_ops_tpu_torch import kernels

MODES = ("one_shot", "two_shot")
MAX_RANKS = 8  # the kernel's rank table
_THREADS = 128  # the kernel's threads per row, each owning chunks of 8 columns


def _row_mean_square(r: torch.Tensor) -> torch.Tensor:
    """mean(r * r) over the last dim of a float32 [n, h], summed in the
    kernel's order: thread t of 128 adds the squares of its 8-column chunks
    t, t + 128, ... in column order; each warp's 32 lanes are added by
    halving; the 4 warp sums as (w0 + w2) + (w1 + w3); then one correctly
    rounded division by h."""
    n, h = r.shape
    k = -(-(h // 8) // _THREADS)
    sq = torch.nn.functional.pad(r * r, (0, k * _THREADS * 8 - h)).view(n, k, _THREADS, 8)
    p = torch.zeros((n, _THREADS), dtype=torch.float32, device=r.device)
    for kk in range(k):
        for j in range(8):
            p = p + sq[:, kk, :, j]
    v = p.view(n, _THREADS // 32, 32)
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    w = v[..., 0]
    total = (w[:, 0] + w[:, 2]) + (w[:, 1] + w[:, 3])
    # a tensor divisor: on a card torch multiplies by the reciprocal of a scalar one
    return (total / torch.full_like(total, h))[:, None]


def _allreduce_rmsnorm_ref(xs, residual, weight, eps, mode, bf16_norm):
    """Plain PyTorch version of :func:`allreduce_rmsnorm` for one rank's
    outputs (all ranks' are the same), in the kernel's summation order and
    rounding, each step correctly rounded on the CPU and on a card alike:
    returns (out, out_res), both [N, H] bf16."""
    ws = len(xs)
    n, h = xs[0].shape
    if mode == "one_shot":
        acc = torch.zeros((n, h), dtype=torch.float32, device=xs[0].device)
        for x in xs:
            acc = acc + x.float()
    else:
        c = n // ws
        parts = []
        for r in range(ws):
            rows = slice(r * c, (r + 1) * c)
            a = xs[r][rows].float()
            for s in range(ws):
                if s != r:
                    a = a + xs[s][rows].float()
            parts.append(a)
        acc = torch.cat(parts)
    out_res = acc + residual.float()
    # a correctly rounded float32 square root, as the kernel's: torch's float32
    # sqrt on the CPU is not (a double square root rounded to float32 is)
    rms = 1.0 / torch.sqrt((_row_mean_square(out_res) + eps).double()).float()
    if bf16_norm:
        out = (out_res * rms).to(torch.bfloat16) * weight.reshape(-1).to(torch.bfloat16)
    else:
        out = ((out_res * rms) * weight.reshape(-1).float()).to(torch.bfloat16)
    return out, out_res.to(torch.bfloat16)


def _rank_rows(mode: str, rank: int, ws: int, n: int) -> slice:
    """The rows that rank ``rank``'s launch of the per-device form reduces:
    one_shot rows rank, rank + ws, ...; two_shot its chunk."""
    if mode == "one_shot":
        return slice(rank, n, ws)
    c = n // ws
    return slice(rank * c, (rank + 1) * c)


def _allreduce_rmsnorm_ref_rank(xs, residual, weight, eps, mode, bf16_norm, rank, outs, out_ress):
    """Plain PyTorch version of :func:`allreduce_rmsnorm_rank`: rank
    ``rank``'s share of the rows, summed as :func:`_allreduce_rmsnorm_ref`
    sums them (every step is row-wise, so a row's outputs do not depend on
    which rank reduces it), written into every rank's ``outs`` and
    ``out_ress``."""
    ws = len(xs)
    rows = _rank_rows(mode, rank, ws, xs[0].shape[0])
    order = range(ws) if mode == "one_shot" else [rank, *(s for s in range(ws) if s != rank)]
    acc = torch.zeros_like(xs[0][rows], dtype=torch.float32) if mode == "one_shot" else None
    for s in order:
        acc = xs[s][rows].float() if acc is None else acc + xs[s][rows].float()
    out_res = acc + residual[rows].float()
    rms = 1.0 / torch.sqrt((_row_mean_square(out_res) + eps).double()).float()
    if bf16_norm:
        out = (out_res * rms).to(torch.bfloat16) * weight.reshape(-1).to(torch.bfloat16)
    else:
        out = ((out_res * rms) * weight.reshape(-1).float()).to(torch.bfloat16)
    for o, r in zip(outs, out_ress):
        o[rows] = out
        r[rows] = out_res.to(torch.bfloat16)


PAD_WORDS = 2 * MAX_RANKS + 1  # csrc/collective.cu kPadWords
_QUANTUM = 1 << 20  # csrc/collective.cu kQuantum: a launch's share of the epoch
_EPOCH = 2 * MAX_RANKS  # the pad's word counting the calls completed on it


class _SignalPad:
    """A group's signal pad on its card: ready and done counters that only
    grow and the epoch (calls completed on the pad, in quanta of 2^20), all
    in device memory. Every launch reads its targets from the pad and its
    blocks advance them, so a launch replayed from a captured graph counts
    as an eager one does. Made before any capture that uses it (a pad made
    during a capture would live in the graph's memory pool)."""

    def __init__(self, device):
        kernels.refuse_under_capture("a collective's signal pad")
        self.pad = torch.zeros((PAD_WORDS,), dtype=torch.int64, device=device)

    def epoch(self) -> int:
        """Calls completed on the pad (reads the device: synchronises)."""
        return int(self.pad[_EPOCH]) // _QUANTUM


def _check_mode(mode, n, ws, rows_multiple):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "two_shot" and n % (rows_multiple * ws):
        k = f"{rows_multiple}*" if rows_multiple > 1 else ""
        raise ValueError(f"two_shot needs N divisible by {k}axis_size: N={n}, axis_size={ws}")


def allreduce_rmsnorm(xs, residuals, weights, outs, out_ress, eps: float, mode: str,
                      bf16_norm: bool, skew: int = 0, signals: _SignalPad | None = None):
    """The kernel wrapper: one launch for all ranks of a group on one device.
    ``xs``, ``residuals``, ``outs``, ``out_ress``: one [N, H] tensor per rank
    (outputs bf16, filled here); ``weights``: one [H] per rank. ``signals``
    is the group's pad (made on first use when None is given on a card).

    CPU tensors take the plain version (every rank's outputs get a copy of
    it); CUDA tensors launch the kernel or raise.
    """
    name = "allreduce_rmsnorm"
    ws = len(xs)
    n, h = xs[0].shape
    _check_mode(mode, n, ws, 1)
    dev = xs[0].device
    if dev.type == "cpu":
        out, out_res = _allreduce_rmsnorm_ref(xs, residuals[0], weights[0], eps, mode, bf16_norm)
        for o, r in zip(outs, out_ress):
            o.copy_(out)
            r.copy_(out_res)
        return
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not 1 <= ws <= MAX_RANKS or h % 8 or h > 8 * 8 * _THREADS or skew < 0:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_RANKS} ranks, H a multiple of 8 up "
                         f"to {8 * 8 * _THREADS}, skew >= 0")
    groups = (xs, residuals, outs, out_ress)
    for t in (t for g in groups for t in g):
        if (t.device != dev or t.dtype != torch.bfloat16 or tuple(t.shape) != (n, h)
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: every partial, residual and output must be a contiguous, "
                             f"16-byte aligned bf16 [{n}, {h}] on {dev}")
    for w in weights:
        if (w.device != dev or w.dtype != torch.float32 or w.numel() != h or not w.is_contiguous()
                or w.data_ptr() % 16):
            raise ValueError(f"{name}: weights must be contiguous, 16-byte aligned float32 [{h}]")
    if signals is None:
        signals = _SignalPad(dev)
    ptrs = [(ctypes.c_void_p * ws)(*(t.data_ptr() for t in g)) for g in (*groups, weights)]
    x_p, res_p, out_p, ores_p, w_p = (ctypes.cast(p, ctypes.c_void_p) for p in ptrs)
    rc = kernels.lib().hpc_allreduce_rmsnorm(
        x_p, res_p, w_p, out_p, ores_p, signals.pad.data_ptr(), ws, n, h, float(eps),
        int(mode == "two_shot"), int(bool(bf16_norm)), int(skew), kernels.stream_ptr(xs[0]),
    )
    kernels.check(rc, "hpc_allreduce_rmsnorm")
    kernels.count(allreduce_rmsnorm)


allreduce_rmsnorm.launches = 0


class _RankCall:
    """One call of the per-device form, checked once: its tensors' pointer
    tables, from which :meth:`launch` launches any rank's share (the
    action launches every rank's from one check: a check costs the host
    tens of microseconds)."""

    def __init__(self, xs, residuals, weights, outs, out_ress, eps, mode, bf16_norm, skew):
        name = "allreduce_rmsnorm_rank"
        self.ws = ws = len(xs)
        self.n, self.h = n, h = xs[0].shape
        _check_mode(mode, n, ws, 1)
        if not 1 <= ws <= MAX_RANKS or h % 8 or h > 8 * 8 * _THREADS or skew < 0:
            raise ValueError(f"{name}: the kernel takes 1 to {MAX_RANKS} ranks, H a multiple of 8 up "
                             f"to {8 * 8 * _THREADS}, skew >= 0")
        groups = (xs, residuals, outs, out_ress)
        for g in groups:
            for r, t in enumerate(g):
                if (t.device != xs[r].device or t.device.type != "cuda" or t.dtype != torch.bfloat16
                        or tuple(t.shape) != (n, h) or not t.is_contiguous() or t.data_ptr() % 16):
                    raise ValueError(f"{name}: every partial, residual and output must be a contiguous, "
                                     f"16-byte aligned bf16 [{n}, {h}] on its rank's CUDA device")
        for r, w in enumerate(weights):
            if (w.device != xs[r].device or w.dtype != torch.float32 or w.numel() != h
                    or not w.is_contiguous() or w.data_ptr() % 16):
                raise ValueError(f"{name}: weights must be contiguous, 16-byte aligned float32 [{h}]")
        self.xs = xs
        self.ptrs = [(ctypes.c_void_p * ws)(*(t.data_ptr() for t in g)) for g in (*groups, weights)]
        self.args = (float(eps), int(mode == "two_shot"), int(bool(bf16_norm)), int(skew))
        self.mode = mode

    def launch(self, rank: int) -> None:
        """Rank ``rank``'s launch, on the current stream of its device."""
        if len(range(self.n)[_rank_rows(self.mode, rank, self.ws, self.n)]) == 0:
            return  # one_shot with fewer rows than ranks: this rank has none
        x_p, res_p, out_p, ores_p, w_p = (ctypes.cast(p, ctypes.c_void_p) for p in self.ptrs)
        eps, two_shot, bf16_norm, skew = self.args
        dev = self.xs[rank].device
        with torch.cuda.device(dev):
            rc = kernels.lib().hpc_allreduce_rmsnorm_rank(
                x_p, res_p, w_p, out_p, ores_p, self.ws, rank, self.n, self.h, eps, two_shot, bf16_norm,
                skew, kernels.stream_ptr(self.xs[rank]))
        kernels.check(rc, "hpc_allreduce_rmsnorm_rank")
        kernels.count(allreduce_rmsnorm_rank)


def allreduce_rmsnorm_rank(xs, residuals, weights, outs, out_ress, eps: float, mode: str,
                           bf16_norm: bool, rank: int, skew: int = 0):
    """The per-device form's wrapper: launches rank ``rank``'s share of the
    group's rows on the current stream of ``xs[rank]``'s device, reading
    every rank's partial and writing into every rank's outputs (tensors as
    for :func:`allreduce_rmsnorm`, each rank's on its own device; distinct
    devices must map each other's memory, which the mesh sees to). The
    caller orders the launches (see the module docstring). ``skew`` delays
    rank r's first block by about r * skew spins of ~100 ns.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if not 0 <= rank < len(xs):
        raise ValueError(f"allreduce_rmsnorm_rank: rank {rank} of a group of {len(xs)}")
    dev = xs[rank].device
    if dev.type == "cpu":
        _check_mode(mode, xs[0].shape[0], len(xs), 1)
        _allreduce_rmsnorm_ref_rank(xs, residuals[rank], weights[rank], eps, mode, bf16_norm, rank, outs,
                                    out_ress)
        return
    if dev.type != "cuda":
        raise ValueError(f"allreduce_rmsnorm_rank: unsupported device {dev}")
    _RankCall(xs, residuals, weights, outs, out_ress, eps, mode, bf16_norm, skew).launch(rank)


allreduce_rmsnorm_rank.launches = 0


class _Call(NamedTuple):
    x: torch.Tensor
    residual: torch.Tensor
    weight: torch.Tensor
    out: torch.Tensor
    out_res: torch.Tensor
    eps: float
    mode: str
    bf16_norm: bool
    skew: int


def _allreduce_action(rendezvous, slots):
    """Runs in the last rank to arrive: checks that the ranks agree, then the
    collective for all of them. A group on one device: one
    :func:`allreduce_rmsnorm` on this thread's stream after every rank's
    arrival event. The per-device form (:attr:`_Rendezvous.per_device`): one
    :func:`allreduce_rmsnorm_rank` a rank, each on the rank's stream after
    every rank's arrival event; CPU ranks run its plain version rank by
    rank. Returns (the events every rank's stream waits on, each rank's
    outputs)."""
    calls = [s.payload for s in slots]
    first = calls[0]
    if any((c.x.shape, c.eps, c.mode, c.bf16_norm, c.skew) != (first.x.shape, first.eps, first.mode,
                                                                first.bf16_norm, first.skew)
           for c in calls):
        raise ValueError("the ranks of a collective disagree on its shape, eps, mode or skew")
    fields = ([c.x for c in calls], [c.residual for c in calls], [c.weight for c in calls],
              [c.out for c in calls], [c.out_res for c in calls])
    args = (first.eps, first.mode, first.bf16_norm)
    outs = [(c.out, c.out_res) for c in calls]
    cuda = first.x.device.type == "cuda"
    if rendezvous.per_device:
        if not cuda:
            for r in range(len(calls)):
                allreduce_rmsnorm_rank(*fields, *args, r, first.skew)
            return (), outs
        call = _RankCall(*fields, *args, first.skew)
        dones = []
        for r, slot in enumerate(slots):
            with torch.cuda.stream(slot.stream):
                for s in slots:
                    slot.stream.wait_event(s.event)
                call.launch(r)
                done = torch.cuda.Event()
                done.record(slot.stream)
                dones.append(done)
        return tuple(dones), outs
    if not cuda:
        allreduce_rmsnorm(*fields, *args, first.skew)
        return (), outs
    stream = torch.cuda.current_stream(first.x.device)
    for s in slots:
        stream.wait_event(s.event)
    if rendezvous.state is None:
        rendezvous.state = _SignalPad(first.x.device)
    allreduce_rmsnorm(*fields, *args, first.skew, rendezvous.state)
    done = torch.cuda.Event()
    done.record(stream)
    return (done,), outs


def collective_rmsnorm(group, x, residual, weight, eps: float, mode: str, bf16_norm: bool,
                       skew: int = 0, rows_multiple: int = 1):
    """One rank's side of the fused collective: called by every rank of
    ``group`` (a :class:`~hpc_ops_tpu_torch.parallel.mesh.RankGroup`) with its
    partial ``x`` and its copies of ``residual`` and ``weight``; returns
    (out, out_res), [N, H] bf16 on the rank's device. two_shot needs N
    divisible by ``rows_multiple`` * the group's size."""
    if not hasattr(group, "exchange"):
        raise TypeError(f"axis_name must be a RankGroup (run the rank under run_ranks), got {group!r}")
    n, h = x.shape
    _check_mode(mode, n, group.size, rows_multiple)
    if x.device.type == "cuda":
        w = weight.reshape(-1).float().contiguous()
    else:
        w = weight.reshape(-1)
    out = torch.empty((n, h), dtype=torch.bfloat16, device=x.device)
    out_res = torch.empty_like(out)
    return group.exchange(_Call(x, residual, w, out, out_res, float(eps), mode, bool(bf16_norm),
                                int(skew)), _allreduce_action)


def fuse_allreduce_rmsnorm_pallas(
    x,  # [N, H] this rank's partial
    residual,  # [N, H] replicated
    weight,  # [H]
    ws: int,  # the group's size
    axis_name="tp",  # the rank's RankGroup
    mode: str = "one_shot",
    eps: float = 1e-6,
    interpret: bool = False,
    collective_id: int = 7,
    skew: int = 0,
):
    """Single-kernel fused collective + norm, the TPU kernel's epilogue.
    Called by every rank of the group ``axis_name`` (inside
    :func:`~hpc_ops_tpu_torch.parallel.mesh.run_ranks`). Returns (normed
    [N, H] bf16, out_residual [N, H] bf16), equal on every rank. ``two_shot``
    needs N divisible by 8*ws. ``skew`` delays rank r's arrival signal by
    about r*skew spins of the kernel (a test hook). ``interpret`` and
    ``collective_id`` are TPU hints, accepted and unused."""
    del interpret, collective_id
    if getattr(axis_name, "size", None) != ws:
        raise ValueError(f"ws={ws} is not the size of axis_name {axis_name!r}")
    return collective_rmsnorm(axis_name, x, residual, weight, eps, mode, bf16_norm=False, skew=skew,
                              rows_multiple=8)


__all__ = ["fuse_allreduce_rmsnorm_pallas"]
