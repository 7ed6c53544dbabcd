"""Device meshes and tensor-parallel rank groups (port of
``parallel/mesh.py``).

The JAX package is single-controller: one process drives a (dp, tp) or a
hybrid (ddp, dp, tp) mesh through ``shard_map``, and its tests run those
meshes on 8 host devices. The port does the same in one process: each rank
of a mesh runs as a Python thread of a pool kept by the mesh, with its own
``torch.cuda.Stream`` on its card, and a :class:`RankGroup` is what the port
passes where JAX passes ``axis_name="tp"``. Every axis but the last, "tp",
is a row axis: request rows and page pools are split over the product of
the row axes, ddp-major, as JAX's ``P(("ddp", "dp"))`` splits them.

Where the ranks lie:

* all on one device, as *virtual ranks* (``make_mesh(tp, dp,
  devices=[torch.device("cuda")] * n)``, or ``["cpu"] * n``): how one H100
  serves a tp mesh;
* one rank a device, over distinct CUDA devices;
* each tp group on one device, the groups on distinct devices.

Any other mix raises ``ValueError``. A mesh over distinct devices maps every
pair's memory when it is built (peer access); a pair without it raises
``ValueError``, since a collective reads its peers' partials in place and
nothing stages them through the host.

At a collective every rank of a tp group records an event on its stream and
arrives at the group's rendezvous, a ``threading.Barrier`` with a timeout.
The last rank to arrive runs the collective's action: for a group on one
device it makes its stream wait on every rank's event and launches one
kernel that serves all the group's ranks; for a group over several devices
(or with the mesh's private ``_per_device`` switch) it launches one kernel a
rank, each on the rank's stream after every rank's event. Every rank's
stream then waits on the action's events. On the CPU the action computes
the plain version for all ranks. An exception in any rank thread aborts the
barrier, so a fault fails the call instead of hanging it.

The ranks' host work runs one rank at a time: a rank thread holds the
mesh's baton (a lock) while it runs and hands it on only at a collective.
The interpreter lock serialises that work anyway; without the baton every
torch call, which releases the interpreter lock, hands it to another rank
thread, and a tp-4 decode step of llama3_8b took 350-400 ms on an H100
host (``chip_smoke.py`` slice_full_tp).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

COLLECTIVE_TIMEOUT_S = 300.0  # a rank that never reaches a collective fails the call after this

class Mesh:
    """A grid of ``torch.device`` s with JAX's ``shape`` (axis name -> size),
    ``axis_names`` and ``devices`` (an object array of the grid); "tp" is
    the last axis. ``grid`` is the same devices as [row shard, tp rank],
    the row shards flattened over the row axes, ddp-major. The rank
    threads, their streams and each tp group's rendezvous are made at the
    first :func:`run_ranks` and kept for the mesh's life."""

    def __init__(self, devices: np.ndarray, axis_names=("dp", "tp")):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.axis_names[-1] != "tp" or len(self.axis_names) != devices.ndim:
            raise ValueError(f"a mesh's axes end in 'tp' and name every dim: {self.axis_names}")
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.grid = devices.reshape(-1, devices.shape[-1])
        self._per_device = False  # private: the per-device collective even for virtual ranks
        self._lock = threading.Lock()
        self.baton = threading.Lock()  # held by the one rank thread that runs host work
        self._pool = None
        self._groups = None

    @property
    def device(self) -> torch.device:
        """The device of rank 0 of row shard 0: the one device every rank
        lies on for virtual ranks, and where the sharded steps gather their
        outputs."""
        return self.devices.flat[0]

    def _runtime(self):
        """Each rank's thread (an executor of one worker, so that a rank always
        runs on the same thread: per-thread state such as the cuBLAS handle
        made for the rank's stream is made once, by an eager call, and found
        again when that work is captured into a CUDA graph), and the groups."""
        with self._lock:
            if self._pool is None:
                shards, tp = self.grid.shape
                cuda = self.device.type == "cuda"
                self._pool = [[ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"tp-rank-{d}-{r}")
                               for r in range(tp)] for d in range(shards)]
                self._groups = []
                for d in range(shards):
                    devs = list(self.grid[d])
                    rv = _Rendezvous(tp, devs, self)
                    self._groups.append([RankGroup(r, tp, devs[r], torch.cuda.Stream(devs[r]) if cuda else None,
                                                   rv, self) for r in range(tp)])
            return self._pool, self._groups

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={sorted(set(map(str, self.devices.flat)))})"


def _normalise(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def _enable_peers(devs) -> None:
    """Map every ordered pair of the distinct CUDA devices ``devs``; a pair
    without peer access raises."""
    from hpc_ops_tpu_torch import kernels

    for a, b in itertools.permutations(sorted(devs, key=lambda d: d.index), 2):
        if not torch.cuda.can_device_access_peer(a, b):
            raise ValueError(f"{a} cannot access {b}'s memory (no peer access): a mesh over distinct "
                             "devices reads its peers' partials in place and stages nothing through the host")
        kernels.check(kernels.lib().hpc_enable_peer_access(a.index, b.index), "hpc_enable_peer_access")


def _make(devices, shape: tuple, axis_names: tuple) -> Mesh:
    """The mesh of the first prod(shape) ``devices``, reshaped; checks the
    layout rules of the module docstring."""
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = [_normalise(d) for d in devices[:n]]
    if len({d.type for d in devs}) != 1 or devs[0].type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh's ranks lie on one kind of device, cpu or cuda: {devs}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    grid = grid.reshape(shape)
    distinct = set(devs)
    if len(distinct) > 1:
        visible = torch.cuda.device_count()
        for d in sorted(distinct, key=lambda d: d.index):
            if d.index >= visible:
                raise ValueError(f"{d} is not visible: this process sees {visible} CUDA devices")
        groups = grid.reshape(-1, shape[-1])
        if len(distinct) != n and any(len(set(g)) > 1 for g in groups):
            raise ValueError("a mesh over distinct devices puts one rank on a device, or each tp group's "
                             f"ranks on one device: {[[str(d) for d in g] for g in groups]}")
        _enable_peers(distinct)
    return Mesh(grid, axis_names)


def make_mesh(tp: int = 1, dp: int = 1, ep: int | None = None, devices=None,
              backend: str | None = None) -> Mesh:
    """Build a (dp, tp) mesh. EP reuses the tp axis (experts sharded where the
    MoE weights are), as in the JAX package.

    ``devices=None`` takes every visible CUDA device and needs ``dp * tp`` of
    them (with ``backend="cpu"``: ``dp * tp`` ranks on the CPU);
    ``devices=[torch.device("cuda")] * n`` asks for n virtual ranks on one
    card, ``["cpu"] * n`` for n ranks on the CPU, a list of distinct CUDA
    devices for a rank a device (or a tp group a device).
    """
    del ep
    if devices is None:
        devices = ([torch.device("cpu")] * (dp * tp) if backend == "cpu" else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return _make(devices, (dp, tp), ("dp", "tp"))


def make_hybrid_mesh(dcn_dp: int, tp: int, dp: int = 1, devices=None) -> Mesh:
    """A (ddp, dp, tp) mesh: JAX's multi-host layout, request rows split over
    ddp x dp and the collectives on tp. The port is one process: a "host" is
    a slice of this process's devices. ``devices`` as for :func:`make_mesh`
    (the first ``dcn_dp * dp * tp`` are taken and reshaped, as JAX does);
    ``None`` takes every visible CUDA device and raises ``ValueError`` if
    there are too few."""
    n = dcn_dp * dp * tp
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if len(devices) < n:
            raise ValueError(f"make_hybrid_mesh({dcn_dp}, {tp}, dp={dp}) needs {n} CUDA devices, this "
                             f"process sees {len(devices)}; pass devices=[torch.device('cuda')] * {n} "
                             "for virtual ranks")
    return _make(devices, (dcn_dp, dp, tp), ("ddp", "dp", "tp"))


class NamedSharding(NamedTuple):
    """How a tensor is laid out over a mesh: ``spec`` names, for each dim,
    the mesh axis it is split over, or None where it is replicated."""

    mesh: Mesh
    spec: tuple


def tp_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


class _Slot(NamedTuple):
    payload: tuple
    event: object  # the rank's stream event at arrival (None on the CPU)
    stream: object  # the rank's stream (None on the CPU)


class _Rendezvous:
    """Where the ranks of one tp group meet at a collective. The barrier's
    action runs in the last thread to arrive; its result is read by each rank
    after the barrier and replaced only at the next collective, which every
    rank must reach first. ``state`` is the collective kernels' own (their
    signal pad), made at first use. ``devices``: each rank's."""

    def __init__(self, size: int, devices: list, mesh: Mesh):
        self.size = size
        self.devices = devices
        self.mesh = mesh
        self._slots = [None] * size
        self._action = None
        self._result = None
        self.state = None
        self.barrier = threading.Barrier(size, action=self._run, timeout=COLLECTIVE_TIMEOUT_S)

    @property
    def per_device(self) -> bool:
        """Whether a collective launches once a rank: the group spans
        devices, or the mesh's private switch asks for it."""
        return len(set(self.devices)) > 1 or self.mesh._per_device

    def _run(self):
        self._result = self._action(self, self._slots)

    def exchange(self, rank: int, payload: tuple, event, stream, action):
        """Arrive with ``payload``; ``action(rendezvous, slots)`` runs once,
        in the last rank to arrive, and its result is returned to every rank.
        Every rank of a collective passes the same ``action``."""
        self._slots[rank] = _Slot(payload, event, stream)
        self._action = action
        try:
            self.barrier.wait()
        except threading.BrokenBarrierError:
            raise _PeerFailed("a peer rank failed or timed out at a collective") from None
        return self._result


class _PeerFailed(RuntimeError):
    """Raised in the ranks that waited at a collective another rank broke."""


class RankGroup:
    """One rank of a tensor-parallel group: what the port passes as
    ``axis_name``. ``rank`` is JAX's ``jax.lax.axis_index``, ``size`` the
    group's; ``device`` and ``stream`` are the rank's (``stream`` None on the
    CPU); ``rendezvous`` is shared by the group's ranks."""

    def __init__(self, rank: int, size: int, device: torch.device, stream, rendezvous: _Rendezvous,
                 mesh: Mesh):
        self.rank = rank
        self.size = size
        self.device = device
        self.stream = stream
        self.rendezvous = rendezvous
        self.mesh = mesh

    def exchange(self, payload: tuple, action):
        """Meet the group's other ranks (see :class:`_Rendezvous`) and return
        this rank's share of the action's result, which is ``(events, [one
        result per rank])``. On a card the rank's stream first records an
        event that the launching streams wait on, and afterwards waits on
        each of the action's events."""
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(self.stream)
        self.mesh.baton.release()  # the other ranks run on to this collective
        try:
            result = self.rendezvous.exchange(self.rank, payload, event, self.stream, action)
        finally:
            self.mesh.baton.acquire()
        if self.stream is not None:
            for e in result[0]:
                self.stream.wait_event(e)
        return result[1][self.rank]

    def __repr__(self):
        return f"RankGroup(rank={self.rank}, size={self.size}, device={self.device})"


def run_ranks(mesh: Mesh, fn) -> list:
    """Run ``fn(group, shard)`` once per rank of ``mesh``, each in a rank
    thread (on the rank's own stream on a card), and return the results as
    ``[shard][tp]``; ``shard`` is the rank's flat row-shard index over the
    row axes, ddp-major. The ranks' streams start after the caller's
    current work on ``mesh.device`` and the caller's stream waits on all of
    them before this returns. A rank on another device than ``mesh.device``
    runs with the caller's stream as its current stream there, so a copy
    between the two devices inside ``fn`` is ordered with the caller's work
    (and joins a capture the caller runs). The first exception a rank raised
    is raised here (ranks that were waiting on it at a collective fail too,
    instead of hanging)."""
    pool, groups = mesh._runtime()
    for g in groups:
        if g[0].rendezvous.barrier.broken:
            g[0].rendezvous.barrier.reset()  # left broken by an earlier failed call
    home = mesh.device
    cuda = home.type == "cuda"
    entry = caller = None
    if cuda:
        caller = torch.cuda.current_stream(home)
        entry = torch.cuda.Event()
        entry.record(caller)

    def task(group: RankGroup, d: int):
        mesh.baton.acquire()
        try:
            if not cuda:
                return fn(group, d), None
            with contextlib.ExitStack() as stack:
                if group.device != home:
                    stack.enter_context(torch.cuda.stream(caller))
                stack.enter_context(torch.cuda.device(group.device))
                stack.enter_context(torch.cuda.stream(group.stream))
                group.stream.wait_event(entry)
                out = fn(group, d)
                done = torch.cuda.Event()
                done.record(group.stream)
                return out, done
        except BaseException:
            group.rendezvous.barrier.abort()
            raise
        finally:
            mesh.baton.release()

    futures = [[pool[d][g.rank].submit(task, g, d) for g in groups[d]] for d in range(len(groups))]
    results, first, peer = [], None, None
    for row in futures:
        out_row = []
        for f in row:
            try:
                out, done = f.result()
            except _PeerFailed as e:
                peer = peer or e
                out_row.append(None)
                continue
            except BaseException as e:  # noqa: BLE001 - re-raised below, after every rank ended
                first = first or e
                out_row.append(None)
                continue
            if done is not None:
                caller.wait_event(done)
            out_row.append(out)
        results.append(out_row)
    if first is not None:
        raise first
    if peer is not None:
        raise peer
    return results


__all__ = [
    "Mesh",
    "NamedSharding",
    "RankGroup",
    "make_hybrid_mesh",
    "make_mesh",
    "run_ranks",
    "tp_sharding",
]
