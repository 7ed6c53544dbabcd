"""Device meshes and tensor-parallel rank groups (port of
``parallel/mesh.py``).

The JAX package is single-controller: one process drives a (dp, tp) mesh
through ``shard_map``, and its tests run that mesh on 8 host devices. The
port does the same in one process: each rank of a mesh runs as a Python
thread of a pool kept by the mesh, with its own ``torch.cuda.Stream`` on a
card, and a :class:`RankGroup` is what the port passes where JAX passes
``axis_name="tp"``. The ranks may all be *virtual ranks* on one device
(``make_mesh(tp, dp, devices=[torch.device("cuda")] * n)``, or ``["cpu"] *
n``), which is how one H100 serves a tp mesh; a mesh over more than one
distinct CUDA device is not ported (ROADMAP queue 1 item 8: a launch per
device over peer memory).

At a collective every rank of a tp group records an event on its stream and
arrives at the group's rendezvous, a ``threading.Barrier`` with a timeout.
The last rank to arrive makes its stream wait on every rank's event and
launches one kernel that serves all the group's ranks; every rank's stream
then waits on that launch. On the CPU the last rank computes the plain
version for all ranks. An exception in any rank thread aborts the barrier,
so a fault fails the call instead of hanging it.

The ranks' host work runs one rank at a time: a rank thread holds the
mesh's baton (a lock) while it runs and hands it on only at a collective.
The interpreter lock serialises that work anyway; without the baton every
torch call, which releases the interpreter lock, hands it to another rank
thread, and a tp-4 decode step of llama3_8b took 350-400 ms on an H100
host (``chip_smoke.py`` slice_full_tp).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

_ITEM8 = "ROADMAP queue 1 item 8 (multi-GPU)"
COLLECTIVE_TIMEOUT_S = 300.0  # a rank that never reaches a collective fails the call after this


class Mesh:
    """A (dp, tp) grid of ``torch.device`` s with JAX's ``shape`` (axis name
    -> size), ``axis_names`` and ``devices`` (an object array of the grid).
    The rank threads, their streams and each tp group's rendezvous are made at
    the first :func:`run_ranks` and kept for the mesh's life."""

    def __init__(self, devices: np.ndarray, axis_names=("dp", "tp")):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self._lock = threading.Lock()
        self.baton = threading.Lock()  # held by the one rank thread that runs host work
        self._pool = None
        self._groups = None

    @property
    def device(self) -> torch.device:
        """The one device every rank lies on."""
        return self.devices.flat[0]

    def _runtime(self):
        with self._lock:
            if self._pool is None:
                dp, tp = self.devices.shape
                self._pool = ThreadPoolExecutor(max_workers=dp * tp, thread_name_prefix="tp-rank")
                self._groups = [
                    [RankGroup(r, tp, self.devices[d, r],
                               torch.cuda.Stream(self.devices[d, r]) if self.device.type == "cuda"
                               else None, rv, self)
                     for r in range(tp)]
                    for d, rv in ((d, _Rendezvous(tp)) for d in range(dp))
                ]
            return self._pool, self._groups

    def __repr__(self):
        return f"Mesh(shape={self.shape}, device={self.device})"


def _normalise(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def make_mesh(tp: int = 1, dp: int = 1, ep: int | None = None, devices=None,
              backend: str | None = None) -> Mesh:
    """Build a (dp, tp) mesh. EP reuses the tp axis (experts sharded where the
    MoE weights are), as in the JAX package.

    ``devices=None`` takes every visible CUDA device and needs ``dp * tp`` of
    them (with ``backend="cpu"``: ``dp * tp`` ranks on the CPU);
    ``devices=[torch.device("cuda")] * n`` asks for n virtual ranks on one
    card, ``["cpu"] * n`` for n ranks on the CPU. A mesh over more than one
    distinct CUDA device raises ``NotImplementedError``.
    """
    del ep
    if devices is None:
        devices = ([torch.device("cpu")] * (dp * tp) if backend == "cpu" else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    n = dp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = [_normalise(d) for d in devices[:n]]
    if len({d.type for d in devs}) != 1 or devs[0].type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh's ranks lie on one kind of device, cpu or cuda: {devs}")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"a mesh over {len(set(devs))} distinct CUDA devices is not ported yet: {_ITEM8}; "
            "ask for virtual ranks on one card with devices=[torch.device('cuda')] * n")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devs):
        grid[i // tp, i % tp] = d
    return Mesh(grid, ("dp", "tp"))


def make_hybrid_mesh(dcn_dp: int, tp: int, dp: int = 1, devices=None) -> Mesh:
    """Multi-host meshes are not ported (JAX: a DCN axis over hosts)."""
    raise NotImplementedError(f"make_hybrid_mesh (a mesh across hosts) is not ported yet: {_ITEM8}")


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


class _Rendezvous:
    """Where the ranks of one tp group meet at a collective. The barrier's
    action runs in the last thread to arrive; its result is read by each rank
    after the barrier and replaced only at the next collective, which every
    rank must reach first. ``state`` is the collective kernels' own (their
    signal pad), made at first use."""

    def __init__(self, size: int):
        self.size = size
        self._slots = [None] * size
        self._action = None
        self._result = None
        self.state = None
        self.barrier = threading.Barrier(size, action=self._run, timeout=COLLECTIVE_TIMEOUT_S)

    def _run(self):
        self._result = self._action(self, self._slots)

    def exchange(self, rank: int, payload: tuple, event, action):
        """Arrive with ``payload``; ``action(rendezvous, slots)`` runs once,
        in the last rank to arrive, and its result is returned to every rank.
        Every rank of a collective passes the same ``action``."""
        self._slots[rank] = _Slot(payload, event)
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
        this rank's share of the action's result, which is ``(event, [one
        result per rank])``. On a card the rank's stream first records an
        event that the launching rank's stream waits on, and afterwards waits
        on the action's event."""
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(self.stream)
        self.mesh.baton.release()  # the other ranks run on to this collective
        try:
            result = self.rendezvous.exchange(self.rank, payload, event, action)
        finally:
            self.mesh.baton.acquire()
        if self.stream is not None:
            self.stream.wait_event(result[0])
        return result[1][self.rank]

    def __repr__(self):
        return f"RankGroup(rank={self.rank}, size={self.size}, device={self.device})"


def run_ranks(mesh: Mesh, fn) -> list:
    """Run ``fn(group, dp_index)`` once per rank of ``mesh``, each in a rank
    thread (on the rank's own stream on a card), and return the results as
    ``[dp][tp]``. The ranks' streams start after the caller's current work
    and the caller's stream waits on all of them before this returns. The
    first exception a rank raised is raised here (ranks that were waiting
    on it at a collective fail too, instead of hanging)."""
    pool, groups = mesh._runtime()
    for g in groups:
        if g[0].rendezvous.barrier.broken:
            g[0].rendezvous.barrier.reset()  # left broken by an earlier failed call
    cuda = mesh.device.type == "cuda"
    entry = None
    if cuda:
        caller = torch.cuda.current_stream(mesh.device)
        entry = torch.cuda.Event()
        entry.record(caller)

    def task(group: RankGroup, d: int):
        mesh.baton.acquire()
        try:
            if not cuda:
                return fn(group, d), None
            with torch.cuda.device(group.device), torch.cuda.stream(group.stream):
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

    futures = [[pool.submit(task, g, d) for g in groups[d]] for d in range(len(groups))]
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
