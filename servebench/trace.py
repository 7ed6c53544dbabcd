"""A torch.profiler slice of the window: device intervals, kernel time by
name, the union of busy intervals, and idle gaps named by the harness span
the host was in.

The harness wraps each engine step in the slice in a ``servebench.step``
range and its own client bookkeeping in ``servebench.clients``; the i-th
step range is the i-th step the harness recorded in the slice, which gives
it its kind. Device events are every kernel, copy and set on the card, each
with the index of its card: over several cards the busy time and the idle
share are each card's, averaged over the cards, and the idle gaps are card
0's, where the sampled tokens land.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

STEP, CLIENTS = "servebench.step", "servebench.clients"


@dataclass
class Slice:
    """What one profiled slice read: ``wall_s`` (host clock, from a
    synchronised start to a synchronised stop), the device intervals
    ``[(start_s, end_s, name)]`` on the trace's clock, and the host spans
    ``[(start_s, end_s, label)]`` on the same clock. ``cards`` holds each
    device interval's card index (empty: all on one card)."""

    wall_s: float
    device: list
    spans: list
    steps: list = field(default_factory=list)  # the harness's step records in the slice
    cards: list = field(default_factory=list)

    def card_ids(self) -> list:
        """The cards the slice saw, in order ([None] for a slice of one card
        that names none)."""
        return sorted(set(self.cards)) or [None]

    def _on(self, card) -> list:
        if card is None or not self.cards:
            return self.device
        return [ev for ev, c in zip(self.device, self.cards) if c == card]

    def device_s(self, patterns) -> float:
        """Seconds of device time of operations whose name holds any of
        ``patterns``."""
        return sum(b - a for a, b, n in self.device if any(p in n for p in patterns))

    def busy_intervals(self, card=None) -> list:
        """The union of the device intervals (of ``card``'s alone where it is
        given), as sorted disjoint (start, end)."""
        out = []
        for a, b, _ in sorted(self._on(card)):
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1][1] = b
            else:
                out.append([a, b])
        return out

    def busy_s(self, card=None) -> float:
        """Seconds in which an operation ran on ``card``; with no card given,
        the mean of that over the cards."""
        if card is None and len(self.card_ids()) > 1:
            return sum(self.busy_s(c) for c in self.card_ids()) / len(self.card_ids())
        return sum(b - a for a, b in self.busy_intervals(card))

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` operations by total device seconds: [[name, seconds]]."""
        tot: dict = {}
        for a, b, name in self.device:
            key = name[:120]
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between busy intervals of the first card,
        each named by the host span open at its middle: [[name, seconds]]."""
        busy = self.busy_intervals(self.card_ids()[0])
        gaps = [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            label = "outside the harness's spans"
            for s0, s1, lab in self.spans:
                if s0 <= mid <= s1:
                    label = lab
                    break
            out.append([label, b - a])
        return out


class Profiler:
    """torch.profiler over CPU and CUDA from :meth:`start` to :meth:`stop`."""

    def __init__(self, torch, devices=None):
        self.torch = torch
        self.devices = devices  # every card to synchronise (None: the current one)
        self.prof = None
        self.t0 = 0.0

    def _sync(self) -> None:
        if self.devices is None:
            self.torch.cuda.synchronize()
        else:
            for d in self.devices:
                self.torch.cuda.synchronize(d)

    def warm(self) -> None:
        """One empty session: the first one initialises the device tracer,
        which takes seconds, so set-up pays it and the slice does not."""
        self.start()
        self.prof.__exit__(None, None, None)
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def range(self, name: str):
        return self.torch.profiler.record_function(name)

    def stop(self, step_kinds: list) -> Slice:
        """End the slice; ``step_kinds`` labels the step ranges in order."""
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        device, cards, steps, clients = [], [], [], []
        known = {d.index for d in self.devices or ()}
        cpu = self.torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns() * 1e-9
            b = a + e.duration_ns() * 1e-9
            if e.device_type() != cpu:
                if e.name().startswith("servebench."):  # a range's mirror on the device's timeline
                    continue
                if self.devices is None:
                    device.append((a, b, e.name()))
                elif e.device_index() in known:  # over several cards, each event's card
                    device.append((a, b, e.name()))
                    cards.append(e.device_index())
            elif e.name() == STEP:
                steps.append((a, b))
            elif e.name() == CLIENTS:
                clients.append((a, b, "harness client bookkeeping"))
        steps.sort()
        spans = [(a, b, f"engine step ({kind})") for (a, b), kind in zip(steps, step_kinds)]
        self.prof = None
        return Slice(wall_s=wall, device=device, spans=spans + clients, cards=cards)
