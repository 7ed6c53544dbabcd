"""Host spans of the serving path, kept in memory.

Off by default. While off, :func:`span` returns one shared no-op object:
a global read and a call, with no clock read and no allocation. Attributes
go through the span's ``set(key, value)``, which allocates nothing either
(a ``**kwargs`` call would build a dict every time); the ``with``
statement's bound ``__exit__`` is the interpreter's one transient object.

While on, a span records its name, start and end on ``time.perf_counter_ns``
(the clock of ``time.perf_counter``), the index of its parent (the innermost
span open on the same thread, -1 for none), the request id where there is
one, and its attributes. Records are read with :func:`records`; their
index in that list is what ``parent`` refers to. Each garbage collection is
recorded as a ``python.gc`` span with its generation.

:func:`clock_offset_ns` maps the records' clock onto the Unix epoch in
nanoseconds, which is the clock of ``torch.profiler``'s events
(``start_ns()``): it is measured at :func:`enable` by pairing
``time.time_ns`` with ``time.perf_counter_ns``.

No span may be opened inside code that a CUDA graph captures: a host span
there would record the capture once, not each replay.
"""

from __future__ import annotations

import gc
import threading
import time

__all__ = ["Record", "span", "enable", "disable", "clear", "records", "now", "clock_offset_ns"]

now = time.perf_counter_ns  # the records' clock; Request timestamps use it too

_on = False
_records: list = []
# reentrant: a collection can start while the lock is held (records()
# allocates), and its hook opens a python.gc span under the same lock
_lock = threading.RLock()
_local = threading.local()
_offset_ns = 0


class Record:
    """One span: ``t1`` is None while it is open."""

    __slots__ = ("name", "t0", "t1", "parent", "rid", "attrs")

    def __init__(self, name: str, t0: int, t1: int | None, parent: int, rid, attrs: dict):
        self.name, self.t0, self.t1, self.parent, self.rid, self.attrs = name, t0, t1, parent, rid, attrs

    def __repr__(self) -> str:
        return f"Record({self.name!r}, {self.t0}, {self.t1}, parent={self.parent}, rid={self.rid}, {self.attrs})"


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb) -> bool:
        return False

    def set(self, key: str, value) -> None:
        pass


NO_SPAN = _NoSpan()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _open(name: str, rid) -> Record:
    st = _stack()
    rec = Record(name, 0, None, st[-1] if st else -1, rid, {})
    with _lock:
        _records.append(rec)
        st.append(len(_records) - 1)
    rec.t0 = now()
    return rec


def _close(rec: Record) -> None:
    rec.t1 = now()
    st = _stack()
    if st:
        st.pop()


class _Span:
    __slots__ = ("name", "rid", "rec")

    def __init__(self, name: str, rid):
        self.name, self.rid, self.rec = name, rid, None

    def __enter__(self):
        self.rec = _open(self.name, self.rid)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        _close(self.rec)
        return False

    def set(self, key: str, value) -> None:
        self.rec.attrs[key] = value


def span(name: str, rid=None):
    """A context manager timing its block as span ``name`` (of request
    ``rid``, if given); its ``set(key, value)`` adds an attribute."""
    if not _on:
        return NO_SPAN
    return _Span(name, rid)


_gc_open: dict = {}  # thread id -> the open python.gc record


def _on_gc(phase: str, info: dict) -> None:
    tid = threading.get_ident()
    if phase == "start":
        rec = _open("python.gc", None)
        rec.attrs["generation"] = info["generation"]
        _gc_open[tid] = rec
    else:
        rec = _gc_open.pop(tid, None)
        if rec is not None:
            _close(rec)


def _measure_offset() -> int:
    """time.time_ns() - time.perf_counter_ns(), from the tightest of a few
    bracketed pairs."""
    best = None
    for _ in range(16):
        a = now()
        w = time.time_ns()
        b = now()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


def enable() -> None:
    """Start recording spans (and garbage collections); measures the clock
    offset."""
    global _on, _offset_ns
    if _on:
        return
    _offset_ns = _measure_offset()
    gc.callbacks.append(_on_gc)
    _on = True


def disable() -> None:
    """Stop recording; spans open now are closed as they end, unrecorded
    spans no longer start, and the collection hook is removed."""
    global _on
    _on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _gc_open.clear()


def clear() -> None:
    """Drop every record (the open spans' stacks too)."""
    with _lock:
        _records.clear()
    _local.stack = []


def records() -> list:
    """The records so far, in the order the spans opened."""
    with _lock:
        return list(_records)


def clock_offset_ns() -> int:
    """Add to a record's time to put it on the Unix epoch in nanoseconds
    (torch.profiler's clock); measured at the last :func:`enable`."""
    return _offset_ns
