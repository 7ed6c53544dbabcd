"""Record/replay verification harness (port of ``utils/replay.py``).

:class:`TraceHook` wraps public functions (the ops) and records
each call: its arguments as they were before the call (wrappers that update
a tensor in place, such as the sampler's penalty mask, see their inputs) and
its outputs, as host copies that remember their devices, pickled to disk.
:func:`replay_record` re-runs a record on the devices it was taken on,
twice, and requires both outputs to equal the recorded one bit for bit: a
kernel with a race or a read of uninitialised memory shows as a difference.
The JAX package also re-runs each record in the Pallas interpreter; a CUDA
kernel has no interpreter, so that check has no counterpart here. ::

    with TraceHook([module.op_fn]) as hook:
        run_workload()
    for rec in hook.records:
        replay_record(rec)

Calls made while a CUDA graph is being captured are not recorded (their
outputs hold no values yet), as the JAX hook skips calls under a trace. Hook
an op (``ops.activation.act_mul_and_quant``), not a kernel wrapper of
:func:`hpc_ops_tpu_torch.kernels.wrappers`: a wrapper counts its launches on
its own function object, which the hook replaces while it is active.
"""

from __future__ import annotations

import importlib
import os
import pickle
import tempfile
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


@dataclass
class _HostTensor:
    """A recorded tensor: its bytes (a numpy uint8 array, which pickles for
    every dtype), dtype, shape and the device it lay on."""

    raw: np.ndarray
    dtype: torch.dtype
    shape: tuple
    device: str

    @classmethod
    def of(cls, t: torch.Tensor) -> "_HostTensor":
        host = t.detach().to("cpu", copy=True).contiguous()
        return cls(host.reshape(-1).view(torch.uint8).numpy(), t.dtype, tuple(t.shape),
                   str(t.device))

    @property
    def data(self) -> torch.Tensor:
        """The values as a CPU tensor."""
        return torch.from_numpy(self.raw.copy()).view(self.dtype).reshape(self.shape)


def _map(tree, leaf, fn):
    """``tree`` with each ``leaf``-typed node replaced by ``fn`` of it."""
    if isinstance(tree, leaf):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, leaf, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(v, leaf, fn) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return tree


def _to_host(tree):
    return _map(tree, torch.Tensor, _HostTensor.of)


def _to_device(tree):
    return _map(tree, _HostTensor, lambda h: h.data.to(h.device))


def _leaves(tree) -> list:
    """The tensors of an output tree, as host tensors, in a fixed order."""
    if isinstance(tree, _HostTensor):
        return [tree.data]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


@dataclass
class CallRecord:
    name: str
    module: str
    args: Any
    kwargs: Any
    outputs: Any
    path: str = ""


@dataclass
class TraceHook:
    """Wraps callables; records (args, kwargs, outputs) of every call."""

    fns: list
    out_dir: str = field(
        default_factory=lambda: os.environ.get(
            "HPC_SANITIZER_DIR", tempfile.mkdtemp(prefix="hpc_replay_")
        )
    )
    records: list = field(default_factory=list)
    _originals: list = field(default_factory=list)

    def __enter__(self):
        self._originals = []
        for fn in self.fns:
            mod = importlib.import_module(fn.__module__)
            name = fn.__name__
            self._originals.append((mod, name, fn))

            def make_wrapper(f, m, n):
                def wrapper(*args, **kwargs):
                    if _capturing():
                        return f(*args, **kwargs)
                    rec_args, rec_kwargs = _to_host(args), _to_host(kwargs)
                    out = f(*args, **kwargs)
                    rec = CallRecord(name=n, module=m.__name__, args=rec_args, kwargs=rec_kwargs,
                                     outputs=_to_host(out))
                    rec.path = os.path.join(self.out_dir, f"{m.__name__}.{n}.{len(self.records)}.pkl")
                    with open(rec.path, "wb") as fh:
                        pickle.dump(rec, fh)
                    self.records.append(rec)
                    return out

                wrapper.__name__ = n
                # the defining module, so that a nested hook can find and
                # wrap this function again
                wrapper.__module__ = m.__name__
                return wrapper

            setattr(mod, name, make_wrapper(fn, mod, name))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._originals:
            setattr(mod, name, fn)
        return False


def replay_record(rec: CallRecord | str, check_interpret: bool = True) -> None:
    """Re-run a recorded call twice on its devices; raise AssertionError
    unless both runs' outputs equal each other and the recorded outputs bit
    for bit (NaNs included). ``check_interpret`` (JAX's interpreter re-run)
    is accepted and unused: a CUDA kernel has no interpreter."""
    del check_interpret
    if isinstance(rec, str):
        with open(rec, "rb") as fh:
            rec = pickle.load(fh)
    fn = getattr(importlib.import_module(rec.module), rec.name)
    runs = [_leaves(fn(*_to_device(rec.args), **_to_device(rec.kwargs))) for _ in range(2)]
    want = _leaves(rec.outputs)
    if len(runs[0]) != len(want):
        raise AssertionError(f"{rec.module}.{rec.name}: {len(runs[0])} outputs, recorded {len(want)}")
    for a, b, w in zip(*runs, want):
        if _bytes(a) != _bytes(b):
            raise AssertionError(f"{rec.module}.{rec.name}: nondeterministic output across replays")
        if a.dtype != w.dtype or a.shape != w.shape or _bytes(a) != _bytes(w):
            raise AssertionError(f"{rec.module}.{rec.name}: replay differs from recorded output")


__all__ = ["TraceHook", "CallRecord", "replay_record"]
