"""Fused multi-step decode as one captured CUDA graph.

The JAX package runs ``decode_multi`` as one compiled ``lax.scan``: no host
round trip between its steps. The port's counterpart on a card is a
``torch.cuda.CUDAGraph`` of all ``num_steps`` iterations of
:func:`~hpc_ops_tpu_torch.models.llama.decode_multi` for one batch shape:
forward, in-graph sampling, the token fed back, ``lens + 1``. A dispatch is
one host-to-device copy into the static inputs (the last tokens, the
sequence lengths and the page tables of the batch, packed into one buffer),
one ``graph.replay()`` and one device-to-host copy of the static output (the
tokens ``[num_steps, B]``, and with logprobs their log-probabilities, packed
into the same buffer). The caches are written in place: the graph holds
their addresses, so the same cache tensors serve every replay.

What the capture relies on:

* the graph is captured at the first dispatch, after one eager run of the
  same work on the same streams (the capture's own side stream, and under
  tensor parallelism each rank's stream), which makes every piece of
  per-stream state a kernel wrapper keeps: the decode kernel's ticket
  buffers, the collective's signal pad, the library, the kernels'
  shared-memory attributes and the cuBLAS workspaces. A wrapper that would
  make such state during a capture raises
  (:func:`~hpc_ops_tpu_torch.kernels.refuse_under_capture`). The eager run
  and the first replay both decode the first dispatch's inputs and write
  the same cache slots;
* kernel arguments are frozen at capture, including the host-chosen forms,
  which are functions of shapes only: the decode step has one shape (dummy
  slots pad the batch), and every replay uses the capture's buffers;
* temperature sampling draws its noise from one CUDA generator a rank,
  registered with the graph and seeded before each replay, so a replay with
  seed ``s`` draws what the eager loop with a generator seeded ``s`` draws;
* the kernel wrappers count launches on the host, so the launches counted
  during the capture are taken back and added again at each replay
  (:func:`~hpc_ops_tpu_torch.kernels.add_launches`);
* under tensor parallelism the whole mesh is one graph: the rank threads'
  streams join the capture through the entry event that
  :func:`~hpc_ops_tpu_torch.parallel.mesh.run_ranks` records on the
  capturing stream and leave it through their done events, and the fused
  collective's cross-stream waits are events recorded inside the capture. A
  replay runs no rank thread. The collective keeps its epoch in device
  memory, so replays and eager calls share one count;
* on a mesh over distinct devices the capture spans the ranks' devices the
  same way (the entry and done events cross devices, as the per-device
  collective's do), and while it runs every allocation on a device other
  than the capturing one goes to a private pool of the graph's pool id on
  that device, so no block the graph writes serves other work afterwards
  (the pools are released with the object). The rank threads' copies to
  and from the capturing device run on the capturing stream there.

On a card a capture or replay that fails raises: nothing runs the eager loop
in its place. On the CPU the object runs the loop itself at each dispatch.
"""

from __future__ import annotations

import ctypes
import time
import weakref

import numpy as np
import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.runtime.tracing import span

__all__ = ["DecodeMultiGraph", "CAPTURE_MODE"]

# The capture's cudaStreamCaptureMode. "global" forbids potentially unsafe
# CUDA calls in every thread while the capture runs, the rank threads of a
# tensor-parallel mesh included, which launch their work into the capture
# another thread began: they make no such call (the capture succeeds on the
# card), so the strictest mode stays.
CAPTURE_MODE = "global"


class DecodeMultiGraph:
    """``decode_multi`` over one batch shape, captured as one CUDA graph.

    ``body(last_tokens, seq_lens, block_ids, generators)`` runs the
    ``num_steps`` decode steps eagerly on device tensors ([B], [B], [B,
    max_blocks] int32) and returns the tokens [num_steps, B] int32, or with
    ``return_logprobs`` (tokens, logprobs [num_steps, B] float32);
    ``generators`` is None at temperature 0, else one generator per rank
    (``rank_devices``: each rank's device, default ``device`` alone), each
    already seeded, for the rank's noise. The object makes
    the generators, registers them with the graph and seeds them with each
    dispatch's seed.

    ``stats`` (after the first dispatch on a card): ``capture_s`` and
    ``instantiate_s``, ``pool_bytes`` (device memory the graph's pool
    reserved), and the captured graph's ``kernel_nodes``, ``memcpy_nodes``
    (``host_memcpy_nodes`` of them from or to host memory), ``nodes``,
    ``collective_nodes`` and ``collective_nodes_cooperative``
    (the fused collective's nodes and those that the capture marked
    cooperative: the capture raises unless they are all) and
    ``collective_rank_nodes`` (the per-device form's). ``launches``: the
    kernel wrappers' launches of one replay.
    """

    def __init__(self, body, batch: int, max_blocks: int, num_steps: int, device, *, rank_devices=None,
                 temperature: float = 0.0, return_logprobs: bool = False):
        self.body = body
        self.batch, self.max_blocks, self.num_steps = batch, max_blocks, num_steps
        self.device = torch.device(device)
        self.rank_devices = [torch.device(d) for d in rank_devices] if rank_devices else [self.device]
        self.temperature = float(temperature)
        self.return_logprobs = return_logprobs
        self.graph = None
        self.launches: dict = {}
        self.stats: dict = {}
        self._cuda = self.device.type == "cuda"
        if not self._cuda:
            return
        n = batch * (2 + max_blocks)
        self._inp = torch.zeros(n, dtype=torch.int32, device=self.device)
        self._host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
        self._staged = torch.cuda.Event()
        self._gens = ([torch.Generator(device=d) for d in self.rank_devices]
                      if self.temperature > 0 else None)
        self._packed = None

    def _views(self):
        b = self.batch
        return self._inp[:b], self._inp[b : 2 * b], self._inp[2 * b :].view(b, self.max_blocks)

    def _stage(self, last_tokens, seq_lens, block_ids) -> None:
        """Copy a dispatch's inputs into the static buffer, in one copy from
        pinned memory (tensors are brought to the host first)."""
        with span("decode_graph.stage"):
            self._staged.synchronize()  # the last dispatch's copy has left the pinned buffer
            b = self.batch
            host = self._host.numpy()
            for lo, hi, part in ((0, b, last_tokens), (b, 2 * b, seq_lens), (2 * b, None, block_ids)):
                part = part.cpu().numpy() if isinstance(part, torch.Tensor) else np.asarray(part)
                host[lo:hi] = part.reshape(-1)
            self._inp.copy_(self._host, non_blocking=True)
            self._staged.record()

    def _pack(self, out) -> torch.Tensor:
        """The static output: tokens [n, B] int32, or [2, n, B] int32 holding
        the tokens and the logprobs' float32 bits, so one copy brings both."""
        if not self.return_logprobs:
            return out
        toks, lps = out
        return torch.stack([toks, lps.view(torch.int32)])

    def _unpack(self, packed: torch.Tensor):
        if not self.return_logprobs:
            return packed
        return packed[0], packed[1].view(torch.float32)

    def _capture(self) -> None:
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        inputs = self._views()
        with torch.cuda.stream(side):
            self.body(*inputs, self._gens)  # the eager run: makes every piece of per-stream state
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self._gens or ():
            graph.register_generator_state(g)
        before = kernels.launch_counts()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first: what it reserves after is the pool
        reserved = torch.cuda.memory_reserved(self.device)
        pool = torch.cuda.graph_pool_handle()
        others = sorted({d.index for d in self.rank_devices if d != self.device})
        for i in others:  # the ranks' allocations on their devices, into the graph's pool id
            torch._C._cuda_beginAllocateToPool(i, pool)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode=CAPTURE_MODE):
                packed = self._pack(self.body(*inputs, self._gens))
        finally:
            for i in others:
                torch._C._cuda_endAllocateToPool(i, pool)
        for i in others:
            weakref.finalize(self, torch._C._cuda_releasePool, i, pool)
        t1 = time.perf_counter()
        self.launches = {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}
        kernels.add_launches({k: -n for k, n in self.launches.items()})  # the capture launched nothing
        counts = (ctypes.c_int * 7)()
        kernels.check(kernels.lib().hpc_graph_node_counts(graph.raw_cuda_graph(), counts),
                      "hpc_graph_node_counts")
        if counts[2] != counts[1]:  # the collective's blocks wait on each other: all must be resident
            raise RuntimeError(f"the capture left {counts[1] - counts[2]} of {counts[1]} fused-collective "
                               "launches without the cooperative attribute")
        t2 = time.perf_counter()
        graph.instantiate()
        t3 = time.perf_counter()
        caller.wait_stream(side)
        self.graph, self._packed = graph, packed
        self.stats = dict(capture_s=t1 - t0, instantiate_s=t3 - t2,
                          pool_bytes=torch.cuda.memory_reserved(self.device) - reserved,
                          kernel_nodes=counts[0], collective_nodes=counts[1],
                          collective_nodes_cooperative=counts[2], collective_rank_nodes=counts[6],
                          memcpy_nodes=counts[3],
                          host_memcpy_nodes=counts[5], nodes=counts[4])

    def replay(self, last_tokens, seq_lens, block_ids, seed: int = 0):
        """One dispatch; returns the tokens [num_steps, B] int32 (with
        ``return_logprobs`` also the logprobs [num_steps, B] float32) on the
        device, in the static output buffer that the next dispatch
        overwrites. Inputs: host arrays or tensors of any device. On the CPU
        the loop runs in place of the graph, under the same spans."""
        if not self._cuda:
            gens = ([torch.Generator().manual_seed(int(seed)) for _ in self.rank_devices]
                    if self.temperature > 0 else None)
            with span("decode_graph.stage"):
                toks, lens, tbl = (torch.as_tensor(x, dtype=torch.int32)
                                   for x in (last_tokens, seq_lens, block_ids))
            with span("decode_graph.replay"):
                return self.body(toks, lens, tbl.reshape(self.batch, self.max_blocks), gens)
        self._stage(last_tokens, seq_lens, block_ids)
        if self.graph is None:
            self._capture()
        for g in self._gens or ():  # after the capture's eager run, which drew from them
            g.manual_seed(int(seed))
        with span("decode_graph.replay"):
            self.graph.replay()
        kernels.add_launches(self.launches)
        return self._unpack(self._packed)

    def __call__(self, last_tokens, seq_lens, block_ids, seed: int = 0):
        """One dispatch, its result on the host: (tokens [num_steps, B] int32
        numpy, logprobs [num_steps, B] float32 numpy or None), from one
        device-to-host copy."""
        out = self.replay(last_tokens, seq_lens, block_ids, seed)
        with span("decode_graph.fetch"):
            host = (self._packed if self._cuda else self._pack(out)).cpu().numpy()
        if not self.return_logprobs:
            return host, None
        return host[0], host[1].view(np.float32)
