"""Continuous batching over a tensor-parallel mesh (port of
``runtime/sharded_engine.py``).

The model is tp-sharded within each row shard (``shard_weights``), and the
request rows and their KV page pools are split over the row shards: the
product of the mesh's row axes, every axis but "tp" (``dp``; ``ddp`` x
``dp`` on a hybrid mesh of ``make_hybrid_mesh``), ddp-major as JAX's
``P(("ddp", "dp"))``. Each rank's caches lie on the rank's device, and the
rows a step reads are made on the device of the shard that reads them.
Each row shard owns ``max_batch`` decode slots and a shard-local page pool (a
:class:`PagedBlockAllocator` per shard; block ids are shard-local). Incoming
requests go to the least-loaded shard. Every engine step runs ONE global
step of :func:`~hpc_ops_tpu_torch.models.llama.make_sharded_step`: either a
decode step over every shard's slots (empty slots are dummy rows parked on
the shard's reserved page), or a prefill step with one request per shard
(the next chunk of each with chunked prefill; shards without pending work
run a dummy row, and every shard's rows are padded to the round's longest
chunk, the port's Engine running each prefill at its own length instead of
JAX's power-of-two buckets). Token rows move host <-> device as small int32
arrays, one device-to-host copy a step (the sampled tokens); weights and
caches stay on the mesh.

With ``multi_step`` > 1 a decode round is one fused run of ``multi_step``
steps over the whole mesh (:func:`~hpc_ops_tpu_torch.models.llama.
make_sharded_multi_step`): on a card ONE CUDA graph for every rank of
the mesh, captured at the first such round and replayed at the next, one
host-to-device and one device-to-host copy a round; the Engine's rules
(slack, fixed batch, surplus tokens dropped). ``logprobs`` records each
output token's log-softmax, copied with the tokens.

Ported: ``add_request`` with its capacity check, least-loaded shard
assignment, whole-prompt and chunked prefill (``prefill_chunk``), greedy and
engine-level temperature sampling, stop tokens, ``multi_step``,
``logprobs``, ``stats``, ``step`` and ``run``.
"""

from __future__ import annotations

import numpy as np
import torch

from hpc_ops_tpu_torch.models.llama import (
    ModelConfig,
    check_supported,
    init_cache,
    make_sharded_multi_step,
    make_sharded_step,
    shard_weights,
)
from hpc_ops_tpu_torch.runtime import PagedBlockAllocator
from hpc_ops_tpu_torch.runtime.engine import Request, _append_runs, next_seed, sample_rows

__all__ = ["ShardedEngine"]


class ShardedEngine:
    """Continuous batching over a (..row axes.., "tp") mesh of
    :func:`~hpc_ops_tpu_torch.parallel.mesh.make_mesh` or
    :func:`~hpc_ops_tpu_torch.parallel.mesh.make_hybrid_mesh`."""

    def __init__(
        self,
        cfg: ModelConfig,
        weights,
        mesh,
        *,
        num_blocks: int = 128,  # per row shard
        block_size: int = 16,
        max_batch: int = 4,  # decode slots per row shard
        max_blocks_per_seq: int | None = None,
        prefill_chunk: int | None = None,
        multi_step: int = 1,
        stop_tokens=(),
        logprobs: bool = False,
        temperature: float = 0.0,
        seed: int = 0,
    ):
        if prefill_chunk is not None and prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be positive")
        if multi_step < 1:
            raise ValueError("multi_step must be at least 1")
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.tp = mesh.shape["tp"]
        self.row_axes = tuple(a for a in mesh.axis_names if a != "tp")
        self.num_shards = int(np.prod([mesh.shape[a] for a in self.row_axes]))
        # where each shard's host-made rows go: its rank 0's device
        self._shard_devices = [mesh.grid[d, 0] for d in range(self.num_shards)]
        self.block_size = block_size
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self._prefer_decode = False
        self.stop_tokens = frozenset(map(int, stop_tokens))
        # fused multi-step decode over the mesh: Engine(multi_step)'s rules
        self.multi_step = multi_step
        self.logprobs = logprobs
        self._multi = (make_sharded_multi_step(mesh, cfg, multi_step, return_logprobs=logprobs,
                                               temperature=temperature) if multi_step > 1 else None)
        self.temperature = temperature
        self.seed = seed
        self._sample_calls = 0
        self._prefill_dispatches = 0
        self._decode_dispatches = 0
        self.num_blocks = num_blocks
        self.max_blocks_per_seq = max_blocks_per_seq or max(num_blocks // 4, 4)
        self.weights = shard_weights(weights, cfg, mesh)
        self.caches = [[init_cache(cfg, num_blocks, block_size, tp=self.tp, device=mesh.grid[d, r])
                        for r in range(self.tp)] for d in range(self.num_shards)]
        # one allocator per row shard; its reserved page parks dummy rows
        self.allocs = [PagedBlockAllocator(num_blocks, block_size) for _ in range(self.num_shards)]
        self._dummy_blocks = []
        for a in self.allocs:
            a.extend(-1, 1)
            self._dummy_blocks.append(int(a.table(-1)[0]))
        self.requests: dict[int, Request] = {}
        self._owner: dict[int, int] = {}
        self._pending: list[int] = []
        self._active: list[list[int]] = [[] for _ in range(self.num_shards)]
        self._next_rid = 0
        self._decode_step = make_sharded_step(mesh, cfg, is_prefill=False, max_seqlens_q=1)

    # ------------------------------------------------------------ requests
    def add_request(self, prompt_ids, max_new: int = 16, stop=None) -> int:
        """Queue a request and return its rid. Raises ValueError when its KV
        footprint cannot fit ``max_blocks_per_seq``."""
        need = len(prompt_ids) + max_new + self.multi_step - 1  # a fused run's slack
        cap = self.max_blocks_per_seq * self.block_size
        if need > cap:
            raise ValueError(
                f"request needs {need} KV slots but the per-seq page table caps a sequence at {cap}")
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(
            rid, list(map(int, prompt_ids)), max_new=max_new,
            stop=self.stop_tokens if stop is None else frozenset(map(int, stop)))
        self._pending.append(rid)
        return rid

    # --------------------------------------------------------------- steps
    def _rows(self, a: np.ndarray) -> list:
        """Host rows [num_shards, ...] as a row-sharded argument: each shard's
        part on the device of the shard that reads it."""
        return [torch.as_tensor(np.ascontiguousarray(part), dtype=torch.int32).to(dev)
                for part, dev in zip(a, self._shard_devices)]

    def _table(self, shard: int, rid: int) -> np.ndarray:
        return self.allocs[shard].table(rid, pad_to=self.max_blocks_per_seq)

    def _sample(self, logits: torch.Tensor):
        """Greedy argmax, or temperature sampling with a seed advanced per
        dispatch, and the logprobs when asked; one device-to-host copy."""
        if self.temperature > 0.0:
            self._sample_calls += 1
        return sample_rows(logits, self.temperature, next_seed(self.seed, self._sample_calls),
                           self.logprobs)

    def _prefill_round(self) -> None:
        """Prefill up to one pending request per shard in one global step (the
        next chunk of each with chunked prefill). A request mid-prefill keeps
        its owner shard (its pages are shard-local) and leaves ``_pending``
        only once fully prefilled."""
        take: list[int | None] = [None] * self.num_shards
        for rid in self._pending:  # mid-prefill requests resume on their shard first
            s = self._owner.get(rid)
            if s is not None and take[s] is None:
                take[s] = rid
        fresh = (r for r in self._pending if self._owner.get(r) is None)
        free = sorted((s for s in range(self.num_shards) if take[s] is None),
                      key=lambda s: len(self._active[s]))
        for s in free:  # least-loaded shards first
            take[s] = next(fresh, None)
        chunks = {}
        for rid in take:
            if rid is not None:
                req = self.requests[rid]
                n = len(req.prompt) - req.prefilled
                chunks[rid] = n if self.prefill_chunk is None else min(self.prefill_chunk, n)
        rows = max(chunks.values())
        tokens = np.zeros((self.num_shards, rows), np.int32)
        seq_lens = np.ones((self.num_shards, 1), np.int32)  # dummy rows: one token
        q_index = np.tile(np.array([0, 1], np.int32), (self.num_shards, 1))
        tables = np.zeros((self.num_shards, 1, self.max_blocks_per_seq), np.int32)
        for s, rid in enumerate(take):
            tables[s] = self._dummy_blocks[s]
            if rid is None:
                continue
            req = self.requests[rid]
            start, n = req.prefilled, chunks[rid]
            self._owner[rid] = s
            self.allocs[s].extend(rid, start + n)  # extend() takes TOTAL tokens
            tokens[s, :n] = req.prompt[start : start + n]
            seq_lens[s, 0] = start + n
            q_index[s] = (0, n)
            tables[s, 0] = self._table(s, rid)
        step = make_sharded_step(self.mesh, self.cfg, is_prefill=True, max_seqlens_q=rows)
        logits, self.caches = step(self.weights, self.caches, self._rows(tokens), self._rows(seq_lens),
                                   self._rows(q_index), self._rows(tables))
        toks, lps = self._sample(logits)  # one row per shard
        for s, rid in enumerate(take):
            if rid is None:
                continue
            req = self.requests[rid]
            req.prefilled += chunks[rid]
            if req.prefilled < len(req.prompt):
                continue  # more chunks to go; this row's logits are a prefix's
            self._pending.remove(rid)
            req.out.append(int(toks[s]))
            if lps is not None:
                req.logprobs.append(lps[s])
            self._active[s].append(rid)
            self._finish_if_done(req)

    def _finish_if_done(self, req: Request) -> None:
        if req.done:
            return
        if len(req.out) >= req.max_new or (req.out and req.out[-1] in req.stop):
            req.done = True
            s = self._owner[req.rid]
            if req.rid in self._active[s]:
                self._active[s].remove(req.rid)
            self.allocs[s].free(req.rid)

    def _round_inputs(self, slack: int):
        """Each shard's served rids and the round's inputs ([shards, batch]
        last tokens and lengths, [shards, batch, max_blocks] page tables),
        each request's table extended to cover ``slack`` more slots; empty
        slots sit on the shard's reserved page."""
        b = self.max_batch
        tokens = np.zeros((self.num_shards, b), np.int32)
        seq_lens = np.ones((self.num_shards, b), np.int32)
        tables = np.zeros((self.num_shards, b, self.max_blocks_per_seq), np.int32)
        served = []
        for s in range(self.num_shards):
            tables[s] = self._dummy_blocks[s]
            rids = self._active[s][:b]
            served.append(rids)
            for i, rid in enumerate(rids):
                req = self.requests[rid]
                new_len = len(req.tokens)
                self.allocs[s].extend(rid, new_len + slack)
                tokens[s, i] = req.tokens[-1]
                seq_lens[s, i] = new_len
                tables[s, i] = self._table(s, rid)
        return served, tokens, seq_lens, tables

    def _decode_round(self) -> None:
        b = self.max_batch
        served, tokens, seq_lens, tables = self._round_inputs(0)
        q_index = np.tile(np.arange(b + 1, dtype=np.int32), (self.num_shards, 1))
        logits, self.caches = self._decode_step(
            self.weights, self.caches, self._rows(tokens), self._rows(seq_lens), self._rows(q_index),
            self._rows(tables))
        toks, lps = self._sample(logits)
        for s, rids in enumerate(served):
            for i, rid in enumerate(rids):
                req = self.requests[rid]
                req.out.append(int(toks[s * b + i]))
                if lps is not None:
                    req.logprobs.append(lps[s * b + i])
                self._finish_if_done(req)

    def _decode_round_multi(self) -> None:
        """One fused ``multi_step`` decode dispatch over the whole mesh."""
        b, n = self.max_batch, self.multi_step
        served, tokens, seq_lens, tables = self._round_inputs(n - 1)
        self._sample_calls += 1  # a per-run seed
        (toks, lps), _ = self._multi(self.weights, self.caches, tokens.reshape(-1), seq_lens.reshape(-1),
                                     tables.reshape(self.num_shards * b, -1),
                                     next_seed(self.seed, self._sample_calls), to_host=True)
        rids = [rid for rids in served for rid in rids]
        slots = [s * b + i for s, rids in enumerate(served) for i in range(len(rids))]
        _append_runs(self.requests, rids, toks[:, slots], None if lps is None else lps[:, slots],
                     self._finish_if_done)

    @property
    def stats(self) -> dict:
        """Serving counters: dispatches, tokens, occupancy, cache state."""
        return {
            "requests": len(self.requests),
            "pending": len(self._pending),
            "active": sum(len(a) for a in self._active),
            "done": sum(r.done for r in self.requests.values()),
            "tokens_out": sum(len(r.out) for r in self.requests.values()),
            "prefill_dispatches": self._prefill_dispatches,
            "decode_dispatches": self._decode_dispatches,
            "blocks_free": sum(a.num_free for a in self.allocs),
            "blocks_total": sum(a.num_blocks for a in self.allocs),
        }

    def step(self) -> bool:
        """One global step (a prefill round or a decode round); False when no
        work remains. With chunked prefill, decode rounds alternate with chunk
        rounds so active requests keep producing tokens while long prompts
        stream in."""
        if self._pending and not (
            self.prefill_chunk is not None and any(self._active) and self._prefer_decode
        ):
            self._prefill_dispatches += 1
            self._prefill_round()
            self._prefer_decode = True
            return True
        self._prefer_decode = False
        if any(self._active):
            self._decode_dispatches += 1
            if self.multi_step > 1:
                self._decode_round_multi()
            else:
                self._decode_round()
            return True
        return False

    def run(self, prompts, max_new: int = 8) -> list:
        """Serve ``prompts`` to completion; return their token lists."""
        rids = [self.add_request(p, max_new=max_new) for p in prompts]
        while self.step():
            pass
        return [self.requests[r].out for r in rids]
