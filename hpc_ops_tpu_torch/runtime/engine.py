"""Continuous-batching serving engine (port of ``runtime/engine.py``, core).

Paged-KV block management (native allocator), whole-prompt or chunked
prefill, dynamically batched decode and sampling, on the port's model.

Shape policy: PyTorch runs eagerly, so nothing is recompiled per shape and
the JAX engine's power-of-two prefill buckets are dropped: a prefill runs
exactly the prompt's (or chunk's) rows. Decode still runs the full
``max_batch``, with dummy slots parked on a reserved page, so every decode
step has one shape.

Fused multi-step decode (``multi_step`` > 1), as in the JAX engine: a
dispatch runs ``multi_step`` decode steps of a fixed batch
(:func:`~hpc_ops_tpu_torch.models.llama.decode_multi`), each request's page
table pre-extended by ``multi_step - 1`` slots, tokens past ``max_new`` or a
stop token dropped. On a card the steps are one CUDA graph
(:class:`~hpc_ops_tpu_torch.runtime.decode_graph.DecodeMultiGraph`), captured
at the first multi-step dispatch and kept by the engine: a dispatch is one
host-to-device copy, one replay and one device-to-host copy. Prefill stays
eager, and chunked prefill still interleaves with the dispatches.

``logprobs``: each output token's log-softmax under the logits it was sampled
from (``Request.logprobs``), computed on the device and copied with the
tokens, one device-to-host copy a step.

Ported: ``add_request`` (n=1) with its capacity check, continuous batching,
whole-prompt and chunked prefill (``prefill_chunk``), greedy and
engine-level temperature sampling, stop tokens, ``multi_step``,
``logprobs``, ``cancel``, ``stats``, ``step`` and ``run``. The other
features of the JAX engine raise ``NotImplementedError`` naming ROADMAP
queue 1 item 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpc_ops_tpu_torch.models.llama import (
    ModelConfig,
    check_supported,
    decode_multi,
    forward_step,
    init_cache,
)
from hpc_ops_tpu_torch.ops.sampler import fused_sampler
from hpc_ops_tpu_torch.runtime import PagedBlockAllocator
from hpc_ops_tpu_torch.runtime.decode_graph import DecodeMultiGraph

__all__ = ["Engine", "Request"]

_LATER = "is not ported yet: ROADMAP queue 1 item 1 (deferred Engine features)"


@dataclass
class Request:
    rid: int
    prompt: list
    out: list = field(default_factory=list)
    max_new: int = 16
    done: bool = False
    prefilled: int = 0  # prompt tokens already written to the KV cache
    stop: frozenset = frozenset()  # sampling any of these ends the request
    logprobs: list = field(default_factory=list)  # per output token, with logprobs=True

    @property
    def tokens(self) -> list:
        return self.prompt + self.out


def sample_rows(logits: torch.Tensor, temperature: float, seed: int, logprobs: bool):
    """Sample one token a row of ``logits`` [rows, vocab]: greedy, or at
    ``temperature`` with noise seeded from ``seed``. Returns (tokens,
    logprobs or None) as host lists, from one device-to-host copy: with
    ``logprobs`` each token's log-softmax under its row's logits, computed on
    the device and packed with the tokens."""
    if temperature <= 0.0:
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        toks, _ = fused_sampler(logits, temperature=float(temperature), seed=seed)
        toks = toks.reshape(-1).to(torch.int32)
    if not logprobs:
        return toks.tolist(), None
    lp = torch.log_softmax(logits.float(), dim=-1).gather(1, toks.long()[:, None])[:, 0]
    host = torch.stack([toks, lp.view(torch.int32)]).cpu().numpy()
    return host[0].tolist(), host[1].view(np.float32).tolist()


def next_seed(seed: int, calls: int) -> int:
    """The seed of a sampling call: a per-call counter folded into the
    engine's seed, so calls draw different noise (the JAX engine's rule)."""
    return (seed + 0x9E3779B9 * calls) % (2**31)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _append_runs(requests: dict, rids, toks: np.ndarray, lps, finish) -> None:
    """Append a fused run's tokens ``toks`` [steps, slots] (and logprobs) to
    the requests of the slots, each up to its ``max_new`` or stop token."""
    for i, rid in enumerate(rids):
        req = requests[rid]
        for j in range(toks.shape[0]):
            if req.done or len(req.out) >= req.max_new:
                break
            req.out.append(int(toks[j, i]))
            if lps is not None:
                req.logprobs.append(float(lps[j, i]))
            finish(req)
        finish(req)


class Engine:
    """Continuous-batching engine over one model + one paged cache pool.

    Runs on ``device`` ("cuda" unless the caller asks for the CPU); the
    weights are moved there if they live elsewhere.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        weights,
        *,
        num_blocks: int = 128,
        block_size: int = 16,
        max_batch: int = 8,
        max_blocks_per_seq: int | None = None,
        temperature: float = 0.0,
        seed: int = 0,
        topk: int = 0,
        topp: float = 0.0,
        softmax_policy=None,
        repetition_penalty: float = 0.0,
        speculative_k: int = 0,
        draft_fn=None,
        prefill_chunk: int | None = None,
        multi_step: int = 1,
        prefix_cache: bool = False,
        stop_tokens=(),
        logprobs: bool = False,
        device="cuda",
    ):
        deferred = {
            "speculative_k": speculative_k != 0 or draft_fn is not None,
            "prefix_cache": prefix_cache,
            "topk/topp/repetition_penalty/softmax_policy": (
                topk != 0 or topp != 0.0 or repetition_penalty != 0.0
                or softmax_policy is not None
            ),
        }
        for name, on in deferred.items():
            if on:
                raise NotImplementedError(f"Engine({name}) {_LATER}")
        if prefill_chunk is not None and prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be positive")
        if multi_step < 1:
            raise ValueError("multi_step must be at least 1")
        check_supported(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: no CUDA device; pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.weights = _to_device(weights, self.device)
        self.block_size = block_size
        self.max_batch = max_batch
        self.temperature = temperature
        self.seed = seed
        # chunked prefill: a long prompt prefills prefill_chunk tokens per
        # step and decode batches run between its chunks
        self.prefill_chunk = prefill_chunk
        self._prefer_decode = False
        self.stop_tokens = frozenset(map(int, stop_tokens))
        self.multi_step = multi_step
        self.logprobs = logprobs
        self._multi = None  # the fused multi-step decode, made at its first dispatch
        self._sample_calls = 0
        self._prefill_dispatches = 0
        self._decode_dispatches = 0
        self.alloc = PagedBlockAllocator(num_blocks, block_size)
        self.caches = init_cache(cfg, num_blocks=num_blocks, block_size=block_size, device=self.device)
        self.max_blocks_per_seq = max_blocks_per_seq or max(num_blocks // 4, 4)
        # reserved page for dummy decode slots (never read back)
        self._dummy_seq = -1
        self.alloc.extend(self._dummy_seq, 1)
        self._dummy_block = int(self.alloc.table(self._dummy_seq)[0])
        self.requests: dict[int, Request] = {}
        self._pending: list[int] = []
        self._active: list[int] = []
        self._next_rid = 0

    # ------------------------------------------------------------- requests
    def add_request(self, prompt_ids, max_new: int = 16, n: int = 1,
                    stop=None, temperature=None, topk=None, topp=None):
        """Queue a request and return its rid. Raises ValueError when its KV
        footprint cannot fit ``max_blocks_per_seq``."""
        if n != 1:
            raise NotImplementedError(f"add_request(n > 1) {_LATER}")
        if temperature is not None or topk is not None or topp is not None:
            raise NotImplementedError(f"per-request sampling params {_LATER}")
        need = len(prompt_ids) + max_new + self.multi_step - 1  # a fused run's slack
        cap = self.max_blocks_per_seq * self.block_size
        if need > cap:
            raise ValueError(
                f"request needs {need} KV slots (prompt {len(prompt_ids)} + "
                f"max_new {max_new}) but max_blocks_per_seq="
                f"{self.max_blocks_per_seq} x block_size={self.block_size} "
                f"caps a sequence at {cap}"
            )
        stop_set = self.stop_tokens if stop is None else frozenset(map(int, stop))
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, list(map(int, prompt_ids)), max_new=max_new, stop=stop_set)
        self._pending.append(rid)
        return rid

    def cancel(self, rid: int) -> None:
        """Abort a request: drop it from scheduling and release its pages."""
        req = self.requests.get(rid)
        if req is None or req.done:
            return
        req.done = True
        if rid in self._pending:
            self._pending.remove(rid)
        if rid in self._active:
            self._active.remove(rid)
        self._release(rid)

    def _release(self, rid: int) -> None:
        try:
            self.alloc.free(rid)
        except KeyError:
            pass  # never prefilled: it holds no pages

    # --------------------------------------------------------------- steps
    def _sample(self, logits: torch.Tensor):
        """(tokens, logprobs or None) of each row, one device-to-host copy."""
        if self.temperature > 0.0:
            self._sample_calls += 1
        return sample_rows(logits, self.temperature, next_seed(self.seed, self._sample_calls),
                           self.logprobs)

    def _table(self, rid: int) -> np.ndarray:
        return self.alloc.table(rid, pad_to=self.max_blocks_per_seq)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _prefill_one(self, rid: int) -> bool:
        """Prefill the next chunk of `rid`'s prompt (the whole prompt when
        chunking is off). Returns True when the prompt is fully prefilled;
        only then is the first token sampled and the request activated."""
        req = self.requests[rid]
        total = len(req.prompt)
        start = req.prefilled
        n = total - start
        if self.prefill_chunk is not None:
            n = min(self.prefill_chunk, n)
        self.alloc.extend(rid, start + n)  # extend() takes TOTAL tokens
        logits, self.caches = forward_step(
            self.weights, self.caches, self.cfg,
            token_ids=self._tensor(req.prompt[start : start + n]),
            seq_lens=self._tensor([start + n]),
            q_index=self._tensor([0, n]),
            block_ids=self._tensor(self._table(rid)[None, :]),
            is_prefill=True,
            max_seqlens_q=n,
        )
        req.prefilled = start + n
        if req.prefilled < total:
            return False
        toks, lps = self._sample(logits.reshape(1, -1))
        req.out.append(int(toks[0]))
        if lps is not None:
            req.logprobs.append(lps[0])
        self._active.append(rid)
        self._finish_if_done(req)
        return True

    def _finish_if_done(self, req: Request) -> None:
        if req.done:
            return
        if len(req.out) >= req.max_new or (req.out and req.out[-1] in req.stop):
            req.done = True
            if req.rid in self._active:
                self._active.remove(req.rid)
            self._release(req.rid)

    def _batch_inputs(self, slack: int):
        """The decode batch's rids and its [max_batch] inputs (last tokens,
        lengths, page tables), each request's table extended to cover
        ``slack`` more slots; dummy slots sit on the reserved page."""
        rids = self._active[: self.max_batch]
        b = self.max_batch
        tokens = np.zeros((b,), np.int32)
        seq_lens = np.ones((b,), np.int32)
        tables = np.full((b, self.max_blocks_per_seq), self._dummy_block, np.int32)
        for i, rid in enumerate(rids):
            req = self.requests[rid]
            new_len = len(req.tokens)
            self.alloc.extend(rid, new_len + slack)
            tokens[i] = req.tokens[-1]
            seq_lens[i] = new_len
            tables[i] = self._table(rid)
        return rids, tokens, seq_lens, tables

    def _decode_batch(self) -> None:
        rids, tokens, seq_lens, tables = self._batch_inputs(0)
        b = self.max_batch
        logits, self.caches = forward_step(
            self.weights, self.caches, self.cfg,
            token_ids=self._tensor(tokens),
            seq_lens=self._tensor(seq_lens),
            q_index=torch.arange(b + 1, dtype=torch.int32, device=self.device),
            block_ids=self._tensor(tables),
            is_prefill=False,
            max_seqlens_q=1,
        )
        toks, lps = self._sample(logits)
        for i, rid in enumerate(rids):
            req = self.requests[rid]
            req.out.append(int(toks[i]))
            if lps is not None:
                req.logprobs.append(lps[i])
            self._finish_if_done(req)

    def _decode_multi_fn(self) -> DecodeMultiGraph:
        """The engine's fused multi-step decode over its weights and caches
        (captured on a card at its first dispatch)."""
        if self._multi is None:
            # no reference to the engine: a cycle would keep its weights and
            # caches alive after the engine is dropped, until a collection
            weights, caches, cfg, steps = self.weights, self.caches, self.cfg, self.multi_step
            temperature, logprobs = self.temperature, self.logprobs

            def body(last_tokens, seq_lens, block_ids, generators):
                out, _ = decode_multi(
                    weights, caches, cfg, last_tokens, seq_lens, block_ids, steps,
                    temperature=temperature, return_logprobs=logprobs,
                    generator=None if generators is None else generators[0])
                return out

            self._multi = DecodeMultiGraph(
                body, self.max_batch, self.max_blocks_per_seq, self.multi_step, self.device,
                temperature=self.temperature, return_logprobs=self.logprobs)
        return self._multi

    def _decode_batch_multi(self) -> None:
        """One fused ``multi_step``-step decode dispatch: the batch membership
        is fixed for the run; a request that reaches ``max_new`` or a stop
        token mid-run drops the surplus tokens (its page-table slack covered
        their cache writes)."""
        rids, tokens, seq_lens, tables = self._batch_inputs(self.multi_step - 1)
        # a per-run seed: a fixed one would replay the same noise every run
        self._sample_calls += 1
        toks, lps = self._decode_multi_fn()(tokens, seq_lens, tables,
                                            next_seed(self.seed, self._sample_calls))
        _append_runs(self.requests, rids, toks, lps, self._finish_if_done)

    @property
    def stats(self) -> dict:
        """Serving counters: dispatches, tokens, occupancy, cache state."""
        return {
            "requests": len(self.requests),
            "pending": len(self._pending),
            "active": len(self._active),
            "done": sum(r.done for r in self.requests.values()),
            "tokens_out": sum(len(r.out) for r in self.requests.values()),
            "prefill_dispatches": self._prefill_dispatches,
            "decode_dispatches": self._decode_dispatches,
            "blocks_free": self.alloc.num_free,
            "blocks_total": self.alloc.num_blocks,
        }

    def step(self) -> bool:
        """One engine step (a prefill [chunk] or a decode batch). Returns
        False when no work remains. With chunked prefill, decode batches
        alternate with prefill chunks."""
        if self._pending and not (
            self.prefill_chunk is not None and self._active and self._prefer_decode
        ):
            self._prefill_dispatches += 1
            if self._prefill_one(self._pending[0]):
                self._pending.pop(0)
            self._prefer_decode = True
            return True
        self._prefer_decode = False
        if self._active:
            self._decode_dispatches += 1
            if self.multi_step > 1:
                self._decode_batch_multi()
            else:
                self._decode_batch()
            return True
        return False

    def run(self, prompts, max_new: int = 8) -> list:
        """Serve `prompts` to completion; return their token lists."""
        rids = [self.add_request(p, max_new=max_new) for p in prompts]
        while self.step():
            pass
        return [self.requests[r].out for r in rids]
