"""Continuous-batching serving engine (port of ``runtime/engine.py``).

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

Speculative decode (``speculative_k``, greedy only): a verification step runs
``[last, d1..dk]`` of every request through the decode path at ``mtp = k``
(the decode kernel's ``sq = k + 1`` query rows), accepts the longest prefix
of drafts that the model's argmax agrees with and emits one correction
token, so the tokens equal plain greedy decode. Drafts come from
``draft_fn(tokens, k)``, by default :func:`ngram_draft`. Rejected drafts
leave cache rows past the committed length: attention reads a request's
rows only up to its ``seq_lens``, and later steps overwrite them.

Prefix caching (``prefix_cache``): a new request whose prompt starts with
full blocks already written for another request, live or finished, shares
those pages (allocator refcounts) and prefills only the rest. Finished
requests keep their pages in LRU order until the pool needs them.

``add_request(n > 1)``: one prefill, n first tokens sampled from its logits
row; the children fork the parent's page table and copy a partial tail page
before they write to it (``alloc.cow_last`` and one in-place ``copy_`` a
cache tensor, so a captured multi-step graph keeps its cache addresses).

The full sampler (``topk``, ``topp``, ``softmax_policy``,
``repetition_penalty``, and per-request ``temperature``/``topk``/``topp``)
runs :func:`~hpc_ops_tpu_torch.ops.sampler.fused_sampler` on the device; the
repetition penalty's bit-packed token mask (one row a live request, seeded
with its prompt, and a scratch row last) never leaves it. Greedy rows of a
mixed batch take the exact argmax. A step still makes one device-to-host
copy.

The JAX engine's ``assert`` s are ``ValueError`` s here, on the same
conditions: speculative decode needs greedy sampling and excludes
``multi_step > 1`` and ``logprobs``; the full sampler and per-request
parameters need ``multi_step == 1``; ``n > 1`` needs temperature > 0.
Speculative, n-best and full-sampler steps run eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hpc_ops_tpu_torch.config import SoftmaxPolicy
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
from hpc_ops_tpu_torch.runtime.tracing import now, span

__all__ = ["Engine", "Request", "ngram_draft"]


def ngram_draft(tokens: list, k: int, n: int = 2) -> list:
    """Prompt-lookup drafter: find the latest earlier occurrence of the
    final n-gram in the request's own history and propose the k tokens that
    followed it. Returns [] when the n-gram has no earlier match (the engine
    then runs a plain decode step)."""
    if len(tokens) <= n:
        return []
    tail = tokens[-n:]
    for s in range(len(tokens) - n - 1, -1, -1):  # right to left over earlier positions
        if tokens[s : s + n] == tail:
            cand = tokens[s + n : s + n + k]
            if cand:
                return list(cand)
    return []


@dataclass
class Request:
    rid: int
    prompt: list
    out: list = field(default_factory=list)
    max_new: int = 16
    done: bool = False
    prefilled: int = 0  # prompt tokens already written to the KV cache
    n_best: int = 1  # parallel samples sharing this prompt's KV (parent)
    parent: int | None = None  # set on n-best children
    stop: frozenset = frozenset()  # sampling any of these ends the request
    logprobs: list = field(default_factory=list)  # per output token, with logprobs=True
    # per-request sampling overrides (None: the engine's)
    temperature: float | None = None
    topk: int | None = None
    topp: float | None = None
    # tracing.now() (perf_counter_ns) when the request was added, when its
    # first prefill step began, when its first token was appended and when
    # it finished or was cancelled; and the ns its admission (the prefix
    # match and the sharing of the matched pages) took
    t_arrive: int | None = None
    t_admit: int | None = None
    t_first: int | None = None
    t_done: int | None = None
    admit_ns: int | None = None

    @property
    def tokens(self) -> list:
        return self.prompt + self.out


def _pack_host(toks: torch.Tensor, lp: torch.Tensor | None):
    """Tokens [rows] int32 (and their logprobs [rows] float32) as host lists,
    from one device-to-host copy."""
    packed = toks if lp is None else torch.stack([toks, lp.view(torch.int32)])
    with span("engine.fetch"):
        host = packed.cpu().numpy()
    if lp is None:
        return host.tolist(), None
    return host[0].tolist(), host[1].view(np.float32).tolist()


def _logprobs_of(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log-softmax of each row's sampled token, [rows] float32."""
    return torch.log_softmax(logits.float(), dim=-1).gather(1, toks.long()[:, None])[:, 0]


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
    return _pack_host(toks, _logprobs_of(logits, toks) if logprobs else None)


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


def _append_runs(requests: dict, rids, toks: np.ndarray, lps, finish) -> int:
    """Append a fused run's tokens ``toks`` [steps, slots] (and logprobs) to
    the requests of the slots, each up to its ``max_new`` or stop token.
    Returns the number of tokens appended."""
    appended = 0
    for i, rid in enumerate(rids):
        req = requests[rid]
        for j in range(toks.shape[0]):
            if req.done or len(req.out) >= req.max_new:
                break
            req.out.append(int(toks[j, i]))
            appended += 1
            if lps is not None:
                req.logprobs.append(float(lps[j, i]))
            finish(req)
        finish(req)
    return appended


def _copy_page(caches, src: int, dst: int) -> None:
    """Copy page ``src`` onto page ``dst`` in every cache tensor of every
    layer, in place (one ``copy_`` a tensor). The page dim is 0 for the
    slot-leading NHD_FUSED slab (3-D) and 1 for the HND ``k``/``v`` (4-D)."""
    for layer in caches:
        for v in layer.values():
            if v.dim() == 3:
                v[dst].copy_(v[src])
            else:
                v[:, dst].copy_(v[:, src])


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
        if prefill_chunk is not None and prefill_chunk <= 0:
            raise ValueError("prefill_chunk must be positive")
        if multi_step < 1:
            raise ValueError("multi_step must be at least 1")
        if speculative_k > 0 and temperature > 0.0:
            raise ValueError("speculative decode requires greedy sampling (temperature 0)")
        if speculative_k >= block_size:
            raise ValueError(f"speculative_k={speculative_k}: a draft run must fit one page "
                             f"(block_size {block_size})")
        if speculative_k > 0 and multi_step > 1:
            raise ValueError("fused multi-step decode and speculative decode are exclusive")
        if speculative_k > 0 and logprobs:
            raise ValueError("speculative decode emits no logprobs: logprobs and speculative_k "
                             "are exclusive")
        full_sampler = topk > 0 or topp > 0 or repetition_penalty > 0
        if full_sampler and temperature <= 0.0:
            raise ValueError("topk/topp/repetition_penalty require temperature > 0")
        if full_sampler and multi_step > 1:
            raise ValueError("topk/topp/repetition_penalty run the eager sampler; use multi_step=1")
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
        self.speculative_k = speculative_k
        self.draft_fn = draft_fn or ngram_draft
        # chunked prefill: a long prompt prefills prefill_chunk tokens per
        # step and decode batches run between its chunks
        self.prefill_chunk = prefill_chunk
        self._prefer_decode = False
        self.multi_step = multi_step
        self.prefix_cache = prefix_cache
        self.stop_tokens = frozenset(map(int, stop_tokens))
        self.logprobs = logprobs
        self._retired: list[int] = []  # finished rids whose pages are kept (LRU)
        self._resident: set[int] = set()  # rids holding allocator tables
        self._bh_cache: dict[int, tuple[int, list]] = {}  # rid -> block hashes
        self.prefix_hits = 0
        self.prefix_shared_blocks = 0
        self._n_done = 0  # running counts behind stats
        self._tokens_out = 0
        self._children: dict[int, list[int]] = {}  # n-best parent -> children
        self._multi = None  # the fused multi-step decode, made at its first dispatch
        self._sample_calls = 0
        self._prefill_dispatches = 0
        self._decode_dispatches = 0
        self.topk = topk
        self.topp = topp
        self.repetition_penalty = repetition_penalty
        if softmax_policy is None:
            softmax_policy = SoftmaxPolicy.BEFORE_TOPK if topp > 0 else SoftmaxPolicy.NONE
        self.softmax_policy = SoftmaxPolicy(int(softmax_policy))
        self._full_sampler = full_sampler
        if repetition_penalty > 0:
            self._mask_slots = max_batch * 8 + 1  # the last row is the dummy rows' scratch
            self._penalty_mask = torch.zeros((self._mask_slots, (cfg.vocab + 7) // 8),
                                             dtype=torch.uint8, device=self.device)
            self._free_slots = list(range(self._mask_slots - 1))
            self._slot_of: dict[int, int] = {}
        self.spec_proposed = 0
        self.spec_accepted = 0
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
        """Queue a request. With ``n > 1`` (parallel sampling, temperature >
        0): one prefill serves n continuations, whose children share the
        parent's pages and copy its partial tail page on write. Returns the
        rid (n == 1) or the list of n rids (parent first). Raises ValueError
        when its KV footprint cannot fit ``max_blocks_per_seq``."""
        if n < 1:
            raise ValueError(f"n={n}: a request has at least one continuation")
        eff_temp = self.temperature if temperature is None else temperature
        if n > 1 and eff_temp <= 0.0:
            raise ValueError("n-best sampling requires temperature > 0 (greedy continuations "
                             "would be identical)")
        if n > 1 and self.speculative_k:
            raise ValueError("n-best sampling and speculative decode are exclusive")
        if temperature is not None or topk is not None or topp is not None:
            if self.multi_step > 1:
                raise ValueError("per-request sampling params require multi_step=1 (the fused "
                                 "decode bakes the engine-level sampler in)")
            if self.speculative_k:
                raise ValueError("per-request sampling params and speculative decode are exclusive")
            if self.repetition_penalty > 0 and eff_temp <= 0.0:
                raise ValueError("the repetition penalty requires temperature > 0")
        # a fused run's slack and a verification step's draft rows
        need = len(prompt_ids) + max_new + self.speculative_k + self.multi_step - 1
        cap = self.max_blocks_per_seq * self.block_size
        if need > cap:
            raise ValueError(
                f"request needs {need} KV slots (prompt {len(prompt_ids)} + "
                f"max_new {max_new}) but max_blocks_per_seq="
                f"{self.max_blocks_per_seq} x block_size={self.block_size} "
                f"caps a sequence at {cap}"
            )
        stop_set = self.stop_tokens if stop is None else frozenset(map(int, stop))
        prompt = list(map(int, prompt_ids))
        t_arrive = now()
        rids = []
        for i in range(n):
            rid = self._next_rid
            self._next_rid += 1
            # children are not pending: the parent's prefill activates them
            self.requests[rid] = Request(
                rid, list(prompt), max_new=max_new, n_best=n if i == 0 else 1,
                parent=rids[0] if i else None, stop=stop_set, temperature=temperature,
                topk=topk, topp=topp, t_arrive=t_arrive)
            rids.append(rid)
        self._pending.append(rids[0])
        if n == 1:
            return rids[0]
        self._children[rids[0]] = rids[1:]
        return rids

    def cancel(self, rid: int) -> None:
        """Abort a request: drop it from scheduling and release its pages
        (n-best children of a cancelled parent not yet activated are
        cancelled too)."""
        req = self.requests.get(rid)
        if req is None or req.done:
            return
        t = now()
        self._mark_done(req, t)
        if rid in self._pending:
            self._pending.remove(rid)
        if rid in self._active:
            self._active.remove(rid)
        for kid in self._children.pop(rid, []):
            if not self.requests[kid].done:  # a child may have been cancelled alone
                self._mark_done(self.requests[kid], t)
        self._free(rid)
        self._release_slot(rid)

    def _mark_done(self, req: Request, t: int) -> None:
        req.done, req.t_done = True, t
        self._n_done += 1

    def _free(self, rid: int) -> None:
        """Return rid's pages to the pool (a never-prefilled rid holds none)."""
        if rid in self._resident:
            self.alloc.free(rid)
            self._resident.discard(rid)
            self._bh_cache.pop(rid, None)

    def _release_slot(self, rid: int) -> None:
        if self.repetition_penalty > 0:
            s = self._slot_of.pop(rid, None)
            if s is not None:
                self._free_slots.append(s)  # the row is re-seeded on reuse

    # --------------------------------------------------------------- sampling
    def _assign_slot(self, rid: int) -> int:
        """Give `rid` a penalty-mask row seeded with its prompt tokens."""
        if rid in self._slot_of:
            return self._slot_of[rid]
        if not self._free_slots:
            # grow the pool: prefill runs ahead of decode, so live slots are
            # bounded by queued requests, not max_batch. The scratch row stays
            # last; the old scratch row becomes a data row, re-seeded when
            # assigned.
            old, n_old = self._penalty_mask, self._mask_slots
            n_new = (n_old - 1) * 2 + 1
            self._penalty_mask = torch.zeros((n_new, old.shape[1]), dtype=old.dtype, device=old.device)
            self._penalty_mask[: n_old - 1] = old[: n_old - 1]
            self._free_slots = list(range(n_old - 1, n_new - 1))
            self._mask_slots = n_new
        s = self._free_slots.pop()
        self._slot_of[rid] = s
        row = np.zeros(self._penalty_mask.shape[1], np.uint8)
        for t in self.requests[rid].prompt:
            row[t // 8] |= np.uint8(1 << (t % 8))
        self._penalty_mask[s] = torch.from_numpy(row).to(self.device)
        return s

    def _sample(self, logits: torch.Tensor, rids=None):
        """(tokens, logprobs or None) of each row of ``logits`` as host lists,
        from one device-to-host copy. Row i samples with the parameters of
        ``rids[i]`` (the engine's for rows past ``rids``)."""
        b = logits.shape[0]
        with span("engine.sample"):
            rows = list(rids or [])[:b]
            rows += [None] * (b - len(rows))

            def per_row(name, default):
                vals = [None if r is None else getattr(self.requests[r], name) for r in rows]
                return [default if v is None else v for v in vals]

            temps = per_row("temperature", self.temperature)
            greedy = [t <= 0.0 for t in temps]
            if all(greedy):
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                # a per-call counter folded into the seed: a fixed seed would
                # replay the same noise every step
                self._sample_calls += 1
                seed = next_seed(self.seed, self._sample_calls)
                topks = per_row("topk", self.topk)
                topps = per_row("topp", self.topp)
                use_topk, use_topp = any(topks), any(t > 0 for t in topps)
                # greedy rows sample at temperature 1 and take the argmax below
                sample_t = [1.0 if g else t for g, t in zip(greedy, temps)]
                kw = {"temperature": (float(sample_t[0]) if len(set(sample_t)) == 1 else
                                      torch.tensor(sample_t, dtype=torch.float32, device=self.device))}
                if self._full_sampler or use_topk or use_topp:
                    policy = self.softmax_policy
                    if use_topp and policy == SoftmaxPolicy.NONE:
                        policy = SoftmaxPolicy.BEFORE_TOPK
                    # a tensor parameter counts as enabled in the sampler even
                    # when all zero: scalars for the unused ones
                    kw.update(
                        topk=(torch.tensor(topks, dtype=torch.int32, device=self.device)
                              if use_topk else 0),
                        topp=(torch.tensor(topps, dtype=torch.float32, device=self.device)
                              if use_topp else 0.0),
                        softmax_policy=policy,
                    )
                    if self.repetition_penalty > 0:
                        scratch = self._mask_slots - 1
                        slots = [scratch if r is None else self._assign_slot(r) for r in rows]
                        kw.update(penalty_mask=self._penalty_mask,
                                  slot_id=torch.tensor(slots, dtype=torch.int32, device=self.device),
                                  repetition_penalty=self.repetition_penalty)
                toks, _ = fused_sampler(logits, seed=seed, **kw)  # the mask is updated in place
                toks = toks.reshape(-1).to(torch.int32)
                if any(greedy):
                    toks = torch.where(torch.tensor(greedy, device=self.device),
                                       torch.argmax(logits, dim=-1).to(torch.int32), toks)
            return _pack_host(toks, _logprobs_of(logits, toks) if self.logprobs else None)

    def _table(self, rid: int) -> np.ndarray:
        return self.alloc.table(rid, pad_to=self.max_blocks_per_seq)

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------- prefix caching
    def _evict_one(self) -> None:
        """Free the least recently finished request's kept pages; re-raises
        the pool's MemoryError when none is kept."""
        old = self._retired.pop(0)
        self._free(old)

    def _extend(self, rid: int, num_tokens: int) -> None:
        """alloc.extend, evicting kept pages of finished requests (LRU) while
        the pool is short (shared pages survive through their refcounts)."""
        self._resident.add(rid)
        while True:
            try:
                self.alloc.extend(rid, num_tokens)
                return
            except MemoryError:
                if not self._retired:
                    raise
                self._evict_one()

    def _written(self, rid: int) -> list:
        """Tokens present in rid's pages: the prefilled prompt prefix while
        prefilling; all but the last sampled token once decoding (that token
        is written by the next step)."""
        req = self.requests[rid]
        if not req.out:
            return req.prompt[: req.prefilled]
        return req.tokens[:-1]

    def _block_hashes(self, tokens: list, nfull: int) -> list:
        """Cumulative hash per full block: h_i = hash(h_{i-1}, block_i)."""
        hs, h = [], 0
        bs = self.block_size
        for i in range(nfull):
            h = hash((h, tuple(tokens[i * bs : (i + 1) * bs])))
            hs.append(h)
        return hs

    def _resident_hashes(self, rid: int) -> list:
        """Cached block hashes of rid's written tokens (recomputed when its
        count of written full blocks changes)."""
        w = self._written(rid)
        nfull = len(w) // self.block_size
        cached = self._bh_cache.get(rid)
        if cached is not None and cached[0] == nfull:
            return cached[1]
        hs = self._block_hashes(w, nfull)
        self._bh_cache[rid] = (nfull, hs)
        return hs

    def _match_prefix(self, prompt: list) -> tuple[int | None, int]:
        """The resident request with the longest full-block prefix of
        ``prompt`` written, and that prefix's blocks, by cumulative block
        hashes; the winner's tokens are checked against the prompt (a hash
        collision shortens the match). At most len(prompt) - 1 tokens are
        shared, so the prefill has a row to take the first token's logits
        from."""
        bs = self.block_size
        cap_blocks = (len(prompt) - 1) // bs
        if cap_blocks <= 0:
            return None, 0
        want = self._block_hashes(prompt, cap_blocks)
        best, best_k = None, 0
        for cand in self._resident:
            if cand == self._dummy_seq or cand not in self.requests:
                continue
            have = self._resident_hashes(cand)
            lim = min(len(have), cap_blocks)
            k = 0
            while k < lim and have[k] == want[k]:
                k += 1
            if k > best_k:
                best, best_k = cand, k
        if best is not None:
            w = self._written(best)
            while best_k and w[: best_k * bs] != prompt[: best_k * bs]:
                best_k -= 1
            if best_k == 0:
                best = None
        return best, best_k

    # --------------------------------------------------------------- steps
    def _prefill_one(self, rid: int) -> bool:
        """Prefill the next chunk of `rid`'s prompt (the whole prompt when
        chunking is off). Returns True when the prompt is fully prefilled;
        only then is the first token sampled and the request activated."""
        req = self.requests[rid]
        total = len(req.prompt)
        if req.t_admit is None:  # its first chunk
            req.t_admit = now()
            with span("engine.admit", rid) as sp:
                shared = 0
                if self.prefix_cache and req.prefilled == 0 and rid not in self._resident:
                    sp.set("candidates", len(self._resident))
                    parent, k = self._match_prefix(req.prompt)
                    if k > 0:
                        self.alloc.share_prefix(parent, rid, k)
                        self._resident.add(rid)
                        req.prefilled = shared = k * self.block_size
                        self.prefix_hits += 1
                        self.prefix_shared_blocks += k
                sp.set("shared_tokens", shared)
            req.admit_ns = now() - req.t_admit
        start = req.prefilled
        n = total - start
        if self.prefill_chunk is not None:
            n = min(self.prefill_chunk, n)
        self._extend(rid, start + n)  # extend() takes TOTAL tokens
        with span("engine.prefill", rid) as sp:
            sp.set("rows", n)
            sp.set("offset", start)
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
        # children cancelled before the prefill take no pages and no token
        kids = [r for r in self._children.pop(rid, []) if not self.requests[r].done]
        # n-best: n first tokens from the same logits row (each row draws
        # its own noise)
        toks, lps = self._sample(logits.reshape(1, -1).expand(1 + len(kids), -1).contiguous(),
                                 rids=[rid] + kids)
        for r in kids:  # the parent's pages, a partial tail page of its own
            self.alloc.fork(rid, r)
            self._resident.add(r)
            self.requests[r].prefilled = total
            if total % self.block_size:
                self._cow_last(r)
        with span("engine.append"):
            t = now()
            for j, r in enumerate([rid] + kids):
                one = self.requests[r]
                one.t_admit, one.t_first = req.t_admit, t
                one.out.append(int(toks[j]))
                if lps is not None:
                    one.logprobs.append(lps[j])
                self._active.append(r)
                self._finish_if_done(one)
            self._tokens_out += 1 + len(kids)
        return True

    def _cow_last(self, rid: int) -> None:
        """Make rid's tail page exclusive, its contents copied in place from
        the shared page in every cache tensor."""
        while True:
            try:
                blk, src = self.alloc.cow_last(rid)
                break
            except MemoryError:
                if not self._retired:
                    raise
                self._evict_one()
        if src >= 0:
            _copy_page(self.caches, src, blk)

    def _finish_if_done(self, req: Request) -> None:
        if req.done:
            return
        if len(req.out) >= req.max_new or (req.out and req.out[-1] in req.stop):
            self._mark_done(req, now())
            if req.rid in self._active:
                self._active.remove(req.rid)
            if self.prefix_cache:
                self._retired.append(req.rid)  # kept for later prefix hits
            else:
                self._free(req.rid)
            self._release_slot(req.rid)

    def _batch_inputs(self, slack: int):
        """The decode batch's rids and its [max_batch] inputs (last tokens,
        lengths, page tables), each request's table extended to cover
        ``slack`` more slots; dummy slots sit on the reserved page."""
        rids = self._active[: self.max_batch]
        b = self.max_batch
        with span("engine.inputs"):
            tokens = np.zeros((b,), np.int32)
            seq_lens = np.ones((b,), np.int32)
            tables = np.full((b, self.max_blocks_per_seq), self._dummy_block, np.int32)
            for i, rid in enumerate(rids):
                req = self.requests[rid]
                new_len = len(req.tokens)
                self._extend(rid, new_len + slack)
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
        toks, lps = self._sample(logits, rids)
        with span("engine.append"):
            for i, rid in enumerate(rids):
                req = self.requests[rid]
                req.out.append(int(toks[i]))
                if lps is not None:
                    req.logprobs.append(lps[i])
                self._finish_if_done(req)
            self._tokens_out += len(rids)

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
        with span("engine.append"):
            self._tokens_out += _append_runs(self.requests, rids, toks, lps, self._finish_if_done)

    # ------------------------------------------------- speculative decode
    def _spec_batch(self, drafts: dict) -> None:
        """One verification step: ``[last, d1..dk]`` of every request through
        the decode path at ``mtp = k``, the longest prefix of drafts equal to
        the model's argmax accepted, plus one correction token. Dummy rows sit
        at ``seq_lens = k + 1`` on the reserved page. One device-to-host copy:
        the argmax of every row."""
        k = self.speculative_k
        sq = k + 1
        rids = self._active[: self.max_batch]
        b = self.max_batch
        with span("engine.inputs"):
            tokens = np.zeros((b, sq), np.int32)
            seq_lens = np.full((b,), sq, np.int32)
            tables = np.full((b, self.max_blocks_per_seq), self._dummy_block, np.int32)
            for i, rid in enumerate(rids):
                req = self.requests[rid]
                base = len(req.tokens)
                tokens[i, 0] = req.tokens[-1]
                tokens[i, 1:] = (drafts[rid] + [0] * k)[:k]
                seq_lens[i] = base + k
                self._extend(rid, base + k)
                tables[i] = self._table(rid)
        logits, self.caches = forward_step(
            self.weights, self.caches, self.cfg,
            token_ids=self._tensor(tokens.reshape(-1)),
            seq_lens=self._tensor(seq_lens),
            q_index=torch.arange(b + 1, dtype=torch.int32, device=self.device) * sq,
            block_ids=self._tensor(tables),
            is_prefill=False,
            mtp=k,
            max_seqlens_q=1,
            return_all_logits=True,
        )
        targets = torch.argmax(logits, dim=-1).to(torch.int32)
        with span("engine.fetch"):
            targets = targets.cpu().numpy().reshape(b, sq)
        with span("engine.append"):
            for i, rid in enumerate(rids):
                req = self.requests[rid]
                d = drafts[rid]
                a = 0
                while a < len(d) and d[a] == targets[i, a]:
                    a += 1
                self.spec_proposed += len(d)
                self.spec_accepted += a
                for t in list(d[:a]) + [int(targets[i, a])]:
                    if req.done or len(req.out) >= req.max_new:
                        break
                    req.out.append(int(t))
                    self._tokens_out += 1
                    self._finish_if_done(req)
                self._finish_if_done(req)

    @property
    def speculative_stats(self) -> dict:
        return {
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "acceptance": self.spec_accepted / self.spec_proposed if self.spec_proposed else 0.0,
        }

    @property
    def stats(self) -> dict:
        """Serving counters: dispatches, tokens, occupancy, cache state (in
        O(1): running counts, not sums over the requests)."""
        return {
            "requests": len(self.requests),
            "pending": len(self._pending),
            "active": len(self._active),
            "done": self._n_done,
            "tokens_out": self._tokens_out,
            "prefill_dispatches": self._prefill_dispatches,
            "decode_dispatches": self._decode_dispatches,
            "blocks_free": self.alloc.num_free,
            "blocks_total": self.alloc.num_blocks,
            "prefix_hits": self.prefix_hits,
            "prefix_shared_blocks": self.prefix_shared_blocks,
            "speculative": self.speculative_stats,
        }

    def step(self) -> bool:
        """One engine step (a prefill [chunk] or a decode batch). Returns
        False when no work remains. With chunked prefill, decode batches
        alternate with prefill chunks. Traced as one engine.step span."""
        with span("engine.step") as sp:
            if self._pending and not (
                self.prefill_chunk is not None and self._active and self._prefer_decode
            ):
                self._prefill_dispatches += 1
                sp.set("kind", "prefill")
                if self._prefill_one(self._pending[0]):
                    self._pending.pop(0)
                self._prefer_decode = True
                return True
            self._prefer_decode = False
            if self._active:
                self._decode_dispatches += 1
                sp.set("live", min(len(self._active), self.max_batch))
                if self.speculative_k > 0:
                    drafts = {rid: self.draft_fn(self.requests[rid].tokens, self.speculative_k)
                              for rid in self._active[: self.max_batch]}
                    if any(drafts.values()):
                        sp.set("kind", "spec")
                        self._spec_batch(drafts)
                        return True
                sp.set("kind", "decode")
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
