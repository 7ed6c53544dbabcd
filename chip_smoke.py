#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hpc_ops_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card (Hopper, sm_90a) and the CUDA toolkit's nvcc, and exits non-zero on
any failure, without a card, or when the package is not beside it.

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi), torch's view;
  2. build: nvcc builds the kernel sources and g++ the block allocator;
  3. kernels: each kernel against its plain PyTorch version on
     the same inputs, timed with CUDA events beside its plain version, a
     PyTorch library call for the same function where one exists, and its
     bound. At the llama3_8b serving shapes (Hq 32, Hkv 8, D 128, pages of
     16): the bf16 RoPE store, paged decode and paged prefill, and the int8
     quantising RoPE store, NHD_FUSED decode and NHD_FUSED prefill (both
     RoPE stores at a decode batch and a ragged 2048-row prefill, with
     torch.profiler device time, share of the bytes bound and, at decode,
     the wrapper's host microseconds a call beside the wall time; the
     decode kernels, shorter than their wrappers' host time since PR 11,
     are timed by device time: torch.profiler's sum of their kernels a
     call, as are their SDPA yardsticks, or, where the profiler records no
     kernel, CUDA events around calls queued behind a spin kernel; their
     wrappers' CUDA-event time beside). check_f5: the head shapes of fault F5 (prefill at head_dim
     96 and 256 and at Hq 128 over Hkv 1, dense, sparse and NHD_FUSED;
     decode at G 32 with 4 draft tokens and at G 128, split and not)
     against the plain versions, the dense bf16 prefill and the bf16
     decode timed. At
     Mixtral-8x7B width (hidden 4096, expert intermediate 14336, 8 experts,
     top-2), for a decode batch of 8 tokens and prefills of 200, 512 and
     2048 (m-tiles of 32, 64, 160 and 512 slots: every instance of the
     grouped GEMM that the serving run launches, and the throughput shape):
     the scatter grouped GEMM (gate-up and down), the activation + e4m3
     quantisation and the top-k reduce (device time and share of bound at
     every token count, the wrapper's host time at decode); then
     moe_pipeline: the three chained
     with every garbage row filled with NaN, and the whole MoE under
     torch's sync debug mode (which raises on the device-to-host copies it
     detects; decode_profile_moe counts them). The int8 MoE at the same
     widths and token counts: the scatter grouped GEMM over int8 operands
     (gg_scatter_i8), its fused activation epilogue over the interleaved
     gate-up weight (gg_scatter_i8_act, timed beside the unfused GEMM and
     activation pair) and the aligned grouped GEMM, int8 and e4m3
     (gg_pertensor, gg_pertensor_e4m3); moe_pipeline_int8: fused, unfused
     and impl="ref" on expert-parallel rank 1 of 2, the fused one under sync
     debug mode; ops_moe: impl="gather" and the packed group_gemm_* entry
     points once each, the launch counts read around each call. The
     blockwise MoE at the same widths and token counts, with seeded scales
     per (token, 128-group) and per 128 x 128 weight block: the blockwise
     scatter grouped GEMM (gg_bw_scatter_{i8,e4m3}) and the blockwise
     aligned grouped GEMM (gg_bw_aligned_{i8,e4m3}), gate-up and down, int8
     bit-equal to the plain version, each timed beside the library's
     unscaled per-expert loop; moe_pipeline_bw: fuse_moe_blockwise_int8
     with scheme "scatter" and "int8" on rank 1 of 2 against the chain of
     plain GEMMs with every garbage row filled with NaN, the scatter one under
     sync debug mode; ops_moe_bw: group_gemm_blockwise_fp8 / _int8 in both
     x-scale layouts and every scheme against impl="ref", and
     fuse_moe_blockwise_fp8 ("scatter", "prescale") against the plain chain,
     the launch counts read around each call. At the llama3_8b shapes again,
     over e4m3 caches: decode and prefill over HND caches, over the NHD_FUSED
     slab, the QuantType-0 decode (one K scale per token and kv head, a V
     scale per head) and the prefill with per-token K scales; then ops_fp8:
     attention_decode_fp8 and attention_with_kvcache_prefill_fp8 driven in
     every form (per-tensor with a q scale per token and head, NHD_FUSED,
     QuantType 0 with paged and with tail-row scales), each held against its
     impl="ref" with the launch counts read around each call. The decode
     operator's other entry: check_decode_fused, the head-major FUSED decode
     (one kernel for the TPU's FUSED and packed FUSED kernels) over bf16, int8
     and e4m3 slabs against its plain version, timed at the decode lengths
     and at KV <= 1024; check_decode_tasks, the task-map (split-KV) decode's
     task kernel and combine kernel against their plain versions and
     attention_decode(task_map=...) against impl="ref", over every cache
     type and layout at mtp 0 and 2; decode_sched, the JAX decode
     benchmark's scenarios at full width (pages of 64, task tile 2048): grid
     against task-map time over bf16 and e4m3, the int8 FUSED grid time, the
     KV-bytes bound, SDPA, the mode select_decode_mode picks, one line each.
     The block-sparse prefill: check_prefill_sparse, the sparse form of the
     prefill kernel against its plain version over HND, NHD and NHD_FUSED,
     bf16, int8 and e4m3 caches and per-token K scales, kv prefixes longer
     than q, mask tiles of 64 x 64, 128 x 64 and 128 x 128 and a q tile with
     no kept key (its rows exactly 0); prefill_sparse, the JAX prefill
     benchmark's four cases at full width (Hkv 8, GQA 4, D 128, pages of 64,
     e4m3 caches): the dense e4m3 call, the sparse call under the
     benchmark's random mask and under Stem's mask (with Stem's own time),
     SDPA causal and over each mask, the kept tiles' bounds, every output
     against the plain version (seeded q tiles at 32K and in the mixed case);
     check_rmsnorm_quant, the RMSNorm + fp8 kernel at 8 and 2048 tokens x
     hidden 4096 and 5120 with and without the MoE outputs; check_route_gemm,
     the route GEMM at the JAX route benchmark's shapes beside one cuBLAS
     float32 product; check_allreduce, the fused all-reduce + residual +
     RMSNorm (both schedules and both epilogues) on 2, 4 and 8 virtual ranks
     of the card, with and without skew, every rank's outputs bit-equal to
     the plain version's, then the JAX collective benchmark's grid at world 8
     beside the plain version and the unfused chain; its per-device form (a
     launch a rank, forced over virtual ranks) bit-equal to the plain
     version and the one-launch form at 2, 4 and 8 ranks, replayed from a
     captured graph at the decode and prefill shapes, device time beside
     the one-launch form's at the grid; sampler_approx: the binned
     approximate top-k against the exact one at [64, 120832] (device ms,
     recall); distinct_devices: a mesh over two cards where the machine has
     them (with one card a line says it did not run). The QuantType-0 decode
     and the per-token prefill also run with K scales in 4 groups along D;
  4. slice_tiny, slice_tiny_int8, slice_tiny_moe, slice_tiny_fp8,
     slice_tiny_moe_int8 and slice_tiny_moe_bw: Engine on tiny_config (bf16
     KV, int8_kv, fp8 MoE, fp8_kv, int8 MoE, blockwise int8 MoE) on the card
     and on the
     CPU with the same weights: logits of the first prefill and decode steps within 0.15 abs /
     0.1 rel, greedy tokens identical wherever the CPU path's top-2 margin
     exceeds that tolerance;
     slice_tiny_tp and slice_tiny_tp_moe: make_sharded_step's first steps
     and ShardedEngine on a (dp 2, tp 2) mesh of virtual ranks on the card
     against CPU ranks (dense, and the fp8 MoE under rank_ep); each of the
     eight phases also serves with multi_step=4 and logprobs=True (on the
     card the captured multi-step decode graph), its tokens held to the CPU
     engine's by the same rule, one logprob a token;
  5. slice_full and slice_full_int8: Engine(llama3_8b) at full width and
     depth, bf16 KV then int8_kv, on one set of random weights, serving 8
     prompts x 32 new tokens; logits finite, tokens in the vocab, each
     kernel's launch count as expected (the other path's kernels never
     launch), int8 prefill logits within cosine 0.98 of bf16's, the share of
     saturated int8 codes; decode_profile and decode_profile_int8: three
     decode steps of each under torch.profiler (device time by kernel class
     and the device's idle share), left out of the step times;
     slice_full_fp8: the same with fp8_kv (e4m3 HND caches, e4m3 q): the
     e4m3 decode and prefill kernels once per layer and call and every other
     kernel at 0, prefill logits within cosine 0.98 of bf16's, the share of
     saturated e4m3 codes, one device-to-host copy per profiled decode step;
     slice_full_w8a8: dense_int8 over the same weights quantised layer by
     layer on the card, cosine as above, the int8 products' device time;
     slice_full_tp: ShardedEngine over the same weights sharded on a (dp 1,
     tp 4) mesh of virtual ranks on the card: the serving stats, prefill
     logits within cosine 0.98 of bf16's, the one_shot collective 2 x 32
     times a forward call and its plain version never, one device-to-host
     copy a profiled decode step (decode_profile_tp);
     slice_full_multi and slice_full_tp_multi: Engine(multi_step=8) and
     ShardedEngine(multi_step=8) on the tp 4 mesh over the same weights and
     prompts, 128 new tokens: every decode dispatch after the first one
     replay of the captured graph (the whole mesh's ranks in one graph), the
     launches counted through the replays (the collective at 2 x layers x
     steps, every collective node cooperative), one device-to-host copy a
     profiled dispatch, each request's first 32 tokens equal to slice_full's
     (slice_full_tp's) but for a first flip at a top-2 margin below 0.15; a
     summary line each (decode ms a step, device busy and idle share, the
     latter also from the union of kernel intervals, launches a step, copies
     a dispatch, capture and instantiate seconds, the graph's pool, peak
     memory); slice_full_hybrid: ShardedEngine on make_hybrid_mesh(2, 4) of
     virtual ranks over the same weights, eager (12 new tokens) and with
     multi_step=8 (128), tokens held to slice_full's by the same rule,
     prefill logits within cosine 0.98 of bf16's, one copy a step or
     dispatch, a *_summary line each;
  6. slice_full_moe: the llama3_8b weights are freed, then Engine serves the
     published Mixtral-8x7B-v0.1 widths at full depth (32 layers, 8 fp8
     experts of 14336, top-2; 45 GB of seeded expert weights built layer by
     layer on the card): 8 prompts of 16..512 tokens x 32 new tokens, logits
     finite, launch counts exact (two grouped GEMMs, one activation and one
     reduce per layer and call), and decode_profile_moe; slice_full_moe_int8:
     the fp8 experts are freed and the same widths served with int8 experts
     from the same seed (MoEConfig(scheme="pertensor_int8"): the fused
     gate-up GEMM, the aligned down GEMM and the reduce once per layer and
     call, no activation kernel), prefill logits within cosine 0.97 of the
     fp8 run's, the share of saturated activation codes, one device-to-host
     copy per decode step, and decode_profile_moe_int8; slice_full_moe_bw:
     the int8 experts are freed and the same widths served with blockwise
     int8 experts from the same seed (MoEConfig(scheme="blockwise_int8"):
     the blockwise scatter gate-up GEMM, the blockwise aligned down GEMM and
     the reduce once per layer and call), prefill logits within cosine 0.97
     of the fp8 run's, the share of the down GEMM's input codes at +-127, one
     device-to-host copy per decode step, and decode_profile_moe_bw;
  7. before the MoE phases, over slice_full's weights: slice_full_spec,
     speculative decode (an oracle drafter fed by slice_full's tokens at
     k = 3, then ngram_draft at k = 3 and 7 on 8 prompts of a random
     64-token segment, the model's continuation of it and the segment again): tokens held to slice_full's (to a plain engine's) by
     the near-tie rule, oracle acceptance > 0.8, the decode kernel once a
     layer and verification step at sq = k + 1, one device-to-host copy a
     profiled verification step, and a summary beside slice_full's eager and
     slice_full_multi's graph ms a step; slice_full_prefix, prefix caching
     over a 1024-token system prompt (two waves of 8, 7 then 8 hits of 64
     pages), tokens held to an uncached engine's, the prefill rows and ms of
     both; slice_full_sampling, add_request(n=4) at topk=1 (slice_full's
     tokens, the copied tail pages equal the parent's in every layer), then
     topk=50 / topp=0.9 with a greedy per-request row and with
     repetition_penalty=1.1, children that diverge, every block returned;
     convert, from_hf_llama over slice_full's weights seen as a
     transformers-named tree (every tensor equal; dense_int8 equal to
     quantize_w8's codes); ring_attention on 4 virtual ranks at llama3_8b's
     heads, 4 x 2048 tokens, float32, every schedule within 2e-4 of SDPA;
     replay, a record of row 17's kernel at Mixtral width replayed
     bit-identically from memory and from disk;
then the kernels line, the nvidia-smi line and the result line. Each phase
also prints its seconds (phase_seconds).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 and fp16
FP8_FLOPS_PER_S = 1979e12  # H100 SXM dense e4m3
HQ, HKV, D, BS = 32, 8, 128, 16
NUM_BLOCKS = 2048
ATOL_LOGITS, RTOL_LOGITS = 0.15, 0.1


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "not available"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the time of the kernels it
    launches (torch.profiler, CUPTI), over ``iters`` calls. Unlike
    :func:`time_ms` it leaves out the host's time between launches, which
    exceeds a short kernel's (the decode kernels'). See
    :func:`profile_kernels`."""
    return profile_kernels(fn, iters, warmup)[0]


def profile_kernels(fn, iters: int = 20, warmup: int = 3) -> tuple[float, int | None]:
    """(device ms of one call of ``fn``, kernels it launches a call). A
    session now and then records only some of the kernels, so each kernel
    counts its mean duration times its launches a call (its count over the
    calls, rounded, at least 1); the kernels a call are those launches
    summed. A session may also record no kernel at all; after two such
    sessions the time comes from :func:`queued_ms` instead, the count is
    None, and a ``device_ms_fallback`` line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == cuda and e.count
                  and "Memcpy" not in e.key and "Memset" not in e.key]
        if events:
            per_call = [max(1, round(e.count / iters)) for e in events]
            return (sum(e.self_device_time_total / e.count * k for e, k in zip(events, per_call)) / 1e3,
                    sum(per_call))
    ms = queued_ms(fn, iters)
    emit("device_ms_fallback", reason="two profiling sessions recorded no kernel", queued_ms=ms)
    return ms, None


def queued_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn`` from CUDA events, with the calls
    queued behind a spin kernel (``torch.cuda._sleep``) that outlasts the
    host's time to launch them, so the card runs them back to back. It
    counts the gaps between kernels (about a microsecond each), which
    torch.profiler leaves out. If the spin ended before the host had
    queued every call, it runs again with a longer spin; the last try's
    time is an upper bound either way."""
    import torch

    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for spin in (2, 8, 32):
        torch.cuda._sleep(int(spin * host_s * 2e9) + 1_000_000)  # cycles; the clock is at most 1.98 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        caught_up = start.query()
        torch.cuda.synchronize()
        if not caught_up:
            break
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200, warmup: int = 20, repeats: int = 5) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls enqueued back to
    back without a sync (a wrapper's checks, conversions, allocation and
    launch), after a warm-up; the least of ``repeats`` such runs, since the
    host's clock picks up other work on a shared machine."""
    import torch

    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    """Least time in ms for this work: ``flops_per_s`` is the card's peak for
    the type of the function's operands, whatever type a kernel multiplies in."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def random_table(gen, lens, max_blocks, num_blocks, device, bs=BS):
    """A shuffled page table of ``bs``-slot pages covering each length, padded with -1."""
    import torch

    perm = torch.randperm(num_blocks, generator=gen)
    tbl = torch.full((len(lens), max_blocks), -1, dtype=torch.int32)
    off = 0
    for i, n in enumerate(lens):
        k = -(-n // bs)
        tbl[i, :k] = perm[off : off + k]
        off += k
    return tbl.to(device)


# ------------------------------------------------------------------ kernels
ROPE_MAX_POS = 8192  # positions of the cos|sin table
# a ragged prefill of 2048 rows: new rows a request, and each request's
# length with them; the last runs past the cos|sin table's end
ROPE_PREFILL_Q = [700, 1, 512, 300, 535]
ROPE_PREFILL_KV = [700, 4000, 1024, 300, 8700]


def rope_rows_case(dev, gen, prefill):
    """qkv, seq_lens, q_index and a page table over NUM_BLOCKS pages: a decode
    batch of 8 rows at lengths up to 4096, or the ragged 2048-row prefill."""
    import torch

    if prefill:
        lens, q_lens = ROPE_PREFILL_KV, ROPE_PREFILL_Q
    else:
        lens = [int(n) for n in torch.randint(1, 4097, (8,), generator=gen, dtype=torch.int32)]
        q_lens = [1] * 8
    rows = sum(q_lens)
    qkv = torch.randn((rows, (HQ + 2 * HKV) * D), generator=gen).to(torch.bfloat16).to(dev)
    tbl = random_table(gen, lens, max(lens) // BS + 4, NUM_BLOCKS, dev)
    q_index = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32, device=dev)
    return qkv, torch.tensor(lens, dtype=torch.int32, device=dev), q_index, tbl


def rope_bytes(rows, kv_elem):
    """qkv and cos|sin rows in, q and the K/V rows out, 3 table entries a row."""
    return rows * ((HQ + 2 * HKV) * D * 2 + D * 4 + 12 + HQ * D * 2 + 2 * HKV * D * kv_elem)


def check_rope(dev, gen):
    """The bf16 store at a decode batch of 8 rows (HND and NHD, every policy)
    and at the ragged 2048-row prefill (HND policy 0, NHD policy 1) against
    the plain version: q and K within one bf16 ulp, V bit-equal, every
    unaddressed cache byte unchanged. Timed at both shapes, HND policy 0:
    wall ms over back-to-back calls, torch.profiler's device ms, the share
    of the bytes bound (of device time) and, at decode, the wrapper's host
    microseconds a call."""
    import torch

    from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache
    from hpc_ops_tpu_torch.ops.rope_kernel import rope_store_rows, rope_store_rows_ref, row_slots
    from hpc_ops_tpu_torch.utils.testing import max_bf16_ulp_err

    cos_sin = make_cos_sin_cache(ROPE_MAX_POS, D, 500000.0, device=dev)
    w = (torch.rand(D, generator=gen) + 0.5).to(dev)
    dgen = torch.Generator(device=dev).manual_seed(int(torch.randint(0, 2**31, (1,), generator=gen)))
    shapes = {"HND": (HKV, NUM_BLOCKS * BS, D), "NHD": (NUM_BLOCKS * BS, HKV, D)}
    # each layout's K and V caches before the store, drawn once on the card
    before = {lay: [torch.randn(shape, generator=dgen, device=dev).to(torch.bfloat16) for _ in range(2)]
              for lay, shape in shapes.items()}
    worst_q = worst_kv = 0.0
    timed = {}
    for prefill, cases in ((False, [(lay, pol) for lay in ("HND", "NHD") for pol in (0, 1, 2)]),
                           (True, [("HND", 0), ("NHD", 1)])):
        qkv, seq_lens, q_index, tbl = rope_rows_case(dev, gen, prefill)
        rows = qkv.shape[0]
        _, slots = row_slots(rows, seq_lens, q_index, tbl, BS, NUM_BLOCKS * BS)
        for layout, policy in cases:
            shape = shapes[layout]
            k0, v0 = before[layout]
            kw = dict(hq=HQ, hkv=HKV, d=D, dv=D, block_size=BS, qk_norm_policy=policy,
                      head_major=layout == "HND")
            args = (qkv, cos_sin, seq_lens, q_index, tbl, w, w)
            kq, kk, kv = rope_store_rows(*args, k0.clone(), v0.clone(), **kw)
            pq, pk, pv = rope_store_rows_ref(*args, k0.clone(), v0.clone(), **kw)
            torch.cuda.synchronize()
            worst_q = max(worst_q, max_bf16_ulp_err(kq, pq))
            written = torch.zeros(shape, dtype=torch.bool, device=dev)
            if layout == "HND":
                written[:, slots] = True
            else:
                written[slots] = True
            if not (torch.equal(kk[~written], k0[~written]) and torch.equal(kv[~written], v0[~written])):
                raise AssertionError(f"rope {layout} {rows} rows: untouched cache slots changed")
            if not torch.equal(kv[written], pv[written]):
                raise AssertionError(f"rope {layout} {rows} rows: V rows differ from the plain version")
            worst_kv = max(worst_kv, max_bf16_ulp_err(kk[written], pk[written]))
            del kk, kv, pk, pv, written
        # timing on the decode main path's form: HND, policy 0
        kf = torch.zeros((HKV, NUM_BLOCKS * BS, D), dtype=torch.bfloat16, device=dev)
        vf = torch.zeros_like(kf)
        kw = dict(hq=HQ, hkv=HKV, d=D, dv=D, block_size=BS, qk_norm_policy=0, head_major=True)
        args = (qkv, cos_sin, seq_lens, q_index, tbl, None, None, kf, vf)
        diff = float((rope_store_rows(*args, **kw)[0].float()
                      - rope_store_rows_ref(*args, **kw)[0].float()).abs().max())
        call = lambda: rope_store_rows(*args, **kw)  # noqa: E731
        b, by = bound(rope_bytes(rows, 2), rows * (HQ + HKV) * D * 3)
        dev_ms = device_ms(call, 50)
        timed["prefill" if prefill else "decode"] = dict(
            rows=rows, diff=diff, ms=time_ms(call, 200 if not prefill else 50),
            plain_ms=time_ms(lambda: rope_store_rows_ref(*args, **kw), 50 if not prefill else 5),
            device_ms=dev_ms, bound_ms=b, bound_by=by, share_of_bound=b / dev_ms,
            **({} if prefill else {"host_us": host_us(call)}))
        del kf, vf
    del before
    err = max(worst_q, worst_kv)
    if err > 1.0:
        raise AssertionError(f"rope: {err} bf16 ulp from the plain version (limit 1)")
    m, pre = timed["decode"], timed.pop("prefill")
    diff = max(m["diff"], pre["diff"])
    emit("kernel", name="rope_store", max_ulp=err, max_abs_err=diff, ms=m["ms"], plain_ms=m["plain_ms"],
         bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=None, rows=m["rows"],
         device_ms=m["device_ms"], share_of_bound=m["share_of_bound"], host_us=m["host_us"],
         prefill=pre)
    return dict(name="rope_store", source="hpc_ops_tpu_torch/csrc/rope_store.cu",
                replaces="hpc_ops_tpu/ops/rope_kernel.py:43", max_abs_err=diff, max_ulp=err,
                ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                library_ms=None, device_ms=m["device_ms"], host_us=m["host_us"])


def check_decode(dev, gen):
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.decode import (
        _decode_ref,
        decode_splits,
        paged_decode_attention,
    )

    b = 8
    lens = torch.randint(1, 4097, (b,), generator=gen)
    lens[0], lens[1], lens[2] = 1, 2048, 4096  # kv_len 1 and page boundaries
    lens_l = [int(x) for x in lens]
    max_blocks = 4096 // BS + 4  # -1 padded past each request's pages
    tbl = random_table(gen, lens_l, max_blocks, NUM_BLOCKS + 8, dev)
    kv_lens = lens.to(torch.int32).to(dev)
    scale = D**-0.5
    q = torch.randn((b, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
    err = 0.0
    for layout in ("NHD", "HND"):
        shape = (HKV, NUM_BLOCKS + 8, BS, D) if layout == "HND" else (NUM_BLOCKS + 8, BS, HKV, D)
        k = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        v = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        want = _decode_ref(q, k, v, tbl, kv_lens, 1, scale, layout)
        for splitk in (True, False):
            got = paged_decode_attention(q, k, v, tbl, kv_lens, 1, scale, layout, splitk=splitk)
            torch.cuda.synchronize()
            if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
                raise AssertionError(f"decode {layout} splitk={splitk}: kernel disagrees with the "
                                     "plain version")
            err = max(err, float((got.float() - want.float()).abs().max()))
    # the main path's layout (HND) is timed, split (the default) and not:
    # device time (the kernel is shorter than the wrapper's host time), and
    # the wrapper's time by CUDA events around eager calls
    ms = device_ms(lambda: paged_decode_attention(q, k, v, tbl, kv_lens, 1, scale, "HND"), 50)
    wrapper = time_ms(lambda: paged_decode_attention(q, k, v, tbl, kv_lens, 1, scale, "HND"), 50)
    ms_no_split = device_ms(
        lambda: paged_decode_attention(q, k, v, tbl, kv_lens, 1, scale, "HND", splitk=False), 50)
    plain = time_ms(lambda: _decode_ref(q, k, v, tbl, kv_lens, 1, scale, "HND"), 5)
    # library yardstick: SDPA over K/V gathered contiguous (gather not timed)
    L = max(lens_l)
    pages = tbl[:, : -(-L // BS)].clamp(min=0).long()
    kg = k[:, pages].permute(1, 0, 2, 3, 4).reshape(b, HKV, -1, D)[:, :, :L]
    vg = v[:, pages].permute(1, 0, 2, 3, 4).reshape(b, HKV, -1, D)[:, :, :L]
    kg = kg.repeat_interleave(HQ // HKV, dim=1).contiguous()
    vg = vg.repeat_interleave(HQ // HKV, dim=1).contiguous()
    mask = (torch.arange(L, device=dev)[None, :] < kv_lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = device_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 20)
    sum_kv = sum(lens_l)
    nbytes = 2 * b * HQ * D * 2 + 2 * sum_kv * HKV * D * 2 + tbl.numel() * 4 + b * 4
    flops = 4 * sum_kv * HQ * D
    bd, by = bound(nbytes, flops)
    emit("kernel", name="paged_decode", max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
         bound_ms=bd, bound_by=by, kv_lens=lens_l, ms_splitk_false=ms_no_split, wrapper_ms=wrapper,
         splits=decode_splits(b, max_blocks * BS))
    return dict(name="paged_decode", source="hpc_ops_tpu_torch/csrc/decode.cu",
                replaces="hpc_ops_tpu/ops/attention/decode.py:74", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


def check_prefill(dev, gen):
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.prefill import _prefill_ref, paged_prefill_attention

    scale = D**-0.5
    nb = NUM_BLOCKS + 8
    shape = (HKV, nb, BS, D)
    k = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
    v = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)

    def case(q_lens, kv_lens, pad):
        cu = torch.tensor([0] + list(torch.tensor(q_lens).cumsum(0)), dtype=torch.int32, device=dev)
        tbl = random_table(gen, kv_lens, max(kv_lens) // BS + 2, nb, dev)
        q = torch.randn((sum(q_lens) + pad, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
        return q, cu, tbl, torch.tensor(kv_lens, dtype=torch.int32, device=dev)

    err = 0.0
    cases = {
        "one_2048": ([2048], [2048], 0),
        "three_with_prefix": ([13, 200, 77], [113, 237, 577], 5),  # unaligned cu, padded rows
    }
    for name, (ql, kl, pad) in cases.items():
        q, cu, tbl, kv = case(ql, kl, pad)
        got = paged_prefill_attention(q, k, v, cu, tbl, kv, max(ql), scale, "HND")
        want = _prefill_ref(q, k, v, cu, tbl, kv, max(ql), scale, "HND")
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
            raise AssertionError(f"prefill {name}: kernel disagrees with the plain version")
        err = max(err, float((got.float() - want.float()).abs().max()))
        if name == "one_2048":
            timed = (q, cu, tbl, kv)
    q, cu, tbl, kv = timed
    ms = time_ms(lambda: paged_prefill_attention(q, k, v, cu, tbl, kv, 2048, scale, "HND"), 10)
    plain = time_ms(lambda: _prefill_ref(q, k, v, cu, tbl, kv, 2048, scale, "HND"), 3)
    pages = tbl[0, : 2048 // BS].long()
    kg = k[:, pages].reshape(HKV, 2048, D).repeat_interleave(HQ // HKV, dim=0)[None].contiguous()
    vg = v[:, pages].reshape(HKV, 2048, D).repeat_interleave(HQ // HKV, dim=0)[None].contiguous()
    q4 = q.permute(1, 0, 2)[None].contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, is_causal=True), 10)
    pairs = 2048 * 2049 // 2  # causal (q, k) pairs of this input
    nbytes = 2 * 2048 * HQ * D * 2 + 2 * 2048 * HKV * D * 2 + tbl.numel() * 4
    flops = 4 * pairs * HQ * D
    bd, by = bound(nbytes, flops)
    emit("kernel", name="paged_prefill", max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
         bound_ms=bd, bound_by=by, tflops=tflops(flops, ms), library_tflops=tflops(flops, lib))
    return dict(name="paged_prefill", source="hpc_ops_tpu_torch/csrc/prefill.cu",
                replaces="hpc_ops_tpu/ops/attention/prefill.py:48", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


def check_rope_int8(dev, gen):
    """The int8 store into a NUM_BLOCKS-page NHD_FUSED slab at a decode batch
    of 8 rows (every policy) and at the ragged 2048-row prefill (policies 0
    and 1) against the plain version: q within one bf16 ulp, codes equal or
    one apart on at most 0.1% (QK-norm's sums in another order), every
    unaddressed slab byte unchanged. Timed as check_rope, policy 0."""
    import torch

    from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache
    from hpc_ops_tpu_torch.ops.rope_kernel import (
        rope_store_rows_int8,
        rope_store_rows_int8_ref,
        row_slots,
    )
    from hpc_ops_tpu_torch.utils.testing import max_bf16_ulp_err

    cos_sin = make_cos_sin_cache(ROPE_MAX_POS, D, 500000.0, device=dev)
    w = (torch.rand(D, generator=gen) + 0.5).to(dev)
    scales = (torch.tensor([0.05], device=dev), torch.tensor([0.05], device=dev))
    dgen = torch.Generator(device=dev).manual_seed(int(torch.randint(0, 2**31, (1,), generator=gen)))
    slab0 = torch.randint(-127, 128, (NUM_BLOCKS, 2 * BS, HKV * D), generator=dgen, device=dev,
                          dtype=torch.int8)
    worst_q, code_diff, diff_share, policy0_diff = 0.0, 0, 0.0, 0
    kw = dict(hq=HQ, hkv=HKV, d=D, block_size=BS)
    timed = {}
    for prefill, policies in ((False, (0, 1, 2)), (True, (0, 1))):
        qkv, seq_lens, q_index, tbl = rope_rows_case(dev, gen, prefill)
        rows = qkv.shape[0]
        _, slots = row_slots(rows, seq_lens, q_index, tbl, BS, NUM_BLOCKS * 2 * BS, fused=True)
        written = torch.zeros(NUM_BLOCKS * 2 * BS, dtype=torch.bool, device=dev)
        written[slots] = True
        written[slots + BS] = True
        written = written.view(NUM_BLOCKS, 2 * BS, 1).expand(NUM_BLOCKS, 2 * BS, HKV * D)
        for policy in policies:
            args = (qkv, cos_sin, seq_lens, q_index, tbl, w, w)
            kq, ks = rope_store_rows_int8(*args, slab0.clone(), *scales, qk_norm_policy=policy, **kw)
            pq, ps = rope_store_rows_int8_ref(*args, slab0.clone(), *scales, qk_norm_policy=policy, **kw)
            torch.cuda.synchronize()
            worst_q = max(worst_q, max_bf16_ulp_err(kq, pq))
            if not torch.equal(ks[~written], slab0[~written]):
                raise AssertionError(f"rope int8 {rows} rows policy {policy}: untouched slab bytes changed")
            diff = (ks[written].int() - ps[written].int()).abs()
            code_diff = max(code_diff, int(diff.max()))
            diff_share = max(diff_share, float((diff > 0).float().mean()))
            if policy == 0:
                policy0_diff = max(policy0_diff, int(diff.max()))
            del ks, ps, diff
        # timing on the decode main path's form: policy 0
        args = (qkv, cos_sin, seq_lens, q_index, tbl, None, None, slab0.clone(), *scales)
        kw0 = dict(kw, qk_norm_policy=0)
        diff = float((rope_store_rows_int8(*args, **kw0)[0].float()
                      - rope_store_rows_int8_ref(*args, **kw0)[0].float()).abs().max())
        call = lambda: rope_store_rows_int8(*args, **kw0)  # noqa: E731
        b, by = bound(rope_bytes(rows, 1), rows * (HQ + HKV) * D * 3 + rows * 2 * HKV * D * 2)
        dev_ms = device_ms(call, 50)
        timed["prefill" if prefill else "decode"] = dict(
            rows=rows, diff=diff, ms=time_ms(call, 200 if not prefill else 50),
            plain_ms=time_ms(lambda: rope_store_rows_int8_ref(*args, **kw0), 50 if not prefill else 5),
            device_ms=dev_ms, bound_ms=b, bound_by=by, share_of_bound=b / dev_ms,
            **({} if prefill else {"host_us": host_us(call)}))
        del args
    if worst_q > 1.0 or code_diff > 1 or diff_share > 1e-3 or policy0_diff:
        raise AssertionError(f"rope int8: q {worst_q} ulp (limit 1), codes {code_diff} apart on "
                             f"{diff_share:.4%} (limits 1 and 0.1%), {policy0_diff} with QK-norm off "
                             "(limit 0)")
    m, pre = timed["decode"], timed.pop("prefill")
    diff = max(m["diff"], pre["diff"])
    emit("kernel", name="rope_store_int8", max_ulp=worst_q, max_abs_err=diff,
         code_max_diff=code_diff, code_diff_share=diff_share, ms=m["ms"], plain_ms=m["plain_ms"],
         bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=None, rows=m["rows"],
         device_ms=m["device_ms"], share_of_bound=m["share_of_bound"], host_us=m["host_us"],
         prefill=pre)
    return dict(name="rope_store_int8", source="hpc_ops_tpu_torch/csrc/rope_store.cu",
                replaces="hpc_ops_tpu/ops/rope_kernel.py:43", max_abs_err=diff, max_ulp=worst_q,
                ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
                library_ms=None, device_ms=m["device_ms"], host_us=m["host_us"])


def gathered_dequant(slab, tbl, kv_len_max, scale):
    """K and V of each request gathered from an NHD_FUSED slab into
    [B, Hq, L, D] bf16 (repeated over the GQA group), dequantised: the
    inputs of the library yardstick."""
    import torch

    b = tbl.shape[0]
    pages = tbl[:, : -(-kv_len_max // BS)].clamp(min=0).long()
    g = slab[pages]  # [B, n, 2*BS, HKV*D]
    out = []
    for rows in (slice(0, BS), slice(BS, 2 * BS)):
        x = g[:, :, rows].reshape(b, -1, HKV, D)[:, :kv_len_max].float() * scale
        out.append(x.permute(0, 2, 1, 3).repeat_interleave(HQ // HKV, dim=1)
                   .to(torch.bfloat16).contiguous())
    return out


def check_decode_nhd_fused(dev, gen):
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.decode import _decode_nhd_fused_ref, paged_decode_nhd_fused

    b = 8
    lens_l = [1, 2048, 4096, 2963, 1346, 3412, 2436, 1735]
    max_blocks = 4096 // BS + 4  # -1 padded past each request's pages
    tbl = random_table(gen, lens_l, max_blocks, NUM_BLOCKS + 8, dev)
    kv_lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    scale = D**-0.5
    sc = torch.tensor([0.05], device=dev)
    shape = (NUM_BLOCKS + 8, 2 * BS, HKV * D)
    slabs = {
        "int8": torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev),
        "bf16": torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev),
    }
    err = 0.0
    for name, sq in (("int8", 1), ("bf16", 1), ("int8", 3)):  # the last: mtp = 2
        slab = slabs[name]
        scs = (sc, sc) if name == "int8" else (None, None)
        q = torch.randn((b * sq, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
        lens_sq = kv_lens.clamp(min=sq)  # every draft row sees at least one key
        got = paged_decode_nhd_fused(q, slab, tbl, lens_sq, sq, scale, *scs)
        want = _decode_nhd_fused_ref(q, slab, tbl, lens_sq, sq, scale, *scs)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
            raise AssertionError(f"decode nhd_fused {name} sq={sq}: kernel disagrees with the plain version")
        err = max(err, float((got.float() - want.float()).abs().max()))
    q = torch.randn((b, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
    slab = slabs["int8"]
    ms = device_ms(lambda: paged_decode_nhd_fused(q, slab, tbl, kv_lens, 1, scale, sc, sc), 50)
    wrapper = time_ms(lambda: paged_decode_nhd_fused(q, slab, tbl, kv_lens, 1, scale, sc, sc), 50)
    ms_bf16 = device_ms(lambda: paged_decode_nhd_fused(q, slabs["bf16"], tbl, kv_lens, 1, scale), 50)
    plain = time_ms(lambda: _decode_nhd_fused_ref(q, slab, tbl, kv_lens, 1, scale, sc, sc), 5)
    # library yardstick: SDPA over dequantised K/V gathered contiguous (gather not timed)
    L = max(lens_l)
    kg, vg = gathered_dequant(slab, tbl, L, 0.05)
    mask = (torch.arange(L, device=dev)[None, :] < kv_lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = device_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 20)
    kg, vg = gathered_dequant(slabs["bf16"], tbl, L, 1.0)  # the bf16 slab's yardstick
    lib16 = device_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 20)
    del kg, vg
    sum_kv = sum(lens_l)
    nbytes = 2 * b * HQ * D * 2 + 2 * sum_kv * HKV * D + tbl.numel() * 4 + b * 4 + 8
    flops = 4 * sum_kv * HQ * D
    bd, by = bound(nbytes, flops)
    bd16, _ = bound(nbytes + 2 * sum_kv * HKV * D, flops)
    emit("kernel", name="paged_decode_nhd_fused", max_abs_err=err, ms=ms, plain_ms=plain,
         library_ms=lib, bound_ms=bd, bound_by=by, ms_bf16_slab=ms_bf16, bound_ms_bf16_slab=bd16,
         library_ms_bf16_slab=lib16, wrapper_ms=wrapper, kv_lens=lens_l)
    return dict(name="paged_decode_nhd_fused", source="hpc_ops_tpu_torch/csrc/decode.cu",
                replaces="hpc_ops_tpu/ops/attention/decode.py:449", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


def check_prefill_nhd_fused(dev, gen):
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.prefill import (
        _prefill_nhd_fused_ref,
        paged_prefill_nhd_fused,
    )

    scale = D**-0.5
    nb = NUM_BLOCKS + 8
    slab = torch.randint(-127, 128, (nb, 2 * BS, HKV * D), generator=gen, dtype=torch.int8).to(dev)
    sc = torch.tensor([0.05], device=dev)
    err = 0.0
    cases = {"one_2048": ([2048], [2048]), "chunk_512_on_2048": ([512], [2048])}
    for name, (ql, kl) in cases.items():
        cu = torch.tensor([0] + list(torch.tensor(ql).cumsum(0)), dtype=torch.int32, device=dev)
        tbl = random_table(gen, kl, max(kl) // BS + 2, nb, dev)
        q = torch.randn((sum(ql), HQ, D), generator=gen).to(torch.bfloat16).to(dev)
        kv = torch.tensor(kl, dtype=torch.int32, device=dev)
        got = paged_prefill_nhd_fused(q, slab, cu, tbl, kv, max(ql), scale, sc, sc)
        want = _prefill_nhd_fused_ref(q, slab, cu, tbl, kv, max(ql), scale, sc, sc)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
            raise AssertionError(f"prefill nhd_fused {name}: kernel disagrees with the plain version")
        err = max(err, float((got.float() - want.float()).abs().max()))
        if name == "one_2048":
            timed = (q, cu, tbl, kv)
    q, cu, tbl, kv = timed
    ms = time_ms(lambda: paged_prefill_nhd_fused(q, slab, cu, tbl, kv, 2048, scale, sc, sc), 10)
    slab16 = torch.randn((nb, 2 * BS, HKV * D), generator=gen).to(torch.bfloat16).to(dev)
    ms_bf16 = time_ms(lambda: paged_prefill_nhd_fused(q, slab16, cu, tbl, kv, 2048, scale), 10)
    q4 = q.permute(1, 0, 2)[None].contiguous()
    kg, vg = gathered_dequant(slab16, tbl[:1], 2048, 1.0)  # the bf16 slab's yardstick
    lib16 = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, is_causal=True), 10)
    del slab16, kg, vg
    plain = time_ms(lambda: _prefill_nhd_fused_ref(q, slab, cu, tbl, kv, 2048, scale, sc, sc), 3)
    kg, vg = gathered_dequant(slab, tbl[:1], 2048, 0.05)
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, is_causal=True), 10)
    pairs = 2048 * 2049 // 2  # causal (q, k) pairs of this input
    nbytes = 2 * 2048 * HQ * D * 2 + 2 * 2048 * HKV * D + tbl.numel() * 4 + 8
    flops = 4 * pairs * HQ * D
    bd, by = bound(nbytes, flops)
    bd16, _ = bound(nbytes + 2 * 2048 * HKV * D, flops)
    emit("kernel", name="paged_prefill_nhd_fused", max_abs_err=err, ms=ms, plain_ms=plain,
         library_ms=lib, bound_ms=bd, bound_by=by, ms_bf16_slab=ms_bf16, bound_ms_bf16_slab=bd16,
         library_ms_bf16_slab=lib16, tflops=tflops(flops, ms), tflops_bf16_slab=tflops(flops, ms_bf16))
    return dict(name="paged_prefill_nhd_fused", source="hpc_ops_tpu_torch/csrc/prefill.cu",
                replaces="hpc_ops_tpu/ops/attention/prefill.py:1070", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


# ------------------------------------------------------- fault F5's head shapes
F5_PREFILL = {"d96": (96, 32, 8), "d256": (256, 8, 2), "g128": (128, 128, 1)}  # D, Hq, Hkv
F5_DECODE = {"g32_mtp4": (32, 5), "g128": (128, 1)}  # Hq over one kv head (D 128), sq
F5_CHECK_Q, F5_CHECK_KV = [300, 77], [600, 77]  # the prefill checks' requests
F5_TIMED_ROWS = 2048  # the timed dense prefill: one request of this many rows


def f5_caches(dev, gen, kind, nb, hkv, d):
    """HND K and V of ``kind`` on the card and their per-tensor scales."""
    import torch

    shape = (hkv, nb, BS, d)
    if kind == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev) for _ in "kv")
        sc = torch.tensor([0.05], device=dev)
        return k, v, sc, sc
    k, v = (torch.randn(shape, generator=gen).to(dev) for _ in "kv")
    if kind == "e4m3":
        ks, vs = torch.tensor([KSCALE], device=dev), torch.tensor([VSCALE], device=dev)
        return (k * 0.05).to(torch.float8_e4m3fn), (v * 0.05).to(torch.float8_e4m3fn), ks, vs
    return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None


def check_f5(dev, gen):
    """Fault F5's head shapes, which the card refused before PR 11, through
    the kernels against their plain versions at chip_smoke's 1e-2: prefill
    dense (bf16, int8, e4m3), sparse (e4m3, 128 x 64 mask tiles) and over
    the NHD_FUSED slab (int8) at head_dim 96 and 256 and at Hq 128 over Hkv
    1; decode over bf16, int8 and e4m3 HND caches at G 32 with 4 draft
    tokens and at G 128 (D 128), split and not. One line each; the dense
    bf16 prefill is timed at 2048 rows and the bf16 decode at B 8, kv_len
    1-4096, beside their bounds (not kernel-table rows: the rows are D 128's)."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.decode import _decode_ref, paged_decode_attention
    from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused_nhd
    from hpc_ops_tpu_torch.ops.attention.prefill import (
        _prefill_nhd_fused_ref,
        _prefill_ref,
        _prefill_sparse_ref,
        paged_prefill_attention,
        paged_prefill_nhd_fused,
        paged_prefill_sparse,
    )

    nb = 2 * (F5_TIMED_ROWS // BS) + 64
    for name, (d, hq, hkv) in F5_PREFILL.items():
        scale, err = d**-0.5, {}
        ql, kl = F5_CHECK_Q, F5_CHECK_KV
        cu = torch.tensor([0] + list(torch.tensor(ql).cumsum(0)), dtype=torch.int32, device=dev)
        tbl = random_table(gen, kl, max(kl) // BS + 2, nb, dev)
        kv = torch.tensor(kl, dtype=torch.int32, device=dev)
        q = torch.randn((sum(ql), hq, d), generator=gen).to(torch.bfloat16).to(dev)
        for kind in ("bf16", "int8", "e4m3"):
            k, v, ks, vs = f5_caches(dev, gen, kind, nb, hkv, d)
            args = (q, k, v, cu, tbl, kv, max(ql), scale, "HND")
            err[f"dense_{kind}"] = close(paged_prefill_attention(*args, ks, vs), _prefill_ref(*args, ks, vs),
                                         f"f5 prefill {name} {kind}")
            if kind == "e4m3":
                n_tm, n_tkv = -(-max(ql) // 128), -(-max(kl) // 64)
                mask = (torch.rand((len(ql), hq, n_tm, n_tkv), generator=gen) < 0.5).to(torch.uint8)
                for b_, (a, c) in enumerate(zip(ql, kl)):
                    for t in range(n_tm):
                        mask[b_, :, t, min((c - a + t * 128) // 64, n_tkv - 1)] = 1
                mask = mask.to(dev)
                err["sparse_e4m3"] = close(paged_prefill_sparse(*args, mask, 128, 64, ks, vs),
                                           _prefill_sparse_ref(*args, mask, 128, 64, ks, vs),
                                           f"f5 sparse {name}")
            if kind == "int8":
                slab = pack_kv_fused_nhd(k, v)
                sargs = (q, slab, cu, tbl, kv, max(ql), scale, ks, vs)
                err["nhd_fused_int8"] = close(paged_prefill_nhd_fused(*sargs), _prefill_nhd_fused_ref(*sargs),
                                              f"f5 nhd_fused {name}")
                del slab
            del k, v
        # timed: one bf16 request of F5_TIMED_ROWS rows
        n = F5_TIMED_ROWS
        k, v, _, _ = f5_caches(dev, gen, "bf16", nb, hkv, d)
        cu = torch.tensor([0, n], dtype=torch.int32, device=dev)
        tbl = random_table(gen, [n], n // BS + 2, nb, dev)
        kv = torch.tensor([n], dtype=torch.int32, device=dev)
        q = torch.randn((n, hq, d), generator=gen).to(torch.bfloat16).to(dev)
        ms = time_ms(lambda: paged_prefill_attention(q, k, v, cu, tbl, kv, n, scale, "HND"), 10)
        flops = 4 * (n * (n + 1) // 2) * hq * d
        bd, by = bound(2 * n * hq * d * 2 + 2 * n * hkv * d * 2, flops)
        emit("f5_prefill", shape=name, head_dim=d, hq=hq, hkv=hkv, max_abs_err=err, ms=ms,
             bound_ms=bd, bound_by=by, tflops=tflops(flops, ms), rows=n)
        del k, v, q
    lens = [1, 2048, 4096, 2963, 1346, 3412, 2436, 1735]
    max_blocks = 4096 // BS + 4
    nbd = NUM_BLOCKS + 8
    tbl = random_table(gen, lens, max_blocks, nbd, dev)
    for name, (hq, sq) in F5_DECODE.items():
        lens_sq = torch.tensor(lens, dtype=torch.int32, device=dev).clamp(min=sq)
        q = torch.randn((len(lens) * sq, hq, D), generator=gen).to(torch.bfloat16).to(dev)
        err = {}
        for kind in ("bf16", "int8", "e4m3"):
            k, v, ks, vs = f5_caches(dev, gen, kind, nbd, 1, D)
            args = (q, k, v, tbl, lens_sq, sq, D**-0.5, "HND", ks, vs)
            want = _decode_ref(*args)
            for splitk in (True, False):
                err[f"{kind}_split" if splitk else kind] = close(
                    paged_decode_attention(*args, splitk=splitk), want, f"f5 decode {name} {kind}")
            if kind == "bf16":
                ms = time_ms(lambda: paged_decode_attention(*args), 20)
                sum_kv = int(lens_sq.sum())
                bd, by = bound(2 * q.numel() * 2 + 2 * sum_kv * D * 2, 4 * sum_kv * hq * sq * D)
            del k, v
        emit("f5_decode", shape=name, hq=hq, hkv=1, sq=sq, max_abs_err=err, ms=ms, bound_ms=bd,
             bound_by=by, kv_lens=lens)
    torch.cuda.empty_cache()


# ------------------------------------------------------- e4m3 attention kernels
DECODE_LENS = [1, 2048, 4096, 2963, 1346, 3412, 2436, 1735]  # check_decode's kv_lens
KSCALE, VSCALE = 0.75, 1.25  # per-tensor scales of the e4m3 checks
PREFILL_ROWS = 2048  # the timed prefill: one request of this many rows


def tflops(flops, ms):
    """Achieved rate of a timed call, TFLOP/s."""
    return flops / ms / 1e9


def kernel_row(name, source, replaces, err, ms, plain, lib, nbytes, flops, **more):
    bd, by = bound(nbytes, flops)
    emit("kernel", name=name, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bd,
         bound_by=by, **more)
    return dict(name=name, source=source, replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


def close(got, want, what):
    import torch

    torch.cuda.synchronize()
    if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
        raise AssertionError(f"{what}: kernel disagrees with the plain version")
    return float((got.float() - want.float()).abs().max())


def close_scaled(got, want, what):
    """As :func:`close` with the absolute part cut to 1% of the largest
    |want| where that is below 1e-2: |got - want| <= 1e-2 * |want| +
    min(1e-2, 1e-2 * max|want|). Attention outputs over many small values
    are far below 1e-2, where a fixed atol would pass a zero output."""
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    atol = min(1e-2, 1e-2 * float(w.abs().max()))
    if not bool(torch.isfinite(g).all()) or not torch.allclose(g, w, atol=atol, rtol=1e-2):
        raise AssertionError(f"{what}: kernel disagrees with the plain version")
    return float((g - w).abs().max())


def e4m3_caches(dev, gen, nb):
    """Seeded e4m3 K and V (HND), their NHD_FUSED slab, per-token K scales
    paged like the cache and per-head V scales."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused_nhd

    fp8 = torch.float8_e4m3fn
    k = torch.randn((HKV, nb, BS, D), generator=gen).to(fp8).to(dev)
    v = torch.randn((HKV, nb, BS, D), generator=gen).to(fp8).to(dev)
    slab = pack_kv_fused_nhd(k.view(torch.uint8), v.view(torch.uint8)).view(fp8)
    ktok = (torch.rand((nb, BS, HKV, 1), generator=gen) + 0.5).to(dev)
    vhead = (torch.rand(HKV, generator=gen) + 0.5).to(dev)
    return k, v, slab, ktok, vhead


K_GROUPS = 4  # K scales grouped along D (fault F4's forms): 4 groups of 32 columns


def grouped_scales(gen, nb, dev):
    """[nb, BS, HKV, K_GROUPS] float32 K scales, one per token, kv head and group of D / K_GROUPS columns."""
    import torch

    return (torch.rand((nb, BS, HKV, K_GROUPS), generator=gen) + 0.5).to(dev)


def gathered_hnd(k, v, tbl, kv_len_max, ktok, vscale):
    """K and V of each request gathered from HND e4m3 caches into [B, Hq, L, D]
    bf16 (repeated over the GQA group) and dequantised (``ktok``: a [1] scale
    or the paged per-token scales; ``vscale``: [1] or [Hkv]): the inputs of
    the library yardstick."""
    import torch

    b = tbl.shape[0]
    pages = tbl[:, : -(-kv_len_max // BS)].clamp(min=0).long()
    kg = k[:, pages].float()  # [HKV, B, n, BS, D]
    if ktok.numel() > 1:  # [B, n, BS, HKV, G] -> [HKV, B, n, BS, D]: each group's scale over D/G columns
        kt = ktok[pages]
        kg = kg * kt.repeat_interleave(D // kt.shape[-1], dim=-1).permute(3, 0, 1, 2, 4)
    else:
        kg = kg * ktok
    vg = v[:, pages].float() * vscale.reshape(-1, 1, 1, 1, 1)
    out = []
    for x in (kg, vg):
        x = x.permute(1, 0, 2, 3, 4).reshape(b, HKV, -1, D)[:, :, :kv_len_max]
        out.append(x.repeat_interleave(HQ // HKV, dim=1).to(torch.bfloat16).contiguous())
    return out


def check_decode_fp8(dev, gen):
    """The decode kernels over e4m3 caches at the serving shape: HND caches
    with per-tensor scales (the fp8_kv model path), the NHD_FUSED slab, and
    QuantType 0."""
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.decode import (
        _decode_nhd_fused_ref,
        _decode_qt0_ref,
        _decode_ref,
        paged_decode_attention,
        paged_decode_nhd_fused,
        paged_decode_qt0,
    )

    b, lens_l = 8, DECODE_LENS
    nb = NUM_BLOCKS + 8
    tbl = random_table(gen, lens_l, max(lens_l) // BS + 4, nb, dev)
    kv_lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    scale = D**-0.5
    k, v, slab, ktok, vhead = e4m3_caches(dev, gen, nb)
    kgrp = grouped_scales(gen, nb, dev)
    ks, vs = torch.tensor([KSCALE], device=dev), torch.tensor([VSCALE], device=dev)
    variants = {
        "paged_decode_e4m3": (
            lambda q, lens, sq, layout="HND": paged_decode_attention(
                q, *(hnd if layout == "HND" else nhd), tbl, lens, sq, scale, layout, ks, vs),
            lambda q, lens, sq, layout="HND": _decode_ref(
                q, *(hnd if layout == "HND" else nhd), tbl, lens, sq, scale, layout, ks, vs),
            "hpc_ops_tpu/ops/attention/decode.py:74", ks, vs, 8),
        "paged_decode_nhd_fused_e4m3": (
            lambda q, lens, sq: paged_decode_nhd_fused(q, slab, tbl, lens, sq, scale, ks, vs),
            lambda q, lens, sq: _decode_nhd_fused_ref(q, slab, tbl, lens, sq, scale, ks, vs),
            "hpc_ops_tpu/ops/attention/decode.py:449", ks, vs, 8),
        "paged_decode_qt0": (
            lambda q, lens, sq: paged_decode_qt0(q, k, v, ktok, vhead, tbl, lens, sq, scale, "HND"),
            lambda q, lens, sq: _decode_qt0_ref(q, k, v, ktok, vhead, tbl, lens, sq, scale, "HND"),
            "hpc_ops_tpu/ops/attention/decode.py:881", ktok, vhead,
            4 * sum(lens_l) * HKV + 4 * HKV),  # 4 bytes of scale per token and kv head
        "paged_decode_qt0_grouped": (
            lambda q, lens, sq: paged_decode_qt0(q, k, v, kgrp, vhead, tbl, lens, sq, scale, "HND"),
            lambda q, lens, sq: _decode_qt0_ref(q, k, v, kgrp, vhead, tbl, lens, sq, scale, "HND"),
            "hpc_ops_tpu/ops/attention/decode.py:881", kgrp, vhead,
            4 * K_GROUPS * sum(lens_l) * HKV + 4 * HKV),
    }
    hnd = (k, v)
    nhd = (k.permute(1, 2, 0, 3).contiguous(), v.permute(1, 2, 0, 3).contiguous())
    L = max(lens_l)
    mask = (torch.arange(L, device=dev)[None, :] < kv_lens[:, None])[:, None, None, :]
    sum_kv = sum(lens_l)
    rows = []
    for name, (kern, plain_fn, replaces, kscale, vscale, scale_bytes) in variants.items():
        err = 0.0
        agree = close_scaled if name.endswith("_grouped") else close
        for sq in (1, 3):  # the second: mtp = 2
            q = torch.randn((b * sq, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
            lens_sq = kv_lens.clamp(min=sq)
            err = max(err, agree(kern(q, lens_sq, sq), plain_fn(q, lens_sq, sq), f"{name} sq={sq}"))
        if name == "paged_decode_e4m3":
            err = max(err, close(kern(q, lens_sq, 3, "NHD"), plain_fn(q, lens_sq, 3, "NHD"),
                                 f"{name} NHD"))
        q = torch.randn((b, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
        ms = device_ms(lambda: kern(q, kv_lens, 1), 50)
        wrapper = time_ms(lambda: kern(q, kv_lens, 1), 50)
        plain = time_ms(lambda: plain_fn(q, kv_lens, 1), 5)
        kg, vg = gathered_hnd(k, v, tbl, L, kscale, vscale)
        q4 = q[:, :, None, :]
        lib = device_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 20)
        del kg, vg
        nbytes = 2 * b * HQ * D * 2 + 2 * sum_kv * HKV * D + tbl.numel() * 4 + b * 4 + scale_bytes
        rows.append(kernel_row(name, "hpc_ops_tpu_torch/csrc/decode.cu", replaces, err, ms, plain,
                               lib, nbytes, 4 * sum_kv * HQ * D, kv_lens=lens_l, wrapper_ms=wrapper))
    return rows


def check_prefill_fp8(dev, gen):
    """The prefill kernel over e4m3 caches: HND caches with per-tensor scales
    (the fp8_kv model path), the NHD_FUSED slab, and per-token K scales with
    a V scale per head (``pertoken_ks``)."""
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.prefill import (
        _prefill_nhd_fused_ref,
        _prefill_ref,
        paged_prefill_attention,
        paged_prefill_nhd_fused,
    )

    scale = D**-0.5
    nb = NUM_BLOCKS + 8
    k, v, slab, ktok, vhead = e4m3_caches(dev, gen, nb)
    kgrp = grouped_scales(gen, nb, dev)
    ks, vs = torch.tensor([KSCALE], device=dev), torch.tensor([VSCALE], device=dev)
    variants = {
        "paged_prefill_e4m3": (
            lambda *a: paged_prefill_attention(a[0], k, v, *a[1:], scale, "HND", ks, vs),
            lambda *a: _prefill_ref(a[0], k, v, *a[1:], scale, "HND", ks, vs),
            "hpc_ops_tpu/ops/attention/prefill.py:48", ks, vs, 8),
        "paged_prefill_nhd_fused_e4m3": (
            lambda *a: paged_prefill_nhd_fused(a[0], slab, *a[1:], scale, ks, vs),
            lambda *a: _prefill_nhd_fused_ref(a[0], slab, *a[1:], scale, ks, vs),
            "hpc_ops_tpu/ops/attention/prefill.py:1070", ks, vs, 8),
        "paged_prefill_pertoken_ks": (
            lambda *a: paged_prefill_attention(a[0], k, v, *a[1:], scale, "HND", None, vhead, ktok),
            lambda *a: _prefill_ref(a[0], k, v, *a[1:], scale, "HND", None, vhead, ktok),
            "hpc_ops_tpu/ops/attention/prefill.py:48", ktok, vhead,
            4 * PREFILL_ROWS * HKV + 4 * HKV),
        "paged_prefill_pertoken_ks_grouped": (
            lambda *a: paged_prefill_attention(a[0], k, v, *a[1:], scale, "HND", None, vhead, kgrp),
            lambda *a: _prefill_ref(a[0], k, v, *a[1:], scale, "HND", None, vhead, kgrp),
            "hpc_ops_tpu/ops/attention/prefill.py:48", kgrp, vhead,
            4 * K_GROUPS * PREFILL_ROWS * HKV + 4 * HKV),
    }
    cases = {
        "one": ([PREFILL_ROWS], [PREFILL_ROWS], 0),
        "three_with_prefix": ([13, 200, 77], [113, 237, 577], 5),  # unaligned cu, padded rows
    }
    inputs = {}
    for cname, (ql, kl, pad) in cases.items():
        cu = torch.tensor([0] + list(torch.tensor(ql).cumsum(0)), dtype=torch.int32, device=dev)
        tbl = random_table(gen, kl, max(kl) // BS + 2, nb, dev)
        q = torch.randn((sum(ql) + pad, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
        inputs[cname] = (q, cu, tbl, torch.tensor(kl, dtype=torch.int32, device=dev), max(ql))
    pairs = PREFILL_ROWS * (PREFILL_ROWS + 1) // 2  # causal (q, k) pairs of the timed input
    rows = []
    for name, (kern, plain_fn, replaces, kscale, vscale, scale_bytes) in variants.items():
        agree = close_scaled if name.endswith("_grouped") else close
        err = max(agree(kern(*a), plain_fn(*a), f"{name} {c}") for c, a in inputs.items())
        timed = inputs["one"]
        ms = time_ms(lambda: kern(*timed), 10)
        plain = time_ms(lambda: plain_fn(*timed), 3)
        kg, vg = gathered_hnd(k, v, timed[2][:1], PREFILL_ROWS, kscale, vscale)
        q4 = timed[0].permute(1, 0, 2)[None].contiguous()
        lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, is_causal=True), 10)
        del kg, vg
        nbytes = (2 * PREFILL_ROWS * HQ * D * 2 + 2 * PREFILL_ROWS * HKV * D + timed[2].numel() * 4
                  + scale_bytes)
        flops = 4 * pairs * HQ * D
        rows.append(kernel_row(name, "hpc_ops_tpu_torch/csrc/prefill.cu", replaces, err, ms, plain,
                               lib, nbytes, flops, tflops=tflops(flops, ms)))
    return rows


def ops_fp8(dev, gen):
    """The fp8 operator entry points, each form once at the serving head
    geometry, against its own impl="ref" (1e-2 abs + 1%: the kernel path
    rounds q * qscale to bf16 first), with the launch counts set to 0 before
    each call and read after it. Returns {kernels-line name: launches}."""
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.config import QuantType
    from hpc_ops_tpu_torch.ops.attention import (
        attention_decode_fp8,
        attention_with_kvcache_prefill_fp8,
    )

    fp8 = torch.float8_e4m3fn
    qt0 = QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD
    b, lens_l, nb = 8, DECODE_LENS, NUM_BLOCKS + 8
    tbl = random_table(gen, lens_l, max(lens_l) // BS + 4, nb, dev)
    kv_lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    k, v, slab, ktok, vhead = e4m3_caches(dev, gen, nb)
    kgrp = grouped_scales(gen, nb, dev)
    ks, vs = torch.tensor([KSCALE], device=dev), torch.tensor([VSCALE], device=dev)
    knhd, vnhd = k.permute(1, 2, 0, 3).contiguous(), v.permute(1, 2, 0, 3).contiguous()
    # the tail-row serving layout: 32-slot NHD pages whose last row holds the
    # 32 tokens' float32 K scales as bytes ([nb, H, bs] f32 -> [nb, 1, H, D] bytes)
    nb32, bs32 = nb // 2, 2 * BS
    tok32 = ktok.view(nb32, bs32, HKV)
    tail = tok32.permute(0, 2, 1).contiguous().view(torch.uint8).view(nb32, HKV, 1, D).permute(0, 2, 1, 3)
    k_tail = torch.cat([knhd.view(nb32, bs32, HKV, D).view(torch.uint8), tail], dim=1).view(fp8)
    v_tail = torch.cat([vnhd.view(nb32, bs32, HKV, D).view(torch.uint8), torch.zeros_like(tail)],
                       dim=1).view(fp8)
    tbl32 = random_table(gen, lens_l, max(lens_l) // bs32 + 2, nb32, dev, bs=bs32)
    q = torch.randn((b, HQ, D), generator=gen)
    qscale = (q.abs().amax(-1) / 448.0).to(dev)
    q8 = (q / (q.abs().amax(-1, keepdim=True) / 448.0)).to(fp8).to(dev)
    qb = torch.randn((b, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
    ql, kl = [13, 200, 77], [113, 237, 577]
    cu = torch.tensor([0, 13, 213, 290], dtype=torch.int32, device=dev)
    ptbl = random_table(gen, kl, max(kl) // BS + 2, nb, dev)
    plens = torch.tensor(kl, dtype=torch.int32, device=dev)
    qp = torch.randn((290, HQ, D), generator=gen)
    row_scale = qp.abs().amax(-1) / 448.0  # [rows, Hq]
    qp8 = (qp / row_scale[..., None]).to(fp8).to(dev)
    pscale = torch.zeros((3, HQ, 256))
    for r, (s, n) in enumerate(zip((0, 13, 213), ql)):
        pscale[r, :, :n] = row_scale[s : s + n].T
    pscale = pscale.to(dev)
    qpb = qp.to(torch.bfloat16).to(dev)
    dec = dict(new_kv_included=True)
    pre = (cu, ptbl, plens, max(ql))
    forms = {  # kernels-line name (or a second form of it): (wrapper, call)
        "paged_decode_e4m3": ("paged_decode", lambda **kw: attention_decode_fp8(
            q8, k, v, tbl, kv_lens, qscale, ks, vs, cache_layout="HND", **dec, **kw)),
        "paged_decode_nhd_fused_e4m3": ("paged_decode_nhd_fused", lambda **kw: attention_decode_fp8(
            q8, slab, None, tbl, kv_lens, qscale, ks, vs, cache_layout="NHD_FUSED", **dec, **kw)),
        "paged_decode_qt0": ("paged_decode_qt0", lambda **kw: attention_decode_fp8(
            qb, knhd, vnhd, tbl, kv_lens, None, ktok, vhead, quant_type=qt0, **dec, **kw)),
        "paged_decode_qt0 (tail-row scales)": ("paged_decode_qt0", lambda **kw: attention_decode_fp8(
            qb, k_tail, v_tail, tbl32, kv_lens, None, k_tail[:, bs32:], vhead, quant_type=qt0,
            **dec, **kw)),
        "paged_prefill_e4m3": ("paged_prefill", lambda **kw: attention_with_kvcache_prefill_fp8(
            qp8, k, v, pscale, ks, vs, *pre, cache_layout="HND", **kw)),
        "paged_prefill_nhd_fused_e4m3": (
            "paged_prefill_nhd_fused", lambda **kw: attention_with_kvcache_prefill_fp8(
                qp8, slab, None, pscale, ks, vs, *pre, cache_layout="NHD_FUSED", **kw)),
        "paged_prefill_pertoken_ks": ("paged_prefill", lambda **kw: attention_with_kvcache_prefill_fp8(
            qpb, knhd, vnhd, None, ktok, vhead, *pre, quant_type=qt0, **kw)),
        # fault F4's forms: K scales in K_GROUPS groups along D launch the kernels
        "paged_decode_qt0_grouped": ("paged_decode_qt0", lambda **kw: attention_decode_fp8(
            qb, knhd, vnhd, tbl, kv_lens, None, kgrp, vhead, quant_type=qt0, **dec, **kw)),
        "paged_prefill_pertoken_ks_grouped": (
            "paged_prefill", lambda **kw: attention_with_kvcache_prefill_fp8(
                qpb, knhd, vnhd, None, kgrp, vhead, *pre, quant_type=qt0, **kw)),
    }
    launches, errs = {}, {}
    for name, (wrapper, call) in forms.items():
        want = call(impl="ref")
        kernels.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if counts != {**{n: 0 for n in counts}, wrapper: 1}:
            raise AssertionError(f"ops_fp8 {name}: launch counts {counts}, expected one of {wrapper}")
        if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
            raise AssertionError(f"ops_fp8 {name}: the entry point disagrees with its impl='ref'")
        errs[name] = float((got.float() - want.float()).abs().max())
        kernel = name.split(" (")[0]  # a second form counts for the same kernel
        launches[kernel] = launches.get(kernel, 0) + 1
    emit("ops_fp8", launches=launches, max_abs_err=errs)
    return launches


# --------------------------------------- FUSED and task-map (split-KV) decode
SHORT_LENS = [1, 64, 333, 1024, 700, 16, 512, 1000]  # KV <= 1024: the TPU's packed FUSED kernel
SCHED_BS, SCHED_TILE = 64, 2048  # the decode benchmark's pages and task tile
# benchmark/attention_decode/bench_attention_decode.py: scenario -> [(count, kv_len)]
SCENARIOS = {
    "uniform_512": [(64, 512)],
    "skewed_mix": [(32, 128), (32, 4096)],
    "skewed_extreme": [(1, 16384), (15, 64)],
    "one_64k_7x4k": [(1, 65536), (7, 4096)],
    "one_128k_31x4k": [(1, 131072), (31, 4096)],
}
REF_GATHER_LIMIT = 16 << 30  # bytes of float32 K/V, over every q head, that impl="ref" may gather
SDPA_GATHER_LIMIT = 24 << 30  # bytes of bf16 K/V gathered for the library yardstick
ROW_SCENARIO = "one_64k_7x4k"  # the task kernel's and the combine's kernels-line shape


def driven(call):
    """Run ``call`` once with every launch count set to 0 just before and
    read just after; returns (its output, the counts that moved)."""
    import torch

    from hpc_ops_tpu_torch import kernels

    kernels.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    return out, {k: n for k, n in kernels.launch_counts().items() if n}


def pack_bytes(pack, k, v):
    """``pack(k, v)`` of caches of any type, 1-byte ones packed as bytes."""
    import torch

    if k.element_size() != 1:
        return pack(k, v)
    return pack(k.view(torch.uint8), v.view(torch.uint8)).view(k.dtype)


def fused_slabs(dev, gen, nb, bs=BS):
    """Seeded K and V (HND bf16) and their head-major FUSED slabs: bf16, int8
    codes from quantize_kv_fused_int8 (with its per-tensor scales) and e4m3
    at the scales of the e4m3 checks. Returns {kind: (slab, kscale, vscale)}."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.paging import pack_kv_fused
    from hpc_ops_tpu_torch.ops.quant import quantize_kv_fused_int8

    k = torch.randn((HKV, nb, bs, D), generator=gen).to(torch.bfloat16).to(dev)
    v = torch.randn((HKV, nb, bs, D), generator=gen).to(torch.bfloat16).to(dev)
    kv8, ks, vs = quantize_kv_fused_int8(k, v)
    fp8 = torch.float8_e4m3fn
    ks8, vs8 = torch.tensor([KSCALE], device=dev), torch.tensor([VSCALE], device=dev)
    e4 = pack_bytes(pack_kv_fused, (k.float() / KSCALE).to(fp8), (v.float() / VSCALE).to(fp8))
    return {"int8": (kv8, ks, vs), "bf16": (pack_kv_fused(k, v), None, None), "e4m3": (e4, ks8, vs8)}


def gathered_fused(slab, tbl, kv_len_max, ks, vs, bs=BS):
    """K and V of each request gathered from a FUSED slab into [B, Hq, L, D]
    bf16 (repeated over the GQA group), dequantised: the library yardstick's
    inputs."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.paging import unpack_kv_fused

    k, v = unpack_kv_fused(slab)
    one = torch.ones(1, device=slab.device)
    return gathered_hnd(k, v, tbl, kv_len_max, one if ks is None else ks, one if vs is None else vs)


def check_decode_fused(dev, gen):
    """The head-major FUSED decode (one kernel for the TPU's rows 6 and 7:
    the decode kernel over strided views of the slab, V at K + bs*D) over
    bf16, int8 and e4m3 slabs at the shapes of the other decode checks, mtp
    0 and 2, against its plain version; timed at the decode lengths and at
    lengths of at most 1024 (the TPU's packed regime); then
    attention_decode(cache_layout="FUSED") once per kind against its
    impl="ref", the launch counts read around each call."""
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.decode import (
        _decode_ref,
        _hnd_views,
        attention_decode,
        paged_decode_attention,
    )

    nb = NUM_BLOCKS + 8
    slabs = fused_slabs(dev, gen, nb)
    scale = D**-0.5
    lens_sets = {"long": DECODE_LENS, "short": SHORT_LENS}
    tbls = {n: random_table(gen, ls, max(ls) // BS + 4, nb, dev) for n, ls in lens_sets.items()}
    b = len(DECODE_LENS)
    errs = {kind: 0.0 for kind in slabs}
    for kind, (slab, ks, vs) in slabs.items():
        kh, vh = _hnd_views(slab, None, "FUSED", D)
        for name, ls in lens_sets.items():
            for sq in (1, 3):
                q = torch.randn((b * sq, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
                lens = torch.tensor([max(n, sq) for n in ls], dtype=torch.int32, device=dev)
                args = (q, kh, vh, tbls[name], lens, sq, scale, "HND", ks, vs)
                errs[kind] = max(errs[kind], close_scaled(
                    paged_decode_attention(*args), _decode_ref(*args), f"decode fused {kind} {name} sq={sq}"))
    rows, launches = [], {}
    q = torch.randn((b, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
    for kind, (slab, ks, vs) in slabs.items():
        kh, vh = _hnd_views(slab, None, "FUSED", D)
        kw = dict(new_kv_included=True, cache_layout="FUSED", kscale=ks, vscale=vs)
        lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
        want = attention_decode(q, slab, None, tbls["long"], lens, impl="ref", **kw)
        got, counts = driven(lambda: attention_decode(q, slab, None, tbls["long"], lens, **kw))
        if counts != {"paged_decode": 1}:
            raise AssertionError(f"decode fused {kind}: launch counts {counts}")
        errs[kind] = max(errs[kind], close_scaled(got, want, f"attention_decode FUSED {kind}"))
        launches[kind] = 1
        elem = 1 if kind != "bf16" else 2
        timed = [("long", DECODE_LENS)] + ([("short", SHORT_LENS)] if kind == "int8" else [])
        for name, ls in timed:
            lens = torch.tensor(ls, dtype=torch.int32, device=dev)
            args = (q, kh, vh, tbls[name], lens, 1, scale, "HND", ks, vs)
            ms = device_ms(lambda: paged_decode_attention(*args), 50)
            wrapper = time_ms(lambda: paged_decode_attention(*args), 50)
            plain = time_ms(lambda: _decode_ref(*args), 5)
            L = max(ls)
            kg, vg = gathered_fused(slab, tbls[name], L, ks, vs)
            mask = (torch.arange(L, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            lib = device_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask), 20)
            del kg, vg
            sum_kv = sum(ls)
            nbytes = (2 * b * HQ * D * 2 + 2 * sum_kv * HKV * D * elem + tbls[name].numel() * 4 + b * 4
                      + (8 if ks is not None else 0))
            row_name = {"bf16": "paged_decode_fused_bf16", "e4m3": "paged_decode_fused_e4m3"}.get(
                kind, "paged_decode_fused" if name == "long" else "paged_decode_fused_packed")
            replaces = ("hpc_ops_tpu/ops/attention/decode.py:671" if name == "short"
                        else "hpc_ops_tpu/ops/attention/decode.py:245")
            rows.append(kernel_row(row_name, "hpc_ops_tpu_torch/csrc/decode.cu", replaces, errs[kind],
                                   ms, plain, lib, nbytes, 4 * sum_kv * HQ * D, kv_lens=ls,
                                   wrapper_ms=wrapper))
    return rows, launches


def task_map_inputs(dev, gen, lens, layout, kind, sq, bs=BS):
    """Seeded q, caches of ``kind`` in ``layout`` over a shuffled page
    table, and the attention_decode keywords of the kind's scales."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.paging import hnd_to_nhd, pack_kv_fused, pack_kv_fused_nhd

    nb = sum(-(-n // bs) for n in lens) + 8
    tbl = random_table(gen, lens, max(lens) // bs + 2, nb, dev, bs=bs)
    k = torch.randn((HKV, nb, bs, D), generator=gen).to(dev)
    v = torch.randn((HKV, nb, bs, D), generator=gen).to(dev)
    ks = vs = None
    if kind == "int8":
        k, v = (torch.randint(-127, 128, tuple(t.shape), generator=gen, dtype=torch.int8).to(dev)
                for t in (k, v))
        ks = vs = torch.tensor([0.05], device=dev)
    elif kind == "e4m3":
        k, v = (t.to(torch.float8_e4m3fn) for t in (k, v))
        ks, vs = torch.tensor([KSCALE], device=dev), torch.tensor([VSCALE], device=dev)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    caches = {"HND": (k, v), "NHD": (hnd_to_nhd(k).contiguous(), hnd_to_nhd(v).contiguous()),
              "FUSED": (pack_bytes(pack_kv_fused, k, v), None),
              "NHD_FUSED": (pack_bytes(pack_kv_fused_nhd, k, v), None)}[layout]
    q = torch.randn((len(lens) * sq, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, caches, tbl, lens_t, dict(mtp=sq - 1, new_kv_included=True, cache_layout=layout,
                                        kscale=ks, vscale=vs)


def partials_err(got, want, what):
    """The task kernel's partials against the plain version's: 1e-3 abs/rel
    on rows that saw a key (float32 sums in another order, the card's
    __expf), exactly m = -inf, l = 0, o = 0 on the others."""
    import torch

    (go, gm, gl), (wo, wm, wl) = got, want
    seen = torch.isfinite(wm)
    if not torch.equal(torch.isfinite(gm), seen):
        raise AssertionError(f"{what}: the rows that saw a key differ")
    if not (torch.all(gl[~seen] == 0) and torch.all(go[~seen] == 0)):
        raise AssertionError(f"{what}: rows that saw no key are not neutral")
    err = 0.0
    for g, w in ((gm[seen], wm[seen]), (gl[seen], wl[seen]), (go[seen], wo[seen])):
        if not torch.allclose(g, w, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"{what}: partials disagree with the plain version")
        err = max(err, float((g - w).abs().max()))
    return err


def check_decode_tasks(dev, gen):
    """The task kernel's partials against its plain version, and the combined
    output of attention_decode(task_map=...) against impl="ref" (close_scaled),
    over bf16, int8 and e4m3 caches in the four layouts at mtp 0 and 2: page
    tables of 16-slot pages, a 4097-token request split into 9 tasks, a map
    of capacity 256 (sentinel tasks) whose last tasks hold a position that a
    draft row may not see; then the combine kernel against its plain version
    over partials with rows at m = -inf and the map's tasks shuffled (no
    segment contiguous). Returns the largest errors by kind."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.decode import (
        _decode_combine_ref,
        _decode_tasks_ref,
        _hnd_views,
        attention_decode,
        decode_combine,
        paged_decode_tasks,
    )
    from hpc_ops_tpu_torch.ops.attention.scheduler import assign_attention_decode_task

    lens = [1, 300, 1025, 4097, 64, 2000, 17, 513]
    errs = {}
    for kind in ("bf16", "int8", "e4m3"):
        for layout in ("HND", "NHD", "FUSED", "NHD_FUSED"):
            for sq in (1, 3):
                ls = [max(n, sq) for n in lens]
                q, (kc, vc), tbl, lens_t, kw = task_map_inputs(dev, gen, ls, layout, kind, sq)
                tm = assign_attention_decode_task(lens_t, HKV, tile=256, min_process_len=512,
                                                  capacity=256, impl="np")
                if not (int(tm.num_tasks) < 256 and int((tm.batch == 3).sum()) == 9 * HKV):
                    raise AssertionError("check_decode_tasks: the map has no sentinel or split task")
                k, v = _hnd_views(kc, vc, layout, D)
                what = f"tasks {kind} {layout} sq={sq}"
                args = (q, k, v, tbl, lens_t, tm, sq, D**-0.5, kw["kscale"])
                err = partials_err(paged_decode_tasks(*args), _decode_tasks_ref(*args), what)
                want = attention_decode(q, kc, vc, tbl, lens_t, impl="ref", **kw)
                got, counts = driven(lambda: attention_decode(q, kc, vc, tbl, lens_t, task_map=tm, **kw))
                if counts != {"paged_decode_tasks": 1, "decode_combine": 1}:
                    raise AssertionError(f"{what}: launch counts {counts}")
                errs[kind] = max(errs.get(kind, 0.0), err, close_scaled(got, want, f"{what} combined"))
    # the combine alone, the last case's partials with the map's tasks shuffled
    perm = torch.randperm(tm.capacity, generator=gen).to(dev)
    shuffled = tm._replace(**{f: getattr(tm, f)[perm].contiguous()
                              for f in ("batch", "head", "tile_start", "num_tiles", "seg")})
    o, m, l = paged_decode_tasks(q, k, v, tbl, lens_t, shuffled, 3, D**-0.5, kw["kscale"])
    if bool(torch.isfinite(m).all()):
        raise AssertionError("check_decode_tasks: no partial row at m = -inf")
    errs["combine"] = close_scaled(decode_combine(o, m, l, shuffled, 3, HQ, kw["vscale"]),
                                   _decode_combine_ref(o, m, l, shuffled, 3, HQ, kw["vscale"]), "combine")
    emit("check_decode_tasks", max_abs_err=errs)
    return errs


def scenario_caches(dev, kv_lens, kind, seed):
    """The decode benchmark's inputs on the card: q [B, Hq, D] bf16, HND K
    and V of N(0, 1/8) over contiguous 64-slot pages (the table padded with
    page 0), as bf16, e4m3 of 16x (scales 1/16) or the int8 FUSED slab of
    quantize_kv_fused_int8; returns (q, k, v, table, lengths, keywords)."""
    import torch

    from hpc_ops_tpu_torch.ops.quant import quantize_kv_fused_int8

    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(kv_lens)
    nb_per = [max(n // SCHED_BS, 1) for n in kv_lens]
    nb = sum(nb_per)
    tbl = torch.zeros((b, max(kv_lens) // SCHED_BS), dtype=torch.int32)
    start = 0
    for i, n in enumerate(nb_per):
        tbl[i, :n] = torch.arange(start, start + n)
        start += n
    q = torch.randn((b, HQ, D), generator=g, device=dev).to(torch.bfloat16)
    k = (torch.randn((HKV, nb, SCHED_BS, D), generator=g, device=dev) / 8).to(torch.bfloat16)
    v = (torch.randn((HKV, nb, SCHED_BS, D), generator=g, device=dev) / 8).to(torch.bfloat16)
    kw = dict(new_kv_included=True, cache_layout="HND")
    if kind == "e4m3":
        k, v = ((x.float() * 16).to(torch.float8_e4m3fn) for x in (k, v))
        kw.update(kscale=torch.tensor([1 / 16], device=dev), vscale=torch.tensor([1 / 16], device=dev))
    elif kind == "int8":
        kv, ks, vs = quantize_kv_fused_int8(k, v)
        k, v = kv, None
        kw.update(cache_layout="FUSED", kscale=ks, vscale=vs)
    return q, k, v, tbl.to(dev), torch.tensor(kv_lens, dtype=torch.int32, device=dev), kw


def sdpa_ms(q, k, v, tbl, kv_lens, kw):
    """One SDPA call over K/V gathered contiguous and dequantised to bf16
    (queries of a kv head as its G rows; gather not timed), or None when the
    padded gather exceeds SDPA_GATHER_LIMIT."""
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.paging import unpack_kv_fused

    b, L = kv_lens.shape[0], int(kv_lens.max())
    if 2 * b * HKV * L * D * 2 > SDPA_GATHER_LIMIT:
        return None
    if kw["cache_layout"] == "FUSED":
        k, v = unpack_kv_fused(k)
    pages = tbl[:, : -(-L // SCHED_BS)].clamp(min=0).long()
    out = []
    for x, s in ((k, kw.get("kscale")), (v, kw.get("vscale"))):
        x = x[:, pages].permute(1, 0, 2, 3, 4).reshape(b, HKV, -1, D)[:, :, :L]
        out.append((x.float() * s if s is not None else x).to(torch.bfloat16).contiguous())
    mask = (torch.arange(L, device=q.device)[None, :] < kv_lens[:, None])[:, None, None, :]
    q4 = q.view(b, HKV, HQ // HKV, D)
    return device_ms(lambda: F.scaled_dot_product_attention(q4, out[0], out[1], attn_mask=mask), 5, 1)


def tasks_ref_chunked(q, k, v, tbl, lens, tm, kscale, chunk=128):
    """The task kernel's plain version over ``chunk`` tasks at a time (its
    float32 gather of a task's span would not fit for every task at once at
    128K keys); the partials concatenated."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.decode import _decode_tasks_ref

    fields = ("batch", "head", "tile_start", "num_tiles", "seg")
    parts = [_decode_tasks_ref(q, k, v, tbl, lens, tm._replace(**{f: getattr(tm, f)[i:i + chunk]
                                                                for f in fields}), 1, D**-0.5, kscale)
             for i in range(0, tm.capacity, chunk)]
    return tuple(torch.cat(x) for x in zip(*parts))


def decode_sched(dev):
    """The JAX decode benchmark's scenarios at full width (Hkv 8, GQA 4, D
    128, pages of 64, task tile 2048): for bf16 and e4m3 HND caches the grid
    decode and the task-map decode (a "tight" map built by the numpy
    scheduler outside the timed window, equal to the native and torch
    schedulers' maps; the task kernel and the combine), the KV-bytes bound,
    SDPA over the gathered K/V, the mode select_decode_mode picks and the
    task count; for the int8 FUSED slab the grid decode. Every output, grid
    and task map, is held against impl="ref" where its padded float32
    gather fits REF_GATHER_LIMIT, else against the plain task-map pipeline
    (the task kernel's and the combine's plain versions, the tasks gathered
    in chunks), within close_scaled; the task kernel's partials, and the
    combine over the plain partials, are held against their plain versions
    in every scenario. Each mode is driven once
    with the launch counts set to 0 before and read after; the kernels-line
    rows of the task kernel and the combine are timed at ROW_SCENARIO.
    Returns (rows, launches by kernels-line name)."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.decode import (
        _decode_combine_ref,
        _hnd_views,
        attention_decode,
        decode_combine,
        paged_decode_tasks,
    )
    from hpc_ops_tpu_torch.ops.attention.scheduler import (
        assign_attention_decode_task,
        select_decode_mode,
    )

    launches, rows = {}, []

    def tally(label, counts, row_of):
        """Counts of one drive: each kernel of ``row_of`` once, under its row."""
        if counts != {k: 1 for k in row_of}:
            raise AssertionError(f"decode_sched {label}: launch counts {counts}")
        for k, row in row_of.items():
            launches[row] = launches.get(row, 0) + 1

    for si, (case, spec) in enumerate(SCENARIOS.items()):
        kv_lens = [n for count, n in spec for _ in range(count)]
        b, sum_kv = len(kv_lens), sum(kv_lens)
        mode = select_decode_mode(kv_lens, HKV)
        for kind in ("bf16", "e4m3", "int8"):
            q, k, v, tbl, lens, kw = scenario_caches(dev, kv_lens, kind, 100 + si)
            tm = assign_attention_decode_task(lens, HKV, tile=SCHED_TILE, capacity="tight", impl="np")
            kh, vh = _hnd_views(k, v, kw["cache_layout"], D)
            fits = 2 * b * max(kv_lens) * HQ * D * 4 <= REF_GATHER_LIMIT
            parts_plain = (None if kind == "int8" and fits
                           else tasks_ref_chunked(q, kh, vh, tbl, lens, tm, kw.get("kscale")))
            if fits:
                want, against = attention_decode(q, k, v, tbl, lens, impl="ref", **kw), "ref"
            else:
                want = _decode_combine_ref(*parts_plain, tm, 1, HQ, kw.get("vscale"))
                against = "plain task map"
            elem = 2 if kind == "bf16" else 1
            kv_bytes = 2 * sum_kv * HKV * D * elem
            line = dict(case=case, kind=kind, batch=b, kv_bytes=kv_bytes,
                        bound_ms=kv_bytes / HBM_BYTES_PER_S * 1e3, selected_mode=mode,
                        checked_against=against)
            grid, counts = driven(lambda: attention_decode(q, k, v, tbl, lens, **kw))
            fused_row = "paged_decode_fused" + ("_packed" if max(kv_lens) <= 1024 else "")
            tally(f"{case} {kind} grid", counts,
                  {"paged_decode": fused_row if kind == "int8" else "paged_decode"})
            line["grid_max_abs_err"] = close_scaled(grid, want, f"decode_sched {case} {kind} grid vs {against}")
            line["grid_ms"] = time_ms(lambda: attention_decode(q, k, v, tbl, lens, **kw), 5, 1)
            line["grid_device_ms"] = device_ms(lambda: attention_decode(q, k, v, tbl, lens, **kw), 5, 1)
            if kind != "int8":  # the benchmark runs no task map over the fused slab
                for impl in ("native", "torch"):
                    other = assign_attention_decode_task(
                        lens, HKV, tile=SCHED_TILE, impl=impl,
                        capacity="tight" if impl == "native" else tm.capacity)
                    if not all(torch.equal(getattr(tm, f), getattr(other, f)) for f in
                               ("batch", "head", "tile_start", "num_tiles", "seg", "num_tasks")):
                        raise AssertionError(f"decode_sched {case}: the {impl} map differs from np's")
                task_row = "paged_decode_tasks" + ("_e4m3" if kind == "e4m3" else "")
                got, counts = driven(lambda: attention_decode(q, k, v, tbl, lens, task_map=tm, **kw))
                tally(f"{case} {kind} taskmap", counts,
                      {"paged_decode_tasks": task_row, "decode_combine": "decode_combine"})
                perr = partials_err(paged_decode_tasks(q, kh, vh, tbl, lens, tm, 1, D**-0.5, kw.get("kscale")),
                                    parts_plain, f"decode_sched {case} {kind} partials")
                vs = kw.get("vscale")
                line["combine_max_abs_err"] = close_scaled(
                    decode_combine(*parts_plain, tm, 1, HQ, vs), _decode_combine_ref(*parts_plain, tm, 1, HQ, vs),
                    f"decode_sched {case} {kind} combine")
                line.update(num_tasks=int(tm.num_tasks), capacity=tm.capacity, partials_max_abs_err=perr,
                            max_abs_err=close_scaled(got, want, f"decode_sched {case} {kind} vs {against}"),
                            taskmap_ms=time_ms(lambda: attention_decode(q, k, v, tbl, lens, task_map=tm,
                                                                        **kw), 5, 1),
                            taskmap_device_ms=device_ms(
                                lambda: attention_decode(q, k, v, tbl, lens, task_map=tm, **kw), 5, 1))
                line["faster"] = "taskmap" if line["taskmap_ms"] < line["grid_ms"] else "grid"
                line["picked_faster"] = mode == line["faster"]
                if case == ROW_SCENARIO:
                    rows += task_rows(q, kh, vh, tbl, lens, tm, kw, kind, sum_kv, elem, line, perr,
                                      parts_plain)
            line["sdpa_ms"] = sdpa_ms(q, k, v, tbl, lens, kw)
            emit("decode_sched", **line)
            del q, k, v, kh, vh, want, grid, parts_plain
            torch.cuda.empty_cache()
    return rows, launches


def combine_work(capacity, batch):
    """(bytes, operations) of the segment combine at Hq, Hkv and D over a
    map of ``capacity`` tasks: every partial (o, m, l) and the map's batch
    and segment read once, the bf16 output written once."""
    rows = HQ // HKV
    return (capacity * rows * (D + 2) * 4 + 2 * 4 * capacity + batch * HQ * D * 2,
            capacity * rows * (3 * D + 4))


def task_rows(q, kh, vh, tbl, lens, tm, kw, kind, sum_kv, elem, line, err, parts_plain):
    """Kernels-line rows of the task kernel (its partials' error ``err``
    against ``parts_plain``, their plain version) and (bf16 only) the
    combine at this scenario: each alone, beside its plain version; the
    task kernel's library column is the scenario's SDPA."""
    from hpc_ops_tpu_torch.ops.attention.decode import (
        _decode_combine_ref as combine_ref,
        _decode_tasks_ref as tasks_ref,
        decode_combine as combine_fn,
        paged_decode_tasks as tasks_fn,
    )

    args = (q, kh, vh, tbl, lens, tm, 1, D**-0.5, kw.get("kscale"))
    ms = device_ms(lambda: tasks_fn(*args), 10, 2)
    plain = time_ms(lambda: tasks_ref(*args), 2, 1)
    b = lens.shape[0]
    rows_per = HQ // HKV
    part_bytes = tm.capacity * rows_per * (D + 2) * 4
    nbytes = (2 * sum_kv * HKV * D * elem + b * HQ * D * 2 + tbl.numel() * 4 + b * 4
              + 4 * 4 * tm.capacity + part_bytes)
    suffix = "_e4m3" if kind == "e4m3" else ""
    out = [kernel_row("paged_decode_tasks" + suffix, "hpc_ops_tpu_torch/csrc/decode.cu",
                      "hpc_ops_tpu/ops/attention/decode.py:1097", err, ms, plain,
                      sdpa_ms(q, kh, vh, tbl, lens, dict(kw, cache_layout="HND")), nbytes,
                      4 * sum_kv * HQ * D, scenario=line["case"], num_tasks=int(tm.num_tasks),
                      capacity=tm.capacity)]
    if kind == "bf16":
        o, m, l = parts_plain
        vs = kw.get("vscale")
        cerr = close_scaled(combine_fn(o, m, l, tm, 1, HQ, vs), combine_ref(o, m, l, tm, 1, HQ, vs),
                            "decode_sched combine")
        cms = device_ms(lambda: combine_fn(o, m, l, tm, 1, HQ, vs), 20, 2)
        cplain = time_ms(lambda: combine_ref(o, m, l, tm, 1, HQ, vs), 5, 1)
        out.append(kernel_row("decode_combine", "hpc_ops_tpu_torch/csrc/decode.cu",
                              "hpc_ops_tpu/ops/attention/decode.py:1325", cerr, cms, cplain, None,
                              *combine_work(tm.capacity, b), scenario=line["case"]))
    return out


# ------------------- block-sparse prefill, Stem masks, RMSNorm + fp8, route GEMM
SPARSE_BS = 64  # the JAX prefill benchmark's pages
# benchmark/attention_prefill/bench_attention_prefill.py: case -> prompt lengths (q == kv)
PREFILL_CASES = {
    "b8_2k": [2048] * 8,
    "b2_8k": [8192] * 2,
    "b1_32k": [32768],
    "mix_4k_16k": [4096, 4096, 16384],
}
FULL_PLAIN_CASES = ("b8_2k", "b2_8k")  # held by a full plain pass; the others by seeded q tiles
SPARSE_KEEP = 0.2  # the benchmark's random keep ratio (--sparse-keep)
SPARSE_ROW_CASE = "b8_2k"  # the shape of the sparse kernel's kernels-line rows
SDPA_MASK_LIMIT = 16 << 30  # bytes of one request's token-expanded bool mask SDPA may take
# the benchmark's Stem budget (--stem): about 0.2 of the causal tiles at 32K
STEM_BUDGET = dict(initial_blocks=2, window_size=2, k_block_num_rate_medium=0.12,
                   k_block_num_bias_medium=6, k_block_num_rate_large=0.08,
                   k_block_num_bias_large=6, gqa_groups=HQ // HKV)
# Stem also over a pool of this many pages a cache (1 GiB of e4m3 at Hkv 8,
# D 128, pages of 64: one layer's share of a serving pool), the case's pages
# first and the rest never named by the table
STEM_POOL_PAGES = 16384
SPARSE_FORMS = {"bf16": "paged_prefill_sparse", "e4m3": "paged_prefill_sparse_e4m3",
                "pertoken": "paged_prefill_sparse_pertoken"}


def run_timed(fn):
    """One call (its output; the warm-up) and the time of a call: CUDA events
    over 20 calls, or over 3 when one call takes more than 100 ms."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time_ms(fn, 3 if time.perf_counter() - t0 > 0.1 else 20, 0)


def split_bodies(counts):
    """(launch counts without the e4m3 grouped GEMMs' bodies, the bodies' counts)."""
    from hpc_ops_tpu_torch.ops.group_gemm import E4M3_BODIES

    names = {body.__name__ for body in E4M3_BODIES.values()}
    return ({k: n for k, n in counts.items() if k not in names},
            {k: n for k, n in counts.items() if k in names})


def count_drive(launches, counts, want, row, what):
    """Check one drive's launch counts (``want`` exactly) and add them to ``row``."""
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected {want}")
    if want:
        launches[row] = launches.get(row, 0) + 1


def random_tile_mask(gen, q_lens, kv_lens, mtq, mtkv, keep, per_kv_head=False):
    """A seeded [B, Hq, n_tm, n_tkv] uint8 mask keeping each q tile's causal
    diagonal tile; ``per_kv_head``: one row per kv head repeated over its
    group, with the two sink tiles kept (the JAX prefill benchmark's mask)."""
    import torch

    n_tm, n_tkv = -(-max(q_lens) // mtq), -(-max(kv_lens) // mtkv)
    heads = HKV if per_kv_head else HQ
    mask = torch.rand((len(q_lens), heads, n_tm, n_tkv), generator=gen) < keep
    if per_kv_head:
        mask = mask.repeat_interleave(HQ // HKV, dim=1)
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        for t in range(n_tm):
            mask[b, :, t, min((kl - ql + t * mtq) // mtkv, n_tkv - 1)] = True
        if per_kv_head:
            mask[b, :, :, :2] = True
    return mask.to(torch.uint8)


def check_prefill_sparse(dev, gen):
    """The block-sparse form of the prefill kernel against its plain version
    at the serving head geometry (Hq 32, Hkv 8, D 128, pages of 16): HND,
    NHD and the NHD_FUSED slab (as NHD views) over bf16, int8 and e4m3
    caches, and per-token K scales with a V scale per head; three requests
    with kv prefixes longer than q (mtp-style chunked prefill), unaligned
    starts and padded rows; mask tiles of 64 x 64, 128 x 64 and 128 x 128; q
    head 1 keeps no tile in request 0's first q tile, nor does any q head of
    kv head 2 (a block whose walk is empty), so their rows must come back
    exactly 0. Within close_scaled."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.paging import nhd_fused_views, pack_kv_fused_nhd
    from hpc_ops_tpu_torch.ops.attention.prefill import _prefill_sparse_ref, paged_prefill_sparse

    scale = D**-0.5
    nb = NUM_BLOCKS + 8
    q_lens, kv_lens, pad = [13, 200, 77], [113, 237, 577], 5
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32, device=dev)
    tbl = random_table(gen, kv_lens, max(kv_lens) // BS + 2, nb, dev)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.randn((sum(q_lens) + pad, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
    kb = torch.randn((HKV, nb, BS, D), generator=gen).to(dev)
    vb = torch.randn((HKV, nb, BS, D), generator=gen).to(dev)
    k8, v8, _, ktok, vhead = e4m3_caches(dev, gen, nb)
    caches = {
        "bf16": (kb.to(torch.bfloat16), vb.to(torch.bfloat16), None, None),
        "int8": ((kb * 40).round().clamp(-127, 127).to(torch.int8),
                 (vb * 40).round().clamp(-127, 127).to(torch.int8),
                 torch.tensor([1 / 40], device=dev), torch.tensor([1 / 40], device=dev)),
        "e4m3": (k8, v8, torch.tensor([KSCALE], device=dev), torch.tensor([VSCALE], device=dev)),
    }
    tiles = [(64, 64), (128, 64), (128, 128)]
    errs, dead_rows = {}, q_lens[0]
    dead_group = slice(2 * (HQ // HKV), 3 * (HQ // HKV))  # the q heads of kv head 2
    for i, (kind, layout) in enumerate([(k, l) for k in caches for l in ("HND", "NHD", "NHD_FUSED")]
                                       + [("pertoken", "HND"), ("pertoken", "NHD_FUSED")]):
        k, v, ks, vs = caches["e4m3" if kind == "pertoken" else kind]
        tok = ktok if kind == "pertoken" else None
        if kind == "pertoken":
            ks, vs = None, vhead
        mtq, mtkv = tiles[i % len(tiles)]
        mask = random_tile_mask(gen, q_lens, kv_lens, mtq, mtkv, 0.4)
        mask[0, 1, 0] = 0  # q head 1 keeps nothing in request 0's first q tile
        mask[0, dead_group, 0] = 0  # nor does kv head 2's whole group: an empty walk
        mask = mask.to(dev)
        kc, vc, lay = k, v, "HND"
        if layout == "NHD":
            kc, vc, lay = k.permute(1, 2, 0, 3).contiguous(), v.permute(1, 2, 0, 3).contiguous(), "NHD"
        elif layout == "NHD_FUSED":
            kc, vc = nhd_fused_views(pack_bytes(pack_kv_fused_nhd, k, v), HKV)
            lay = "NHD"
        args = (q, kc, vc, cu, tbl, lens, max(q_lens), scale, lay, mask, mtq, mtkv, ks, vs, tok)
        got = paged_prefill_sparse(*args)
        want = _prefill_sparse_ref(*args)
        name = f"{kind} {layout} {mtq}x{mtkv}"
        errs[name] = close_scaled(got, want, f"check_prefill_sparse {name}")
        dead = torch.cat([got[:dead_rows, 1:2], got[:dead_rows, dead_group]], dim=1)
        if dead.float().abs().max() != 0:
            raise AssertionError(f"check_prefill_sparse {name}: a row with no kept key is not 0")
    emit("check_prefill_sparse", max_abs_err=errs)


def kept_work(mask, lens, mtq, mtkv):
    """What a mask [B, Hq, n_tm, n_tkv] over fresh prompts (q == kv) leaves to
    compute: the causal (q, k) pairs of its kept tiles summed over q heads,
    and the kv positions that some q head of a kv head's group needs, summed
    over kv heads (each read once)."""
    import torch
    import torch.nn.functional as F

    pairs = positions = 0
    g = HQ // HKV
    for b, L in enumerate(lens):
        n_tm, n_tk = -(-L // mtq), -(-L // mtkv)
        start = torch.arange(n_tk, device=mask.device) * mtkv
        width = (L - start).clamp(max=mtkv)
        qpos = torch.arange(L, device=mask.device)
        cnt = torch.minimum((qpos[:, None] + 1 - start[None, :]).clamp(min=0), width[None, :])
        per_tile = F.pad(cnt, (0, 0, 0, n_tm * mtq - L)).view(n_tm, mtq, n_tk).sum(dim=1)
        m = mask[b, :, :n_tm, :n_tk].bool()
        pairs += int((m * per_tile[None]).sum())
        need = (m & (per_tile > 0)[None]).view(HKV, g, n_tm, n_tk).any(dim=1).any(dim=1)
        positions += int((need * width[None]).sum())
    return pairs, positions


def sparse_bound(total_q, pairs, positions, mask_bytes, tbl_bytes, elem=1):
    """Bound of a prefill call: q and out in bf16, each needed K/V row once
    (``elem`` bytes an element), the mask and the table; 4 D operations a
    causal pair, at the bf16 rate (q is bf16)."""
    nbytes = 2 * total_q * HQ * D * 2 + 2 * positions * D * elem + mask_bytes + tbl_bytes
    return nbytes, 4 * pairs * D


def sparse_sdpa_ms(q, kc, vc, tbl, lens, keep=None, mtq=128, mtkv=64):
    """Causal SDPA request by request over K/V gathered from the NHD caches
    and dequantised to bf16, each kv head repeated over its group (gather not
    timed); with ``keep`` the tile mask expanded to tokens beside the causal
    mask, or None when one request's expanded mask exceeds SDPA_MASK_LIMIT."""
    import torch
    import torch.nn.functional as F

    calls, off = [], 0
    for b, L in enumerate(lens):
        if keep is not None and HQ * L * L > SDPA_MASK_LIMIT:
            return None
        pages = tbl[b, : L // SPARSE_BS].long()
        kv = [x[pages].reshape(L, HKV, D).permute(1, 0, 2).to(torch.bfloat16)
              .repeat_interleave(HQ // HKV, dim=0)[None].contiguous() for x in (kc, vc)]
        q4 = q[off : off + L].permute(1, 0, 2)[None].contiguous()
        if keep is None:
            calls.append(lambda q4=q4, kv=kv: F.scaled_dot_product_attention(q4, *kv, is_causal=True))
        else:
            pos = torch.arange(L, device=q.device)
            m = keep[b][:, pos // mtq][:, :, pos // mtkv].bool() & (pos[None, :] <= pos[:, None])[None]
            calls.append(lambda q4=q4, kv=kv, m=m: F.scaled_dot_product_attention(q4, *kv, attn_mask=m[None]))
        off += L
    return run_timed(lambda: [c() for c in calls])[1]


def sparse_plain_check(label, got, args, mask, mtq, mtkv, lens, full, gen, extra=()):
    """Hold ``got`` against the plain version (close_scaled): a full pass, or
    seeded q tiles of 128 rows of each request (the first, the last and
    three between), each as a sub-request cut at a mask-row boundary: its
    rows, the keys up to its last row, the mask rows from its first on."""
    import torch

    from hpc_ops_tpu_torch.ops.attention.prefill import _prefill_sparse_ref

    q, kc, vc, cu, tbl, kv_lens, max_q = args
    if full:
        return close_scaled(got, _prefill_sparse_ref(*args, D**-0.5, "NHD", mask, mtq, mtkv, *extra),
                            label)
    err, off = 0.0, 0
    for b, L in enumerate(lens):
        n_t = L // 128
        picks = {0, n_t - 1, *torch.randint(0, n_t, (3,), generator=gen).tolist()}
        for t in sorted(picks):
            r0 = t * 128
            sub = (q[off + r0 : off + r0 + 128], kc, vc,
                   torch.tensor([0, 128], dtype=torch.int32, device=q.device), tbl[b : b + 1],
                   torch.tensor([r0 + 128], dtype=torch.int32, device=q.device), 128)
            want = _prefill_sparse_ref(*sub, D**-0.5, "NHD", mask[b : b + 1, :, r0 // mtq :], mtq, mtkv,
                                       *extra)
            err = max(err, close_scaled(got[off + r0 : off + r0 + 128], want, f"{label} request {b} q tile {t}"))
        off += L
    return err


def sparse_case_inputs(dev, lens, seed):
    """The JAX prefill benchmark's data on the card: q of N(0, 1) as e4m3 (q
    scale 1), K and V of N(0, 1/8) in contiguous 64-slot NHD pages as e4m3
    (scales 1), and their bf16 originals."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    b, total = len(lens), sum(lens)
    nb_per = [-(-n // SPARSE_BS) for n in lens]
    tbl = torch.zeros((b, max(nb_per)), dtype=torch.int32)
    start = 0
    for i, n in enumerate(nb_per):
        tbl[i, :n] = torch.arange(start, start + n)
        start += n
    q = torch.randn((total, HQ, D), generator=g, device=dev).to(torch.bfloat16)
    kb = (torch.randn((sum(nb_per), SPARSE_BS, HKV, D), generator=g, device=dev) / 8).to(torch.bfloat16)
    vb = (torch.randn((sum(nb_per), SPARSE_BS, HKV, D), generator=g, device=dev) / 8).to(torch.bfloat16)
    fp8 = torch.float8_e4m3fn
    cu = torch.tensor([0] + torch.tensor(lens).cumsum(0).tolist(), dtype=torch.int32, device=dev)
    return dict(q8=q.to(fp8), kb=kb, vb=vb, k8=kb.to(fp8), v8=vb.to(fp8), cu=cu, tbl=tbl.to(dev),
                lens=torch.tensor(lens, dtype=torch.int32, device=dev),
                qscale=torch.ones((b, HQ, max(lens)), device=dev), one=torch.ones(1, device=dev))


def prefill_sparse(dev):
    """The JAX prefill benchmark's cases at full width, not cut (Hkv 8, GQA
    4, D 128, pages of 64, e4m3 caches at scale 1, one line each): the dense
    e4m3 call, the sparse call under the benchmark's random per-kv-head mask
    (keep 0.2, the diagonal and two sink tiles kept, 128 x 64 tiles), Stem
    (stem_paged_kv with the benchmark's budget, GQA-pooled; timed again over
    a pool of STEM_POOL_PAGES pages, with the same mask) and the sparse call
    under its mask at 128 x 128, causal SDPA and SDPA over each mask
    expanded to tokens where that fits SDPA_MASK_LIMIT, the bytes and
    operations bounds of the kept tiles. Every output is held against the
    plain version (dense: the same function, a mask keeping every tile);
    each entry point is driven once with the launch counts set to 0 before
    and read after. At SPARSE_ROW_CASE also the kernels-line rows of the
    sparse kernel's three forms. Returns (rows, launches by row name)."""
    import torch

    from hpc_ops_tpu_torch.ops.attention import (
        attention_with_kvcache_blocksparse_prefill_fp8,
        attention_with_kvcache_prefill_fp8,
    )
    from hpc_ops_tpu_torch.ops.stem import stem_paged_kv

    launches, rows = {}, []
    gen = torch.Generator().manual_seed(41)
    for ci, (case, lens) in enumerate(PREFILL_CASES.items()):
        x = sparse_case_inputs(dev, lens, 200 + ci)
        b, total, max_q = len(lens), sum(lens), max(lens)
        one = x["one"]
        pre = (x["cu"], x["tbl"], x["lens"], max_q)
        full = case in FULL_PLAIN_CASES
        plain_args = (x["q8"].to(torch.bfloat16), x["k8"], x["v8"], *pre)
        line = dict(case=case, batch=b, total_q=total)

        def dense():
            return attention_with_kvcache_prefill_fp8(x["q8"], x["k8"], x["v8"], x["qscale"], one, one, *pre)

        got, counts = driven(dense)
        count_drive(launches, counts, {"paged_prefill": 1}, "paged_prefill_e4m3", f"prefill_sparse {case} dense")
        _, line["dense_fp8_ms"] = run_timed(dense)
        n_tm, n_tk = -(-max_q // 128), x["tbl"].shape[1]
        ones = torch.ones((b, HQ, n_tm, n_tk), dtype=torch.uint8, device=dev)
        line["dense_max_abs_err"] = sparse_plain_check(
            f"prefill_sparse {case} dense", got, plain_args, ones, 128, SPARSE_BS, lens, full, gen, (one, one))
        pairs_d, pos_d = kept_work(ones, lens, 128, SPARSE_BS)
        tbl_bytes = x["tbl"].numel() * 4
        line["dense_bound_ms"] = bound(*sparse_bound(total, pairs_d, pos_d, 0, tbl_bytes))[0]
        line["dense_tflops"] = tflops(4 * pairs_d * D, line["dense_fp8_ms"])
        del got, ones

        mask = random_tile_mask(gen, lens, lens, 128, SPARSE_BS, SPARSE_KEEP, per_kv_head=True)
        mask = mask[:, :, :, :n_tk].contiguous().to(dev)

        def sparse(m=mask, tq=128, tkv=SPARSE_BS):
            return attention_with_kvcache_blocksparse_prefill_fp8(
                x["q8"], x["k8"], x["v8"], x["qscale"], one, one, *pre, block_mask=m, mask_tile_q=tq,
                mask_tile_kv=tkv)

        got, counts = driven(sparse)
        count_drive(launches, counts, {"paged_prefill_sparse": 1}, "paged_prefill_sparse_e4m3",
              f"prefill_sparse {case} sparse")
        _, line["sparse_ms"] = run_timed(sparse)
        line["sparse_max_abs_err"] = sparse_plain_check(
            f"prefill_sparse {case} sparse", got, plain_args, mask, 128, SPARSE_BS, lens, full, gen,
            (one, one))
        del got
        pairs, positions = kept_work(mask, lens, 128, SPARSE_BS)
        nbytes, flops = sparse_bound(total, pairs, positions, mask.numel(), tbl_bytes)
        line.update(keep_frac=float(mask.float().mean()), speedup_vs_dense_fp8=line["dense_fp8_ms"] / line["sparse_ms"],
                    kept_pair_frac=pairs / pairs_d, sparse_kv_bytes=2 * positions * D,
                    sparse_bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    sparse_bound_ops_ms=flops / BF16_FLOPS_PER_S * 1e3,
                    sparse_tflops=tflops(flops, line["sparse_ms"]))

        def stem():
            return stem_paged_kv(x["q8"], x["k8"], x["v8"], x["qscale"], one, one, x["tbl"], x["cu"],
                                 x["lens"], x["lens"], **STEM_BUDGET)

        stem_mask, counts = driven(stem)
        count_drive(launches, counts, {}, None, f"prefill_sparse {case} stem")
        _, line["stem_ms"] = run_timed(stem)
        pool = [torch.cat([c.view(torch.uint8), torch.zeros((STEM_POOL_PAGES - c.shape[0], *c.shape[1:]),
                                                           dtype=torch.uint8, device=dev)]).view(c.dtype)
                for c in (x["k8"], x["v8"])]
        pool_mask, line["stem_pool_ms"] = run_timed(lambda: stem_paged_kv(
            x["q8"], *pool, x["qscale"], one, one, x["tbl"], x["cu"], x["lens"], x["lens"], **STEM_BUDGET))
        if not torch.equal(pool_mask, stem_mask):
            raise AssertionError(f"prefill_sparse {case} stem: the mask depends on the pool's spare pages")
        line["stem_pool_pages"] = STEM_POOL_PAGES
        del pool, pool_mask
        got, counts = driven(lambda: sparse(stem_mask, 128, 128))
        count_drive(launches, counts, {"paged_prefill_sparse": 1}, "paged_prefill_sparse_e4m3",
              f"prefill_sparse {case} stem sparse")
        _, line["stem_sparse_ms"] = run_timed(lambda: sparse(stem_mask, 128, 128))
        line["stem_sparse_max_abs_err"] = sparse_plain_check(
            f"prefill_sparse {case} stem sparse", got, plain_args, stem_mask, 128, 128, lens, full, gen,
            (one, one))
        del got
        mq, mk = stem_mask.shape[2:]
        tri = (torch.arange(mk, device=dev)[None, :] * 128 <= (torch.arange(mq, device=dev)[:, None] + 1) * 128 - 1)
        stem_pairs, _ = kept_work(stem_mask, lens, 128, 128)
        line.update(stem_keep_frac=float(stem_mask.float().sum() / (tri.sum() * b * HQ)),
                    stem_kept_pair_frac=stem_pairs / pairs_d,
                    net_speedup=line["dense_fp8_ms"] / (line["stem_ms"] + line["stem_sparse_ms"]))
        qb = x["q8"].to(torch.bfloat16)
        line["sdpa_causal_ms"] = sparse_sdpa_ms(qb, x["kb"], x["vb"], x["tbl"], lens)
        line["sdpa_mask_ms"] = sparse_sdpa_ms(qb, x["kb"], x["vb"], x["tbl"], lens, mask, 128, SPARSE_BS)
        line["sdpa_stem_mask_ms"] = sparse_sdpa_ms(qb, x["kb"], x["vb"], x["tbl"], lens, stem_mask, 128, 128)
        if case == SPARSE_ROW_CASE:
            rows += sparse_rows(dev, x, mask, line, launches)
        emit("prefill_sparse", **line)
        del x, mask, stem_mask, qb
        torch.cuda.empty_cache()
    return rows, launches


def sparse_rows(dev, x, mask, line, launches):
    """Kernels-line rows of the sparse kernel at one case under its random
    mask: over the e4m3 caches, over their bf16 originals, and over the e4m3
    codes with seeded K scales per (token, kv head) and a V scale per head;
    each beside its plain version (a full pass) and SDPA over the mask
    expanded to tokens. The bf16 and per-token forms are driven once through
    the entry point (attention_with_kvcache_prefill with the bf16 caches,
    and with QuantType 0)."""
    import torch

    from hpc_ops_tpu_torch.config import QuantType
    from hpc_ops_tpu_torch.ops.attention import attention_with_kvcache_prefill
    from hpc_ops_tpu_torch.ops.attention.prefill import _prefill_sparse_ref, paged_prefill_sparse

    g = torch.Generator(device=dev).manual_seed(7)
    ktok = torch.rand((x["k8"].shape[0], SPARSE_BS, HKV, 1), generator=g, device=dev) + 0.5
    vhead = torch.rand(HKV, generator=g, device=dev) + 0.5
    qb = x["q8"].to(torch.bfloat16)
    lens = x["lens"].tolist()
    pre = (x["cu"], x["tbl"], x["lens"], max(lens), D**-0.5, "NHD", mask, 128, SPARSE_BS)
    forms = {
        "bf16": ((qb, x["kb"], x["vb"], *pre), 2, dict()),
        "e4m3": ((qb, x["k8"], x["v8"], *pre, x["one"], x["one"]), 1, None),
        "pertoken": ((qb, x["k8"], x["v8"], *pre, None, vhead, ktok), 1,
                     dict(kscale=ktok, vscale=vhead,
                          quant_type=QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD)),
    }
    out = []
    for form, (args, elem, entry_kw) in forms.items():
        if entry_kw is not None:
            kc, vc = args[1], args[2]
            _, counts = driven(lambda: attention_with_kvcache_prefill(
                qb, kc, vc, x["cu"], x["tbl"], x["lens"], max(lens), block_mask=mask, mask_tile_q=128,
                mask_tile_kv=SPARSE_BS, **entry_kw))
            count_drive(launches, counts, {"paged_prefill_sparse": 1}, SPARSE_FORMS[form],
                  f"prefill_sparse {form} entry point")
        got, ms = run_timed(lambda: paged_prefill_sparse(*args))
        want, plain = run_timed(lambda: _prefill_sparse_ref(*args))
        err = close_scaled(got, want, f"prefill_sparse row {form}")
        pairs, positions = kept_work(mask, lens, 128, SPARSE_BS)
        scale_bytes = 4 * positions if form == "pertoken" else 0
        nbytes, flops = sparse_bound(sum(lens), pairs, positions, mask.numel(), x["tbl"].numel() * 4, elem)
        out.append(kernel_row(SPARSE_FORMS[form], "hpc_ops_tpu_torch/csrc/prefill.cu",
                              "hpc_ops_tpu/ops/attention/prefill.py:543", err, ms, plain,
                              line["sdpa_mask_ms"], nbytes + scale_bytes, flops, case=line["case"],
                              keep_frac=line["keep_frac"], tflops=tflops(flops, ms)))
        del got, want
    return out


NORM_SHAPES = [(8, 4096), (8, 5120), (2048, 4096), (2048, 5120)]  # tokens x hidden
NORM_ROW_SHAPE = (2048, 4096)  # the kernels-line rows' shape


def norm_bytes(n, h, is_moe):
    """Bytes of RMSNorm + fp8 over [n, h]: the bf16 input and bf16 weight
    read, the scales, the codes (and with the MoE outputs the float32 norm
    and the second codes) written."""
    return n * h * 2 + h * 2 + (8 if is_moe else 4) + n * h * (6 if is_moe else 1)


def check_rmsnorm_quant(dev, gen):
    """The RMSNorm + fp8 kernel against its plain version on the card at 8
    and 2048 tokens x hidden 4096 and 5120, with and without the MoE
    outputs: every float32 norm equal, every e4m3 code equal (a code one
    step apart is counted and allowed on at most 0.1% of them); the entry point
    fused_rmsnorm_with_scale driven once per shape and form. The kernel's
    time is torch.profiler's device time, and a call at the bf16 weight
    launches one kernel (profiler count; held wherever a session counted).
    Returns (rows, launches by row name)."""
    import torch

    from hpc_ops_tpu_torch.ops.normalization import (
        _F32_EPS,
        _rmsnorm_quant_ref,
        fused_rmsnorm_with_scale,
        norm_form,
        rmsnorm_quant,
    )

    rows, launches, counted = [], {}, 0
    for n, h in NORM_SHAPES:
        x = (torch.randn((n, h), generator=gen) * 2).to(torch.bfloat16).to(dev)
        w = (torch.rand(h, generator=gen) + 0.5).to(torch.bfloat16).to(dev)
        for is_moe in (False, True):
            name = "fused_rmsnorm_moe" if is_moe else "fused_rmsnorm"
            sc = torch.tensor([0.02, 0.05] if is_moe else [0.02], device=dev)  # some codes saturate
            _, counts = driven(lambda: fused_rmsnorm_with_scale(x, w, scale=sc, is_moe=is_moe))
            count_drive(launches, counts, {"rmsnorm_quant": 1}, name, f"{name} {n}x{h}")
            got = rmsnorm_quant(x, w, sc, _F32_EPS, is_moe)
            ms, kernels_a_call = profile_kernels(lambda: rmsnorm_quant(x, w, sc, _F32_EPS, is_moe))
            if kernels_a_call not in (None, 1):
                raise AssertionError(f"check_rmsnorm_quant {name} {n}x{h}: {kernels_a_call} kernels a call")
            counted += kernels_a_call is not None
            want, plain = run_timed(lambda: _rmsnorm_quant_ref(x, w, sc, _F32_EPS, is_moe))
            got, want = (got, want) if is_moe else ((got,), (want,))
            off_codes, err = 0, 0.0
            for a, b_ in zip(got, want):
                if a.dtype == torch.float32:
                    if not torch.equal(a, b_):
                        raise AssertionError(f"check_rmsnorm_quant {name} {n}x{h}: float32 norms differ")
                    continue
                ia, ib = (t.view(torch.uint8).to(torch.int16) for t in (a, b_))
                diff = (ia - ib).abs()
                off_codes += int((diff > 0).sum())
                if int(diff.max()) > 1 or off_codes > 1e-3 * a.numel():
                    raise AssertionError(f"check_rmsnorm_quant {name} {n}x{h}: codes disagree")
                err = max(err, float((a.float() - b_.float()).abs().max()))
            nbytes = norm_bytes(n, h, is_moe)
            bd, by = bound(nbytes, 5 * n * h)
            line = dict(tokens=n, hidden=h, codes_off_by_one=off_codes, kernels_a_call=kernels_a_call,
                        share_of_bound=bd / ms, form=norm_form(n, h)._asdict())
            if (n, h) == NORM_ROW_SHAPE:
                rows.append(kernel_row(name, "hpc_ops_tpu_torch/csrc/normalization.cu",
                                       "hpc_ops_tpu/ops/normalization.py:51", err, ms, plain, None, nbytes,
                                       5 * n * h, **line))
            else:
                emit("rmsnorm_quant", name=name, **line, max_abs_err=err, ms=ms, plain_ms=plain,
                     bound_ms=bd, bound_by=by)
    if not counted:
        raise AssertionError("check_rmsnorm_quant: no profiling session counted the kernels a call")
    return rows, launches


# benchmark/route_gemm/bench_route_gemm.py: (m, n, k)
ROUTE_SHAPES = [(256, 256, 7168), (4096, 256, 7168), (16384, 256, 7168), (4096, 4096, 4096),
                (8192, 8192, 8192)]
ROUTE_ROW_SHAPE = (4096, 256, 7168)  # the kernels-line row's shape


def check_route_gemm(dev, gen):
    """The route GEMM kernel at the JAX route benchmark's shapes: its float32
    output within the float32 summation bound of the float64 product of the
    split weights ((k / 16 + 1) ulps of |x| @ |w|^T, element by element: one
    rounding per tensor-core step), its bf16 output within half a bf16 step
    more; max_abs_err is its bf16 output against the plain version (two
    float32 products with TF32 off);
    the library column is one cuBLAS float32 product x.float() @ w.T (TF32
    off), the reference's own baseline; gemm_bf16xfp32 driven once per shape.
    Kernel and library times (``ms``, ``library_ms``) are wall times over
    back-to-back calls (CUDA events), host time included; their device times
    (torch.profiler) stand beside them as ``device_ms`` and
    ``library_device_ms``. Each line carries the kernel's share of its bound
    (of its device time) and its form (ops/gemm.py:route_form: body, tile,
    splits of K, blocks).
    Returns (rows, launches by row name)."""
    import torch

    from hpc_ops_tpu_torch.ops.gemm import (
        _route_gemm_ref,
        gemm_bf16xfp32,
        route_form,
        route_gemm,
        split_fp32_weight,
    )

    rows, launches = [], {}
    for m, n, k in ROUTE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(m + n)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w32 = torch.randn((n, k), generator=g, device=dev)
        wh, wl, ws = split_fp32_weight(w32)
        _, counts = driven(lambda: gemm_bf16xfp32(x, wh, wl, ws))
        count_drive(launches, counts, {"route_gemm": 1}, "route_gemm", f"route_gemm {m}x{n}x{k}")
        got, ms = run_timed(lambda: route_gemm(x, wh, wl, ws, False))
        dev_ms = device_ms(lambda: route_gemm(x, wh, wl, ws, False))
        want, plain = run_timed(lambda: _route_gemm_ref(x, wh, wl, ws, True))
        got32 = route_gemm(x, wh, wl, ws, True)
        # the float64 product of the split weights, and the float32 summation
        # bound: the kernel adds k / 16 tensor-core steps into each float32
        # accumulator, each rounding by at most one ulp of a partial sum no
        # larger than (|x| @ |w_high + scale * w_low|^T)
        xd, whd, wld = x.double(), wh.double(), wl.double()
        exact = xd @ (whd + float(ws) * wld).T
        sum_tol = (k / 16 + 1) * 2.0**-23 * (xd.abs() @ (whd.abs() + float(ws) * wld.abs()).T)
        torch.cuda.synchronize()
        if not bool(((got32.double() - exact).abs() <= sum_tol).all()):
            raise AssertionError(f"route_gemm {m}x{n}x{k} fp32: kernel outside the float32 summation bound")
        if not bool(((got.double() - exact).abs() <= sum_tol + 2.0**-8 * exact.abs()).all()):
            raise AssertionError(f"route_gemm {m}x{n}x{k}: kernel outside the bound plus half a bf16 step")
        err = float((got.float() - want).abs().max())
        del xd, whd, wld, sum_tol
        xf = x.float()
        _, lib = run_timed(lambda: xf @ w32.T)
        lib_dev = device_ms(lambda: xf @ w32.T)
        exact_err = float((got32.double() - x.double() @ w32.double().T).abs().max())
        del exact
        nbytes, flops = m * k * 2 + 2 * n * k * 2 + m * n * 2, 4 * m * n * k
        bd, by = bound(nbytes, flops)
        f = route_form(m, n, k)
        form = dict(body=f.body, tile=[f.tile_m, f.tile_n], splits=f.splits, blocks=f.blocks)
        if (m, n, k) == ROUTE_ROW_SHAPE:
            rows.append(kernel_row("route_gemm", "hpc_ops_tpu_torch/csrc/gemm.cu", "hpc_ops_tpu/ops/gemm.py:35",
                                   err, ms, plain, lib, nbytes, flops, shape=[m, n, k],
                                   fp32_out_abs_err_vs_float64=exact_err, share_of_bound=bd / dev_ms,
                                   form=form, device_ms=dev_ms, library_device_ms=lib_dev))
        else:
            emit("route_gemm", shape=[m, n, k], max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                 bound_ms=bd, bound_by=by, share_of_bound=bd / dev_ms, form=form, device_ms=dev_ms,
                 library_device_ms=lib_dev, fp32_out_abs_err_vs_float64=exact_err)
        del x, w32, wh, wl, got, got32, want, xf
        torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------- MoE kernels
MOE_H, MOE_I, MOE_E, MOE_K = 4096, 14336, 8, 2  # Mixtral-8x7B: hidden, expert width, experts, top-k
# Tokens of a call. The serving run prefills one prompt of 16 to 512 tokens a
# call, so its m-tiles run from 32 to 160 slots: 8, 200 and 512 tokens give tm
# 32, 64 and 160, one for each instance of the grouped GEMM (32-, 64- and
# 128-row blocks, the last with a ragged second block). 2048 tokens (tm 512)
# is the throughput shape, which this run's short prompts never reach.
# ------------------------------------------- fused all-reduce + RMSNorm
ALLREDUCE_WS = (2, 4, 8)  # virtual ranks of the bit-equality checks
ALLREDUCE_CHECK = (128, 4096)  # their tokens x hidden (two_shot needs tokens % (8 * ws) == 0)
ALLREDUCE_SKEW = 2000  # rank r raises its ready flag after about r * 2000 spins of ~100 ns
# the JAX collective benchmark's grid (benchmark/fuse_allreduce_rmsnorm/bench_allreduce.py:33-36)
ALLREDUCE_GRID = dict(world=8, hidden=(4096, 5120, 7168), tokens=(8, 128, 2048, 32768))
# the kernels-line rows: (mode, ranks, tokens, hidden): slice_full_tp's decode
# collective, and a prefill-sized two_shot over the same ranks
ALLREDUCE_ROWS = {"allreduce_rmsnorm_one_shot": ("one_shot", 4, 8, 4096),
                  "allreduce_rmsnorm_two_shot": ("two_shot", 4, 2048, 4096)}
ALLREDUCE_REPLACES = {"one_shot": "hpc_ops_tpu/parallel/collective_kernels.py:95",
                      "two_shot": "hpc_ops_tpu/parallel/collective_kernels.py:166"}


def allreduce_inputs(dev, gen, ws, n, h):
    """``ws`` seeded bf16 partials [n, h] (standard deviation 0.5), a residual
    for each rank (equal values, separate tensors) and a float32 weight in
    [0.5, 1.5), made on the card."""
    import torch

    xs = [(torch.randn((n, h), generator=gen, device=dev) * 0.5).to(torch.bfloat16) for _ in range(ws)]
    res = torch.randn((n, h), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.rand((h,), generator=gen, device=dev) + 0.5
    return xs, [res.clone() for _ in range(ws)], w


def allreduce_bytes(ws, n, h):
    """Each partial read once, the residual and weight once, each rank's two
    outputs written once."""
    return ws * n * h * 2 + n * h * 2 + h * 4 + ws * 2 * n * h * 2


def allreduce_case(dev, gen, mode, ws, n, h, eps=1e-5, bf16_norm=False, own_res=False):
    """One case of the fused collective on ``ws`` virtual ranks of the card,
    from seeded inputs: the kernel's call (one launch for the group; run once
    here and checked bit-equal to the plain version on every rank), the
    plain version's (one set of outputs and a copy per rank, as the CPU ranks
    get them), the unfused chain's (sum of the partials, residual add,
    RMSNorm: one library call each) and the per-device form's (a launch a
    rank, in rank order on one stream; also run and checked bit-equal), as
    closures. The ranks read one
    residual tensor, as the bound counts it, or with ``own_res`` each its
    own copy, as the serving ranks do."""
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.parallel.collective_kernels import (
        _allreduce_rmsnorm_ref,
        _RankCall,
        _SignalPad,
        allreduce_rmsnorm,
    )

    xs, res, w = allreduce_inputs(dev, gen, ws, n, h)
    if not own_res:
        res = [res[0]] * ws
    ws_w = [w] * ws
    outs = [torch.empty_like(xs[0]) for _ in range(ws)]
    oress = [torch.empty_like(xs[0]) for _ in range(ws)]
    pad = _SignalPad(dev)

    def kern():
        allreduce_rmsnorm(xs, res, ws_w, outs, oress, eps, mode, bf16_norm, 0, pad)

    def plain():
        o, r_ = _allreduce_rmsnorm_ref(xs, res[0], w, eps, mode, bf16_norm)
        for a, b in zip(outs, oress):
            a.copy_(o)
            b.copy_(r_)

    def unfused():
        r_ = torch.stack(xs).sum(0, dtype=torch.float32) + res[0]
        return F.rms_norm(r_, (h,), w, eps).to(torch.bfloat16), r_.to(torch.bfloat16)

    rank_call = _RankCall(xs, res, ws_w, outs, oress, eps, mode, bf16_norm, 0)

    def per_device():  # the per-device form: a launch a rank (checked once), in rank order on one stream
        for r in range(ws):
            rank_call.launch(r)

    want = _allreduce_rmsnorm_ref(xs, res[0], w, eps, mode, bf16_norm)
    for form in (kern, per_device):
        for o in (*outs, *oress):
            o.zero_()
        form()
        torch.cuda.synchronize()
        if not all(torch.equal(o, want[0]) and torch.equal(r_, want[1]) for o, r_ in zip(outs, oress)):
            raise AssertionError(f"allreduce {mode} {ws}x{n}x{h} ({form.__name__}): not bit-equal to the "
                                 "plain version")
    return kern, plain, unfused, per_device


def check_allreduce(dev, _gen):
    """Rows 20 and 21 on virtual ranks of the card: both schedules, both
    epilogues, 2, 4 and 8 ranks, with and without skew, each rank's outputs
    bit-equal to the plain version's and to every other rank's, one launch a
    call; each public entry point driven once with the launch counts read
    around it; then the JAX benchmark's grid at world 8 (:func:`allreduce_case`):
    kernel ms, the bytes bound, the plain version's ms and the unfused
    chain's, and the share of the bound; the one_shot row at slice_full_tp's decode shape takes the
    kernel's device time (torch.profiler), its wall time is the host's.
    Returns (kernels-line rows, {row: launches})."""
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.parallel import (
        fuse_allreduce_rmsnorm,
        fuse_allreduce_rmsnorm_pallas,
        fuse_allreduce_rmsnorm_sharded,
        make_mesh,
    )
    from hpc_ops_tpu_torch.parallel.collective_kernels import (
        _allreduce_rmsnorm_ref,
        allreduce_rmsnorm,
        collective_rmsnorm,
    )
    from hpc_ops_tpu_torch.parallel.mesh import run_ranks

    gen = torch.Generator(device=dev).manual_seed(2024)
    eps = 1e-5
    n, h = ALLREDUCE_CHECK
    checked = 0
    launches = {}
    for ws in ALLREDUCE_WS:
        mesh = make_mesh(tp=ws, devices=[dev] * ws)
        xs, res, w = allreduce_inputs(dev, gen, ws, n, h)
        for mode in ("one_shot", "two_shot"):
            for bf16_norm in (False, True):
                want = _allreduce_rmsnorm_ref(xs, res[0], w, eps, mode, bf16_norm)
                for skew in (0, ALLREDUCE_SKEW):
                    n0 = allreduce_rmsnorm.launches
                    outs = run_ranks(mesh, lambda g, _: collective_rmsnorm(
                        g, xs[g.rank], res[g.rank], w, eps, mode, bf16_norm, skew))[0]
                    torch.cuda.synchronize()
                    if allreduce_rmsnorm.launches != n0 + 1:
                        raise AssertionError(f"allreduce {mode} ws={ws}: {allreduce_rmsnorm.launches - n0} "
                                             "launches for one call")
                    for r, (o, o_res) in enumerate(outs):
                        if not (torch.equal(o, want[0]) and torch.equal(o_res, want[1])):
                            bad = float((o.float() - want[0].float()).abs().max())
                            raise AssertionError(f"allreduce {mode} ws={ws} bf16_norm={bf16_norm} "
                                                 f"skew={skew} rank {r}: not bit-equal to the plain "
                                                 f"version (max err {bad})")
                    checked += 1
        # the public entry points, each once
        for row, mode, call in (
                ("allreduce_rmsnorm_one_shot", "one_shot", lambda g, _: fuse_allreduce_rmsnorm_pallas(
                    xs[g.rank], res[g.rank], w, ws, g, "one_shot", eps)),
                ("allreduce_rmsnorm_two_shot", "two_shot", lambda g, _: fuse_allreduce_rmsnorm(
                    xs[g.rank], res[g.rank], w, eps, g, "two_shot"))):
            kernels.reset_launch_counts()
            outs = run_ranks(mesh, call)[0]
            torch.cuda.synchronize()
            count_drive(launches, kernels.launch_counts(),
                        {**{k: 0 for k in kernels.launch_counts()}, "allreduce_rmsnorm": 1}, row,
                        f"allreduce entry {mode} ws={ws}")
            want = _allreduce_rmsnorm_ref(xs, res[0], w, eps, mode, row.endswith("two_shot"))
            if not all(torch.equal(o, want[0]) and torch.equal(r_, want[1]) for o, r_ in outs):
                raise AssertionError(f"allreduce entry {mode} ws={ws}: not bit-equal to the plain version")
        kernels.reset_launch_counts()
        x_parts = torch.stack(xs)
        out, _ = fuse_allreduce_rmsnorm_sharded(mesh, x_parts, res[0], w, eps, mode="two_shot")
        count_drive(launches, kernels.launch_counts(),
                    {**{k: 0 for k in kernels.launch_counts()}, "allreduce_rmsnorm": 1},
                    "allreduce_rmsnorm_two_shot", f"fuse_allreduce_rmsnorm_sharded ws={ws}")
        if not torch.equal(out, _allreduce_rmsnorm_ref(xs, res[0], w, eps, "two_shot", True)[0]):
            raise AssertionError(f"fuse_allreduce_rmsnorm_sharded ws={ws}: not bit-equal to plain")
        del xs, res, x_parts, outs
    emit("check_allreduce", bit_equal_cases=checked, ranks=ALLREDUCE_WS, tokens=n, hidden=h,
         skew=ALLREDUCE_SKEW)
    per_device_cases = check_allreduce_per_device(dev, gen, launches)

    def timed(mode, ws, n, h):
        kern, plain, unfused, per_device = allreduce_case(dev, gen, mode, ws, n, h, eps)
        big = n * h >= 2048 * 4096
        ms = time_ms(kern, 5 if big else 20)
        plain_ms = time_ms(plain, 3 if big else 10, 1)
        unfused_ms = time_ms(unfused, 3 if big else 10, 1)
        # device time of both forms (torch.profiler): the per-device form's
        # wall time at small shapes is its ws launches' host time
        dev_ms = device_ms(kern, 5 if big else 20)
        rank_ms = device_ms(per_device, 5 if big else 20)
        return ms, plain_ms, unfused_ms, dev_ms, rank_ms, kern, per_device

    g = ALLREDUCE_GRID
    for h in g["hidden"]:
        for n in g["tokens"]:
            for mode in ("one_shot", "two_shot"):
                if mode == "two_shot" and n % (8 * g["world"]):
                    continue
                ms, plain_ms, unfused_ms, dev_ms, rank_ms, _, _ = timed(mode, g["world"], n, h)
                bd, by = bound(allreduce_bytes(g["world"], n, h), 0)
                emit("allreduce", mode=mode, world=g["world"], tokens=n, hidden=h, ms=ms, plain_ms=plain_ms,
                     unfused_ms=unfused_ms, device_ms=dev_ms, per_device_device_ms=rank_ms, bound_ms=bd,
                     bound_by=by, share_of_bound=bd / ms, per_device_share_of_bound=bd / rank_ms)
                torch.cuda.empty_cache()
    rows = []
    for name, (mode, ws, n, h) in ALLREDUCE_ROWS.items():
        wall_ms, plain_ms, unfused_ms, dev_ms, rank_ms, kern, per_device = timed(mode, ws, n, h)
        # the decode collective's wall time is the host's (a launch a call);
        # its row takes the kernel's device time, as the decode rows do
        ms = device_ms(kern, 50) if n <= 64 else wall_ms
        if n <= 64:
            rank_ms = device_ms(per_device, 50)
        rank_wall_ms = time_ms(per_device, 20)
        bd, _ = bound(allreduce_bytes(ws, n, h), n * h * (ws + 6))
        rows.append(kernel_row(name, "hpc_ops_tpu_torch/csrc/collective.cu", ALLREDUCE_REPLACES[mode], 0.0,
                               ms, plain_ms, None, allreduce_bytes(ws, n, h), n * h * (ws + 6),
                               ranks=ws, tokens=n, hidden=h, unfused_ms=unfused_ms, wrapper_ms=wall_ms,
                               share_of_bound=bd / ms))
        # the per-device form (a launch a rank): all ranks' launches a call
        rows.append(kernel_row(name.replace("rmsnorm", "rmsnorm_rank"), "hpc_ops_tpu_torch/csrc/collective.cu",
                               ALLREDUCE_REPLACES[mode], 0.0, rank_ms, plain_ms, None,
                               allreduce_bytes(ws, n, h), n * h * (ws + 6), ranks=ws, tokens=n, hidden=h,
                               launches_per_call=ws, one_launch_ms=ms, one_launch_device_ms=dev_ms,
                               wrapper_ms=rank_wall_ms,
                               share_of_bound=bd / rank_ms, bit_equal_cases=per_device_cases))
    return rows, launches


def check_allreduce_per_device(dev, gen, launches):
    """The per-device form of rows 20 and 21 (a launch a rank on the rank's
    stream, ordered by events) over virtual ranks, forced by the mesh's
    private switch: 2, 4 and 8 ranks, both schedules and epilogues, each
    rank's outputs bit-equal to the plain version's and to the one-launch
    form's, ws launches a call; then at slice_full_tp's decode shape (4 x 8
    x 4096) and a 2048-row two_shot, the same call captured into a CUDA
    graph and replayed (one non-cooperative node a rank), bit-equal. The
    public entry points are driven once each under the switch, their launch
    counts read around them (``launches`` gains the per-device rows).
    Returns the cases checked."""
    import ctypes

    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.parallel import fuse_allreduce_rmsnorm, fuse_allreduce_rmsnorm_pallas, make_mesh
    from hpc_ops_tpu_torch.parallel.collective_kernels import (
        _allreduce_rmsnorm_ref,
        allreduce_rmsnorm_rank,
        collective_rmsnorm,
    )
    from hpc_ops_tpu_torch.parallel.mesh import run_ranks

    eps = 1e-5
    n, h = ALLREDUCE_CHECK
    checked = 0

    def forced(ws):
        mesh = make_mesh(tp=ws, devices=[dev] * ws)
        mesh._per_device = True
        return mesh

    def run(mesh, xs, res, w, mode, bf16_norm):
        return run_ranks(mesh, lambda g, _: collective_rmsnorm(g, xs[g.rank], res[g.rank], w, eps, mode,
                                                               bf16_norm))[0]

    def same(outs, want):
        return all(torch.equal(o, want[0]) and torch.equal(r_, want[1]) for o, r_ in outs)

    for ws in ALLREDUCE_WS:
        mesh, one = forced(ws), make_mesh(tp=ws, devices=[dev] * ws)
        xs, res, w = allreduce_inputs(dev, gen, ws, n, h)
        for mode in ("one_shot", "two_shot"):
            for bf16_norm in (False, True):
                want = _allreduce_rmsnorm_ref(xs, res[0], w, eps, mode, bf16_norm)
                r0 = allreduce_rmsnorm_rank.launches
                outs = run(mesh, xs, res, w, mode, bf16_norm)
                ref = run(one, xs, res, w, mode, bf16_norm)
                torch.cuda.synchronize()
                if allreduce_rmsnorm_rank.launches != r0 + ws:
                    raise AssertionError(f"per-device allreduce {mode} ws={ws}: "
                                         f"{allreduce_rmsnorm_rank.launches - r0} launches for one call")
                if not same(outs, want) or not same(outs, (ref[0][0], ref[0][1])):
                    raise AssertionError(f"per-device allreduce {mode} ws={ws} bf16_norm={bf16_norm}: not "
                                         "bit-equal to the plain version and the one-launch form")
                checked += 1
        for row, mode, call in (
                ("allreduce_rmsnorm_rank_one_shot", "one_shot", lambda g, _: fuse_allreduce_rmsnorm_pallas(
                    xs[g.rank], res[g.rank], w, ws, g, "one_shot", eps)),
                ("allreduce_rmsnorm_rank_two_shot", "two_shot", lambda g, _: fuse_allreduce_rmsnorm(
                    xs[g.rank], res[g.rank], w, eps, g, "two_shot"))):
            kernels.reset_launch_counts()
            outs = run_ranks(mesh, call)[0]
            torch.cuda.synchronize()
            count_drive(launches, kernels.launch_counts(),
                        {**{k: 0 for k in kernels.launch_counts()}, "allreduce_rmsnorm_rank": ws}, row,
                        f"per-device allreduce entry {mode} ws={ws}")
            launches[row] += ws - 1  # the row counts kernel launches: ws a call
            if not same(outs, _allreduce_rmsnorm_ref(xs, res[0], w, eps, mode, row.endswith("two_shot"))):
                raise AssertionError(f"per-device allreduce entry {mode} ws={ws}: not bit-equal to plain")
        del xs, res, outs
    for mode, ws, rows_, hid in (ALLREDUCE_ROWS["allreduce_rmsnorm_one_shot"],
                                 ALLREDUCE_ROWS["allreduce_rmsnorm_two_shot"]):
        mesh = forced(ws)
        xs, res, w = allreduce_inputs(dev, gen, ws, rows_, hid)
        want = _allreduce_rmsnorm_ref(xs, res[0], w, eps, mode, False)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run(mesh, xs, res, w, mode, False)  # the eager run before the capture
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="global"):
            outs = run(mesh, xs, res, w, mode, False)
        counts = (ctypes.c_int * 7)()
        kernels.check(kernels.lib().hpc_graph_node_counts(graph.raw_cuda_graph(), counts), "node counts")
        graph.instantiate()
        for o, r_ in outs:
            o.zero_()
            r_.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if counts[6] != ws or counts[1] or not same(outs, want):
            raise AssertionError(f"per-device allreduce {mode} {ws}x{rows_}x{hid} replayed: node counts "
                                 f"{list(counts)}, bit-equal {same(outs, want)}")
        checked += 1
        del graph, outs, xs, res
    emit("check_allreduce_per_device", bit_equal_cases=checked, ranks=ALLREDUCE_WS, tokens=n, hidden=h,
         captured=[ALLREDUCE_ROWS[k] for k in ALLREDUCE_ROWS])
    return checked


MOE_SHAPES = {"decode": 8, "prefill_200": 200, "prefill_512": 512, "prefill_2048": 2048}
FP8_STD = 80.0  # standard deviation of the seeded e4m3 test tensors
I8_STD = 30.0  # standard deviation of the seeded int8 test codes
I8_ACT_SCALE = 127.0 / 8.0  # int8 activation scale of MoEConfig's act_clip 8
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8
GEMM_RTOL = 2.0**-7  # one bf16 step; plus 1e-3 of the largest output for the summation order


def moe_check_inputs(dev, gen):
    """Seeded expert weights at Mixtral width and, per shape, tokens, routing
    and the tile-aligned layout the MoE gives its kernels."""
    import torch

    from hpc_ops_tpu_torch.ops.group_gemm import _pick_tm
    from hpc_ops_tpu_torch.ops.moe import _route_aligned, interleave_gate_up

    from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast

    dgen = torch.Generator(device=dev).manual_seed(int(torch.randint(0, 2**31, (1,), generator=gen)))

    def rand_fp8(shape):
        # a per-tensor-scaled tensor: its largest entries sit at the e4m3 bound of 448
        return fp8_saturate_cast(torch.randn(shape, generator=dgen, device=dev).mul_(FP8_STD))

    def rand_i8(shape):
        # int8 codes of a Gaussian, the tails clipped at the int8 bound
        return torch.randn(shape, generator=dgen, device=dev).mul_(I8_STD).round_().clamp_(
            -127, 127).to(torch.int8)

    # scales that bring gate, up and the MoE output near 1
    inp = {"gw": rand_fp8((MOE_E, 2 * MOE_I, MOE_H)), "dw": rand_fp8((MOE_E, MOE_H, MOE_I)),
           "gs": (torch.rand(MOE_E, generator=dgen, device=dev) + 1.0) / (FP8_STD**2 * MOE_H**0.5),
           "ds": (torch.rand(MOE_E, generator=dgen, device=dev) + 1.0) / (FP8_STD**2 * MOE_I**0.5),
           "act": torch.full((1,), FP8_STD, device=dev),
           # int8 experts; the down scale undoes the activation's int8 scale
           "gw8": rand_i8((MOE_E, 2 * MOE_I, MOE_H)), "dw8": rand_i8((MOE_E, MOE_H, MOE_I)),
           "gs8": (torch.rand(MOE_E, generator=dgen, device=dev) + 1.0) / (I8_STD**2 * MOE_H**0.5),
           "ds8": (torch.rand(MOE_E, generator=dgen, device=dev) + 1.0)
           / (I8_STD * I8_ACT_SCALE * MOE_I**0.5),
           "act8": torch.full((1,), I8_ACT_SCALE, device=dev)}
    inp["gw8_il"] = interleave_gate_up(inp["gw8"])
    for name, s in MOE_SHAPES.items():
        logits = torch.randn((s, MOE_E), generator=dgen, device=dev)
        scale, ids = torch.topk(logits, MOE_K, dim=-1)
        tm = _pick_tm(max(s * MOE_K // MOE_E, 1), MOE_H)
        row_idx, topk_pos, seqlens, _, _, cu_tiles, grp = _route_aligned(ids.to(torch.int32), MOE_E, 0, tm)
        inp[name] = dict(
            s=s, tm=tm, x=rand_fp8((s, MOE_H)), x8=rand_i8((s, MOE_H)), ids=ids.to(torch.int32),
            ts=torch.softmax(scale, dim=-1), row_idx=row_idx, topk_pos=topk_pos, grp=grp,
            nvt=cu_tiles[-1:], seqlens=[int(n) for n in seqlens.cpu()],
            row_blk=torch.where(torch.arange(grp.shape[0], device=dev) < cu_tiles[-1], torch.arange(
                grp.shape[0], device=dev), grp.shape[0]).to(torch.int32),
            ident=torch.arange(row_idx.shape[0], dtype=torch.int32, device=dev),
        )
    return inp


def gemm_close(got, want, valid, what):
    import torch

    got, want = got[valid].float(), want[valid].float()
    tol = 1e-3 * float(want.abs().max()) + GEMM_RTOL * want.abs()
    err = (got - want).abs()
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{what}: kernel disagrees with the plain version "
                             f"(max abs err {float(err.max())}, outputs up to {float(want.abs().max())})")
    return float(err.max())


def gg_rate(ms, bound_ms, ops, i8, tm, kind):
    """A grouped-GEMM shape line's rate (``tops`` over int8 operands, else
    ``tflops``), its share of the bound (bound / ms) and the body that ran:
    ``kind`` as :func:`gg_form` takes it ("int8", "e4m3": the e4m3
    per-tensor forms, "blockwise"), m-tiles of ``tm`` slots."""
    from hpc_ops_tpu_torch.ops.group_gemm import GG_MMA_SYNC, GG_RS, gg_form

    wg = gg_form(tm, kind)
    body = {GG_MMA_SYNC: "mma.sync over fp16 values of e4m3, 32-row blocks",
            GG_RS: "wgmma, fp16 weights from registers by 256 slots of fp16 rows, 128 weight rows a block"
            }.get(wg, f"wgmma over 8-bit operands, {64 * wg}-row blocks")
    return {"tops" if i8 else "tflops": 1e-9 * ops / ms, "share_of_bound": bound_ms / ms, "body": body}


def padded_rows(m):
    """Rows of an fp8 library yardstick's operand for m real rows: a multiple
    of 16, as cuBLASLt's fp8 product takes them, and at least 64, the fewest
    it has run with on the H100; beside an expert's weight the padding is a
    sliver of the bytes."""
    return max(-(-m // 16) * 16, 64)


def library_ms(make_loop, *args):
    """(ms, None) for the library loop ``make_loop(*args)``, or (None, the
    library's error) where cuBLASLt refuses the product: a yardstick, not a
    check, so its refusal is reported in the line and stops nothing."""
    try:
        return time_ms(make_loop(*args), 5), None
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0][:240]


def scaled_mm_probe(dev):
    """Whether this torch's ``torch._scaled_mm`` runs with per-tensor scales
    on this card, tried on 64 e4m3 rows of Mixtral's gate-up width (N 28672,
    K 4096) and on 256 x 256 x 256, each against the dequantised product.
    Returns {shape: "agrees", or what went wrong}."""
    import torch

    g = torch.Generator(device=dev).manual_seed(80)
    tried = {}
    for m, n, k in ((64, 2 * MOE_I, MOE_H), (256, 256, 256)):
        a = torch.randn((m, k), generator=g, device=dev).mul_(FP8_STD).clamp_(-448, 448).to(
            torch.float8_e4m3fn)
        b = torch.randn((n, k), generator=g, device=dev).mul_(FP8_STD).clamp_(-448, 448).to(
            torch.float8_e4m3fn)
        sa, sb = torch.tensor(0.5, device=dev), torch.tensor(0.25, device=dev)
        try:
            got = torch._scaled_mm(a, b.t(), sa, sb, out_dtype=torch.bfloat16).float()
            torch.cuda.synchronize()
        except RuntimeError as e:
            tried[f"{m}x{n}x{k}"] = str(e).strip().splitlines()[0][:240]
            continue
        want = (a.float() @ b.float().T) * 0.125
        err = float((got - want).abs().max())
        tried[f"{m}x{n}x{k}"] = ("agrees" if err <= 1e-2 * float(want.abs().max())
                                 else f"ran, but {err} from the dequantised product")
    return tried


def scaled_mm_loop(k, w, y_scale, seqlens, dev):
    """The fp8-rate library yardstick of a per-tensor e4m3 grouped GEMM: one
    ``torch._scaled_mm`` per hit expert over e4m3 rows (padded_rows),
    ``w[e].T`` column-major, the expert's scale (a tensor of its own: a view
    into ``y_scale`` made cuBLASLt answer CUBLAS_STATUS_NOT_SUPPORTED on the
    H100) and a unit one, bf16 out, full-precision accumulation (the
    counterpart of the kernel's promotion). Returns the call list; the port
    never calls it."""
    import torch

    one = torch.ones((), device=dev)
    scales = [y_scale[i].reshape(()).clone() for i in range(len(seqlens))]
    xs = [torch.randn((padded_rows(m), k), device=dev).mul_(FP8_STD).clamp_(-448, 448).to(
        torch.float8_e4m3fn) for m in seqlens]
    return lambda: [torch._scaled_mm(xe, w[i].t(), one, scales[i], out_dtype=torch.bfloat16)
                    for i, xe in enumerate(xs) if seqlens[i]]


BLOCK_SCALE_LAYOUTS = {  # name -> (A's [m, k/128] scales, B's [n/128, k/128]) as _scaled_mm takes them
    "sa [m, k/128] outer-dim-major, sb [n/128, k/128]": lambda sa, sb: (sa.t().contiguous().t(), sb),
    "sa [m, k/128] outer-dim-major, sb [k/128, n/128]": lambda sa, sb: (sa.t().contiguous().t(), sb.t()),
    "sa [m, k/128] row-major, sb [n/128, k/128]": lambda sa, sb: (sa, sb),
}


def blockwise_scaled_mm(dev):
    """Whether this torch's ``torch._scaled_mm`` takes 1x128 scales for the
    rows of A and 128x128 ones for B on this card, tried on a 256 x 256 x
    256 e4m3 product in the scale layouts of BLOCK_SCALE_LAYOUTS and held
    against the dequantised product. Returns (the name of the layout that
    worked or None, the error of each layout tried)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(79)
    m = n = k = 256
    a = torch.randn((m, k), generator=g, device=dev).mul_(FP8_STD).clamp_(-448, 448).to(torch.float8_e4m3fn)
    b = torch.randn((n, k), generator=g, device=dev).mul_(FP8_STD).clamp_(-448, 448).to(torch.float8_e4m3fn)
    sa = torch.rand((m, k // 128), generator=g, device=dev) + 0.5
    sb = torch.rand((n // 128, k // 128), generator=g, device=dev) + 0.5
    want = ((a.float() * sa.repeat_interleave(128, 1))
            @ (b.float() * sb.repeat_interleave(128, 0).repeat_interleave(128, 1)).T)
    errors = {}
    for name, layout in BLOCK_SCALE_LAYOUTS.items():
        try:
            got = torch._scaled_mm(a, b.t(), *layout(sa, sb), out_dtype=torch.bfloat16).float()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError, TypeError, NotImplementedError) as e:
            errors[name] = str(e).strip().splitlines()[0][:200] if str(e).strip() else type(e).__name__
            continue
        err = float((got - want).abs().max())
        if err <= 1e-2 * float(want.abs().max()):
            return name, errors
        errors[name] = f"ran, but {err} from the dequantised product"
    return None, errors


def blockwise_scaled_mm_loop(layout, k, w, sw, seqlens, dev):
    """One ``torch._scaled_mm`` per hit expert with 1x128 row scales and the
    expert's 128x128 block scales in BLOCK_SCALE_LAYOUTS[layout], e4m3 rows
    padded to a multiple of 16, bf16 out; the port never calls it."""
    import torch

    kb = k // 128
    xs, scales = [], []
    for i, m in enumerate(seqlens):
        rows = padded_rows(m)
        xs.append(torch.randn((rows, k), device=dev).mul_(FP8_STD).clamp_(-448, 448).to(torch.float8_e4m3fn))
        scales.append(BLOCK_SCALE_LAYOUTS[layout](torch.rand((rows, kb), device=dev) + 0.5,
                                                  sw[i, :, :kb].contiguous()))
    return lambda: [torch._scaled_mm(xe, w[i].t(), *scales[i], out_dtype=torch.bfloat16)
                    for i, xe in enumerate(xs) if seqlens[i]]


def check_gg_scatter(dev, inp):
    import torch

    from hpc_ops_tpu_torch.ops.group_gemm import gg_scatter, gg_scatter_ref
    from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast

    detail, err = {}, 0.0
    emit("scaled_mm_probe", tried=scaled_mm_probe(dev), torch=torch.__version__, cuda=torch.version.cuda)
    for shape in MOE_SHAPES:
        c = inp[shape]
        pairs, tm = c["s"] * MOE_K, c["tm"]
        experts_hit = sum(1 for n in c["seqlens"] if n)
        valid = c["row_idx"] >= 0
        # the down GEMM's input: e4m3 activations in the aligned layout
        act = fp8_saturate_cast(torch.randn((c["row_idx"].shape[0], MOE_I), device=dev) * FP8_STD)
        for gemm, x, w, sc, rows, (n, k) in (
            ("gate_up", c["x"], inp["gw"], inp["gs"], c["row_idx"], (2 * MOE_I, MOE_H)),
            ("down", act, inp["dw"], inp["ds"], c["ident"], (MOE_H, MOE_I)),
        ):
            args = (x, w, sc, rows, c["grp"], tm, c["nvt"])
            got = gg_scatter(*args)
            want = gg_scatter_ref(*args)
            torch.cuda.synchronize()
            e = gemm_close(got, want, valid, f"gg_scatter {shape} {gemm}")
            del got, want
            ms = time_ms(lambda: gg_scatter(*args), 20 if shape == "decode" else 5)
            plain = time_ms(lambda: gg_scatter_ref(*args), 2, 1)
            # "library": one torch.matmul per expert on operands decoded to bf16
            # beforehand (a loop of E calls; the port never calls it)
            w16 = w.to(torch.bfloat16)
            xs = [torch.randn((max(m, 1), k), device=dev).to(torch.bfloat16) for m in c["seqlens"]]
            lib = time_ms(lambda: [xe @ w16[i].T for i, xe in enumerate(xs) if c["seqlens"][i]], 5)
            del w16, xs
            lib_fp8, lib_fp8_error = library_ms(scaled_mm_loop, k, w, sc, c["seqlens"], dev)
            # each token row and each hit expert's weight read once, each real output row written once
            nbytes = c["s"] * k + experts_hit * n * k + pairs * n * 2 + rows.numel() * 4 + c["grp"].numel() * 4
            # both operands are e4m3: the card's fp8 rate
            bd, by = bound(nbytes, 2.0 * pairs * n * k, FP8_FLOPS_PER_S)
            detail[f"{shape}_{gemm}"] = dict(ms=ms, plain_ms=plain, library_loop_ms=lib,
                                             library_scaled_mm_ms=lib_fp8,
                                             library_scaled_mm_error=lib_fp8_error, bound_ms=bd,
                                             bound_by=by, max_abs_err=e, tm=tm, n=n, k=k, pairs=pairs,
                                             experts_hit=experts_hit, gbytes_per_s=nbytes / ms * 1e-6,
                                             **gg_rate(ms, bd, 2.0 * pairs * n * k, False, tm, "e4m3"))
            err = max(err, e)
        del act
    torch.cuda.empty_cache()
    main = detail["decode_gate_up"]  # the call the serving path makes most often
    emit("kernel", name="gg_scatter", max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
         library_ms=main["library_loop_ms"], library_is="a loop of one torch.matmul per expert",
         library_scaled_mm_ms=main["library_scaled_mm_ms"],
         library_scaled_mm_is="a loop of one torch._scaled_mm per expert (e4m3, per-tensor scales)",
         bound_ms=main["bound_ms"], bound_by=main["bound_by"], shapes=detail)
    return dict(name="gg_scatter", source="hpc_ops_tpu_torch/csrc/group_gemm.cu",
                replaces="hpc_ops_tpu/ops/group_gemm.py:891", max_abs_err=err, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_loop_ms"], library_scaled_mm_ms=main["library_scaled_mm_ms"])


def e4m3_ordinals(codes):
    import torch

    b = codes.view(torch.uint8).int()
    return torch.where(b >= 128, -(b & 0x7F), b & 0x7F)


def act_bytes(valid_rows):
    """Bytes of the activation + quantisation over ``valid_rows`` rows: the
    bf16 gate|up row read, the codes written, the scale and the count."""
    return valid_rows * (2 * MOE_I * 2 + MOE_I) + 8


def check_act_quant(dev, inp):
    """The activation + quantisation at every MOE_SHAPES entry: codes at most
    one step from the plain version's on at most 0.1% of them; wall ms,
    torch.profiler's device ms and its share of the bytes bound per shape."""
    import torch

    from hpc_ops_tpu_torch.ops.activation import act_quant, act_quant_ref

    fp8 = torch.float8_e4m3fn
    detail, worst, share = {}, 0, 0.0
    for shape in MOE_SHAPES:
        c = inp[shape]
        rows = c["row_idx"].shape[0]
        gate_up = (torch.randn((rows, 2 * MOE_I), device=dev) * 2).to(torch.bfloat16)
        nv = c["nvt"] * c["tm"]
        got = act_quant(gate_up, inp["act"], True, fp8, nv)
        want = act_quant_ref(gate_up, inp["act"], True, fp8, nv)
        torch.cuda.synchronize()
        n_valid = int(nv)
        d = (e4m3_ordinals(got[:n_valid]) - e4m3_ordinals(want[:n_valid])).abs()
        worst, share = max(worst, int(d.max())), max(share, float((d > 0).float().mean()))
        value_err = float((got[:n_valid].float() - want[:n_valid].float()).abs().max())
        del got, want, d
        ms = time_ms(lambda: act_quant(gate_up, inp["act"], True, fp8, nv), 20)
        dev_ms = device_ms(lambda: act_quant(gate_up, inp["act"], True, fp8, nv), 20)
        plain = time_ms(lambda: act_quant_ref(gate_up, inp["act"], True, fp8, nv), 3, 1)
        bd, by = bound(act_bytes(n_valid), n_valid * MOE_I * 12.0)
        detail[shape] = dict(ms=ms, device_ms=dev_ms, share_of_bound=bd / dev_ms, plain_ms=plain,
                             bound_ms=bd, bound_by=by, rows=rows, valid_rows=n_valid, max_abs_err=value_err)
        del gate_up
    if worst > 1 or share > 1e-3:
        raise AssertionError(f"act_quant: codes {worst} apart on {share:.4%} (limits 1 and 0.1%)")
    torch.cuda.empty_cache()
    main = detail["decode"]
    err = max(v["max_abs_err"] for v in detail.values())
    emit("kernel", name="act_quant", code_max_diff=worst, code_diff_share=share, max_abs_err=err,
         ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None, bound_ms=main["bound_ms"],
         bound_by=main["bound_by"], device_ms=main["device_ms"], shapes=detail)
    return dict(name="act_quant", source="hpc_ops_tpu_torch/csrc/activation.cu",
                replaces="hpc_ops_tpu/ops/activation.py:86", max_abs_err=err, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None)


def check_moe_reduce(dev, inp):
    """The top-k reduce at every MOE_SHAPES token count, with and without a
    shared expert, every garbage row NaN: bit-equal to the plain version, no
    NaN in the output. Timed per shape without a shared expert: wall ms over
    back-to-back calls, torch.profiler's device ms and its share of the bytes
    bound; at the decode shape also the wrapper's host microseconds a call."""
    import torch

    from hpc_ops_tpu_torch.ops.moe import moe_reduce, moe_reduce_ref, reduce_form

    detail, err = {}, 0.0
    for shape in MOE_SHAPES:
        c = inp[shape]
        x = torch.randn((c["row_idx"].shape[0], MOE_H), device=dev).to(torch.bfloat16)
        x[c["row_idx"] < 0] = float("nan")  # garbage rows: no valid slot points at them
        shared = torch.randn((c["s"], MOE_H), device=dev).to(torch.bfloat16)
        for sh in (None, shared):
            got = moe_reduce(x, c["topk_pos"], c["ts"], sh)
            want = moe_reduce_ref(x, c["topk_pos"], c["ts"], sh)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"moe_reduce {shape}: NaN of a garbage row reached the output")
            err = max(err, float((got.float() - want.float()).abs().max()))
        call = lambda: moe_reduce(x, c["topk_pos"], c["ts"])  # noqa: E731
        ms = time_ms(call, 50)
        plain = time_ms(lambda: moe_reduce_ref(x, c["topk_pos"], c["ts"]), 5)
        dev_ms = device_ms(call, 50)
        pairs = c["s"] * MOE_K
        bd, by = bound(pairs * MOE_H * 2 + c["s"] * MOE_H * 2 + pairs * 8, 2.0 * pairs * MOE_H)
        detail[shape] = dict(ms=ms, plain_ms=plain, bound_ms=bd, bound_by=by, tokens=c["s"],
                             device_ms=dev_ms, share_of_bound=bd / dev_ms,
                             form=reduce_form(c["s"], MOE_H)._asdict())
        if shape == "decode":
            detail[shape]["host_us"] = host_us(call)
    if err != 0.0:
        raise AssertionError(f"moe_reduce: {err} from the plain version (limit 0: the same "
                             "float32 operations in the same order)")
    main = detail["decode"]
    emit("kernel", name="moe_reduce", max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
         library_ms=None, bound_ms=main["bound_ms"], bound_by=main["bound_by"],
         device_ms=main["device_ms"], host_us=main["host_us"], shapes=detail)
    return dict(name="moe_reduce", source="hpc_ops_tpu_torch/csrc/moe.cu",
                replaces="hpc_ops_tpu/ops/moe.py:212", max_abs_err=err, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, device_ms=main["device_ms"], host_us=main["host_us"])


def check_moe_pipeline(dev, inp):
    """The three kernels chained as the MoE chains them, at the decode shape
    and at a prefill one (512 tokens: m-tiles of 160), with every garbage row
    (empty slot, tile past the valid count) filled with NaN after each GEMM;
    then the whole MoE under sync debug mode."""
    import torch

    from hpc_ops_tpu_torch.ops.activation import act_quant, act_quant_ref
    from hpc_ops_tpu_torch.ops.group_gemm import gg_scatter, gg_scatter_ref
    from hpc_ops_tpu_torch.ops.moe import fuse_moe_pertensor_fp8, moe_reduce, moe_reduce_ref

    for shape in ("decode", "prefill_512"):
        c = inp[shape]
        garbage = (c["row_idx"] < 0)[:, None]
        nan = float("nan")
        outs = {}
        for name, gemm, act, red in (("kernel", gg_scatter, act_quant, moe_reduce),
                                     ("plain", gg_scatter_ref, act_quant_ref, moe_reduce_ref)):
            gate_up = gemm(c["x"], inp["gw"], inp["gs"], c["row_idx"], c["grp"], c["tm"], c["nvt"])
            gate_up = torch.where(garbage, nan, gate_up.float()).to(torch.bfloat16)
            down_in = act(gate_up, inp["act"], True, torch.float8_e4m3fn, c["nvt"] * c["tm"])
            down = gemm(down_in, inp["dw"], inp["ds"], c["ident"], c["grp"], c["tm"], c["nvt"])
            down = torch.where(garbage, nan, down.float()).to(torch.bfloat16)
            outs[name] = red(down, c["topk_pos"], c["ts"]).float()
        torch.cuda.synchronize()
        k, p = outs["kernel"], outs["plain"]
        tol = 2e-2 * float(p.abs().max())
        if not torch.isfinite(k).all() or not torch.allclose(k, p, atol=tol, rtol=2e-2):
            raise AssertionError(f"moe_pipeline {shape}: NaN garbage rows leaked, or kernels and plain "
                                 f"versions disagree (max err {float((k - p).abs().max())}, limit {tol} "
                                 "+ 2%)")
        args = (c["x"], inp["gw"], inp["dw"], inp["gs"], inp["ds"], inp["act"], c["ids"], c["ts"], 0,
                MOE_E)
        whole = fuse_moe_pertensor_fp8(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a device-to-host copy of a count would raise
        try:
            again = fuse_moe_pertensor_fp8(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if not torch.equal(whole, again) or not torch.allclose(whole.float(), p, atol=tol, rtol=2e-2):
            raise AssertionError(f"moe_pipeline {shape}: fuse_moe_pertensor_fp8 disagrees with the "
                                 "chained stages")
        ms = time_ms(lambda: fuse_moe_pertensor_fp8(*args), 20 if shape == "decode" else 5)
        emit("moe_pipeline", shape=shape, tm=c["tm"], garbage_rows=int(garbage.sum()),
             output_max=float(p.abs().max()), max_abs_err=float((k - p).abs().max()),
             sync_debug_mode_raised=False, fuse_moe_ms=ms)


# ----------------------------------------------------------- int8 MoE kernels
def int_mm_loop(x8_rows, w8, seqlens, dev):
    """The library yardstick of an int8 grouped GEMM: one ``torch._int_mm`` per
    hit expert on the column-major view of its weight (the layout the library
    streams), rows padded past 16 as ``_int8_matmul`` pads them. Returns the
    call list; the port never calls it."""
    import torch

    xs = [torch.randint(-127, 128, (max(-(-m // 8) * 8, 32), x8_rows), device=dev, dtype=torch.int8)
          for m in seqlens]
    return lambda: [torch._int_mm(xe, w8[i].t()) for i, xe in enumerate(xs) if seqlens[i]]


def gemm_bytes(c, n, k, out_bytes):
    """Bytes a scatter grouped GEMM of this shape must move: each token row and
    each hit expert's weight read once, each real output row written once,
    the index vectors."""
    experts_hit = sum(1 for m in c["seqlens"] if m)
    return (c["s"] * k + experts_hit * n * k + c["s"] * MOE_K * n * out_bytes
            + c["row_idx"].numel() * 4 + c["grp"].numel() * 4)


def check_gg_scatter_i8(dev, inp):
    """Row 15 over int8 operands: gate-up and down at every MoE shape, bit-equal
    to the plain version on every real slot (both sum int8 products exactly)."""
    import torch

    from hpc_ops_tpu_torch.ops.group_gemm import gg_scatter, gg_scatter_ref

    detail = {}
    for shape in MOE_SHAPES:
        c = inp[shape]
        pairs, tm = c["s"] * MOE_K, c["tm"]
        valid = c["row_idx"] >= 0
        act = torch.randn((c["row_idx"].shape[0], MOE_I), device=dev).mul_(I8_STD).round_().clamp_(
            -127, 127).to(torch.int8)
        for gemm, x, w, sc, rows, (n, k) in (
            ("gate_up", c["x8"], inp["gw8"], inp["gs8"], c["row_idx"], (2 * MOE_I, MOE_H)),
            ("down", act, inp["dw8"], inp["ds8"], c["ident"], (MOE_H, MOE_I)),
        ):
            args = (x, w, sc, rows, c["grp"], tm, c["nvt"])
            got, want = gg_scatter(*args), gg_scatter_ref(*args)
            torch.cuda.synchronize()
            if not torch.equal(got[valid], want[valid]):
                raise AssertionError(f"gg_scatter_i8 {shape} {gemm}: kernel differs from the plain "
                                     "version (limit: bit-equal)")
            del got, want
            ms = time_ms(lambda: gg_scatter(*args), 20 if shape == "decode" else 5)
            plain = time_ms(lambda: gg_scatter_ref(*args), 2, 1)
            lib = time_ms(int_mm_loop(k, w, c["seqlens"], dev), 5)
            nbytes = gemm_bytes(c, n, k, 2)
            bd, by = bound(nbytes, 2.0 * pairs * n * k, INT8_OPS_PER_S)
            detail[f"{shape}_{gemm}"] = dict(ms=ms, plain_ms=plain, library_loop_ms=lib, bound_ms=bd,
                                             bound_by=by, tm=tm, n=n, k=k, pairs=pairs,
                                             gbytes_per_s=nbytes / ms * 1e-6,
                                             **gg_rate(ms, bd, 2.0 * pairs * n * k, True, tm, "int8"))
        del act
    torch.cuda.empty_cache()
    main = detail["decode_gate_up"]
    emit("kernel", name="gg_scatter_i8", max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
         library_ms=main["library_loop_ms"], library_is="a loop of one torch._int_mm per expert",
         bound_ms=main["bound_ms"], bound_by=main["bound_by"], shapes=detail)
    return dict(name="gg_scatter_i8", source="hpc_ops_tpu_torch/csrc/group_gemm.cu",
                replaces="hpc_ops_tpu/ops/group_gemm.py:891", max_abs_err=0.0, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_loop_ms"])


def check_gg_scatter_i8_act(dev, inp):
    """Row 15's act_fuse epilogue: the gate-up GEMM over the interleaved int8
    weight writing the activation's int8 codes, every code of a real slot
    equal to the plain version's; timed beside the unfused pair it replaces
    (the int8 gate-up GEMM, then the activation kernel)."""
    import torch

    from hpc_ops_tpu_torch.ops.activation import act_quant
    from hpc_ops_tpu_torch.ops.group_gemm import gg_scatter, gg_scatter_ref

    detail, sat, codes_n = {}, 0, 0
    n, k = 2 * MOE_I, MOE_H
    for shape in MOE_SHAPES:
        c = inp[shape]
        pairs, tm, nt = c["s"] * MOE_K, c["tm"], c["grp"].shape[0]
        valid = c["row_idx"] >= 0
        args = (c["x8"], inp["gw8_il"], inp["gs8"], c["row_idx"], c["grp"], tm, c["nvt"])
        kw = dict(act_fuse=True, act_scale=inp["act8"])
        got, want = gg_scatter(*args, **kw), gg_scatter_ref(*args, **kw)
        torch.cuda.synchronize()
        g, wnt = got[: nt * tm][valid], want[: nt * tm][valid]
        if not torch.equal(g, wnt):
            d = (g.int() - wnt.int()).abs()
            raise AssertionError(f"gg_scatter_i8_act {shape}: codes differ from the plain version on "
                                 f"{float((d > 0).float().mean()):.4%}, by up to {int(d.max())} "
                                 "(limit: equal)")
        sat += int((wnt.abs() == 127).sum())
        codes_n += wnt.numel()
        del got, want, g, wnt
        ms = time_ms(lambda: gg_scatter(*args, **kw), 20 if shape == "decode" else 5)
        plain_args = (c["x8"], inp["gw8"], inp["gs8"], c["row_idx"], c["grp"], tm, c["nvt"])
        unfused = time_ms(lambda: act_quant(gg_scatter(*plain_args), inp["act8"], True, torch.int8,
                                            c["nvt"] * tm), 20 if shape == "decode" else 5)
        plain = time_ms(lambda: gg_scatter_ref(*args, **kw), 2, 1)
        lib = time_ms(int_mm_loop(k, inp["gw8"], c["seqlens"], dev), 5)
        nbytes = gemm_bytes(c, n, k, 0.5) + 4  # an int8 code per pair of accumulators
        bd, by = bound(nbytes, 2.0 * pairs * n * k, INT8_OPS_PER_S)
        detail[shape] = dict(ms=ms, unfused_pair_ms=unfused, plain_ms=plain, library_loop_ms=lib,
                             bound_ms=bd, bound_by=by, tm=tm, pairs=pairs,
                             **gg_rate(ms, bd, 2.0 * pairs * n * k, True, tm, "int8"))
    torch.cuda.empty_cache()
    main = detail["decode"]
    emit("kernel", name="gg_scatter_i8_act", max_abs_err=0.0, code_max_diff=0,
         saturated_share=sat / max(codes_n, 1), ms=main["ms"], unfused_pair_ms=main["unfused_pair_ms"],
         plain_ms=main["plain_ms"], library_ms=main["library_loop_ms"],
         library_is="a loop of one torch._int_mm per expert (the GEMM alone)",
         bound_ms=main["bound_ms"], bound_by=main["bound_by"], shapes=detail)
    return dict(name="gg_scatter_i8_act", source="hpc_ops_tpu_torch/csrc/group_gemm.cu",
                replaces="hpc_ops_tpu/ops/group_gemm.py:891", max_abs_err=0.0, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_loop_ms"])


def check_gg_pertensor(dev, inp):
    """Row 11, int8 and e4m3: gate-up over the tokens copied into the aligned
    layout, down over aligned activation codes, at every MoE shape; every row
    of a valid tile against the plain version (int8 bit-equal, e4m3 within
    the grouped GEMM's tolerance). Rows: int8 (the down GEMM of the int8
    serving path) and e4m3 (both GEMMs of impl="gather")."""
    import torch

    from hpc_ops_tpu_torch.ops.group_gemm import gg_pertensor, gg_pertensor_ref
    from hpc_ops_tpu_torch.ops.moe import _gather_aligned
    from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast

    rows_out = []
    for dtype in ("int8", "e4m3"):
        i8 = dtype == "int8"
        gw, dw = (inp["gw8"], inp["dw8"]) if i8 else (inp["gw"], inp["dw"])
        gs, ds = (inp["gs8"], inp["ds8"]) if i8 else (inp["gs"], inp["ds"])
        detail, err = {}, 0.0
        for shape in MOE_SHAPES:
            c = inp[shape]
            pairs, tm = c["s"] * MOE_K, c["tm"]
            ga = _gather_aligned(c["x8"] if i8 else c["x"], c["ids"], MOE_E, 0, tm)
            rows = ga.x_gathered.shape[0]
            act = torch.randn((rows, MOE_I), device=dev) * (I8_STD if i8 else FP8_STD)
            act = act.round_().clamp_(-127, 127).to(torch.int8) if i8 else fp8_saturate_cast(act)
            n_valid = int(c["nvt"]) * tm
            for gemm, x_al, w, sc, (n, k) in (("gate_up", ga.x_gathered, gw, gs, (2 * MOE_I, MOE_H)),
                                             ("down", act, dw, ds, (MOE_H, MOE_I))):
                args = (x_al, w, sc, ga.grp, ga.row_blk, tm, c["nvt"])
                got, want = gg_pertensor(*args)[:n_valid], gg_pertensor_ref(*args)[:n_valid]
                torch.cuda.synchronize()
                if i8:
                    if not torch.equal(got, want):
                        raise AssertionError(f"gg_pertensor int8 {shape} {gemm}: kernel differs from "
                                             "the plain version (limit: bit-equal)")
                else:
                    err = max(err, gemm_close(got, want, slice(None), f"gg_pertensor e4m3 {shape} {gemm}"))
                del got, want
                ms = time_ms(lambda: gg_pertensor(*args), 20 if shape == "decode" else 5)
                plain = time_ms(lambda: gg_pertensor_ref(*args), 2, 1)
                lib_fp8 = lib_fp8_error = None
                if i8:
                    lib = time_ms(int_mm_loop(k, w, c["seqlens"], dev), 5)
                else:
                    w16 = w.to(torch.bfloat16)
                    xs = [torch.randn((max(m, 1), k), device=dev).to(torch.bfloat16) for m in c["seqlens"]]
                    lib = time_ms(lambda: [xe @ w16[i].T for i, xe in enumerate(xs) if c["seqlens"][i]], 5)
                    del w16, xs
                    lib_fp8, lib_fp8_error = library_ms(scaled_mm_loop, k, w, sc, c["seqlens"], dev)
                # every row of a valid tile read and written, each hit expert's
                # weight read once, the tile vectors
                hit = sum(1 for m in c["seqlens"] if m)
                nbytes = n_valid * k + hit * n * k + n_valid * n * 2 + ga.grp.numel() * 8 + 4
                ops = 2.0 * n_valid * n * k
                bd, by = bound(nbytes, ops, INT8_OPS_PER_S if i8 else FP8_FLOPS_PER_S)
                detail[f"{shape}_{gemm}"] = dict(ms=ms, plain_ms=plain, library_loop_ms=lib,
                                                 library_scaled_mm_ms=lib_fp8,
                                                 library_scaled_mm_error=lib_fp8_error,
                                                 bound_ms=bd, bound_by=by, tm=tm, rows=n_valid,
                                                 pairs=pairs, **gg_rate(ms, bd, ops, i8, tm, dtype))
            del ga, act
        torch.cuda.empty_cache()
        name = "gg_pertensor" if i8 else "gg_pertensor_e4m3"
        main = detail["decode_down" if i8 else "decode_gate_up"]  # what each path launches most
        emit("kernel", name=name, max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
             library_ms=main["library_loop_ms"],
             library_is="a loop of one torch._int_mm (int8) or torch.matmul on bf16 (e4m3) per expert",
             library_scaled_mm_ms=main["library_scaled_mm_ms"],
             library_scaled_mm_is=None if i8 else "a loop of one torch._scaled_mm per expert (e4m3, "
                                                  "per-tensor scales)",
             bound_ms=main["bound_ms"], bound_by=main["bound_by"], shapes=detail)
        rows_out.append(dict(name=name, source="hpc_ops_tpu_torch/csrc/group_gemm.cu",
                             replaces="hpc_ops_tpu/ops/group_gemm.py:148", max_abs_err=err,
                             ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                             bound_by=main["bound_by"], library_ms=main["library_loop_ms"],
                             library_scaled_mm_ms=main["library_scaled_mm_ms"]))
    return rows_out


def moe_int8_args(inp, shape, rank_ep=0, size_ep=1, interleaved=True):
    """fuse_moe_pertensor_int8's arguments at ``shape`` for the local experts
    of one expert-parallel rank."""
    c = inp[shape]
    local = slice(rank_ep * MOE_E // size_ep, (rank_ep + 1) * MOE_E // size_ep)
    gw = inp["gw8_il" if interleaved else "gw8"][local]
    return (c["x8"], gw, inp["dw8"][local], inp["gs8"][local], inp["ds8"][local], inp["act8"],
            c["ids"], c["ts"], rank_ep, MOE_E)


def check_moe_pipeline_int8(dev, inp):
    """The int8 MoE on expert-parallel rank 1 of 2 at the decode shape: fused
    (activation in the gate-up GEMM, aligned down GEMM), unfused (int8 scatter
    GEMMs around the activation kernel) and impl="ref" (plain, the interleave
    undone), the fused one under sync debug mode."""
    import torch

    from hpc_ops_tpu_torch.ops.moe import fuse_moe_pertensor_int8

    fused_args = moe_int8_args(inp, "decode", 1, 2)
    plain_args = moe_int8_args(inp, "decode", 1, 2, interleaved=False)
    fused = fuse_moe_pertensor_int8(*fused_args, gate_up_interleaved=True)
    unfused = fuse_moe_pertensor_int8(*plain_args)
    ref = fuse_moe_pertensor_int8(*fused_args, gate_up_interleaved=True, impl="ref").float()
    torch.cuda.synchronize()
    tol = 2e-2 * float(ref.abs().max())
    for name, got in (("fused", fused), ("unfused", unfused)):
        if not torch.isfinite(got.float()).all() or not torch.allclose(got.float(), ref, atol=tol, rtol=2e-2):
            raise AssertionError(f"moe_pipeline_int8: {name} disagrees with impl='ref' (max err "
                                 f"{float((got.float() - ref).abs().max())}, limit {tol} + 2%)")
    torch.cuda.set_sync_debug_mode("error")  # a device-to-host copy of a count would raise
    try:
        again = fuse_moe_pertensor_int8(*fused_args, gate_up_interleaved=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(again, fused):
        raise AssertionError("moe_pipeline_int8: two fused calls differ")
    times = {}
    for shape in ("decode", "prefill_512"):
        fa, pa = moe_int8_args(inp, shape, 1, 2), moe_int8_args(inp, shape, 1, 2, interleaved=False)
        times[shape] = dict(
            fused_ms=time_ms(lambda: fuse_moe_pertensor_int8(*fa, gate_up_interleaved=True), 10),
            unfused_ms=time_ms(lambda: fuse_moe_pertensor_int8(*pa), 10))
    emit("moe_pipeline_int8", shape="decode", rank_ep="1 of 2", output_max=float(ref.abs().max()),
         fused_max_abs_err=float((fused.float() - ref).abs().max()),
         unfused_max_abs_err=float((unfused.float() - ref).abs().max()),
         fused_equals_unfused=bool(torch.equal(fused, unfused)), sync_debug_mode_raised=False,
         ms=times)


def ops_moe(dev, inp):
    """The MoE entry points that the serving runs do not reach, each once at
    Mixtral width with the launch counts set to 0 before the call and read
    after it, against its impl="ref": fuse_moe_pertensor_fp8(impl="gather")
    (row 11 over e4m3), the unfused fuse_moe_pertensor_int8 (row 15 over
    int8 operands), and the packed group_gemm_pertensor_fp8 / group_gemm_fp8
    / group_gemm_pertensor_int8. Returns {kernels-line name: launches}."""
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.ops import group_gemm as gg
    from hpc_ops_tpu_torch.ops.moe import fuse_moe_pertensor_fp8, fuse_moe_pertensor_int8

    c = inp["prefill_200"]
    fp8_args = (c["x"], inp["gw"], inp["dw"], inp["gs"], inp["ds"], inp["act"], c["ids"], c["ts"], 0, MOE_E)
    int8_args = moe_int8_args(inp, "prefill_200", interleaved=False)
    seqlens = torch.tensor(c["seqlens"], dtype=torch.int32, device=dev)
    cu = torch.zeros(MOE_E + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.cumsum(seqlens, 0)
    total = int(cu[-1])
    xp = {"fp8": torch.randn((total, MOE_H), device=dev).mul_(FP8_STD).to(torch.float8_e4m3fn),
          "int8": torch.randn((total, MOE_H), device=dev).mul_(I8_STD).round_().clamp_(-127, 127)
          .to(torch.int8)}

    def packed(fn, key, w, sc):
        return lambda **kw: fn(xp[key], w, seqlens, cu, sc, **kw)

    forms = {  # name: (kernels-line name, expected launches, call taking impl=)
        "fuse_moe_pertensor_fp8(impl='gather')": (
            "gg_pertensor_e4m3", {"gg_pertensor": 2, "act_quant": 1, "moe_reduce": 1},
            lambda impl: fuse_moe_pertensor_fp8(*fp8_args, impl="gather" if impl == "auto" else impl)),
        "fuse_moe_pertensor_int8 (unfused)": (
            "gg_scatter_i8", {"gg_scatter_i8": 2, "act_quant": 1, "moe_reduce": 1},
            lambda impl: fuse_moe_pertensor_int8(*int8_args, impl=impl)),
        "group_gemm_pertensor_fp8": ("gg_scatter", {"gg_scatter": 1}, lambda impl: packed(
            gg.group_gemm_pertensor_fp8, "fp8", inp["gw"], inp["gs"])(impl=impl)),
        "group_gemm_fp8": ("gg_scatter", {"gg_scatter": 1}, lambda impl: packed(
            gg.group_gemm_fp8, "fp8", inp["gw"], inp["gs"])(impl=impl)),
        "group_gemm_pertensor_int8": ("gg_scatter_i8", {"gg_scatter_i8": 1}, lambda impl: packed(
            gg.group_gemm_pertensor_int8, "int8", inp["gw8"], inp["gs8"])(impl=impl)),
    }
    launches, errs = {}, {}
    for name, (row, expect, call) in forms.items():
        want = call("ref").float()
        kernels.reset_launch_counts()
        got = call("auto").float()
        torch.cuda.synchronize()
        counts, bodies = split_bodies(kernels.launch_counts())
        e4m3 = expect.get("gg_scatter", 0) + (expect.get("gg_pertensor", 0) if "fp8" in name else 0)
        if counts != {**{n: 0 for n in counts}, **expect} or sum(bodies.values()) != e4m3:
            raise AssertionError(f"ops_moe {name}: launch counts {counts} (e4m3 by body {bodies}), "
                                 f"expected {expect}")
        tol = 2e-2 * float(want.abs().max())
        if not torch.isfinite(got).all() or not torch.allclose(got, want, atol=tol, rtol=2e-2):
            raise AssertionError(f"ops_moe {name}: the entry point disagrees with its impl='ref' "
                                 f"(max err {float((got - want).abs().max())}, limit {tol} + 2%)")
        errs[name] = float((got - want).abs().max())
        counted = {"gg_pertensor_e4m3": "gg_pertensor"}.get(row, row)
        launches[row] = launches.get(row, 0) + counts[counted]
    emit("ops_moe", launches=launches, max_abs_err=errs)
    return launches


# ------------------------------------------------------- blockwise MoE kernels
BW_STD = {"i8": I8_STD, "e4m3": FP8_STD}  # standard deviation of the seeded codes


def bw_check_inputs(dev, inp):
    """Blockwise scales for moe_check_inputs' codes: a scale per (token,
    128-group) and per 128 x 128 weight block, drawn from a seed, that bring
    gate, up and the outputs near 1. Adds them to ``inp`` in place."""
    import torch

    from hpc_ops_tpu_torch.ops.group_gemm import _take_rows
    from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast

    g = torch.Generator(device=dev).manual_seed(77)

    def scales(*shape, den):
        return (torch.rand(shape, generator=g, device=dev) + 0.5) / den

    for form, std in BW_STD.items():
        inp[f"bw_gsw_{form}"] = scales(MOE_E, 2 * MOE_I // 128, MOE_H // 128, den=std * MOE_H**0.5)
        inp[f"bw_dsw_{form}"] = scales(MOE_E, MOE_H // 128, MOE_I // 128, den=std * MOE_I**0.5)
        for shape in MOE_SHAPES:
            c = inp[shape]
            c[f"sx_{form}"] = scales(c["s"], MOE_H // 128, den=std)
            # the down GEMM's input: codes and their scales in the aligned layout
            rows = c["row_idx"].shape[0]
            act = torch.randn((rows, MOE_I), generator=g, device=dev).mul_(std)
            c[f"act_{form}"] = (act.round_().clamp_(-127, 127).to(torch.int8) if form == "i8"
                                else fp8_saturate_cast(act))
            c[f"act_sx_{form}"] = scales(rows, MOE_I // 128, den=std)
            x = c["x8"] if form == "i8" else c["x"]
            c[f"x_al_{form}"] = _take_rows(x, c["row_idx"])
            c[f"sx_al_{form}"] = _take_rows(c[f"sx_{form}"], c["row_idx"])


def bw_gemm_args(inp, shape, form, gemm, aligned):
    """(args of gg_bw_scatter or gg_bw_aligned, (n, k), rows to compare)."""
    c = inp[shape]
    i8 = form == "i8"
    tm, nvt = c["tm"], c["nvt"]
    if gemm == "gate_up":
        w, sw, nk = inp["gw8" if i8 else "gw"], inp[f"bw_gsw_{form}"], (2 * MOE_I, MOE_H)
        if aligned:
            args = (c[f"x_al_{form}"], w, c[f"sx_al_{form}"], sw, c["grp"], c["row_blk"], tm, nvt)
        else:
            args = (c["x8" if i8 else "x"], w, c[f"sx_{form}"], sw, c["row_idx"], c["grp"], tm, nvt)
    else:
        w, sw, nk = inp["dw8" if i8 else "dw"], inp[f"bw_dsw_{form}"], (MOE_H, MOE_I)
        if aligned:
            args = (c[f"act_{form}"], w, c[f"act_sx_{form}"], sw, c["grp"], c["row_blk"], tm, nvt)
        else:
            args = (c[f"act_{form}"], w, c[f"act_sx_{form}"], sw, c["ident"], c["grp"], tm, nvt)
    if aligned:  # every row of a valid tile
        rows = c["ident"] < int(nvt) * tm
    else:  # the real slots (gate-up) or every slot of a valid tile (down, identity rows)
        rows = (c["row_idx"] >= 0) if gemm == "gate_up" else (c["ident"] < int(nvt) * tm)
    return args, nk, rows


def check_gg_bw(dev, inp, aligned):
    """Rows 12-14: the blockwise scatter (row 14) or aligned (rows 12 and 13)
    grouped GEMM over int8 and e4m3, gate-up and down at every MoE shape,
    against its plain version: int8 bit-equal, e4m3 within one bf16 step plus
    1e-3 of the largest output (the order of the float32 sums). The serving
    run's blockwise MoE uses m-tiles of 64 (the JAX package's default
    num_seq_per_group_avg of 32); these shapes also reach the 32-row block.
    Timed beside the plain version and the library's unscaled loop (one
    torch._int_mm (int8) or torch.matmul on bf16 (e4m3) per expert, no
    scales: no single PyTorch call applies blockwise scales)."""
    import torch

    from hpc_ops_tpu_torch.ops import group_gemm as gg

    kernel = gg.gg_bw_aligned if aligned else gg.gg_bw_scatter
    plain_fn = gg.gg_bw_aligned_ref if aligned else gg.gg_bw_scatter_ref
    base = "gg_bw_aligned" if aligned else "gg_bw_scatter"
    layout, layout_errors = blockwise_scaled_mm(dev)
    emit("blockwise_scaled_mm", form=base, supported=layout is not None, layout=layout,
         errors=layout_errors, torch=torch.__version__, cuda=torch.version.cuda)
    rows_out = []
    for form in ("i8", "e4m3"):
        i8 = form == "i8"
        detail, err = {}, 0.0
        for shape in MOE_SHAPES:
            c = inp[shape]
            for gemm in ("gate_up", "down"):
                args, (n, k), rows = bw_gemm_args(inp, shape, form, gemm, aligned)
                got, want = kernel(*args), plain_fn(*args)
                torch.cuda.synchronize()
                if i8:
                    if not torch.equal(got[rows], want[rows]):
                        d = (got[rows].float() - want[rows].float()).abs()
                        raise AssertionError(f"{base}_{form} {shape} {gemm}: kernel differs from the "
                                             f"plain version by up to {float(d.max())} (limit: bit-equal)")
                else:
                    err = max(err, gemm_close(got, want, rows, f"{base}_{form} {shape} {gemm}"))
                del got, want
                ms = time_ms(lambda: kernel(*args), 20 if shape == "decode" else 5)
                plain = time_ms(lambda: plain_fn(*args), 2, 1)
                lib_fp8 = lib_fp8_error = None
                if i8:
                    lib = time_ms(int_mm_loop(k, args[1], c["seqlens"], dev), 5)
                else:
                    w16 = args[1].to(torch.bfloat16)
                    xs = [torch.randn((max(m, 1), k), device=dev).to(torch.bfloat16) for m in c["seqlens"]]
                    lib = time_ms(lambda: [xe @ w16[i].T for i, xe in enumerate(xs) if c["seqlens"][i]], 5)
                    del w16, xs
                    if layout is not None:
                        lib_fp8, lib_fp8_error = library_ms(blockwise_scaled_mm_loop, layout, k, args[1],
                                                            args[3], c["seqlens"], dev)
                hit = sum(1 for m in c["seqlens"] if m)
                nrows = int(rows.sum())
                kb = k // 128
                # rows of x and their scales read once (the aligned form reads
                # every row of a valid tile), each hit expert's weight and block
                # scales once, each compared output row written once, the index vectors
                in_rows = nrows if aligned or gemm == "down" else c["s"]
                nbytes = (in_rows * (k + 4 * kb) + hit * (n * k + (n // 128) * kb * 4) + nrows * n * 2
                          + args[4].numel() * 4 + args[5].numel() * 4 + 4)
                ops = 2.0 * nrows * n * k
                bd, by = bound(nbytes, ops, INT8_OPS_PER_S if i8 else FP8_FLOPS_PER_S)
                detail[f"{shape}_{gemm}"] = dict(ms=ms, plain_ms=plain, library_loop_ms=lib,
                                                 library_scaled_mm_ms=lib_fp8,
                                                 library_scaled_mm_error=lib_fp8_error,
                                                 bound_ms=bd, bound_by=by, tm=c["tm"], rows=nrows,
                                                 n=n, k=k, gbytes_per_s=nbytes / ms * 1e-6,
                                                 **gg_rate(ms, bd, ops, i8, c["tm"], "blockwise"))
        torch.cuda.empty_cache()
        name = f"{base}_{form}"
        # what serving launches most: the scatter gate-up, the aligned down
        main = detail["decode_down" if aligned else "decode_gate_up"]
        emit("kernel", name=name, max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"],
             library_ms=main["library_loop_ms"],
             library_is="unscaled: a loop of one torch._int_mm (int8) or torch.matmul on bf16 (e4m3) "
                        "per expert",
             library_scaled_mm_ms=main["library_scaled_mm_ms"],
             library_scaled_mm_is=None if i8 or layout is None else "a loop of one torch._scaled_mm per "
                                                               "expert with 1x128 and 128x128 scales",
             bound_ms=main["bound_ms"], bound_by=main["bound_by"], shapes=detail)
        replaces = ("hpc_ops_tpu/ops/group_gemm.py:193" if i8 else "hpc_ops_tpu/ops/group_gemm.py:348"
                    ) if aligned else "hpc_ops_tpu/ops/group_gemm.py:666"
        row = dict(name=name, source="hpc_ops_tpu_torch/csrc/group_gemm.cu", replaces=replaces,
                   max_abs_err=err, ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                   bound_by=main["bound_by"], library_ms=main["library_loop_ms"],
                   library_scaled_mm_ms=main["library_scaled_mm_ms"])
        if aligned:  # one kernel for both aligned-row TPU kernels, each scheme over both types
            row["also_replaces"] = ("hpc_ops_tpu/ops/group_gemm.py:348" if i8
                                    else "hpc_ops_tpu/ops/group_gemm.py:193")
        rows_out.append(row)
    return rows_out


def bw_moe_args(inp, shape, form, rank_ep=0, size_ep=1):
    """fuse_moe_blockwise_*'s arguments at ``shape`` for the local experts of
    one expert-parallel rank: token codes and their scales, block-scaled
    experts (inp's codes with bw_check_inputs' scales)."""
    c = inp[shape]
    i8 = form == "i8"
    local = slice(rank_ep * MOE_E // size_ep, (rank_ep + 1) * MOE_E // size_ep)
    return (c["x8" if i8 else "x"], c[f"sx_{form}"], inp["gw8" if i8 else "gw"][local],
            inp[f"bw_gsw_{form}"][local], inp["dw8" if i8 else "dw"][local],
            inp[f"bw_dsw_{form}"][local], c["ids"], c["ts"], rank_ep, MOE_E)


def bw_moe_plain(args, nan_garbage=False):
    """The scatter pipeline of fuse_moe_blockwise_* over the plain GEMMs (the
    card's routing, re-quantisation and plain reduce), with every garbage row
    filled with NaN after each GEMM when asked."""
    import torch

    from hpc_ops_tpu_torch.ops import group_gemm as gg
    from hpc_ops_tpu_torch.ops import moe
    from hpc_ops_tpu_torch.ops.quant import blockwise_fp8_quant, blockwise_int8_quant

    x, sx, gw, gsw, dw, dsw, ids, ts, rank_ep, _ = args
    quant = blockwise_int8_quant if x.dtype == torch.int8 else blockwise_fp8_quant
    tm = gg._pick_tm(32, x.shape[1])
    row_idx, topk_pos, _, _, _, cu_tiles, grp = moe._route_aligned(ids, gw.shape[0], rank_ep, tm)
    nvt = cu_tiles[-1:]
    garbage = (row_idx < 0)[:, None]
    gate_up = gg.gg_bw_scatter_ref(x, gw, sx, gsw, row_idx, grp, tm, nvt)
    if nan_garbage:
        gate_up = torch.where(garbage, float("nan"), gate_up.float()).to(torch.bfloat16)
    d_in, d_sx = moe._act_requant(gate_up, quant)
    row_blk = torch.arange(grp.shape[0], dtype=torch.int32, device=x.device)
    down = gg.gg_bw_aligned_ref(d_in, dw, d_sx, dsw, grp, row_blk, tm, nvt)
    if nan_garbage:
        down = torch.where(garbage, float("nan"), down.float()).to(torch.bfloat16)
    return moe.moe_reduce_ref(down, topk_pos, ts).float()


def check_moe_pipeline_bw(dev, inp):
    """The blockwise int8 MoE on expert-parallel rank 1 of 2 at the decode
    shape: fuse_moe_blockwise_int8 with scheme "scatter" (the serving path)
    and "int8" (the aligned-row copy) against the pipeline over the plain
    GEMMs with every garbage row filled with NaN after each GEMM, the
    scatter one under sync debug mode."""
    import torch

    from hpc_ops_tpu_torch.ops.moe import fuse_moe_blockwise_int8

    args = bw_moe_args(inp, "decode", "i8", 1, 2)
    plain = bw_moe_plain(args, nan_garbage=True)
    outs = {s: fuse_moe_blockwise_int8(*args, scheme=s).float() for s in ("scatter", "int8")}
    torch.cuda.synchronize()
    tol = 2e-2 * float(plain.abs().max())
    for s, got in outs.items():
        if not torch.isfinite(got).all() or not torch.allclose(got, plain, atol=tol, rtol=2e-2):
            raise AssertionError(f"moe_pipeline_bw: scheme {s!r} disagrees with the plain pipeline "
                                 f"(max err {float((got - plain).abs().max())}, limit {tol} + 2%)")
    if not torch.isfinite(plain).all():
        raise AssertionError("moe_pipeline_bw: a NaN garbage row reached the plain pipeline's output")
    torch.cuda.set_sync_debug_mode("error")  # a device-to-host copy of a count would raise
    try:
        again = fuse_moe_blockwise_int8(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not torch.equal(again.float(), outs["scatter"]):
        raise AssertionError("moe_pipeline_bw: two scatter calls differ")
    times = {}
    for shape in ("decode", "prefill_512"):
        a = bw_moe_args(inp, shape, "i8", 1, 2)
        times[shape] = {s: time_ms(lambda s=s: fuse_moe_blockwise_int8(*a, scheme=s), 10)
                        for s in ("scatter", "int8")}
    emit("moe_pipeline_bw", shape="decode", rank_ep="1 of 2", output_max=float(plain.abs().max()),
         max_abs_err={s: float((g - plain).abs().max()) for s, g in outs.items()},
         equal_to_plain={s: bool(torch.equal(g, plain)) for s, g in outs.items()},
         sync_debug_mode_raised=False, ms=times)


def ops_moe_bw(dev, inp):
    """The blockwise entry points that serving does not reach, each once at
    Mixtral width (the prefill_200 shape) with the launch counts set to 0
    before the call and read after it: group_gemm_blockwise_fp8 and _int8 in
    both x-scale layouts and every scheme against their impl="ref" (one bf16
    step plus 1e-3 of the largest output), fuse_moe_blockwise_fp8 with
    "scatter" and "prescale" against the pipeline over the plain GEMMs (2% of
    the largest output + 2%: e4m3 sums in another order can move a
    re-quantised code). Returns {kernels-line name: launches}."""
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.ops import group_gemm as gg
    from hpc_ops_tpu_torch.ops.moe import fuse_moe_blockwise_fp8
    from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast

    c = inp["prefill_200"]
    seqlens = torch.tensor(c["seqlens"], dtype=torch.int32, device=dev)
    cu = torch.zeros(MOE_E + 1, dtype=torch.int32, device=dev)
    cu[1:] = torch.cumsum(seqlens, 0)
    total = int(cu[-1])
    avg = max(total // MOE_E, 1)
    g = torch.Generator(device=dev).manual_seed(78)
    packed = {}
    for form in BW_STD:
        x = torch.randn((total, MOE_H), generator=g, device=dev).mul_(BW_STD[form])
        x = x.round_().clamp_(-127, 127).to(torch.int8) if form == "i8" else fp8_saturate_cast(x)
        sx = (torch.rand((total, MOE_H // 128), generator=g, device=dev) + 0.5) / BW_STD[form]
        packed[form] = (x, sx, gg.reformat_x_scale(sx, seqlens, cu, avg))
    forms = {}
    for form, entry in (("i8", gg.group_gemm_blockwise_int8), ("e4m3", gg.group_gemm_blockwise_fp8)):
        x, sx, sx_t = packed[form]
        w, sw = inp["gw8" if form == "i8" else "gw"], inp[f"bw_gsw_{form}"]
        for layout, scales in (("natural", sx), ("transposed", sx_t)):
            for scheme in gg.BLOCKWISE_SCHEMES:
                if scheme == "int8" and form != "i8":
                    continue
                kernel = "gg_bw_scatter" if scheme == "scatter" else "gg_bw_aligned"
                forms[f"{entry.__name__}({layout}, {scheme})"] = (
                    f"{kernel}_{form}", {kernel: 1},
                    lambda impl, entry=entry, x=x, w=w, scales=scales, sw=sw, layout=layout,
                    scheme=scheme: entry(x, w, seqlens, cu, scales, sw, avg, x_scale_layout=layout,
                                         scheme=scheme, impl=impl))
    moe_args = bw_moe_args(inp, "prefill_200", "e4m3")
    for scheme, expect in (("scatter", {"gg_bw_scatter": 1, "gg_bw_aligned": 1, "moe_reduce": 1}),
                           ("prescale", {"gg_bw_aligned": 2, "moe_reduce": 1})):
        forms[f"fuse_moe_blockwise_fp8({scheme})"] = (
            None, expect, lambda impl, scheme=scheme: (
                bw_moe_plain(moe_args) if impl == "ref" else fuse_moe_blockwise_fp8(*moe_args, scheme=scheme)))
    launches, errs = {}, {}
    for name, (row, expect, call) in forms.items():
        want = call("ref").float()
        kernels.reset_launch_counts()
        got = call("auto").float()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if counts != {**{n: 0 for n in counts}, **expect}:
            raise AssertionError(f"ops_moe_bw {name}: launch counts {counts}, expected {expect}")
        if row is None:  # a whole MoE
            tol = 2e-2 * float(want.abs().max())
            ok = torch.isfinite(got).all() and torch.allclose(got, want, atol=tol, rtol=2e-2)
        else:
            tol = 1e-3 * float(want.abs().max())
            ok = torch.isfinite(got).all() and torch.allclose(got, want, atol=tol, rtol=GEMM_RTOL)
        if not ok:
            raise AssertionError(f"ops_moe_bw {name}: the entry point disagrees with its reference "
                                 f"(max err {float((got - want).abs().max())}, outputs up to "
                                 f"{float(want.abs().max())})")
        errs[name] = float((got - want).abs().max())
        for kernel, n in expect.items():
            if kernel != "moe_reduce":
                key = f"{kernel}_e4m3" if row is None else row
                launches[key] = launches.get(key, 0) + n
    emit("ops_moe_bw", launches=launches, max_abs_err=errs)
    return launches


# -------------------------------------------------------------------- slice
def first_steps(llama, cfg, w, dev):
    """Prefill 7 and 5 tokens for two requests, then decode one token each."""
    import torch

    t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    caches = llama.init_cache(cfg, num_blocks=8, block_size=BS, device=dev)
    tbl = t([[0, 1, -1], [2, 3, -1]])
    lp, caches = llama.forward_step(w, caches, cfg, t([i % cfg.vocab for i in range(12)]), t([7, 5]),
                                    t([0, 7, 12]), tbl, is_prefill=True, max_seqlens_q=7)
    ld, _ = llama.forward_step(w, caches, cfg, t([3, 5]), t([8, 6]), t([0, 1, 2]), tbl,
                               is_prefill=False, max_seqlens_q=1)
    return lp.float().cpu(), ld.float().cpu()


def slice_tiny(dev, phase="slice_tiny", moe_scheme=None, **cfg_kw):
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.runtime.engine import Engine
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

    cfg = llama.tiny_config(**cfg_kw)
    if moe_scheme is not None:
        cfg = cfg._replace(moe=cfg.moe._replace(scheme=moe_scheme))
    w_cpu = llama.init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    w_gpu = {**{k: v.to(dev) for k, v in w_cpu.items() if k != "layers"},
             "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in w_cpu["layers"]]}
    diffs = {}
    cpu_steps = first_steps(llama, cfg, w_cpu, "cpu")
    gpu_steps = first_steps(llama, cfg, w_gpu, dev)
    for name, c, g in zip(("prefill", "decode"), cpu_steps, gpu_steps):
        if not torch.isfinite(g).all() or not torch.allclose(g, c, atol=ATOL_LOGITS, rtol=RTOL_LOGITS):
            raise AssertionError(f"{phase} {name} logits: card vs CPU beyond 0.15/0.1")
        diffs[name] = float((g - c).abs().max())
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61))]
    outs, multi = {}, {}
    for d in ("cpu", dev):
        for ms, into in ((1, outs), (TINY_MULTI_STEP, multi)):
            eng = Engine(cfg, w_cpu if d == "cpu" else w_gpu, num_blocks=64, block_size=BS, max_batch=4,
                         prefill_chunk=16, device=d, multi_step=ms, logprobs=ms > 1)
            into[str(d)] = (eng.run(prompts, max_new=8), [r.logprobs for r in eng.requests.values()])
    outs = {d: o for d, (o, _) in outs.items()}

    def margin(tokens):
        n = len(tokens)
        caches = llama.init_cache(cfg, num_blocks=8, block_size=BS, device="cpu")
        t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
        logits, _ = llama.forward_step(w_cpu, caches, cfg, t(tokens), t([n]), t([0, n]),
                                       t([list(range(8))]), is_prefill=True, max_seqlens_q=n)
        return top2_margin(logits.float())

    flips = []
    for p, want, got in zip(prompts, outs["cpu"], outs[str(dev)]):
        j = assert_greedy_match(want, got, lambda j, p=p, want=want: margin(p + want[:j]), ATOL_LOGITS)
        if j is not None:
            flips.append({"prompt": p, "step": j, "cpu_margin": margin(p + want[:j])})
    emit(phase, max_logits_diff=diffs, tokens_card=outs[str(dev)], tokens_cpu=outs["cpu"],
         near_tie_flips=flips, **multi_step_vs_cpu(phase, prompts, multi, str(dev), margin))


TINY_MULTI_STEP = 4  # the slice_tiny* phases' second run: Engine(multi_step=4, logprobs=True)


def multi_step_vs_cpu(phase, prompts, runs, dev, margin):
    """The slice_tiny* phases' multi-step run (``runs``: device -> (tokens,
    logprobs), the card's a captured graph): the card's tokens held to the
    CPU engine's by ``assert_greedy_match``, one logprob a token, each <= 0,
    and each logprob before any accepted flip within the logits' tolerance
    of the CPU engine's (0.15 abs / 0.1 rel: a logprob is a logit less the
    row's log-sum-exp); returns the largest difference."""
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match

    flips, lp_diff = [], 0.0
    for i, p in enumerate(prompts):
        (want, want_lp), (got, got_lp) = ((runs[d][0][i], runs[d][1][i]) for d in ("cpu", dev))
        if len(got_lp) != len(got) or not all(v <= 0.0 for v in got_lp):
            raise AssertionError(f"{phase} multi_step: {len(got_lp)} logprobs for {len(got)} tokens")
        j = assert_greedy_match(want, got, lambda j, p=p, want=want: margin(p + want[:j]), ATOL_LOGITS)
        if j is not None:
            flips.append({"prompt": p, "step": j})
        for k, (a, b) in enumerate(zip(want_lp[:j], got_lp[:j])):
            if not abs(a - b) <= ATOL_LOGITS + RTOL_LOGITS * abs(a):
                raise AssertionError(f"{phase} multi_step request {i} token {k}: logprob {b} on the card, "
                                     f"{a} on the CPU, beyond 0.15/0.1")
            lp_diff = max(lp_diff, abs(a - b))
    return {"multi_step": TINY_MULTI_STEP, "multi_step_tokens_card": runs[dev][0],
            "multi_step_near_tie_flips": flips, "multi_step_max_logprob_diff": lp_diff}


def sharded_first_steps(llama, cfg, w, mesh, dev):
    """slice_tiny's first steps on a (dp 2, tp 2) mesh: each dp shard
    prefills one request (7 and 5 tokens, rows padded to 7), then decodes
    one token each."""
    import torch

    t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    weights = llama.shard_weights(w, cfg, mesh)
    caches = [[llama.init_cache(cfg, 8, BS, tp=2, device=dev) for _ in range(2)] for _ in range(2)]
    tbl = t([[0, 1, -1], [2, 3, -1]])
    lp, caches = llama.make_sharded_step(mesh, cfg, True, max_seqlens_q=7)(
        weights, caches, t(list(range(7)) + list(range(10, 15)) + [0, 0]), t([7, 5]), t([0, 7, 0, 5]), tbl)
    ld, _ = llama.make_sharded_step(mesh, cfg, False, max_seqlens_q=1)(
        weights, caches, t([3, 5]), t([8, 6]), t([0, 1, 0, 1]), tbl)
    return lp.float().cpu(), ld.float().cpu()


def slice_tiny_tp(dev, phase="slice_tiny_tp", **cfg_kw):
    """make_sharded_step and ShardedEngine on a (dp 2, tp 2) mesh of virtual
    ranks on the card against the same calls on CPU ranks: logits within 0.15
    abs / 0.1 rel, greedy tokens identical wherever the CPU path's top-2
    margin exceeds that tolerance; with moe=True the fp8 MoE kernels run
    under rank_ep (4 experts a rank)."""
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.parallel import make_mesh
    from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

    cfg = llama.tiny_config(**cfg_kw)
    w_cpu = llama.init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    w_gpu = {**{k: v.to(dev) for k, v in w_cpu.items() if k != "layers"},
             "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in w_cpu["layers"]]}
    meshes = {"cpu": make_mesh(tp=2, dp=2, devices=["cpu"] * 4),
              str(dev): make_mesh(tp=2, dp=2, devices=[dev] * 4)}
    kernels.reset_launch_counts()
    steps = {d: sharded_first_steps(llama, cfg, w_cpu if d == "cpu" else w_gpu, m, d)
             for d, m in meshes.items()}
    torch.cuda.synchronize()
    if kernels.launch_counts()["allreduce_rmsnorm"] != 2 * 2 * 2 * cfg.layers:
        raise AssertionError(f"{phase}: {kernels.launch_counts()['allreduce_rmsnorm']} collective launches")
    diffs = {}
    for name, c, g in zip(("prefill", "decode"), steps["cpu"], steps[str(dev)]):
        if not torch.isfinite(g).all() or not torch.allclose(g, c, atol=ATOL_LOGITS, rtol=RTOL_LOGITS):
            raise AssertionError(f"{phase} {name} logits: card vs CPU beyond 0.15/0.1")
        diffs[name] = float((g - c).abs().max())
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61))]
    outs, multi = {}, {}
    for d, m in meshes.items():
        for ms, into in ((1, outs), (TINY_MULTI_STEP, multi)):
            eng = ShardedEngine(cfg, w_cpu if d == "cpu" else w_gpu, m, num_blocks=64, block_size=BS,
                                max_batch=2, prefill_chunk=16, multi_step=ms, logprobs=ms > 1)
            into[d] = (eng.run(prompts, max_new=8), [r.logprobs for r in eng.requests.values()])
    outs = {d: o for d, (o, _) in outs.items()}

    def margin(tokens):
        n = len(tokens)
        t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
        logits, _ = llama.forward_step(w_cpu, llama.init_cache(cfg, 8, BS, device="cpu"), cfg, t(tokens),
                                       t([n]), t([0, n]), t([list(range(8))]), is_prefill=True,
                                       max_seqlens_q=n)
        return top2_margin(logits.float())

    flips = []
    for p, want, got in zip(prompts, outs["cpu"], outs[str(dev)]):
        j = assert_greedy_match(want, got, lambda j, p=p, want=want: margin(p + want[:j]), ATOL_LOGITS)
        if j is not None:
            flips.append({"prompt": p, "step": j, "cpu_margin": margin(p + want[:j])})
    emit(phase, max_logits_diff=diffs, tokens_card=outs[str(dev)], tokens_cpu=outs["cpu"],
         near_tie_flips=flips, **multi_step_vs_cpu(phase, prompts, multi, str(dev), margin))


PROFILE_FROM, PROFILE_STEPS = 4, 3  # decode steps 5..7 of slice_full


class DecodeProfile:
    """torch.profiler over a few decode steps: device time per step by kernel
    class and the device's idle share of the window's wall time."""

    def __init__(self, torch, classes, steps_per_dispatch=1):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.classes = classes  # kernel-name substring -> class name
        self.per = steps_per_dispatch  # decode steps a profiled engine step runs (multi_step)
        self.steps = 0  # engine steps profiled
        self.active = True
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.active = False

    def summary(self) -> dict:
        cuda = self.torch.autograd.DeviceType.CUDA
        classes = {**{c: 0.0 for c in self.classes.values()}, "gemm": 0.0, "other": 0.0}
        other = {}
        dtoh = launches = 0
        for e in self.prof.key_averages():
            if e.device_type != cuda:
                continue
            us = e.self_device_time_total
            name = e.key
            if "Memcpy DtoH" in name:
                dtoh += e.count
            elif "Memcpy" not in name and "Memset" not in name:
                launches += e.count
            for k, c in self.classes.items():
                if k in name:
                    classes[c] += us
                    break
            else:
                if any(m in name.lower() for m in ("gemm", "nvjet", "xmma", "cutlass", "imma")):
                    classes["gemm"] += us
                else:
                    classes["other"] += us
                    other[name[:80]] = other.get(name[:80], 0.0) + us
        n = self.steps * self.per
        busy_ms = sum(classes.values()) / 1e3 / n
        wall_ms = self.wall_s * 1e3 / n
        # the time some kernel ran: the union of the kernels' intervals (the
        # branches of a tensor-parallel graph overlap, so the sum above can
        # exceed the wall time)
        spans = sorted((e.time_range.start, e.time_range.end) for e in self.prof.events()
                       if e.device_type == cuda and "Memcpy" not in e.name and "Memset" not in e.name)
        union_us, end = 0.0, float("-inf")
        for a, b in spans:
            if b > end:
                union_us += b - max(a, end)
                end = b
        union_ms = union_us / 1e3 / n
        per_dispatch = {}
        if self.per > 1:
            per_dispatch = {"dispatches": self.steps, "steps_per_dispatch": self.per,
                            "device_to_host_copies_per_dispatch": dtoh / self.steps}
        return {
            **per_dispatch,
            "steps": n,
            "device_ms_per_step": {k: v / 1e3 / n for k, v in classes.items()},
            "device_busy_ms_per_step": busy_ms,
            "wall_ms_per_step": wall_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "device_busy_union_ms_per_step": union_ms,
            "idle_share_union": 1.0 - union_ms / wall_ms if union_ms else None,
            "kernel_launches_per_step": launches / n,
            "device_to_host_copies_per_step": dtoh / n,
            "top_other_ms_per_step": {k: v / 1e3 / n for k, v in
                                      sorted(other.items(), key=lambda kv: -kv[1])[:6]},
        }


# launches of each MoE kernel in one forward call, per layer, by scheme
MOE_PER_CALL = {
    "pertensor_fp8": {"gg_scatter": 2, "act_quant": 1, "moe_reduce": 1},
    "pertensor_int8": {"gg_scatter_i8_act": 1, "gg_pertensor": 1, "moe_reduce": 1},
    "blockwise_int8": {"gg_bw_scatter": 1, "gg_bw_aligned": 1, "moe_reduce": 1},
}
# profile classes of the MoE kernels, the longer names first (a kernel takes
# the first class whose name it contains)
MOE_CLASSES = ("gg_bw_scatter", "gg_bw_aligned", "gg_scatter_i8_act", "gg_scatter_i8", "gg_scatter",
               "gg_pertensor", "act_quant", "moe_reduce")
MOE_KERNELS = tuple(MOE_PER_CALL["pertensor_fp8"])
# (RoPE store, decode, prefill) wrappers of each KV path
BF16_KERNELS = ("rope_store", "paged_decode", "paged_prefill")
INT8_KERNELS = ("rope_store_int8", "paged_decode_nhd_fused", "paged_prefill_nhd_fused")
FP8_KERNELS = (None, "paged_decode", "paged_prefill")  # the fp8 store is plain PyTorch


def full_prompts(vocab, longest=2000):
    import numpy as np

    rng = np.random.RandomState(0)
    lens = [16, longest] + [int(x) for x in rng.randint(16, longest + 1, 6)]
    return lens, [[int(t) for t in rng.randint(0, vocab, n)] for n in lens]


def serve_full(dev, cfg, w, phase, kernels_used, config="llama3_8b", longest=2000, mesh=None,
               multi_step=1, new_tokens=32):
    """Engine(cfg) at full width and depth on weights ``w`` (with ``mesh``:
    ShardedEngine over the mesh's ranks): 8 prompts (of 16 to ``longest``
    tokens) x ``new_tokens`` new tokens, with every sampled-from logits
    tensor checked finite (on the multi-step path by a device flag a call
    that the graph updates at every replay), the launch counts of
    ``kernels_used`` (once per rank; with ``cfg.moe``, the MoE kernels; with
    ``mesh``, the one_shot collective twice per layer and call, one launch
    for all ranks) as the step counts say and every other kernel at 0, and
    three decode dispatches profiled. With ``multi_step`` > 1 a decode
    dispatch is a replay of the captured multi-step graph (its launches
    counted through the replays), the first dispatch, which captures it after
    one eager run of its steps, is left out of the step times, and the
    decode ms per step is a dispatch's wall time over ``multi_step``.
    Returns (stats, launch counts, last-token logits of each prefill call,
    the engine, the profile)."""
    import itertools

    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.models import llama as llama_mod
    from hpc_ops_tpu_torch.runtime import engine as engine_mod
    from hpc_ops_tpu_torch.runtime import sharded_engine as sharded_mod

    lens, prompts = full_prompts(cfg.vocab, longest)
    finite, prefill_logits = [], []
    base_forward, base_make_step = engine_mod.forward_step, sharded_mod.make_sharded_step
    base_model_forward = llama_mod.forward_step  # what decode_multi and the sharded ranks call
    # one flag a forward call of the model (modulo 64: the calls of one step
    # on the ranks' streams write different flags), ANDed on the device
    flags = torch.ones(64, dtype=torch.bool, device=dev)
    slots = itertools.count()

    def checked(out, is_prefill):
        finite.append(torch.isfinite(out).all())
        if is_prefill:
            prefill_logits.append(out.float().reshape(-1))

    def checked_forward(*a, **kw):
        out, caches = base_forward(*a, **kw)
        checked(out, kw.get("is_prefill"))
        return out, caches

    def checked_make_step(*a, **kw):
        step = base_make_step(*a, **kw)

        def run(*sa):
            out, caches = step(*sa)
            checked(out, kw.get("is_prefill"))
            return out, caches

        return run

    def flagged_forward(*a, **kw):
        out, caches = base_model_forward(*a, **kw)
        flags[next(slots) % len(flags)].logical_and_(torch.isfinite(out).all())
        return out, caches

    def make_engine(num_blocks, ms):
        if mesh is None:
            return engine_mod.Engine(cfg, w, num_blocks=num_blocks, block_size=BS, max_batch=8, device=dev,
                                     multi_step=ms)
        return sharded_mod.ShardedEngine(cfg, w, mesh, num_blocks=num_blocks, block_size=BS, max_batch=8,
                                         multi_step=ms)

    engine_mod.forward_step, sharded_mod.make_sharded_step = checked_forward, checked_make_step
    if multi_step > 1:
        llama_mod.forward_step = flagged_forward
    try:
        warm = make_engine(64, 1)
        warm.run([prompts[0]], max_new=2)  # cuBLAS and allocator warm-up
        del warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = make_engine(NUM_BLOCKS, multi_step)
        rids = [eng.add_request(p, max_new=new_tokens) for p in prompts]
        prefill_logits.clear()
        kernels.reset_launch_counts()
        prefill_s, decode_s, decode_tokens, capture_dispatch_s = [], [], 0, None
        profiled = None
        bodies = {"prefill": {}, "decode": {}}  # e4m3 grouped-GEMM launches by body, by step kind
        while True:
            st = eng.stats
            decode_next = st["pending"] == 0
            n_dec = st["decode_dispatches"]
            body_before = split_bodies(kernels.launch_counts())[1]
            if decode_next and n_dec == PROFILE_FROM:
                profiled = DecodeProfile(torch, {
                    **{sub: k for sub, k in zip(("rope_store", "paged_decode", "paged_prefill"),
                                                kernels_used) if k},
                    **{k: k for k in MOE_CLASSES}, "allreduce_rmsnorm": "allreduce_rmsnorm"}, multi_step)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if not eng.step():
                break
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            step_bodies = bodies["decode" if decode_next else "prefill"]
            for name, n in split_bodies(kernels.launch_counts())[1].items():
                step_bodies[name] = step_bodies.get(name, 0) + n - body_before[name]
            if not decode_next:
                prefill_s.append(dt)
            elif profiled is not None and profiled.active:
                profiled.steps += 1
                if profiled.steps == PROFILE_STEPS:
                    profiled.stop()
            elif multi_step > 1 and n_dec == 0:  # the dispatch that captured the graph
                capture_dispatch_s = dt
            else:  # profiled steps are left out of the step times
                decode_s.append(dt)
                decode_tokens += eng.stats["tokens_out"] - st["tokens_out"]
        counts, body_counts = split_bodies(kernels.launch_counts())
        finite.append(flags.all())
    finally:
        engine_mod.forward_step, sharded_mod.make_sharded_step = base_forward, base_make_step
        llama_mod.forward_step = base_model_forward
    outs = [eng.requests[r].out for r in rids]
    if not all(bool(f) for f in finite):
        raise AssertionError(f"{phase}: non-finite logits")
    if not all(len(o) == new_tokens and all(0 <= x < cfg.vocab for x in o) for o in outs):
        raise AssertionError(f"{phase}: missing tokens or tokens outside the vocab")
    st = eng.stats
    n_pre, n_dec = st["prefill_dispatches"], st["decode_dispatches"]
    # forward calls of the decode path: every dispatch runs multi_step steps,
    # and the first of a captured run also its eager run before the capture
    calls = n_dec * multi_step + (multi_step if multi_step > 1 else 0)
    ranks = 1 if mesh is None else mesh.grid.size
    per_step = {k: n * ranks for k, n in zip(kernels_used, (calls, calls, n_pre)) if k}
    if cfg.moe is not None:  # every call, the scheme's MoE kernels in every layer
        per_step.update({k: v * (calls + n_pre) * ranks for k, v in MOE_PER_CALL[cfg.moe.scheme].items()})
    if mesh is not None:  # two fused collectives a layer, one launch per tp group
        per_step["allreduce_rmsnorm"] = 2 * (calls + n_pre) * mesh.grid.shape[0]
    expect = {k: per_step.get(k, 0) * cfg.layers for k in counts}
    if counts != expect or min(counts[k] for k in per_step) == 0:
        raise AssertionError(f"{phase}: launch counts {counts} != expected {expect}")
    if sum(body_counts.values()) != counts["gg_scatter"]:  # the serving path's e4m3 GEMMs
        raise AssertionError(f"{phase}: e4m3 grouped-GEMM launches by body {body_counts}, "
                             f"{counts['gg_scatter']} in all")
    stats = dict(config=config, int8_kv=cfg.int8_kv, fp8_kv=cfg.fp8_kv, dense_int8=cfg.dense_int8,
                 kv_scale=cfg.kv_scale,
                 residual_alpha=cfg.residual_alpha, layers=cfg.layers, prompt_lens=lens,
                 new_tokens=new_tokens, prefill_calls=n_pre, prefill_s_total=sum(prefill_s),
                 prefill_s_each=prefill_s, prefill_tokens_per_s=sum(lens) / sum(prefill_s),
                 decode_steps=n_dec, decode_steps_timed=len(decode_s),
                 decode_ms_per_step=1e3 * sum(decode_s) / len(decode_s) / multi_step,
                 decode_tokens_per_s=decode_tokens / sum(decode_s),
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 launches=counts, e4m3_launches_by_body=bodies, first_tokens=[o[:4] for o in outs])
    DECODE_MS[phase] = stats["decode_ms_per_step"]
    if multi_step > 1:
        graph = eng._multi if mesh is None else eng._multi.graph
        stats.update(multi_step=multi_step, decode_dispatches=n_dec,
                     decode_ms_per_dispatch=1e3 * sum(decode_s) / len(decode_s),
                     capture_dispatch_s=capture_dispatch_s, graph=graph.stats,
                     graph_launches_per_replay=graph.launches)
    return stats, counts, prefill_logits, eng, profiled


def prefill_profile(eng, cfg):
    """torch.profiler over one prefill call of a 512-token prompt (the longest
    of the MoE runs' prompts) on ``eng`` after its serving run: device ms by
    kernel class, the grouped GEMMs' ms and share of the device's busy time,
    and the idle share of the call's wall time. Says how far the grouped
    GEMMs can move prefill tokens/s."""
    import torch

    eng.add_request(full_prompts(cfg.vocab, 512)[1][1], max_new=1)
    torch.cuda.synchronize()
    prof = DecodeProfile(torch, {"paged_prefill": "paged_prefill", "rope_store": "rope_store",
                                 **{k: k for k in MOE_CLASSES}})
    if not eng.step() or eng.stats["pending"]:
        raise AssertionError("prefill_profile: the step was not one whole prefill call")
    prof.steps = 1
    prof.stop()
    while eng.step():
        pass
    out = prof.summary()
    gg = sum(ms for name, ms in out["device_ms_per_step"].items() if name.startswith("gg_"))
    busy = out["device_busy_ms_per_step"]  # 0 if the session recorded no kernel
    return dict(prompt_tokens=512, grouped_gemm_ms=gg, grouped_gemm_share=gg / busy if busy else None,
                **out)


def slice_full(dev, w):
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    stats, counts, prefill_logits, eng, profiled = serve_full(dev, cfg, w, "slice_full", BF16_KERNELS)
    tokens = [r.out for r in eng.requests.values()]
    del eng
    torch.cuda.empty_cache()
    emit("slice_full", **stats)
    emit("decode_profile", **profiled.summary())
    return counts, prefill_logits, tokens


TP_FULL = 4  # slice_full_tp's tp ranks: 8 q heads, 2 kv heads and 3584 MLP columns each


def slice_full_tp(dev, w, bf16_prefill_logits, bf16_tokens):
    """ShardedEngine(llama3_8b) at full width and depth on a (dp 1, tp 4) mesh
    of virtual ranks on the card, over slice_full's weights sharded once:
    the serving stats, prefill logits within cosine 0.98 of the single-device
    bf16 run's, the one_shot collective launched twice a layer and call (one
    launch for all four ranks) and its plain version never, one
    device-to-host copy a profiled decode step; the share of greedy tokens
    equal to the single-device run's is reported, not gated."""
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.parallel import collective_kernels, make_mesh

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    mesh = make_mesh(tp=TP_FULL, dp=1, devices=[dev] * TP_FULL)
    plain_calls = []
    base_plain = collective_kernels._allreduce_rmsnorm_ref

    def counted_plain(*a, **kw):
        plain_calls.append(1)
        return base_plain(*a, **kw)

    collective_kernels._allreduce_rmsnorm_ref = counted_plain
    try:
        stats, counts, prefill_logits, eng, profiled = serve_full(
            dev, cfg, w, "slice_full_tp", BF16_KERNELS, mesh=mesh)
    finally:
        collective_kernels._allreduce_rmsnorm_ref = base_plain
    cos = prefill_cosines("slice_full_tp", prefill_logits, bf16_prefill_logits)
    calls = stats["prefill_calls"] + stats["decode_steps"]
    if counts["allreduce_rmsnorm"] != 2 * cfg.layers * calls or plain_calls:
        raise AssertionError(f"slice_full_tp: {counts['allreduce_rmsnorm']} collective launches for "
                             f"{calls} forward calls (want {2 * cfg.layers} each), {len(plain_calls)} "
                             "plain collectives")
    profile = profiled.summary()
    if profile["device_to_host_copies_per_step"] != 1:
        raise AssertionError("slice_full_tp: a decode step copies to the host "
                             f"{profile['device_to_host_copies_per_step']} times (expected 1)")
    tokens = [r.out for r in eng.requests.values()]
    same = sum(a == b for x, y in zip(tokens, bf16_tokens) for a, b in zip(x, y))
    del eng
    torch.cuda.empty_cache()
    emit("slice_full_tp", tp=TP_FULL, dp=1, prefill_cosine_vs_bf16=cos, prefill_cosine_min=min(cos),
         collective_launches_per_call=counts["allreduce_rmsnorm"] / calls,
         greedy_tokens_equal_to_single_device=same / sum(len(x) for x in bf16_tokens), **stats)
    emit("decode_profile_tp", **profile)
    return counts, tokens


MULTI_STEP, MULTI_NEW = 8, 128  # slice_full_multi*: 1 prefill token + 16 dispatches of 8 steps
MULTI_COMPARE = 32  # each request's first tokens held to the single-step run's


def prompt_margin(cfg, prefill):
    """``margin(tokens)``: the top-2 logit margin after a prefill of
    ``tokens`` by ``prefill(tokens, seq_lens, q_index, table, caches, n)``
    over fresh caches of its own."""
    import torch

    from hpc_ops_tpu_torch.utils.testing import top2_margin

    def margin(tokens):
        n = len(tokens)
        nb = -(-n // BS)
        t = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
        logits = prefill(t(tokens), t([n]), t([0, n]), t([list(range(nb))]), nb, n)
        return top2_margin(logits.float().reshape(-1))

    return margin


def hold_to_single_step(phase, want, got, prompts, margin, compare=None):
    """Each request's first ``compare`` (default MULTI_COMPARE) tokens of
    ``got`` (the multi-step run) against ``want`` (the single-step run) by
    ``assert_greedy_match``: a first difference is accepted only where
    ``margin`` (the reference's top-2 logit margin there) is below 0.15,
    and the comparison stops there. Returns (share of equal tokens,
    accepted flips)."""
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match

    compare = compare or MULTI_COMPARE
    flips, same = [], 0
    for i, (p, w, g) in enumerate(zip(prompts, want, got)):
        w, g = w[:compare], g[:compare]
        try:
            j = assert_greedy_match(w, g, lambda j, p=p, w=w: margin(p + w[:j]), ATOL_LOGITS)
        except AssertionError as e:
            raise AssertionError(f"{phase} request {i}: {e}") from None
        if j is not None:
            flips.append({"request": i, "step": j})
        same += sum(a == b for a, b in zip(w, g))
    return same / sum(len(w[:compare]) for w in want), flips


def slice_full_multi(dev, w, bf16_tokens, mesh=None, ref_phase="slice_full"):
    """Engine(llama3_8b, multi_step=8) (with ``mesh``: ShardedEngine over
    it) at full width and depth over slice_full's weights and prompts, batch
    8, greedy, 128 new tokens: each decode dispatch after the first is one
    replay of the captured graph, its launches counted through the replays
    (the collective at 2 x layers x steps); one device-to-host copy a
    profiled dispatch; the capture's cost and the graph's pool; each
    request's first 32 tokens held to ``ref_phase``'s run."""
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    phase = "slice_full_multi" if mesh is None else "slice_full_tp_multi"
    stats, counts, _, eng, profiled = serve_full(dev, cfg, w, phase, BF16_KERNELS, mesh=mesh,
                                                 multi_step=MULTI_STEP, new_tokens=MULTI_NEW)
    profile = profiled.summary()
    if profile["device_to_host_copies_per_dispatch"] != 1:
        raise AssertionError(f"{phase}: a dispatch copies to the host "
                             f"{profile['device_to_host_copies_per_dispatch']} times (expected 1)")
    graph = stats["graph"]
    if graph["host_memcpy_nodes"]:
        raise AssertionError(f"{phase}: the graph holds {graph['host_memcpy_nodes']} host copies")
    if mesh is not None and not (graph["collective_nodes"] == 2 * cfg.layers * MULTI_STEP
                                 == stats["graph_launches_per_replay"]["allreduce_rmsnorm"]):
        raise AssertionError(f"{phase}: {graph['collective_nodes']} collective nodes in the graph, "
                             f"want {2 * cfg.layers * MULTI_STEP}")
    tokens = [r.out for r in eng.requests.values()]
    _, prompts = full_prompts(cfg.vocab)
    if mesh is None:
        def prefill(toks, lens, qi, tbl, nb, n):
            caches = llama.init_cache(cfg, nb, BS, device=dev)
            return llama.forward_step(eng.weights, caches, cfg, toks, lens, qi, tbl, is_prefill=True,
                                      max_seqlens_q=n)[0]
    else:
        def prefill(toks, lens, qi, tbl, nb, n):
            caches = [[llama.init_cache(cfg, nb, BS, tp=TP_FULL, device=dev) for _ in range(TP_FULL)]]
            return llama.make_sharded_step(mesh, cfg, True, max_seqlens_q=n)(
                eng.weights, caches, toks, lens, qi, tbl)[0]
    share, flips = hold_to_single_step(phase, bf16_tokens, tokens, prompts, prompt_margin(cfg, prefill))
    del eng
    torch.cuda.empty_cache()
    emit(phase, **{f"greedy_tokens_equal_to_{ref_phase}": share, "near_tie_flips": flips,
                   "compared_tokens_per_request": MULTI_COMPARE, **stats})
    emit("decode_profile_multi" if mesh is None else "decode_profile_tp_multi", **profile)
    emit(f"{phase}_summary", decode_ms_per_step=stats["decode_ms_per_step"],
         device_busy_ms_per_step=profile["device_busy_ms_per_step"], idle_share=profile["idle_share"],
         device_busy_union_ms_per_step=profile["device_busy_union_ms_per_step"],
         idle_share_union=profile["idle_share_union"],
         launches_per_step=profile["kernel_launches_per_step"],
         device_to_host_copies_per_dispatch=profile["device_to_host_copies_per_dispatch"],
         capture_s=graph["capture_s"], instantiate_s=graph["instantiate_s"],
         graph_pool_bytes=graph["pool_bytes"], peak_memory_bytes=stats["max_memory_allocated_bytes"],
         graph_kernel_nodes=graph["kernel_nodes"], collective_nodes=graph["collective_nodes"],
         collective_nodes_cooperative=graph["collective_nodes_cooperative"])
    return counts


HYBRID = (2, 4)  # slice_full_hybrid: make_hybrid_mesh(2, 4), two row shards of 4 virtual tp ranks
# its eager run's new tokens: a host-bound eager step of the 8 ranks costs
# 0.37-0.60 s, so 12 tokens (8 timed steps after the 3 profiled ones) keep
# the phase inside the run's budget (PERF.md section 4)
HYBRID_EAGER_NEW = 12


def slice_full_hybrid(dev, w, bf16_prefill_logits, bf16_tokens):
    """ShardedEngine(llama3_8b) at full width and depth on
    make_hybrid_mesh(2, 4) of virtual ranks (JAX's multi-host layout and
    tests/test_multihost.py's mesh: request rows over ddp 2, each row shard
    a tp group of 4) over slice_full's weights, eager (32 new tokens) and
    with multi_step=8 (128 new tokens; one captured graph for both groups).
    Prefill logits within cosine 0.98 of the single-device run's, request by
    request; each request's first 12 (eager) and 32 (graph) tokens held to
    slice_full's by the near-tie rule; launch counts exact in serve_full (the one-launch
    collective twice a layer, call and group, the per-device form never);
    one device-to-host copy a profiled decode step or dispatch; a summary
    line for each run."""
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.parallel.mesh import make_hybrid_mesh

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    dcn, tp = HYBRID
    mesh = make_hybrid_mesh(dcn, tp, devices=[dev] * (dcn * tp))
    _, prompts = full_prompts(cfg.vocab)

    def prefill(toks, lens, qi, tbl, nb, n):  # slice_full's single-device model: the margins
        caches = llama.init_cache(cfg, nb, BS, device=dev)
        return llama.forward_step(w, caches, cfg, toks, lens, qi, tbl, is_prefill=True, max_seqlens_q=n)[0]

    margin = prompt_margin(cfg, prefill)
    counts = None
    for ms, new in ((1, HYBRID_EAGER_NEW), (MULTI_STEP, MULTI_NEW)):
        name = "slice_full_hybrid" if ms == 1 else "slice_full_hybrid_multi"
        stats, counts, prefill_logits, eng, profiled = serve_full(
            dev, cfg, w, name, BF16_KERNELS, mesh=mesh, multi_step=ms, new_tokens=new)
        profile = profiled.summary()
        copies = profile["device_to_host_copies_per_step" if ms == 1 else "device_to_host_copies_per_dispatch"]
        if copies != 1:
            raise AssertionError(f"{name}: {copies} device-to-host copies a decode step or dispatch (want 1)")
        # a prefill call gives one row a shard: requests 2i and 2i + 1 (least-loaded placement)
        rows = list(torch.cat(prefill_logits).view(-1, cfg.vocab))
        if len(rows) != len(bf16_prefill_logits):
            raise AssertionError(f"{name}: {len(rows)} prefill rows for {len(bf16_prefill_logits)} requests")
        cos = prefill_cosines(name, rows, bf16_prefill_logits)
        tokens = [r.out for r in eng.requests.values()]
        compare = min(new, MULTI_COMPARE)
        share, flips = hold_to_single_step(name, bf16_tokens, tokens, prompts, margin, compare)
        extra = {}
        if ms > 1:
            graph = stats["graph"]
            want_nodes = 2 * cfg.layers * ms * dcn
            replayed = stats["graph_launches_per_replay"]["allreduce_rmsnorm"]
            if graph["host_memcpy_nodes"] or not graph["collective_nodes"] == want_nodes == replayed:
                raise AssertionError(f"{name}: graph {graph}, want {want_nodes} collective nodes and no host copy")
            extra = dict(capture_s=graph["capture_s"], instantiate_s=graph["instantiate_s"],
                         graph_pool_bytes=graph["pool_bytes"], collective_nodes=graph["collective_nodes"])
        del eng
        torch.cuda.empty_cache()
        emit(name, ddp=dcn, dp=1, tp=tp, prefill_cosine_vs_bf16=cos, prefill_cosine_min=min(cos),
             greedy_tokens_equal_to_slice_full=share, near_tie_flips=flips,
             compared_tokens_per_request=compare, **stats)
        emit(f"decode_profile_{name[len('slice_full_'):]}", **profile)
        emit(f"{name}_summary", decode_ms_per_step=stats["decode_ms_per_step"],
             device_busy_ms_per_step=profile["device_busy_ms_per_step"], idle_share=profile["idle_share"],
             device_busy_union_ms_per_step=profile["device_busy_union_ms_per_step"],
             idle_share_union=profile["idle_share_union"],
             launches_per_step=profile["kernel_launches_per_step"], device_to_host_copies=copies,
             peak_memory_bytes=stats["max_memory_allocated_bytes"], prefill_cosine_min=min(cos),
             greedy_tokens_equal_to_slice_full=share, **extra)
    return counts


SAMPLER_SHAPE = (64, 120832)  # hpc_ops_tpu/ops/sampler.py:80-83: the approx top-k's measured shape


def sampler_approx(dev):
    """fused_sampler(topk_impl="approx") on the card at the JAX docstring's
    [64, 120832], max_topk 64: the binned top-k (PartialReduce's algorithm,
    ops/sampler.py:_approx_max_k) against the exact path's stable sort,
    device ms of each (torch.profiler), the recall of the exact top-64,
    every value the logit at its index, values sorted descending; and the
    whole sampler (temperature 0.8, top-k 50) with each impl. The bound:
    the logits read once."""
    import torch

    from hpc_ops_tpu_torch.ops import sampler as S

    b, v = SAMPLER_SHAPE
    k = 64
    gen = torch.Generator(device=dev).manual_seed(77)
    logits = torch.randn((b, v), generator=gen, device=dev) * 3
    noise = S.gumbel_from_uniform(torch.rand((b, v), generator=gen, device=dev))
    vals, idx = S._approx_max_k(logits, k)
    exact = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :k]
    if not torch.equal(vals, torch.gather(logits, 1, idx)) or not bool((vals[:, :-1] >= vals[:, 1:]).all()):
        raise AssertionError("sampler_approx: values not the logits at their indices, or not sorted")
    found = sum(len(set(a) & set(c)) for a, c in zip(idx.tolist(), exact.tolist()))
    recall = found / (b * k)
    if recall < 0.95:
        raise AssertionError(f"sampler_approx: recall {recall} < 0.95")
    approx_ms = device_ms(lambda: S._approx_max_k(logits, k))
    exact_ms = device_ms(lambda: torch.sort(logits, dim=-1, descending=True, stable=True))
    sampler_ms = {impl: device_ms(lambda impl=impl: S.fused_sampler(
        logits, temperature=0.8, topk=50, max_topk=k, gumbel_noise=noise, topk_impl=impl))
        for impl in ("exact", "approx")}
    bd, by = bound(b * v * 4, 0)
    emit("sampler_approx", batch=b, vocab=v, k=k, bins=-(-v // S._bins(v, k, 0.95)), recall=recall,
         topk_approx_ms=approx_ms, topk_exact_ms=exact_ms, sampler_exact_ms=sampler_ms["exact"],
         sampler_approx_ms=sampler_ms["approx"], bound_ms=bd, bound_by=by)


def distinct_devices(dev):
    """A mesh over distinct cards, with 2 or more on the machine: the fused
    collective on make_mesh(tp=2) over cards 0 and 1 (the per-device form,
    each launch reading its peer's partial over peer memory) bit-equal to
    the plain version in both schedules; ShardedEngine on tiny_config over
    a rank a card (make_mesh(tp=2)) and a tp group a card
    (make_hybrid_mesh(2, 2)), eager and multi_step=4, each equal to the
    same mesh of virtual ranks on card 0. With one card it prints that it
    did not run. Returns the per-device collective's launches."""
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.parallel import make_mesh
    from hpc_ops_tpu_torch.parallel.collective_kernels import _allreduce_rmsnorm_ref, allreduce_rmsnorm_rank
    from hpc_ops_tpu_torch.parallel.collective_kernels import collective_rmsnorm
    from hpc_ops_tpu_torch.parallel.mesh import make_hybrid_mesh, run_ranks
    from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine

    cards = torch.cuda.device_count()
    if cards < 2:
        emit("distinct_devices", ran=False, cards=cards, reason="a mesh over distinct devices needs 2 cards")
        return 0
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    r0 = allreduce_rmsnorm_rank.launches
    gen = torch.Generator().manual_seed(5)
    mesh = make_mesh(tp=2, devices=devs)
    xs = [(torch.randn((64, 4096), generator=gen) * 0.5).to(torch.bfloat16) for _ in range(2)]
    res = torch.randn((64, 4096), generator=gen).to(torch.bfloat16)
    w_ = torch.rand(4096, generator=gen) + 0.5
    for mode in ("one_shot", "two_shot"):
        want = _allreduce_rmsnorm_ref(xs, res, w_, 1e-5, mode, False)
        outs = run_ranks(mesh, lambda g, _: collective_rmsnorm(g, xs[g.rank].to(g.device), res.to(g.device),
                                                               w_.to(g.device), 1e-5, mode, False))[0]
        for d in devs:
            torch.cuda.synchronize(d)
        if not all(torch.equal(o.cpu(), want[0]) and torch.equal(r_.cpu(), want[1]) for o, r_ in outs):
            raise AssertionError(f"distinct_devices: the {mode} collective over two cards is not bit-equal")
    cfg = llama.tiny_config()
    w = llama.init_weights(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61))]
    served = {}
    for layout, (over, virtual) in {
            "rank_a_card": (lambda: make_mesh(tp=2, devices=devs), lambda: make_mesh(tp=2, devices=[dev] * 2)),
            "group_a_card": (lambda: make_hybrid_mesh(2, 2, devices=[devs[0], devs[0], devs[1], devs[1]]),
                             lambda: make_hybrid_mesh(2, 2, devices=[dev] * 4))}.items():
        for ms in (1, 4):
            got, want = (ShardedEngine(cfg, w, m(), num_blocks=64, block_size=BS, max_batch=4,
                                       multi_step=ms).run(prompts, max_new=12) for m in (over, virtual))
            if got != want:
                raise AssertionError(f"distinct_devices {layout} multi_step={ms}: {got} != {want}")
            served[f"{layout}_ms{ms}"] = True
    emit("distinct_devices", ran=True, cards=cards, collective_bit_equal=True, served_equal=served,
         per_device_launches=allreduce_rmsnorm_rank.launches - r0)
    return allreduce_rmsnorm_rank.launches - r0


# ------------------------------------------ the rest of the serving engine
SERVE_CLASSES = {"rope_store": "rope_store", "paged_decode": "paged_decode", "paged_prefill": "paged_prefill"}
SPEC_NEW = 32  # new tokens a request in slice_full_spec
SEGMENT = 64  # slice_full_spec: the n-gram prompts' random segment and its continuation
SYSTEM_PROMPT, PREFIX_NEW = 1024, 16  # slice_full_prefix: the shared prompt's tokens (64 pages)
SAMPLING_N, SAMPLING_NEW = 4, 32  # slice_full_sampling: continuations of one prompt, new tokens
DECODE_MS = {}  # serve_full's decode ms a step by phase (slice_full: eager; slice_full_multi: graph)


def full_engine(dev, w, cfg, **kw):
    from hpc_ops_tpu_torch.runtime.engine import Engine

    return Engine(cfg, w, num_blocks=NUM_BLOCKS, block_size=BS, max_batch=8, device=dev, **kw)


def bf16_margin(cfg, w, dev):
    """``margin(tokens)``: the top-2 logit margin after a bf16 prefill of
    ``tokens`` on the card (the reference side of the near-tie rule)."""
    from hpc_ops_tpu_torch.models import llama

    def prefill(toks, lens, qi, tbl, nb, n):
        caches = llama.init_cache(cfg, nb, BS, device=dev)
        return llama.forward_step(w, caches, cfg, toks, lens, qi, tbl, is_prefill=True, max_seqlens_q=n)[0]

    return prompt_margin(cfg, prefill)


def drive(eng, phase):
    """Step ``eng`` until it has no work, synchronised around each step: the
    seconds of its prefill and decode steps, the tokens the decode steps
    added, the rows its prefill calls ran, torch.profiler over the second
    prefill call of this call (device and wall ms) and over its second
    decode dispatch, which must copy to the host once (both left out of the
    step times)."""
    import torch

    from hpc_ops_tpu_torch.runtime import engine as engine_mod

    base_forward, rows = engine_mod.forward_step, []

    def counted(*a, **kw):
        if kw.get("is_prefill"):
            rows.append(int(kw["token_ids"].shape[0]))
        return base_forward(*a, **kw)

    prefill_s, decode_s, decode_tokens, decode_rows, n_dec, n_pre = [], [], 0, 0, 0, 0
    profile = prefill_profile = None
    engine_mod.forward_step = counted
    try:
        while True:
            st = eng.stats
            decode_next = st["pending"] == 0 and st["active"] > 0
            n_dec += decode_next
            n_pre += not decode_next
            prof = (DecodeProfile(torch, SERVE_CLASSES)
                    if (decode_next and n_dec == 2) or (not decode_next and n_pre == 2) else None)
            torch.cuda.synchronize()
            t = time.perf_counter()
            more = eng.step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if prof is not None:
                prof.steps = 1
                prof.stop()
                if decode_next:
                    profile = prof.summary()
                else:
                    prefill_profile = {k: prof.summary()[k] for k in (
                        "device_busy_ms_per_step", "wall_ms_per_step", "device_ms_per_step")}
            elif decode_next:
                decode_s.append(dt)
                decode_rows += min(st["active"], eng.max_batch)
                decode_tokens += eng.stats["tokens_out"] - st["tokens_out"]
            elif more:
                prefill_s.append(dt)
            if not more:
                break
    finally:
        engine_mod.forward_step = base_forward
    if profile is None or profile["device_to_host_copies_per_step"] != 1:
        raise AssertionError(f"{phase}: a profiled decode step copies to the host "
                             f"{None if profile is None else profile['device_to_host_copies_per_step']} "
                             "times (expected 1)")
    return dict(prefill_s=sum(prefill_s), prefill_calls_timed=len(prefill_s), prefill_rows=sum(rows),
                second_prefill_call=prefill_profile, decode_s=sum(decode_s),
                decode_steps_timed=len(decode_s), decode_tokens=decode_tokens, decode_rows=decode_rows,
                profile=profile)


def spec_run(dev, cfg, w, prompts, k, draft_fn, phase):
    """Engine(speculative_k=k) serving ``prompts`` x SPEC_NEW tokens: its
    tokens, counters, decode ms an output token, the decode kernel's launches
    inside verification steps (one a layer and step, at sq = k + 1) and the
    device-to-host copies of a profiled verification step."""
    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.ops.attention.decode import paged_decode_attention

    eng = full_engine(dev, w, cfg, speculative_k=k, draft_fn=draft_fn)
    spec_steps, spec_launches = [], []
    base_spec = eng._spec_batch

    def counted_spec(drafts):
        before = paged_decode_attention.launches
        base_spec(drafts)
        spec_steps.append(1)
        spec_launches.append(paged_decode_attention.launches - before)

    eng._spec_batch = counted_spec
    rids = [eng.add_request(p, max_new=SPEC_NEW) for p in prompts]
    kernels.reset_launch_counts()
    run = drive(eng, phase)
    counts = kernels.launch_counts()
    del eng._spec_batch  # the closure holds the engine
    st = eng.stats
    if sum(spec_launches) != cfg.layers * len(spec_steps) or not spec_steps:
        raise AssertionError(f"{phase}: {sum(spec_launches)} decode launches in {len(spec_steps)} "
                             f"verification steps (want {cfg.layers} each)")
    ms_step = 1e3 * run["decode_s"] / run["decode_steps_timed"]
    per_request = run["decode_tokens"] / run["decode_rows"]
    out = dict(speculative_k=k, decode_dispatches=st["decode_dispatches"],
               verification_dispatches=len(spec_steps),
               tokens_per_dispatch=run["decode_tokens"] / max(run["decode_steps_timed"], 1),
               tokens_per_request_dispatch=per_request,
               acceptance=st["speculative"]["acceptance"], proposed=st["speculative"]["proposed"],
               accepted=st["speculative"]["accepted"], decode_ms_per_dispatch=ms_step,
               # a plain step gives each request one token: its ms a step is this
               decode_ms_per_output_token=ms_step / per_request,
               decode_launches_at_sq=(k + 1, sum(spec_launches)),
               device_to_host_copies_per_verification_step=run["profile"]["device_to_host_copies_per_step"],
               profiled_step_device_busy_ms=run["profile"]["device_busy_ms_per_step"],
               profiled_step_wall_ms=run["profile"]["wall_ms_per_step"], launches=counts)
    tokens = [eng.requests[r].out for r in rids]
    if any(len(o) != SPEC_NEW or not all(0 <= t < cfg.vocab for t in o) for o in tokens):
        raise AssertionError(f"{phase}: missing tokens or tokens outside the vocab")
    if eng.alloc.num_free != eng.alloc.num_blocks - 1:
        raise AssertionError(f"{phase}: {eng.alloc.num_free} free blocks after serving")
    del eng
    return tokens, out


def slice_full_spec(dev, w, bf16_tokens):
    """Speculative decode at llama3_8b width and depth over slice_full's
    weights: an oracle drafter fed by slice_full's tokens at k = 3 (tokens
    held to slice_full's by the near-tie rule, acceptance > 0.8), then the
    default ngram_draft at k = 3 and k = 7 on 8 prompts of a random 64-token
    segment, the model's greedy continuation of it and the segment again,
    held to a plain engine's tokens on them."""
    import numpy as np
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    _, prompts = full_prompts(cfg.vocab)
    fulls = [p + t for p, t in zip(prompts, bf16_tokens)]

    def oracle(tokens, k):
        for f in fulls:
            if len(f) > len(tokens) and f[: len(tokens)] == tokens:
                return f[len(tokens) : len(tokens) + k]
        return []

    margin = bf16_margin(cfg, w, dev)
    tokens, oracle_run = spec_run(dev, cfg, w, prompts, 3, oracle, "slice_full_spec")
    share, flips = hold_to_single_step("slice_full_spec", bf16_tokens, tokens, prompts, margin)
    if oracle_run["acceptance"] <= 0.8:
        raise AssertionError(f"slice_full_spec: oracle acceptance {oracle_run['acceptance']}")
    emit("slice_full_spec", run="oracle_k3", **oracle_run, greedy_tokens_equal_to_slice_full=share,
         near_tie_flips=flips)
    # ngram prompts: a random segment, the model's own greedy continuation of
    # it, the segment again; the drafter proposes the continuation's tokens
    # where the model repeats it (seeded weights do not continue a repeated
    # random segment, so a prompt of the segment alone gets no draft)
    rng = np.random.RandomState(21)
    segments = [[int(t) for t in rng.randint(0, cfg.vocab, SEGMENT)] for _ in range(8)]
    plain = full_engine(dev, w, cfg)
    conts = plain.run(segments, max_new=SEGMENT)
    ngram_prompts = [seg + cont + seg for seg, cont in zip(segments, conts)]
    want = plain.run(ngram_prompts, max_new=SPEC_NEW)
    del plain
    runs = {"oracle_k3": oracle_run}
    for k in (3, 7):
        got, run = spec_run(dev, cfg, w, ngram_prompts, k, None, f"slice_full_spec ngram k={k}")
        share, flips = hold_to_single_step(f"slice_full_spec ngram k={k}", want, got, ngram_prompts, margin)
        runs[f"ngram_k{k}"] = run
        emit("slice_full_spec", run=f"ngram_k{k}", **run, greedy_tokens_equal_to_plain=share,
             near_tie_flips=flips)
    torch.cuda.empty_cache()
    emit("slice_full_spec_summary", slice_full_eager_decode_ms_per_step=DECODE_MS.get("slice_full"),
         slice_full_multi_graph_decode_ms_per_step=DECODE_MS.get("slice_full_multi"),
         **{name: {key: run[key] for key in ("decode_dispatches", "tokens_per_dispatch",
                                              "tokens_per_request_dispatch", "acceptance",
                                              "decode_ms_per_dispatch", "decode_ms_per_output_token",
                                              "decode_launches_at_sq",
                                              "device_to_host_copies_per_verification_step")}
            for name, run in runs.items()})
    return {name: run["launches"] for name, run in runs.items()}


def slice_full_prefix(dev, w):
    """Prefix caching at llama3_8b width and depth: 8 prompts of one
    1024-token system prompt (64 pages) plus distinct 16-64-token suffixes x
    16 new tokens, then a second wave of 8 after the first finished, on an
    uncached engine and on Engine(prefix_cache=True): tokens held to the
    uncached engine's by the near-tie rule, 7 hits of 64 blocks in the first
    wave and 8 on the kept pages in the second; prefill rows and ms of
    both."""
    import numpy as np
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    rng = np.random.RandomState(23)
    system = [int(t) for t in rng.randint(0, cfg.vocab, SYSTEM_PROMPT)]
    waves = [[system + [int(t) for t in rng.randint(0, cfg.vocab, n)] for n in rng.randint(16, 65, 8)]
             for _ in range(2)]
    margin = bf16_margin(cfg, w, dev)
    out, counts = {}, {}
    for cached in (False, True):
        eng = full_engine(dev, w, cfg, prefix_cache=cached)
        free0 = eng.alloc.num_free
        kernels.reset_launch_counts()
        for i, prompts in enumerate(waves):
            rids = [eng.add_request(p, max_new=PREFIX_NEW) for p in prompts]
            run = drive(eng, f"slice_full_prefix cached={cached} wave {i}")
            hits = eng.stats["prefix_hits"], eng.stats["prefix_shared_blocks"]
            want_hits = (7 + 8 * i, (7 + 8 * i) * SYSTEM_PROMPT // BS) if cached else (0, 0)
            if hits != want_hits:
                raise AssertionError(f"slice_full_prefix wave {i}: hits, shared blocks {hits} != {want_hits}")
            out[(cached, i)] = dict(tokens=[eng.requests[r].out for r in rids], prefix_hits=hits[0],
                                    prefix_shared_blocks=hits[1], **run)
        counts["cached" if cached else "uncached"] = kernels.launch_counts()
        if not cached and eng.alloc.num_free != free0:
            raise AssertionError(f"slice_full_prefix: {free0 - eng.alloc.num_free} blocks not returned")
        del eng
    torch.cuda.empty_cache()
    for i, prompts in enumerate(waves):
        share, flips = hold_to_single_step(f"slice_full_prefix wave {i}", out[(False, i)]["tokens"],
                                           out[(True, i)]["tokens"], prompts, margin)
        runs = {("cached" if c else "uncached"): {k: v for k, v in out[(c, i)].items() if k != "tokens"}
                for c in (False, True)}
        emit("slice_full_prefix", wave=i, prompt_lens=[len(p) for p in prompts],
             greedy_tokens_equal_to_uncached=share, near_tie_flips=flips,
             prefill_rows_saved=runs["uncached"]["prefill_rows"] - runs["cached"]["prefill_rows"], **runs)
    return counts


def tail_page_prompt(prompts):
    """The first of slice_full's prompts (after the two fixed ones) whose last
    page is partial, so that its children copy a page."""
    return next(i for i, p in enumerate(prompts) if i >= 2 and len(p) % BS)


def slice_full_sampling(dev, w, bf16_tokens):
    """n > 1 and the full sampler at llama3_8b width and depth: add_request(n=4)
    at temperature 0.8 with topk=1 (every continuation slice_full's greedy
    tokens by the near-tie rule; the children's copied tail pages equal the
    parent's in every layer); then topk=50, topp=0.9 with a greedy
    per-request row (slice_full's tokens) beside an n=4 request, and with
    repetition_penalty=1.1 an n=4 request beside a per-request temperature
    row (JAX's engine refuses a greedy row under the penalty): tokens in the
    vocab, children that diverge, every block returned, one device-to-host
    copy a profiled step."""
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    _, prompts = full_prompts(cfg.vocab)
    margin = bf16_margin(cfg, w, dev)
    i = tail_page_prompt(prompts)
    j = next(x for x in range(2, len(prompts)) if x != i)
    lines, counts = {}, {}
    # 1. n = 4 at topk=1: greedy continuations; the copied tail pages
    eng = full_engine(dev, w, cfg, temperature=0.8, seed=3)
    free0 = eng.alloc.num_free
    kernels.reset_launch_counts()
    rids = eng.add_request(prompts[i], max_new=SAMPLING_NEW, n=SAMPLING_N, topk=1)
    eng.step()  # the prefill, the forks and the page copies
    pt = eng.alloc.table(rids[0])
    last = len(prompts[i]) // BS
    for c in rids[1:]:
        ct = eng.alloc.table(c)
        if not (ct[:last] == pt[:last]).all() or ct[last] == pt[last]:
            raise AssertionError("slice_full_sampling: the children's pages are not the parent's "
                                 "full pages and a tail page of their own")
        for layer in eng.caches:
            for t in layer.values():
                if not torch.equal(t[:, int(ct[last])], t[:, int(pt[last])]):
                    raise AssertionError("slice_full_sampling: a copied tail page differs from the parent's")
    run = drive(eng, "slice_full_sampling topk1")
    outs = [eng.requests[r].out for r in rids]
    share, flips = hold_to_single_step("slice_full_sampling topk1", [bf16_tokens[i]] * SAMPLING_N, outs,
                                       [prompts[i]] * SAMPLING_N, margin)
    if eng.alloc.num_free != free0:
        raise AssertionError("slice_full_sampling topk1: blocks not returned")
    counts["topk1_n4"] = kernels.launch_counts()
    lines["topk1_n4"] = dict(greedy_tokens_equal_to_slice_full=share, near_tie_flips=flips,
                             copied_tail_page_equal_in_layers=cfg.layers, **run)
    del eng
    # 2. and 3. the full sampler, without and with the repetition penalty
    for name, penalty in (("topk50_topp09", 0.0), ("topk50_topp09_penalty11", 1.1)):
        eng = full_engine(dev, w, cfg, temperature=0.8, topk=50, topp=0.9, repetition_penalty=penalty,
                          seed=4)
        free0 = eng.alloc.num_free
        kernels.reset_launch_counts()
        row = eng.add_request(prompts[i], max_new=SAMPLING_NEW, temperature=1.0 if penalty else 0.0)
        kids = eng.add_request(prompts[j], max_new=SAMPLING_NEW, n=SAMPLING_N)
        run = drive(eng, f"slice_full_sampling {name}")
        outs = [eng.requests[r].out for r in [row] + kids]
        if not all(len(o) == SAMPLING_NEW and all(0 <= t < cfg.vocab for t in o) for o in outs):
            raise AssertionError(f"slice_full_sampling {name}: missing tokens or tokens outside the vocab")
        distinct = len({tuple(o) for o in outs[1:]})
        if distinct < 2:
            raise AssertionError(f"slice_full_sampling {name}: the children did not diverge")
        if eng.alloc.num_free != free0:
            raise AssertionError(f"slice_full_sampling {name}: blocks not returned")
        extra = {}
        if not penalty:
            share, flips = hold_to_single_step(f"slice_full_sampling {name}", [bf16_tokens[i]], outs[:1],
                                               [prompts[i]], margin)
            extra = dict(greedy_row_equal_to_slice_full=share, near_tie_flips=flips)
        counts[name] = kernels.launch_counts()
        lines[name] = dict(distinct_children=distinct, **extra, **run)
        del eng
    torch.cuda.empty_cache()
    for name, line in lines.items():
        emit("slice_full_sampling", run=name, prompt_len=len(prompts[i]), **line)
    return counts


RING_WS, RING_S_LOC = 4, 2048  # ring_attention: virtual ranks, tokens a rank
RING_TOL = 2e-4  # tests/test_ring_attention.py's bar


def ring_attention_phase(dev):
    """ring_attention on 4 virtual ranks of the card at llama3_8b's heads (Hq
    32, Hkv 8, D 128), 4 x 2048 tokens, float32 with TF32 off: ring causal,
    ring non-causal and zigzag against SDPA over the gathered sequence
    (within 2e-4), each schedule's ms and SDPA's."""
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.parallel import make_mesh, ring_attention
    from hpc_ops_tpu_torch.parallel.mesh import run_ranks
    from hpc_ops_tpu_torch.parallel.ring_attention import zigzag_layout, zigzag_unlayout

    gen = torch.Generator(device=dev).manual_seed(31)
    s = RING_WS * RING_S_LOC
    q = torch.randn((1, s, HQ, D), generator=gen, device=dev)
    k, v = (torch.randn((1, s, HKV, D), generator=gen, device=dev) for _ in range(2))
    mesh = make_mesh(tp=RING_WS, devices=[dev] * RING_WS)
    g = HQ // HKV
    kx, vx = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    lines = {}
    for causal in (True, False):
        def sdpa(causal=causal):
            return F.scaled_dot_product_attention(q.transpose(1, 2), kx, vx, is_causal=causal).transpose(1, 2)

        want = sdpa()
        sdpa_ms = time_ms(sdpa, 3, 1)
        for schedule in ("ring", "zigzag") if causal else ("ring",):
            xs = [zigzag_layout(x, RING_WS) if schedule == "zigzag" else x for x in (q, k, v)]
            shards = [[t.contiguous() for t in torch.chunk(x, RING_WS, dim=1)] for x in xs]

            def call(schedule=schedule, shards=shards, causal=causal):
                return run_ranks(mesh, lambda grp, _: ring_attention(
                    *(sh[grp.rank] for sh in shards), grp, causal=causal, schedule=schedule))[0]

            got = torch.cat(call(), dim=1)
            if schedule == "zigzag":
                got = zigzag_unlayout(got, RING_WS)
            err = float((got - want).abs().max())
            if not err < RING_TOL:
                raise AssertionError(f"ring_attention {schedule} causal={causal}: max abs err {err}")
            lines[f"{schedule}_{'causal' if causal else 'full'}"] = dict(
                max_abs_err=err, ms=time_ms(call, 3, 1), sdpa_ms=sdpa_ms)
        del want
    torch.cuda.empty_cache()
    emit("ring_attention", ranks=RING_WS, tokens_per_rank=RING_S_LOC, hq=HQ, hkv=HKV, d=D,
         dtype="float32", tf32=torch.backends.cuda.matmul.allow_tf32, tolerance=RING_TOL, **lines)


def hf_view(w, cfg):
    """slice_full's weights seen, without a copy, as a transformers-named
    module tree: HF's [out, in] weights as ``.T`` views of the port's [in,
    out] matrices, the q|k|v and gate|up column blocks as column slices."""
    from types import SimpleNamespace as NS

    qd, kd, inter = cfg.q_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim, cfg.intermediate

    def lin(t):
        return NS(weight=t, bias=None)

    layers = []
    for L in w["layers"]:
        wqkv, gu = L["wqkv"], L["w_gate_up"]
        layers.append(NS(
            self_attn=NS(q_proj=lin(wqkv[:, :qd].T), k_proj=lin(wqkv[:, qd : qd + kd].T),
                         v_proj=lin(wqkv[:, qd + kd :].T), o_proj=lin(L["wo"].T)),
            mlp=NS(gate_proj=lin(gu[:, :inter].T), up_proj=lin(gu[:, inter:].T), down_proj=lin(L["w_down"].T)),
            input_layernorm=lin(L["attn_norm"]), post_attention_layernorm=lin(L["mlp_norm"])))
    config = NS(vocab_size=cfg.vocab, hidden_size=cfg.hidden, num_hidden_layers=cfg.layers,
                num_attention_heads=cfg.q_heads, num_key_value_heads=cfg.kv_heads, head_dim=cfg.head_dim,
                intermediate_size=cfg.intermediate, rope_theta=cfg.rope_base, rms_norm_eps=cfg.norm_eps,
                max_position_embeddings=cfg.max_position, tie_word_embeddings=False, rope_scaling=None)
    return NS(config=config, lm_head=lin(w["lm_head"].T),
              model=NS(embed_tokens=lin(w["embed"]), norm=lin(w["final_norm"]), layers=layers))


def tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], f"{prefix}/{key}")
    elif isinstance(tree, list):
        for n, x in enumerate(tree):
            yield from tree_items(x, f"{prefix}/{n}")
    else:
        yield prefix, tree


def convert_phase(dev, w):
    """from_hf_llama on the card over slice_full's weights seen as a
    transformers-named tree: every tensor equal to slice_full's (the norms,
    float32 ones in slice_full, come back as bf16 ones: the converter casts to
    its dtype), and with dense_int8=True the codes and scales of
    slice_full_w8a8's quantize_w8, column-major; seconds and peak memory of
    each."""
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.models.convert import from_hf_llama

    cfg = llama.llama3_8b()
    hf = hf_view(w, cfg)
    lines = {}
    for int8 in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ccfg, cw = from_hf_llama(hf, dense_int8=int8, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        if ccfg != cfg._replace(dense_int8=int8):
            raise AssertionError(f"convert: config {ccfg} != llama3_8b")
        want = w
        if int8:
            want = {**w, "layers": []}
            for L in w["layers"]:
                q = dict(L)
                for name in ("wqkv", "wo", "w_gate_up", "w_down"):
                    q[name], q[name + "_scale"] = llama.quantize_w8(L[name])
                want["layers"].append(q)
        got, ref = dict(tree_items(cw)), dict(tree_items(want))
        if sorted(got) != sorted(ref):
            raise AssertionError(f"convert: names {sorted(set(got) ^ set(ref))} differ")
        recast = []
        for name, g in got.items():
            r = ref[name]
            if g.shape != r.shape or (g.dtype == torch.int8 and g.stride() != r.stride()):
                raise AssertionError(f"convert {name}: shape or layout differs")
            if g.dtype != r.dtype:  # the norms: dtype (bf16) ones for float32 ones
                recast.append(name)
                ok = torch.equal(g.to(r.dtype), r) and torch.equal(r.to(g.dtype), g)
            else:
                ok = torch.equal(g, r)
            if not ok:
                raise AssertionError(f"convert {name}: differs from slice_full's")
        lines["dense_int8" if int8 else "bf16"] = dict(seconds=secs, peak_extra_bytes=peak,
                                                       tensors=len(got), cast_tensors=len(recast))
        del cw, want, got, ref
        torch.cuda.empty_cache()
    emit("convert", config="llama3_8b", **lines)


REPLAY_TOKENS = 512  # replay: the row-17 call's rows at Mixtral width (2 x 14336 columns)


def replay_phase(dev):
    """TraceHook around one act_mul_and_quant call at Mixtral-8x7B width on the
    card (row 17's kernel), replayed from memory and from disk (under
    build/replay), bit-identical; the kernel's launches (1 recorded + 2 x 2
    replayed)."""
    import torch

    import hpc_ops_tpu_torch.ops.activation as act_mod
    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.utils.replay import TraceHook, replay_record

    out_dir = os.path.join(ROOT, "build", "replay")
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn((REPLAY_TOKENS, 2 * 14336), generator=gen, device=dev).to(torch.bfloat16)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with TraceHook([act_mod.act_mul_and_quant], out_dir=out_dir) as hook:
        act_mod.act_mul_and_quant(x, torch.tensor([1.7], device=dev))
    rec = hook.records[0]
    replay_record(rec)
    replay_record(rec.path)
    counts = kernels.launch_counts()
    if counts["act_quant"] != 5:
        raise AssertionError(f"replay: {counts['act_quant']} row-17 launches (want 5)")
    emit("replay", op="act_mul_and_quant", shape=list(x.shape), record_bytes=os.path.getsize(rec.path),
         seconds=time.perf_counter() - t0, bit_identical=True, act_quant_launches=counts["act_quant"])
    os.remove(rec.path)
    return counts


def slice_full_int8(dev, w, bf16_prefill_logits):
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(int8_kv=True, residual_alpha=1.0 / 8)
    stats, counts, prefill_logits, eng, profiled = serve_full(
        dev, cfg, w, "slice_full_int8", INT8_KERNELS)
    cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=0))
           for a, b in zip(prefill_logits, bf16_prefill_logits)]
    if len(cos) != len(bf16_prefill_logits) or cos[0] < 0.98:
        raise AssertionError(f"slice_full_int8: first prefill logits at cosine {cos[0]} of bf16's "
                             "(limit 0.98)")
    # saturation: codes at +-127 among the codes the run wrote (nonzero)
    sat = nonzero = 0
    for c in eng.caches:
        sat += int((c["kv"].abs() == 127).sum())
        nonzero += int((c["kv"] != 0).sum())
    del eng
    torch.cuda.empty_cache()
    emit("slice_full_int8", prefill_cosine_vs_bf16=cos, prefill_cosine_min=min(cos),
         saturated_codes=sat, nonzero_codes=nonzero, saturated_share=sat / max(nonzero, 1), **stats)
    emit("decode_profile_int8", **profiled.summary())
    return counts


def prefill_cosines(phase, prefill_logits, bf16_prefill_logits):
    """Cosine of each prefill call's last-token logits against the bf16 run's."""
    import torch

    cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=0))
           for a, b in zip(prefill_logits, bf16_prefill_logits)]
    if len(cos) != len(bf16_prefill_logits) or min(cos) < 0.98:
        raise AssertionError(f"{phase}: prefill logits at cosines {cos} of bf16's (limit 0.98)")
    return cos


def slice_full_fp8(dev, w, bf16_prefill_logits):
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(fp8_kv=True, residual_alpha=1.0 / 8)
    stats, counts, prefill_logits, eng, profiled = serve_full(
        dev, cfg, w, "slice_full_fp8", FP8_KERNELS)
    cos = prefill_cosines("slice_full_fp8", prefill_logits, bf16_prefill_logits)
    if any(c[n].dtype != torch.float8_e4m3fn for c in eng.caches for n in ("k", "v")):
        raise AssertionError("slice_full_fp8: the caches are not float8_e4m3fn")
    # saturation: codes at +-448 (0x7e) among the codes the run wrote (nonzero)
    sat = nonzero = 0
    for c in eng.caches:
        for n in ("k", "v"):
            mag = c[n].view(torch.uint8) & 0x7F
            sat += int((mag == 0x7E).sum())
            nonzero += int((mag != 0).sum())
    del eng
    torch.cuda.empty_cache()
    emit("slice_full_fp8", prefill_cosine_vs_bf16=cos, prefill_cosine_min=min(cos),
         saturated_codes=sat, nonzero_codes=nonzero, saturated_share=sat / max(nonzero, 1), **stats)
    profile = profiled.summary()
    emit("decode_profile_fp8", **profile)
    if profile["device_to_host_copies_per_step"] != 1:
        raise AssertionError("slice_full_fp8: a decode step copies to the host "
                             f"{profile['device_to_host_copies_per_step']} times (expected 1)")
    return counts


def slice_full_w8a8(dev, w, bf16_prefill_logits):
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(dense_int8=True, residual_alpha=1.0 / 8)
    names = ("wqkv", "wo", "w_gate_up", "w_down")
    t0 = time.perf_counter()
    layers = []
    for layer in w["layers"]:  # int8 copies (7 GB) beside the bf16 weights, one layer at a time
        q = dict(layer)
        for name in names:
            q[name], q[name + "_scale"] = llama.quantize_w8(layer[name])
        layers.append(q)
    w8 = {**w, "layers": layers}
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    # the library's int8 product on one weight (gate-up, 4096 x 28672) at the
    # decode step's 32 padded rows: the column-major codes quantize_w8 makes,
    # the same codes row-major, and the bf16 product of the step's 8 rows
    g8 = layers[0]["w_gate_up"]
    x8 = torch.randint(-127, 128, (32, g8.shape[0]), dtype=torch.int8, device=dev)
    xb = torch.randn((8, g8.shape[0]), device=dev).to(torch.bfloat16)
    g8_rows = g8.contiguous()
    product_ms = {
        "int8_column_major": time_ms(lambda: torch._int_mm(x8, g8), 50),
        "int8_row_major": time_ms(lambda: torch._int_mm(x8, g8_rows), 50),
        "bf16": time_ms(lambda: xb @ w["layers"][0]["w_gate_up"], 50),
        "int8_bytes_bound": g8.numel() / HBM_BYTES_PER_S * 1e3,
    }
    del g8_rows
    stats, counts, prefill_logits, eng, profiled = serve_full(
        dev, cfg, w8, "slice_full_w8a8", BF16_KERNELS)
    cos = prefill_cosines("slice_full_w8a8", prefill_logits, bf16_prefill_logits)
    del eng, w8, layers
    torch.cuda.empty_cache()
    emit("slice_full_w8a8", prefill_cosine_vs_bf16=cos, prefill_cosine_min=min(cos),
         quantize_seconds=quantize_s, gate_up_product_ms=product_ms, **stats)
    emit("decode_profile_w8a8", **profiled.summary())
    return counts


def mixtral_8x7b(scheme="pertensor_fp8"):
    """The published Mixtral-8x7B-v0.1 widths, experts as per-tensor fp8 (or int8)."""
    from hpc_ops_tpu_torch.models import llama

    return llama.ModelConfig(
        vocab=32000, hidden=4096, layers=32, q_heads=32, kv_heads=8, head_dim=128,
        intermediate=14336, rope_base=1e6, residual_alpha=1.0 / 8,
        moe=llama.MoEConfig(num_experts=8, topk=2, expert_intermediate=14336, scheme=scheme),
    )


def slice_full_moe(dev):
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = mixtral_8x7b()
    t0 = time.perf_counter()
    w = llama.init_weights(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    emit("init_weights", config="mixtral_8x7b", seconds=time.perf_counter() - t0,
         memory_allocated_bytes=torch.cuda.memory_allocated())
    stats, counts, prefill_logits, eng, profiled = serve_full(
        dev, cfg, w, "slice_full_moe", BF16_KERNELS, config="mixtral_8x7b", longest=512)
    prefill_prof = prefill_profile(eng, cfg)
    del eng, w
    torch.cuda.empty_cache()
    emit("slice_full_moe", moe=cfg.moe._asdict(), **stats)
    emit("decode_profile_moe", **profiled.summary())
    emit("prefill_profile_moe", **prefill_prof)
    return counts, prefill_logits


def slice_full_moe_int8(dev, fp8_prefill_logits):
    """The same Mixtral widths with int8 experts (MoEConfig(scheme="pertensor_int8")),
    drawn from the same seed as the fp8 run's (the same float32 masters), after
    the fp8 experts are freed: launch counts exact (the fused gate-up GEMM,
    the aligned down GEMM and the reduce once per layer and call, no
    activation kernel), each prefill's last-token logits within cosine 0.97
    of the fp8 run's (the bar of tests/test_model.py's int8 MoE test), one
    device-to-host copy per profiled decode step, and the share of
    activation codes at +-127 over a prefill of the prompts."""
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.ops import moe
    from hpc_ops_tpu_torch.runtime.engine import Engine

    cfg = mixtral_8x7b("pertensor_int8")
    t0 = time.perf_counter()
    w = llama.init_weights(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    emit("init_weights", config="mixtral_8x7b int8", seconds=time.perf_counter() - t0,
         memory_allocated_bytes=torch.cuda.memory_allocated())
    stats, counts, prefill_logits, eng, profiled = serve_full(
        dev, cfg, w, "slice_full_moe_int8", BF16_KERNELS, config="mixtral_8x7b", longest=512)
    emit("prefill_profile_moe_int8", **prefill_profile(eng, cfg))
    cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=0))
           for a, b in zip(prefill_logits, fp8_prefill_logits)]
    if len(cos) != len(fp8_prefill_logits) or min(cos) < 0.97:
        raise AssertionError(f"slice_full_moe_int8: prefill logits at cosines {cos} of the fp8 "
                             "MoE run's (limit 0.97)")
    del eng
    # saturation: activation codes at +-127 among the codes of real slots,
    # over one prefill of the prompts (counted outside the timed run)
    real, sat = moe.gg_scatter, torch.zeros(2, dtype=torch.int64, device=dev)

    def counting(x, weight, y_scale, row_idx, grp, tm, *a, **kw):
        out = real(x, weight, y_scale, row_idx, grp, tm, *a, **kw)
        if kw.get("act_fuse"):
            codes = out[: row_idx.shape[0]][row_idx >= 0]
            sat[0] += (codes.abs() == 127).sum()
            sat[1] += codes.numel()
        return out

    moe.gg_scatter = counting  # the MoE's own reference to the wrapper
    try:
        Engine(cfg, w, num_blocks=NUM_BLOCKS, block_size=BS, max_batch=8, device=dev).run(
            full_prompts(cfg.vocab, 512)[1], max_new=1)
    finally:
        moe.gg_scatter = real
    n_sat, n_codes = (int(v) for v in sat.cpu())
    del w
    torch.cuda.empty_cache()
    emit("slice_full_moe_int8", moe=cfg.moe._asdict(), prefill_cosine_vs_fp8=cos,
         prefill_cosine_min=min(cos), saturated_act_codes=n_sat, act_codes=n_codes,
         saturated_share=n_sat / max(n_codes, 1), **stats)
    profile = profiled.summary()
    emit("decode_profile_moe_int8", **profile)
    if profile["device_to_host_copies_per_step"] != 1:
        raise AssertionError("slice_full_moe_int8: a decode step copies to the host "
                             f"{profile['device_to_host_copies_per_step']} times (expected 1)")
    return counts


def slice_full_moe_bw(dev, fp8_prefill_logits):
    """The same Mixtral widths with blockwise int8 experts
    (MoEConfig(scheme="blockwise_int8"): a scale per 128 x 128 block, drawn
    from the fp8 run's seed, the same float32 masters), after the int8
    experts are freed: launch counts exact (the blockwise scatter gate-up
    GEMM, the blockwise aligned down GEMM and the reduce once per layer and
    call, every other MoE kernel at 0), each prefill's last-token logits
    within cosine 0.97 of the fp8 run's (tests/test_model.py's bar for this
    scheme), one device-to-host copy per profiled decode step, and the share
    of the down GEMM's input codes at +-127 over a prefill of the prompts
    (each 128-group's largest code is +-127 by construction)."""
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.ops import moe
    from hpc_ops_tpu_torch.runtime.engine import Engine

    cfg = mixtral_8x7b("blockwise_int8")
    t0 = time.perf_counter()
    w = llama.init_weights(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    emit("init_weights", config="mixtral_8x7b blockwise int8", seconds=time.perf_counter() - t0,
         memory_allocated_bytes=torch.cuda.memory_allocated())
    stats, counts, prefill_logits, eng, profiled = serve_full(
        dev, cfg, w, "slice_full_moe_bw", BF16_KERNELS, config="mixtral_8x7b", longest=512)
    emit("prefill_profile_moe_bw", **prefill_profile(eng, cfg))
    cos = [float(torch.nn.functional.cosine_similarity(a, b, dim=0))
           for a, b in zip(prefill_logits, fp8_prefill_logits)]
    if len(cos) != len(fp8_prefill_logits) or min(cos) < 0.97:
        raise AssertionError(f"slice_full_moe_bw: prefill logits at cosines {cos} of the fp8 "
                             "MoE run's (limit 0.97)")
    del eng
    # saturation: the down GEMM's input codes at +-127 among those of real
    # slots, over one prefill of the prompts (counted outside the timed run)
    real_gemm, real_requant = moe.gg_bw_scatter, moe._act_requant
    sat = torch.zeros(2, dtype=torch.int64, device=dev)
    slots = []

    def remember(x, weight, sx, sw, row_idx, *a, **kw):
        slots.append(row_idx >= 0)
        return real_gemm(x, weight, sx, sw, row_idx, *a, **kw)

    def counting(gate_up, quant):
        codes, scales = real_requant(gate_up, quant)
        real = codes[slots.pop()]
        sat[0] += (real.abs() == 127).sum()
        sat[1] += real.numel()
        return codes, scales

    moe.gg_bw_scatter, moe._act_requant = remember, counting  # the MoE's own references
    try:
        Engine(cfg, w, num_blocks=NUM_BLOCKS, block_size=BS, max_batch=8, device=dev).run(
            full_prompts(cfg.vocab, 512)[1], max_new=1)
    finally:
        moe.gg_bw_scatter, moe._act_requant = real_gemm, real_requant
    n_sat, n_codes = (int(v) for v in sat.cpu())
    del w
    torch.cuda.empty_cache()
    emit("slice_full_moe_bw", moe=cfg.moe._asdict(), prefill_cosine_vs_fp8=cos,
         prefill_cosine_min=min(cos), saturated_down_codes=n_sat, down_codes=n_codes,
         saturated_share=n_sat / max(n_codes, 1), **stats)
    profile = profiled.summary()
    emit("decode_profile_moe_bw", **profile)
    if profile["device_to_host_copies_per_step"] != 1:
        raise AssertionError("slice_full_moe_bw: a decode step copies to the host "
                             f"{profile['device_to_host_copies_per_step']} times (expected 1)")
    return counts


def phase(name, fn, *args, **kw):
    """Run one phase and print its seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit("phase_seconds", name=name, seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "hpc_ops_tpu_torch")):
        print("chip_smoke.py: the hpc_ops_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch import runtime

    t0 = time.perf_counter()
    kernels.lib()
    runtime.native_lib()
    emit("build", seconds=time.perf_counter() - t0, library=os.path.relpath(kernels.library_path(), ROOT))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(1234)
    gen = torch.Generator().manual_seed(1234)
    rows = [phase("check_rope", check_rope, dev, gen), phase("check_decode", check_decode, dev, gen),
            phase("check_prefill", check_prefill, dev, gen),
            phase("check_rope_int8", check_rope_int8, dev, gen),
            phase("check_decode_nhd_fused", check_decode_nhd_fused, dev, gen),
            phase("check_prefill_nhd_fused", check_prefill_nhd_fused, dev, gen)]
    phase("check_f5", check_f5, dev, gen)
    moe_inp = phase("moe_check_inputs", moe_check_inputs, dev, gen)
    rows += [phase("check_gg_scatter", check_gg_scatter, dev, moe_inp),
             phase("check_act_quant", check_act_quant, dev, moe_inp),
             phase("check_moe_reduce", check_moe_reduce, dev, moe_inp)]
    phase("moe_pipeline", check_moe_pipeline, dev, moe_inp)
    int8_rows = [phase("check_gg_scatter_i8", check_gg_scatter_i8, dev, moe_inp),
                 phase("check_gg_scatter_i8_act", check_gg_scatter_i8_act, dev, moe_inp),
                 *phase("check_gg_pertensor", check_gg_pertensor, dev, moe_inp)]
    phase("moe_pipeline_int8", check_moe_pipeline_int8, dev, moe_inp)
    launches_moe_ops = phase("ops_moe", ops_moe, dev, moe_inp)
    phase("bw_check_inputs", bw_check_inputs, dev, moe_inp)
    bw_rows = [*phase("check_gg_bw_scatter", check_gg_bw, dev, moe_inp, False),
               *phase("check_gg_bw_aligned", check_gg_bw, dev, moe_inp, True)]
    phase("moe_pipeline_bw", check_moe_pipeline_bw, dev, moe_inp)
    launches_moe_bw_ops = phase("ops_moe_bw", ops_moe_bw, dev, moe_inp)
    del moe_inp
    torch.cuda.empty_cache()
    fp8_rows = (phase("check_decode_fp8", check_decode_fp8, dev, gen)
                + phase("check_prefill_fp8", check_prefill_fp8, dev, gen))
    launches_ops = phase("ops_fp8", ops_fp8, dev, gen)
    torch.cuda.empty_cache()
    fused_rows, launches_fused = phase("check_decode_fused", check_decode_fused, dev, gen)
    phase("check_decode_tasks", check_decode_tasks, dev, gen)
    sched_rows, launches_sched = phase("decode_sched", decode_sched, dev)
    torch.cuda.empty_cache()
    phase("check_prefill_sparse", check_prefill_sparse, dev, gen)
    sparse_rows_, launches_sparse = phase("prefill_sparse", prefill_sparse, dev)
    norm_rows, launches_norm = phase("check_rmsnorm_quant", check_rmsnorm_quant, dev, gen)
    route_rows, launches_route = phase("check_route_gemm", check_route_gemm, dev, gen)
    torch.cuda.empty_cache()
    allreduce_rows, launches_allreduce = phase("check_allreduce", check_allreduce, dev, gen)
    torch.cuda.empty_cache()
    phase("sampler_approx", sampler_approx, dev)
    launches_distinct = phase("distinct_devices", distinct_devices, dev)
    torch.cuda.empty_cache()
    phase("slice_tiny", slice_tiny, dev)
    phase("slice_tiny_int8", slice_tiny, dev, "slice_tiny_int8", int8_kv=True, kv_scale=0.02)
    phase("slice_tiny_moe", slice_tiny, dev, "slice_tiny_moe", moe=True)
    phase("slice_tiny_fp8", slice_tiny, dev, "slice_tiny_fp8", fp8_kv=True)
    phase("slice_tiny_moe_int8", slice_tiny, dev, "slice_tiny_moe_int8", moe_scheme="pertensor_int8",
          moe=True)
    phase("slice_tiny_moe_bw", slice_tiny, dev, "slice_tiny_moe_bw", moe_scheme="blockwise_int8",
          moe=True)
    phase("slice_tiny_tp", slice_tiny_tp, dev)
    phase("slice_tiny_tp_moe", slice_tiny_tp, dev, "slice_tiny_tp_moe", moe=True)

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.parallel import make_mesh

    # one set of seeded weights (16 GB) serves four paths: int8_kv and fp8_kv
    # change no weight, dense_int8 quantises copies of them
    t0 = time.perf_counter()
    w = llama.init_weights(llama.llama3_8b(), torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    emit("init_weights", config="llama3_8b", seconds=time.perf_counter() - t0)
    counts, bf16_prefill_logits, bf16_tokens = phase("slice_full", slice_full, dev, w)
    counts_int8 = phase("slice_full_int8", slice_full_int8, dev, w, bf16_prefill_logits)
    counts_fp8 = phase("slice_full_fp8", slice_full_fp8, dev, w, bf16_prefill_logits)
    counts_w8a8 = phase("slice_full_w8a8", slice_full_w8a8, dev, w, bf16_prefill_logits)
    counts_tp, tp_tokens = phase("slice_full_tp", slice_full_tp, dev, w, bf16_prefill_logits, bf16_tokens)
    counts_multi = phase("slice_full_multi", slice_full_multi, dev, w, bf16_tokens)
    counts_tp_multi = phase("slice_full_tp_multi", slice_full_multi, dev, w, tp_tokens,
                            make_mesh(tp=TP_FULL, dp=1, devices=[dev] * TP_FULL), "slice_full_tp")
    counts_hybrid = phase("slice_full_hybrid", slice_full_hybrid, dev, w, bf16_prefill_logits, bf16_tokens)
    # the rest of the serving engine, ring attention, the converter and replay
    launches_spec = phase("slice_full_spec", slice_full_spec, dev, w, bf16_tokens)
    launches_prefix = phase("slice_full_prefix", slice_full_prefix, dev, w)
    launches_sampling = phase("slice_full_sampling", slice_full_sampling, dev, w, bf16_tokens)
    phase("convert", convert_phase, dev, w)
    phase("ring_attention", ring_attention_phase, dev)
    launches_replay = phase("replay", replay_phase, dev)
    # the fp8 experts of the MoE model (45 GB) need the room of the llama3_8b weights
    del w, bf16_prefill_logits
    torch.cuda.empty_cache()
    counts_moe, fp8_moe_prefill_logits = phase("slice_full_moe", slice_full_moe, dev)
    counts_moe_int8 = phase("slice_full_moe_int8", slice_full_moe_int8, dev, fp8_moe_prefill_logits)
    counts_moe_bw = phase("slice_full_moe_bw", slice_full_moe_bw, dev, fp8_moe_prefill_logits)
    for r in rows:
        # each kernel's launches on its own path's run: the bf16 kernels'
        # from slice_full_multi's, whose decode ran through graph replays
        by_path = counts_int8 if r["name"] in INT8_KERNELS else (
            counts_moe if r["name"] in MOE_KERNELS else counts_multi)
        r["launches"] = by_path[r["name"]]
    # the e4m3 variants: the fp8_kv serving run launched the HND decode and
    # prefill; the other forms are reached by the operator entry points only
    # (ops_fp8, counts read around each call)
    for r in fp8_rows:
        served = {"paged_decode_e4m3": "paged_decode", "paged_prefill_e4m3": "paged_prefill"}
        r["launches"] = (counts_fp8[served[r["name"]]] if r["name"] in served
                         else launches_ops[r["name"]])
    rows += fp8_rows
    # the int8 MoE forms: the int8 serving run launched the fused gate-up GEMM
    # and the int8 aligned GEMM; ops_moe reached the unfused int8 GEMM and the
    # e4m3 aligned GEMM
    for r in int8_rows:
        r["launches"] = (counts_moe_int8[r["name"]] if r["name"] in MOE_PER_CALL["pertensor_int8"]
                         else launches_moe_ops[r["name"]])
    rows += int8_rows
    # the blockwise forms: the blockwise int8 serving run launched both int8
    # forms; ops_moe_bw reached the e4m3 ones
    for r in bw_rows:
        served = {"gg_bw_scatter_i8": "gg_bw_scatter", "gg_bw_aligned_i8": "gg_bw_aligned"}
        r["launches"] = (counts_moe_bw[served[r["name"]]] if r["name"] in served
                         else launches_moe_bw_ops[r["name"]])
    rows += bw_rows
    # the FUSED and task-map forms, reached by the decode operator's entry
    # points only: decode_sched drove the int8 FUSED grid decode (at KV <= 1024
    # in uniform_512: the packed row) and the task-map decode over bf16 and
    # e4m3 in every scenario; check_decode_fused drove the bf16 and e4m3 FUSED
    for r in fused_rows:
        kind = {"paged_decode_fused_bf16": "bf16", "paged_decode_fused_e4m3": "e4m3"}.get(r["name"])
        r["launches"] = launches_fused[kind] if kind else launches_sched.get(r["name"], 0)
    for r in sched_rows:
        r["launches"] = launches_sched.get(r["name"], 0)
    rows += fused_rows + sched_rows
    # the block-sparse prefill, RMSNorm + fp8 and route GEMM forms, reached
    # by their operator entry points only: prefill_sparse drove the sparse
    # e4m3 form once per mask and case and the bf16 and per-token forms once;
    # check_rmsnorm_quant and check_route_gemm drove theirs once per shape
    for r in sparse_rows_ + norm_rows + route_rows:
        r["launches"] = {**launches_sparse, **launches_norm, **launches_route}.get(r["name"], 0)
    rows += sparse_rows_ + norm_rows + route_rows
    # the fused collective: slice_full_tp_multi's run launched the one_shot
    # form (the model's), its decode through graph replays; check_allreduce
    # drove the two_shot form's entry points and the per-device form's
    # (counted in kernel launches, with those of distinct_devices where the
    # machine has two cards)
    for r in allreduce_rows:
        r["launches"] = (counts_tp_multi["allreduce_rmsnorm"] if r["name"] == "allreduce_rmsnorm_one_shot"
                         else launches_allreduce.get(r["name"], 0))
        if r["name"] == "allreduce_rmsnorm_rank_one_shot":
            r["launches"] += launches_distinct
    rows += allreduce_rows
    for r in rows:
        r["route"] = "cuda"
        r["kernel_ms"] = r["ms"]
        if r["launches"] < 1:
            raise AssertionError(f"kernel {r['name']} was never launched on its path")
    emit("launches", bf16=counts, int8_kv=counts_int8, fp8_kv=counts_fp8, w8a8=counts_w8a8,
         moe=counts_moe, moe_int8=counts_moe_int8, moe_bw=counts_moe_bw, ops_fp8=launches_ops,
         ops_moe=launches_moe_ops, ops_moe_bw=launches_moe_bw_ops, decode_fused=launches_fused,
         decode_sched=launches_sched, prefill_sparse=launches_sparse, rmsnorm_quant=launches_norm,
         route_gemm=launches_route, tp=counts_tp, multi=counts_multi, tp_multi=counts_tp_multi,
         hybrid_multi=counts_hybrid, distinct_devices=launches_distinct,
         allreduce=launches_allreduce, spec=launches_spec, prefix=launches_prefix,
         sampling=launches_sampling, replay=launches_replay)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the failing phase and exit non-zero
        traceback.print_exc()
        sys.exit(1)
