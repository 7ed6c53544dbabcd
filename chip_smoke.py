#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hpc_ops_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card (Hopper, sm_90a) and the CUDA toolkit's nvcc, and exits non-zero on
any failure, without a card, or when the package is not beside it.

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi), torch's view;
  2. build: nvcc builds the three kernels and g++ the block allocator;
  3. kernels: each kernel against its plain PyTorch version on the same
     inputs at the llama3_8b serving shapes (Hq 32, Hkv 8, D 128, pages of
     16), timed with CUDA events beside its plain version, a PyTorch library
     call for the same function where one exists, and its bound;
  4. slice_tiny: Engine on tiny_config on the card and on the CPU with the
     same weights: logits of the first prefill and decode steps within
     0.15 abs / 0.1 rel, greedy tokens identical wherever the CPU path's
     top-2 margin exceeds that tolerance;
  5. slice_full: Engine(llama3_8b) at full width and depth with random
     weights serving 8 prompts x 32 new tokens; logits finite, tokens in the
     vocab, each kernel's launch count as expected; decode_profile: three of
     its decode steps under torch.profiler (device time by kernel class and
     the device's idle share), left out of its step times;
then the kernels line, the nvidia-smi line and the result line.
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
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16
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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def random_table(gen, lens, max_blocks, num_blocks, device):
    """A shuffled page table covering each length, padded with -1."""
    import torch

    perm = torch.randperm(num_blocks, generator=gen)
    tbl = torch.full((len(lens), max_blocks), -1, dtype=torch.int32)
    off = 0
    for i, n in enumerate(lens):
        k = -(-n // BS)
        tbl[i, :k] = perm[off : off + k]
        off += k
    return tbl.to(device)


# ------------------------------------------------------------------ kernels
def check_rope(dev, gen):
    import torch

    from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache
    from hpc_ops_tpu_torch.ops.rope_kernel import rope_store_rows, rope_store_rows_ref, row_slots
    from hpc_ops_tpu_torch.utils.testing import max_bf16_ulp_err

    # a decode batch: one new row per request, at lengths up to 4096
    rows = 8
    cos_sin = make_cos_sin_cache(8192, D, 500000.0, device=dev)
    qkv = torch.randn((rows, (HQ + 2 * HKV) * D), generator=gen).to(torch.bfloat16).to(dev)
    seq_lens = torch.randint(1, 4097, (rows,), generator=gen, dtype=torch.int32)
    tbl = random_table(gen, [int(n) for n in seq_lens], 4096 // BS + 4, NUM_BLOCKS, dev)
    seq_lens = seq_lens.to(dev)
    q_index = torch.arange(rows + 1, dtype=torch.int32, device=dev)
    _, slots = row_slots(rows, seq_lens, q_index, tbl, BS, NUM_BLOCKS * BS)
    w = (torch.rand(D, generator=gen) + 0.5).to(dev)
    worst_q = worst_kv = 0.0
    for layout in ("HND", "NHD"):
        shape = (HKV, NUM_BLOCKS * BS, D) if layout == "HND" else (NUM_BLOCKS * BS, HKV, D)
        k0 = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        v0 = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
        for policy in (0, 1, 2):
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
                raise AssertionError(f"rope {layout}: untouched cache slots changed")
            if not torch.equal(kv[written], pv[written]):
                raise AssertionError(f"rope {layout}: V rows differ from the plain version")
            worst_kv = max(worst_kv, max_bf16_ulp_err(kk[written], pk[written]))
    err = max(worst_q, worst_kv)
    if err > 1.0:
        raise AssertionError(f"rope: {err} bf16 ulp from the plain version (limit 1)")
    # timing at the decode main path: HND, policy 0
    kf = torch.zeros((HKV, NUM_BLOCKS * BS, D), dtype=torch.bfloat16, device=dev)
    vf = torch.zeros_like(kf)
    kw = dict(hq=HQ, hkv=HKV, d=D, dv=D, block_size=BS, qk_norm_policy=0, head_major=True)
    args = (qkv, cos_sin, seq_lens, q_index, tbl, None, None, kf, vf)
    diff = float((rope_store_rows(*args, **kw)[0].float()
                  - rope_store_rows_ref(*args, **kw)[0].float()).abs().max())
    ms = time_ms(lambda: rope_store_rows(*args, **kw), 200)
    plain = time_ms(lambda: rope_store_rows_ref(*args, **kw), 50)
    # qkv and cos|sin rows in, q and the K/V rows out, 3 table entries per row
    nbytes = rows * ((HQ + 2 * HKV) * D * 2 + D * 4 + 12 + HQ * D * 2 + 2 * HKV * D * 2)
    flops = rows * (HQ + HKV) * D * 3
    b, by = bound(nbytes, flops)
    emit("kernel", name="rope_store", max_ulp=err, max_abs_err=diff, ms=ms, plain_ms=plain,
         bound_ms=b, bound_by=by, library_ms=None, rows=rows)
    return dict(name="rope_store", source="hpc_ops_tpu_torch/csrc/rope_store.cu",
                replaces="hpc_ops_tpu/ops/rope_kernel.py:43", max_abs_err=diff, max_ulp=err,
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)


def check_decode(dev, gen):
    import torch
    import torch.nn.functional as F

    from hpc_ops_tpu_torch.ops.attention.decode import _decode_ref, paged_decode_attention

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
        got = paged_decode_attention(q, k, v, tbl, kv_lens, 1, scale, layout)
        want = _decode_ref(q, k, v, tbl, kv_lens, 1, scale, layout)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2):
            raise AssertionError(f"decode {layout}: kernel disagrees with the plain version")
        err = max(err, float((got.float() - want.float()).abs().max()))
    # the main path's layout (HND) is timed
    ms = time_ms(lambda: paged_decode_attention(q, k, v, tbl, kv_lens, 1, scale, "HND"), 50)
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
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 20)
    sum_kv = sum(lens_l)
    nbytes = 2 * b * HQ * D * 2 + 2 * sum_kv * HKV * D * 2 + tbl.numel() * 4 + b * 4
    flops = 4 * sum_kv * HQ * D
    bd, by = bound(nbytes, flops)
    emit("kernel", name="paged_decode", max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
         bound_ms=bd, bound_by=by, kv_lens=lens_l)
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
         bound_ms=bd, bound_by=by)
    return dict(name="paged_prefill", source="hpc_ops_tpu_torch/csrc/prefill.cu",
                replaces="hpc_ops_tpu/ops/attention/prefill.py:48", max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bd, bound_by=by, library_ms=lib)


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


def slice_tiny(dev):
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.runtime.engine import Engine
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

    cfg = llama.tiny_config()
    w_cpu = llama.init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    w_gpu = {**{k: v.to(dev) for k, v in w_cpu.items() if k != "layers"},
             "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in w_cpu["layers"]]}
    diffs = {}
    cpu_steps = first_steps(llama, cfg, w_cpu, "cpu")
    gpu_steps = first_steps(llama, cfg, w_gpu, dev)
    for name, c, g in zip(("prefill", "decode"), cpu_steps, gpu_steps):
        if not torch.isfinite(g).all() or not torch.allclose(g, c, atol=ATOL_LOGITS, rtol=RTOL_LOGITS):
            raise AssertionError(f"tiny {name} logits: card vs CPU beyond 0.15/0.1")
        diffs[name] = float((g - c).abs().max())
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61))]
    outs = {}
    for d in ("cpu", dev):
        eng = Engine(cfg, w_cpu if d == "cpu" else w_gpu, num_blocks=64, block_size=BS, max_batch=4,
                     prefill_chunk=16, device=d)
        outs[str(d)] = eng.run(prompts, max_new=8)

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
    emit("slice_tiny", max_logits_diff=diffs, tokens_card=outs[str(dev)], tokens_cpu=outs["cpu"],
         near_tie_flips=flips)


PROFILE_FROM, PROFILE_STEPS = 4, 3  # decode steps 5..7 of slice_full


class DecodeProfile:
    """torch.profiler over a few decode steps: device time per step by kernel
    class and the device's idle share of the window's wall time."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.steps = 0
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
        classes = {"rope_store": 0.0, "paged_decode": 0.0, "paged_prefill": 0.0, "gemm": 0.0,
                   "other": 0.0}
        other = {}
        for e in self.prof.key_averages():
            if e.device_type != cuda:
                continue
            us = e.self_device_time_total
            name = e.key
            for k in ("rope_store", "paged_decode", "paged_prefill"):
                if k in name:
                    classes[k] += us
                    break
            else:
                if any(m in name.lower() for m in ("gemm", "nvjet", "xmma", "cutlass")):
                    classes["gemm"] += us
                else:
                    classes["other"] += us
                    other[name[:80]] = other.get(name[:80], 0.0) + us
        n = self.steps
        busy_ms = sum(classes.values()) / 1e3 / n
        wall_ms = self.wall_s * 1e3 / n
        return {
            "steps": n,
            "device_ms_per_step": {k: v / 1e3 / n for k, v in classes.items()},
            "device_busy_ms_per_step": busy_ms,
            "wall_ms_per_step": wall_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top_other_ms_per_step": {k: v / 1e3 / n for k, v in
                                      sorted(other.items(), key=lambda kv: -kv[1])[:6]},
        }


def slice_full(dev):
    import numpy as np
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.runtime import engine as engine_mod

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    t0 = time.perf_counter()
    w = llama.init_weights(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    lens = [16, 2000] + [int(x) for x in rng.randint(16, 2001, 6)]
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab, n)] for n in lens]

    # every logits tensor the engine samples from is checked for finiteness
    finite = []
    base_forward = engine_mod.forward_step

    def checked_forward(*a, **kw):
        out, caches = base_forward(*a, **kw)
        finite.append(torch.isfinite(out).all())
        return out, caches

    engine_mod.forward_step = checked_forward
    try:
        warm = engine_mod.Engine(cfg, w, num_blocks=64, block_size=BS, max_batch=8, device=dev)
        warm.run([prompts[0]], max_new=2)  # cuBLAS and allocator warm-up
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = engine_mod.Engine(cfg, w, num_blocks=NUM_BLOCKS, block_size=BS, max_batch=8, device=dev)
        rids = [eng.add_request(p, max_new=32) for p in prompts]
        kernels.reset_launch_counts()
        prefill_s, decode_s, decode_tokens = [], [], 0
        profiled = None
        while True:
            st = eng.stats
            decode_next = st["pending"] == 0
            n_dec = st["decode_dispatches"]
            if decode_next and n_dec == PROFILE_FROM:
                profiled = DecodeProfile(torch)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if not eng.step():
                break
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if not decode_next:
                prefill_s.append(dt)
            elif profiled is not None and profiled.active:
                profiled.steps += 1
                if profiled.steps == PROFILE_STEPS:
                    profiled.stop()
            else:  # profiled steps are left out of the step times
                decode_s.append(dt)
                decode_tokens += min(st["active"], eng.max_batch)
        counts = kernels.launch_counts()
    finally:
        engine_mod.forward_step = base_forward
    outs = [eng.requests[r].out for r in rids]
    if not all(bool(f) for f in finite):
        raise AssertionError("llama3_8b: non-finite logits")
    if not all(len(o) == 32 and all(0 <= x < cfg.vocab for x in o) for o in outs):
        raise AssertionError("llama3_8b: missing tokens or tokens outside the vocab")
    st = eng.stats
    n_pre, n_dec = st["prefill_dispatches"], st["decode_dispatches"]
    expect = {"rope_store": n_dec * cfg.layers, "paged_decode": n_dec * cfg.layers,
              "paged_prefill": n_pre * cfg.layers}
    if counts != expect or min(counts.values()) == 0:
        raise AssertionError(f"launch counts {counts} != expected {expect}")
    emit("slice_full", config="llama3_8b", residual_alpha=1.0 / 8, layers=cfg.layers,
         prompt_lens=lens, new_tokens=32, init_weights_s=init_s,
         prefill_calls=n_pre, prefill_s_total=sum(prefill_s), prefill_s_each=prefill_s,
         prefill_tokens_per_s=sum(lens) / sum(prefill_s),
         decode_steps=n_dec, decode_steps_timed=len(decode_s),
         decode_ms_per_step=1e3 * sum(decode_s) / len(decode_s),
         decode_tokens_per_s=decode_tokens / sum(decode_s),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         launches=counts, first_tokens=[o[:4] for o in outs])
    emit("decode_profile", **profiled.summary())
    return counts


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
    gen = torch.Generator().manual_seed(1234)
    rows = [check_rope(dev, gen), check_decode(dev, gen), check_prefill(dev, gen)]
    slice_tiny(dev)
    counts = slice_full(dev)
    for r in rows:
        r["route"] = "cuda"
        r["launches"] = counts[r["name"]]
        r["kernel_ms"] = r["ms"]
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
