#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (hpc_ops_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card (Hopper, sm_90a) and the CUDA toolkit's nvcc, and exits non-zero on
any failure, without a card, or when the package is not beside it.

Phases, each printing one JSON line:
  1. device: the card's name and power limit (nvidia-smi), torch's view;
  2. build: nvcc builds the kernel sources and g++ the block allocator;
  3. kernels: each of the six kernels against its plain PyTorch version on
     the same inputs at the llama3_8b serving shapes (Hq 32, Hkv 8, D 128,
     pages of 16), timed with CUDA events beside its plain version, a
     PyTorch library call for the same function where one exists, and its
     bound: the bf16 RoPE store, paged decode and paged prefill, and the
     int8 quantising RoPE store, NHD_FUSED decode and NHD_FUSED prefill;
  4. slice_tiny and slice_tiny_int8: Engine on tiny_config (bf16 KV, then
     int8_kv) on the card and on the CPU with the same weights: logits of
     the first prefill and decode steps within 0.15 abs / 0.1 rel, greedy
     tokens identical wherever the CPU path's top-2 margin exceeds that
     tolerance;
  5. slice_full and slice_full_int8: Engine(llama3_8b) at full width and
     depth, bf16 KV then int8_kv, on one set of random weights, serving 8
     prompts x 32 new tokens; logits finite, tokens in the vocab, each
     kernel's launch count as expected (the other path's kernels never
     launch), int8 prefill logits within cosine 0.98 of bf16's, the share of
     saturated int8 codes; decode_profile and decode_profile_int8: three
     decode steps of each under torch.profiler (device time by kernel class
     and the device's idle share), left out of the step times;
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


def check_rope_int8(dev, gen):
    import torch

    from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache
    from hpc_ops_tpu_torch.ops.rope_kernel import (
        rope_store_rows_int8,
        rope_store_rows_int8_ref,
        row_slots,
    )
    from hpc_ops_tpu_torch.utils.testing import max_bf16_ulp_err

    # a decode batch of 8 rows into a 2048-page int8 NHD_FUSED slab
    rows = 8
    cos_sin = make_cos_sin_cache(8192, D, 500000.0, device=dev)
    qkv = torch.randn((rows, (HQ + 2 * HKV) * D), generator=gen).to(torch.bfloat16).to(dev)
    seq_lens = torch.randint(1, 4097, (rows,), generator=gen, dtype=torch.int32)
    tbl = random_table(gen, [int(n) for n in seq_lens], 4096 // BS + 4, NUM_BLOCKS, dev)
    seq_lens = seq_lens.to(dev)
    q_index = torch.arange(rows + 1, dtype=torch.int32, device=dev)
    _, slots = row_slots(rows, seq_lens, q_index, tbl, BS, NUM_BLOCKS * 2 * BS, fused=True)
    written = torch.zeros(NUM_BLOCKS * 2 * BS, dtype=torch.bool, device=dev)
    written[slots] = True
    written[slots + BS] = True
    written = written.view(NUM_BLOCKS, 2 * BS, 1).expand(NUM_BLOCKS, 2 * BS, HKV * D)
    w = (torch.rand(D, generator=gen) + 0.5).to(dev)
    scales = (torch.tensor([0.05], device=dev), torch.tensor([0.05], device=dev))
    slab0 = torch.randint(-127, 128, (NUM_BLOCKS, 2 * BS, HKV * D), generator=gen,
                          dtype=torch.int8).to(dev)
    worst_q, code_diff, diff_share = 0.0, 0, 0.0
    kw = dict(hq=HQ, hkv=HKV, d=D, block_size=BS)
    for policy in (0, 1, 2):
        args = (qkv, cos_sin, seq_lens, q_index, tbl, w, w)
        kq, ks = rope_store_rows_int8(*args, slab0.clone(), *scales, qk_norm_policy=policy, **kw)
        pq, ps = rope_store_rows_int8_ref(*args, slab0.clone(), *scales, qk_norm_policy=policy, **kw)
        torch.cuda.synchronize()
        worst_q = max(worst_q, max_bf16_ulp_err(kq, pq))
        if not torch.equal(ks[~written], slab0[~written]):
            raise AssertionError(f"rope int8 policy {policy}: untouched slab bytes changed")
        diff = (ks[written].int() - ps[written].int()).abs()
        code_diff = max(code_diff, int(diff.max()))
        diff_share = max(diff_share, float((diff > 0).float().mean()))
    if worst_q > 1.0 or code_diff > 1 or diff_share > 1e-3:
        raise AssertionError(f"rope int8: q {worst_q} ulp (limit 1), codes {code_diff} apart on "
                             f"{diff_share:.4%} (limits 1 and 0.1%)")
    # timing at the decode main path: policy 0
    args = (qkv, cos_sin, seq_lens, q_index, tbl, None, None, slab0.clone(), *scales)
    kw["qk_norm_policy"] = 0
    diff = float((rope_store_rows_int8(*args, **kw)[0].float()
                  - rope_store_rows_int8_ref(*args, **kw)[0].float()).abs().max())
    ms = time_ms(lambda: rope_store_rows_int8(*args, **kw), 200)
    plain = time_ms(lambda: rope_store_rows_int8_ref(*args, **kw), 50)
    # qkv and cos|sin rows in, q and the int8 K/V rows out, 3 table entries per row
    nbytes = rows * ((HQ + 2 * HKV) * D * 2 + D * 4 + 12 + HQ * D * 2 + 2 * HKV * D)
    flops = rows * (HQ + HKV) * D * 3 + rows * 2 * HKV * D * 2
    b, by = bound(nbytes, flops)
    emit("kernel", name="rope_store_int8", max_ulp=worst_q, max_abs_err=diff,
         code_max_diff=code_diff, code_diff_share=diff_share, ms=ms, plain_ms=plain,
         bound_ms=b, bound_by=by, library_ms=None, rows=rows)
    return dict(name="rope_store_int8", source="hpc_ops_tpu_torch/csrc/rope_store.cu",
                replaces="hpc_ops_tpu/ops/rope_kernel.py:43", max_abs_err=diff, max_ulp=worst_q,
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)


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
    ms = time_ms(lambda: paged_decode_nhd_fused(q, slab, tbl, kv_lens, 1, scale, sc, sc), 50)
    ms_bf16 = time_ms(lambda: paged_decode_nhd_fused(q, slabs["bf16"], tbl, kv_lens, 1, scale), 50)
    plain = time_ms(lambda: _decode_nhd_fused_ref(q, slab, tbl, kv_lens, 1, scale, sc, sc), 5)
    # library yardstick: SDPA over dequantised K/V gathered contiguous (gather not timed)
    L = max(lens_l)
    kg, vg = gathered_dequant(slab, tbl, L, 0.05)
    mask = (torch.arange(L, device=dev)[None, :] < kv_lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask), 20)
    sum_kv = sum(lens_l)
    nbytes = 2 * b * HQ * D * 2 + 2 * sum_kv * HKV * D + tbl.numel() * 4 + b * 4 + 8
    flops = 4 * sum_kv * HQ * D
    bd, by = bound(nbytes, flops)
    bd16, _ = bound(nbytes + 2 * sum_kv * HKV * D, flops)
    emit("kernel", name="paged_decode_nhd_fused", max_abs_err=err, ms=ms, plain_ms=plain,
         library_ms=lib, bound_ms=bd, bound_by=by, ms_bf16_slab=ms_bf16, bound_ms_bf16_slab=bd16,
         kv_lens=lens_l)
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
    plain = time_ms(lambda: _prefill_nhd_fused_ref(q, slab, cu, tbl, kv, 2048, scale, sc, sc), 3)
    kg, vg = gathered_dequant(slab, tbl[:1], 2048, 0.05)
    q4 = q.permute(1, 0, 2)[None].contiguous()
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, is_causal=True), 10)
    pairs = 2048 * 2049 // 2  # causal (q, k) pairs of this input
    nbytes = 2 * 2048 * HQ * D * 2 + 2 * 2048 * HKV * D + tbl.numel() * 4 + 8
    flops = 4 * pairs * HQ * D
    bd, by = bound(nbytes, flops)
    emit("kernel", name="paged_prefill_nhd_fused", max_abs_err=err, ms=ms, plain_ms=plain,
         library_ms=lib, bound_ms=bd, bound_by=by)
    return dict(name="paged_prefill_nhd_fused", source="hpc_ops_tpu_torch/csrc/prefill.cu",
                replaces="hpc_ops_tpu/ops/attention/prefill.py:1070", max_abs_err=err, ms=ms,
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


def slice_tiny(dev, phase="slice_tiny", **cfg_kw):
    import torch

    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.runtime.engine import Engine
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

    cfg = llama.tiny_config(**cfg_kw)
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
    emit(phase, max_logits_diff=diffs, tokens_card=outs[str(dev)], tokens_cpu=outs["cpu"],
         near_tie_flips=flips)


PROFILE_FROM, PROFILE_STEPS = 4, 3  # decode steps 5..7 of slice_full


class DecodeProfile:
    """torch.profiler over a few decode steps: device time per step by kernel
    class and the device's idle share of the window's wall time."""

    def __init__(self, torch, classes):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.classes = classes  # kernel-name substring -> class name
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
        classes = {**{c: 0.0 for c in self.classes.values()}, "gemm": 0.0, "other": 0.0}
        other = {}
        for e in self.prof.key_averages():
            if e.device_type != cuda:
                continue
            us = e.self_device_time_total
            name = e.key
            for k, c in self.classes.items():
                if k in name:
                    classes[c] += us
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


BF16_KERNELS = ("rope_store", "paged_decode", "paged_prefill")
INT8_KERNELS = ("rope_store_int8", "paged_decode_nhd_fused", "paged_prefill_nhd_fused")


def full_prompts(vocab):
    import numpy as np

    rng = np.random.RandomState(0)
    lens = [16, 2000] + [int(x) for x in rng.randint(16, 2001, 6)]
    return lens, [[int(t) for t in rng.randint(0, vocab, n)] for n in lens]


def serve_full(dev, cfg, w, phase, kernels_used):
    """Engine(cfg) at full width and depth on weights ``w``: 8 prompts x 32
    new tokens, with every sampled-from logits tensor checked finite, the
    launch counts of ``kernels_used`` as the step counts say and every other
    kernel at 0, and three decode steps profiled. Returns (launch counts,
    last-token logits of each prefill call, the engine)."""
    import torch

    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.runtime import engine as engine_mod

    lens, prompts = full_prompts(cfg.vocab)
    finite, prefill_logits = [], []
    base_forward = engine_mod.forward_step

    def checked_forward(*a, **kw):
        out, caches = base_forward(*a, **kw)
        finite.append(torch.isfinite(out).all())
        if kw.get("is_prefill"):
            prefill_logits.append(out.float().reshape(-1))
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
        prefill_logits.clear()
        kernels.reset_launch_counts()
        prefill_s, decode_s, decode_tokens = [], [], 0
        profiled = None
        while True:
            st = eng.stats
            decode_next = st["pending"] == 0
            n_dec = st["decode_dispatches"]
            if decode_next and n_dec == PROFILE_FROM:
                profiled = DecodeProfile(torch, dict(zip(("rope_store", "paged_decode", "paged_prefill"),
                                                         kernels_used)))
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
        raise AssertionError(f"{phase}: non-finite logits")
    if not all(len(o) == 32 and all(0 <= x < cfg.vocab for x in o) for o in outs):
        raise AssertionError(f"{phase}: missing tokens or tokens outside the vocab")
    st = eng.stats
    n_pre, n_dec = st["prefill_dispatches"], st["decode_dispatches"]
    per_step = dict(zip(kernels_used, (n_dec, n_dec, n_pre)))
    expect = {k: per_step.get(k, 0) * cfg.layers for k in counts}
    if counts != expect or min(counts[k] for k in kernels_used) == 0:
        raise AssertionError(f"{phase}: launch counts {counts} != expected {expect}")
    stats = dict(config="llama3_8b", int8_kv=cfg.int8_kv, kv_scale=cfg.kv_scale,
                 residual_alpha=cfg.residual_alpha, layers=cfg.layers, prompt_lens=lens,
                 new_tokens=32, prefill_calls=n_pre, prefill_s_total=sum(prefill_s),
                 prefill_s_each=prefill_s, prefill_tokens_per_s=sum(lens) / sum(prefill_s),
                 decode_steps=n_dec, decode_steps_timed=len(decode_s),
                 decode_ms_per_step=1e3 * sum(decode_s) / len(decode_s),
                 decode_tokens_per_s=decode_tokens / sum(decode_s),
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 launches=counts, first_tokens=[o[:4] for o in outs])
    return stats, counts, prefill_logits, eng, profiled


def slice_full(dev, w):
    import torch

    from hpc_ops_tpu_torch.models import llama

    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    stats, counts, prefill_logits, eng, profiled = serve_full(dev, cfg, w, "slice_full", BF16_KERNELS)
    del eng
    torch.cuda.empty_cache()
    emit("slice_full", **stats)
    emit("decode_profile", **profiled.summary())
    return counts, prefill_logits


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
    rows = [check_rope(dev, gen), check_decode(dev, gen), check_prefill(dev, gen),
            check_rope_int8(dev, gen), check_decode_nhd_fused(dev, gen),
            check_prefill_nhd_fused(dev, gen)]
    slice_tiny(dev)
    slice_tiny(dev, "slice_tiny_int8", int8_kv=True, kv_scale=0.02)

    from hpc_ops_tpu_torch.models import llama

    # one set of seeded weights (16 GB) serves both paths: int8_kv changes no weight
    t0 = time.perf_counter()
    w = llama.init_weights(llama.llama3_8b(), torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    emit("init_weights", config="llama3_8b", seconds=time.perf_counter() - t0)
    counts, bf16_prefill_logits = slice_full(dev, w)
    counts_int8 = slice_full_int8(dev, w, bf16_prefill_logits)
    for r in rows:
        r["route"] = "cuda"
        # each kernel's launches on its own path's run
        r["launches"] = counts_int8[r["name"]] if r["name"] in INT8_KERNELS else counts[r["name"]]
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
