#!/usr/bin/env python3
"""Time the rope store (bf16 and int8) and the MoE top-k reduce of the checkout at ROOT.

Usage: ``python3 scripts/time_rope_reduce.py ROOT`` on a machine with one
CUDA card. ROOT is the root of a checkout of this repository; its package is
imported (its kernels are built there at first use). The timers
(``time_ms``: CUDA events over back-to-back calls, host time included;
``device_ms``: torch.profiler's kernel time; ``host_us``: the host's
microseconds a call, 200 calls enqueued without a sync, the least of five
runs), the bounds and the rope
inputs come from the ``chip_smoke.py`` beside this script, so both
checkouts of an A/B run are timed by the same code on the same inputs.
Prints one JSON line:

- ``rope``: ``rope_store_rows`` (HND bf16 caches) and ``rope_store_rows_int8``
  (the NHD_FUSED slab), QK-norm off, at a decode batch of 8 rows and at the
  ragged 2048-row prefill of ``chip_smoke.rope_rows_case`` (llama3_8b heads:
  Hq 32, Hkv 8, D 128, pages of 16): wall ms, device ms, share of the bytes
  bound (of device time) and host us a call;
- ``reduce``: ``moe_reduce`` at Mixtral width (h 4096, top-2, no shared
  expert) at 8, 512 and 2048 tokens, each token's two rows at random places
  of a [2 * tokens, h] buffer: the same columns.

To compare two commits, unpack both and run parent, change, change, parent
in one call on one card.
"""

import importlib.util
import json
import os
import sys

REDUCE_TOKENS = (8, 512, 2048)


def load_chip_smoke():
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def timed(cs, call, nbytes, flops=0.0):
    dev_ms = cs.device_ms(call, 50)
    bd, _ = cs.bound(nbytes, flops)
    return dict(ms=cs.time_ms(call, 100), device_ms=dev_ms, bound_ms=bd, share_of_bound=bd / dev_ms,
                host_us=cs.host_us(call))


def rope(cs, torch, dev):
    from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache
    from hpc_ops_tpu_torch.ops.rope_kernel import rope_store_rows, rope_store_rows_int8

    gen = torch.Generator().manual_seed(14)
    cos_sin = make_cos_sin_cache(cs.ROPE_MAX_POS, cs.D, 500000.0, device=dev)
    kf = torch.zeros((cs.HKV, cs.NUM_BLOCKS * cs.BS, cs.D), dtype=torch.bfloat16, device=dev)
    vf = torch.zeros_like(kf)
    slab = torch.zeros((cs.NUM_BLOCKS, 2 * cs.BS, cs.HKV * cs.D), dtype=torch.int8, device=dev)
    scale = torch.tensor([0.05], device=dev)
    out = []
    for prefill in (False, True):
        qkv, seq_lens, q_index, tbl = cs.rope_rows_case(dev, gen, prefill)
        rows = qkv.shape[0]
        tables = (qkv, cos_sin, seq_lens, q_index, tbl, None, None)
        flops = rows * (cs.HQ + cs.HKV) * cs.D * 3
        bf16 = lambda: rope_store_rows(*tables, kf, vf, hq=cs.HQ, hkv=cs.HKV, d=cs.D, dv=cs.D,  # noqa: E731
                                       block_size=cs.BS, qk_norm_policy=0, head_major=True)
        int8 = lambda: rope_store_rows_int8(*tables, slab, scale, scale, hq=cs.HQ, hkv=cs.HKV,  # noqa: E731
                                            d=cs.D, block_size=cs.BS, qk_norm_policy=0)
        out.append(dict(kernel="rope_store", rows=rows, **timed(cs, bf16, cs.rope_bytes(rows, 2), flops)))
        out.append(dict(kernel="rope_store_int8", rows=rows,
                        **timed(cs, int8, cs.rope_bytes(rows, 1), flops + rows * 4 * cs.HKV * cs.D)))
    return out


def reduce(cs, torch, dev):
    from hpc_ops_tpu_torch.ops.moe import moe_reduce

    gen = torch.Generator(device=dev).manual_seed(16)
    h, k = cs.MOE_H, cs.MOE_K
    out = []
    for tokens in REDUCE_TOKENS:
        x = torch.randn((tokens * k, h), generator=gen, device=dev).to(torch.bfloat16)
        pos = torch.randperm(tokens * k, generator=gen, device=dev).view(tokens, k).to(torch.int32)
        ts = torch.softmax(torch.randn((tokens, k), generator=gen, device=dev), dim=-1)
        pairs = tokens * k
        nbytes = pairs * h * 2 + tokens * h * 2 + pairs * 8
        out.append(dict(kernel="moe_reduce", tokens=tokens,
                        **timed(cs, lambda: moe_reduce(x, pos, ts), nbytes, 2.0 * pairs * h)))
    return out


def main(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = load_chip_smoke()
    dev = "cuda"
    return dict(root=root, device=cs.nvidia_smi_line(), rope=rope(cs, torch, dev),
                reduce=reduce(cs, torch, dev))


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])), flush=True)
