#!/usr/bin/env python3
"""Time the blockwise int8 MoE kernels of the checkout at ROOT at the shapes
its serving path gives them.

Usage: ``python3 scripts/time_gg_bw.py ROOT`` on a machine with one CUDA
card. ROOT is the root of a checkout of this repository (its kernels are
built there at first use). Prints one JSON line: CUDA-event times in ms of
the blockwise scatter gate-up GEMM (``gg_bw_scatter``), the blockwise
aligned down GEMM (``gg_bw_aligned``) and the whole
``fuse_moe_blockwise_int8`` at the Mixtral-8x7B widths (hidden 4096, expert
intermediate 14336, 8 experts, top-2) for 8 tokens (a decode step) and 512
tokens (a prefill), on seeded int8 codes and scales, with the m-tile of 64
that serving uses (``num_seq_per_group_avg`` 32, the default). To compare
two commits, unpack both and run parent, change, change, parent in one call
on one card.
"""

import json
import sys


def time_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from hpc_ops_tpu_torch.ops.group_gemm import _pick_tm, gg_bw_aligned, gg_bw_scatter
    from hpc_ops_tpu_torch.ops.moe import _route_aligned, fuse_moe_blockwise_int8

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    h, i, e, k = 4096, 14336, 8, 2

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(shape, generator=g, device=dev) + 0.5) / 1e4

    gw, dw = codes(e, 2 * i, h), codes(e, h, i)
    gsw, dsw = scales(e, 2 * i // 128, h // 128), scales(e, h // 128, i // 128)
    tm = _pick_tm(32, h)
    out = {}
    for s in (8, 512):
        ids = torch.topk(torch.randn((s, e), generator=g, device=dev), k, -1)[1].int()
        ts = torch.rand((s, k), generator=g, device=dev)
        row_idx, _, _, _, _, cu_tiles, grp = _route_aligned(ids, e, 0, tm)
        x, sx = codes(s, h), scales(s, h // 128)
        act, act_sx = codes(row_idx.shape[0], i), scales(row_idx.shape[0], i // 128)
        blk = torch.arange(grp.shape[0], dtype=torch.int32, device=dev)
        nvt = cu_tiles[-1:]
        iters = 100 if s == 8 else 20
        out[f"{s}_gate_up"] = time_ms(
            torch, lambda: gg_bw_scatter(x, gw, sx, gsw, row_idx, grp, tm, nvt), iters)
        out[f"{s}_down"] = time_ms(
            torch, lambda: gg_bw_aligned(act, dw, act_sx, dsw, grp, blk, tm, nvt), iters)
        out[f"{s}_moe"] = time_ms(
            torch, lambda: fuse_moe_blockwise_int8(x, sx, gw, gsw, dw, dsw, ids, ts, 0, e), iters)
    return {"root": root, "tm": tm, "ms": out}


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    print(json.dumps(main(sys.argv[1])), flush=True)
