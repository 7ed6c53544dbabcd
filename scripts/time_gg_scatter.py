#!/usr/bin/env python3
"""Time the e4m3 scatter grouped GEMM (``gg_scatter``) of the checkout at ROOT.

Usage: ``python3 scripts/time_gg_scatter.py ROOT`` on a machine with one CUDA
card. ROOT is the root of a checkout of this repository (its kernels are
built there at first use). Prints one JSON line: CUDA-event times in ms of
the gate-up and down GEMMs at the Mixtral-8x7B widths (hidden 4096, expert
intermediate 14336, 8 experts, top-2) for 8 tokens (a decode step) and 2048
tokens (a prefill), on seeded e4m3 inputs. To compare two commits, unpack
both and run parent, change, change, parent in one call on one card.
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

    from hpc_ops_tpu_torch.ops.group_gemm import _pick_tm, gg_scatter
    from hpc_ops_tpu_torch.ops.moe import _route_aligned

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    h, i, e, k = 4096, 14336, 8, 2

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 80).clamp(-448, 448).to(torch.float8_e4m3fn)

    gw, dw = rnd(e, 2 * i, h), rnd(e, h, i)
    sc = torch.full((e,), 1e-6, device=dev)
    out = {}
    for s in (8, 2048):
        ids = torch.topk(torch.randn((s, e), generator=g, device=dev), k, -1)[1].int()
        tm = _pick_tm(max(s * k // e, 1), h)
        row_idx, _, _, _, _, cu_tiles, grp = _route_aligned(ids, e, 0, tm)
        x, act = rnd(s, h), rnd(row_idx.shape[0], i)
        ident = torch.arange(row_idx.shape[0], dtype=torch.int32, device=dev)
        nvt = cu_tiles[-1:]
        for name, args in (("gate_up", (x, gw, sc, row_idx, grp, tm, nvt)),
                           ("down", (act, dw, sc, ident, grp, tm, nvt))):
            out[f"{s}_{name}"] = time_ms(torch, lambda: gg_scatter(*args), 100 if s == 8 else 20)
    return {"root": root, "ms": out}


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    print(json.dumps(main(sys.argv[1])), flush=True)
