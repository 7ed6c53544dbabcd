#!/usr/bin/env python3
"""Time the per-tensor grouped GEMMs of the checkout at ROOT.

Usage: ``python3 scripts/time_gg_scatter.py ROOT [WG]`` on a machine with
one CUDA card. ROOT is the root of a checkout of this repository (its
kernels are built there at first use). Prints one JSON line: CUDA-event
times in ms of the gate-up and down GEMMs at the Mixtral-8x7B widths (hidden
4096, expert intermediate 14336, 8 experts, top-2) for 8 tokens (a decode
step), 200, 512, 1024 and 2048 tokens (prefills; 1024 gives chat's m-tile of
288 slots), on seeded e4m3 inputs and int8 codes, at the m-tile the MoE
picks for each count (``tm``, by token count), for every per-tensor form: the
scatter GEMM over e4m3 (``scatter_e4m3``) and int8 (``scatter_i8``), the
int8 gate-up GEMM with the fused activation (``act``), and the aligned GEMM
(``gg_pertensor``) over e4m3 and int8 (``pertensor_*``). WG (a checkout
with ``ops/group_gemm.py:gg_form``) forces that function's value, the
body and block, on every per-tensor form (the e4m3 forms take 0 and 3,
the int8 forms 1 and 2); a form that refuses it reads null. Without it each
launch takes gg_form's choice. To compare two
commits, unpack both and run parent, change, change, parent in one call on
one card.
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


def main(root: str, wg: str | None = None) -> dict:
    sys.path.insert(0, root)
    import torch

    from hpc_ops_tpu_torch.ops import group_gemm
    from hpc_ops_tpu_torch.ops.group_gemm import _pick_tm, gg_pertensor, gg_scatter
    from hpc_ops_tpu_torch.ops.moe import _route_aligned, interleave_gate_up

    if wg is not None:
        group_gemm.gg_form = lambda tm, kind: int(wg)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    h, i, e, k = 4096, 14336, 8, 2

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 80).clamp(-448, 448).to(torch.float8_e4m3fn)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    gw, dw = rnd(e, 2 * i, h), rnd(e, h, i)
    gw8, dw8 = codes(e, 2 * i, h), codes(e, h, i)
    gw8_il = interleave_gate_up(gw8)
    sc = torch.full((e,), 1e-6, device=dev)
    am = torch.full((1,), 16.0, device=dev)
    out, tms = {}, {}
    for s in (8, 200, 512, 1024, 2048):
        ids = torch.topk(torch.randn((s, e), generator=g, device=dev), k, -1)[1].int()
        tm = tms[s] = _pick_tm(max(s * k // e, 1), h)
        row_idx, _, _, _, _, cu_tiles, grp = _route_aligned(ids, e, 0, tm)
        slots = row_idx.shape[0]
        ident = torch.arange(slots, dtype=torch.int32, device=dev)
        blk = torch.arange(grp.shape[0], dtype=torch.int32, device=dev)
        nvt = cu_tiles[-1:]
        x, x8 = rnd(s, h), codes(s, h)
        x_al, x8_al = rnd(slots + tm, h), codes(slots + tm, h)  # every slot a row, the trash tile
        act, act8 = rnd(slots + tm, i), codes(slots + tm, i)
        calls = {
            "scatter_e4m3_gate_up": lambda: gg_scatter(x, gw, sc, row_idx, grp, tm, nvt),
            "scatter_e4m3_down": lambda: gg_scatter(act[:slots], dw, sc, ident, grp, tm, nvt),
            "scatter_i8_gate_up": lambda: gg_scatter(x8, gw8, sc, row_idx, grp, tm, nvt),
            "scatter_i8_down": lambda: gg_scatter(act8[:slots], dw8, sc, ident, grp, tm, nvt),
            "act_gate_up": lambda: gg_scatter(x8, gw8_il, sc, row_idx, grp, tm, nvt, act_fuse=True,
                                              act_scale=am),
            "pertensor_e4m3_gate_up": lambda: gg_pertensor(x_al, gw, sc, grp, blk, tm, nvt),
            "pertensor_e4m3_down": lambda: gg_pertensor(act, dw, sc, grp, blk, tm, nvt),
            "pertensor_i8_gate_up": lambda: gg_pertensor(x8_al, gw8, sc, grp, blk, tm, nvt),
            "pertensor_i8_down": lambda: gg_pertensor(act8, dw8, sc, grp, blk, tm, nvt),
        }
        for name, fn in calls.items():
            try:
                out[f"{s}_{name}"] = time_ms(torch, fn, 100 if s == 8 else 20)
            except RuntimeError:  # the form has no such block
                out[f"{s}_{name}"] = None
    return {"root": root, "wg": wg, "tm": tms, "ms": out}


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    print(json.dumps(main(*sys.argv[1:])), flush=True)
