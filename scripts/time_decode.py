#!/usr/bin/env python3
"""Time the paged decode kernel (``csrc/decode.cu``) of the checkout at ROOT.

Usage: ``python3 scripts/time_decode.py [--splits N,N,...] ROOT [ROOT ...]``
on a machine with one CUDA card. Each ROOT is the root of a checkout of this repository (its
kernels are built there at first use; each checkout runs in a process of its
own). Prints one JSON line a checkout: device ms a call (torch.profiler, the
kernels' summed time) at ``chip_smoke.py``'s check_decode shape (B 8, Hq 32,
Hkv 8, D 128, pages of 16, kv_len 1-4096, a table of 260 pages): bf16 HND,
split (the default) and with ``splitk=False``, the int8 NHD_FUSED slab, and at
a serving-like shape (kv_len 16-2032 in a table of 512 pages, as the Engine
pads it). ``--splits`` also times the split grid at each given split count
(in place of ``decode_splits``' rule; capped at the table's tiles). To
compare two commits, unpack both and pass parent, change, change, parent in
one call on one card.
"""

import json
import subprocess
import sys

LENS = [1, 2048, 4096, 2963, 1346, 3412, 2436, 1735]
SERVING_LENS = [16, 2032, 300, 1200, 64, 700, 1900, 45]
HQ, HKV, D, BS = 32, 8, 128, 16


def device_ms(torch, fn, iters=50, warmup=5):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == cuda and e.count
              and "Memcpy" not in e.key and "Memset" not in e.key]
    if not events:
        return device_ms(torch, fn, iters, 0)
    # a session now and then records only some kernels: each kernel's mean
    # duration times its launches a call
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
               for e in events) / 1e3


def table(torch, gen, lens, width, nb, dev):
    perm = torch.randperm(nb, generator=gen)
    tbl = torch.full((len(lens), width), -1, dtype=torch.int32)
    off = 0
    for i, n in enumerate(lens):
        k = -(-n // BS)
        tbl[i, :k] = perm[off : off + k]
        off += k
    return tbl.to(dev)


def run(root: str, splits=()) -> dict:
    sys.path.insert(0, root)
    import torch

    from hpc_ops_tpu_torch.ops.attention import decode

    dev = "cuda"
    gen = torch.Generator().manual_seed(5)
    nb = 4200
    k = torch.randn((HKV, nb, BS, D), generator=gen).to(torch.bfloat16).to(dev)
    v = torch.randn((HKV, nb, BS, D), generator=gen).to(torch.bfloat16).to(dev)
    slab = torch.randint(-127, 128, (nb, 2 * BS, HKV * D), generator=gen, dtype=torch.int8).to(dev)
    sc = torch.tensor([0.05], device=dev)
    q = torch.randn((8, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
    out = {}
    for name, lens, width in (("check_decode", LENS, 4096 // BS + 4), ("serving", SERVING_LENS, 512)):
        tbl = table(torch, gen, lens, width, nb, dev)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        out[f"{name}_bf16"] = device_ms(
            torch, lambda: decode.paged_decode_attention(q, k, v, tbl, kv, 1, D**-0.5, "HND"))
        out[f"{name}_int8_slab"] = device_ms(
            torch, lambda: decode.paged_decode_nhd_fused(q, slab, tbl, kv, 1, D**-0.5, sc, sc))
        if name == "check_decode" and "splitk" in (decode.paged_decode_attention.__kwdefaults__ or {}):
            out[f"{name}_bf16_splitk_false"] = device_ms(
                torch, lambda: decode.paged_decode_attention(q, k, v, tbl, kv, 1, D**-0.5, "HND",
                                                             splitk=False))
        rule = decode.decode_splits
        for n in splits:
            decode.decode_splits = lambda b, p, s=True, n=n: min(n, -(-p // 64))
            out[f"{name}_bf16_splits_{n}"] = device_ms(
                torch, lambda: decode.paged_decode_attention(q, k, v, tbl, kv, 1, D**-0.5, "HND"))
            decode.decode_splits = rule
    return {"root": root, "device": torch.cuda.get_device_name(0), "device_ms": out}


if __name__ == "__main__":
    args = sys.argv[1:]
    opt = []
    if args and args[0] == "--splits":
        opt, args = args[:2], args[2:]
    if len(args) > 1:  # one process a checkout: each loads its own kernel library
        for r in args:
            subprocess.run([sys.executable, __file__, *opt, r], check=True)
    else:
        sp = tuple(int(x) for x in opt[1].split(",")) if opt else ()
        print(json.dumps(run(args[0] if args else ".", sp)), flush=True)
