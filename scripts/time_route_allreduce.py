#!/usr/bin/env python3
"""Time the route GEMM and the fused all-reduce + RMSNorm of the checkout at ROOT.

Usage: ``python3 scripts/time_route_allreduce.py ROOT [--forms]`` on a
machine with one CUDA card. ROOT is the root of a checkout of this
repository; its package is imported (its kernels are built there at first
use). The timers (``time_ms``: CUDA events over back-to-back calls;
``device_ms``: torch.profiler), the route GEMM's shapes and the
collective's cases come from the ``chip_smoke.py`` beside this script, so
both checkouts of an A/B run are timed by the same code. Prints one JSON
line:

- ``route``: at each of ``chip_smoke.ROUTE_SHAPES`` the kernel's wall and
  device ms (``route_gemm``, bf16 output) and one cuBLAS float32 product's
  (``x.float() @ w.T``, TF32 off);
- ``allreduce``: one_shot and two_shot at 4 ranks x 8 tokens x 4096
  (slice_full_tp's decode collective: wall and device ms a launch), at 4
  ranks x 2048 x 4096 with the serving epilogue and a residual per rank
  (slice_full_tp's prefill collective), and at world 8 x 2048 x 4096 and 8
  x 32768 x 7168, each beside the unfused chain (wall ms);
- ``host``: the host's microseconds a call of the route GEMM's wrapper and
  of the cuBLAS product at the router's shape (200 calls enqueued without
  a sync);
- with ``--forms`` (a checkout with ``ops/gemm.py:route_form``), ``forms``:
  the route GEMM's device time at the router's shapes under every
  small-body token tile and split count up to 264 blocks (two an SM), and
  at (4096, 256, 7168) under the large body's splits, each forced through
  ``route_form``.

To compare two commits, unpack both and run parent, change, change, parent
in one call on one card.
"""

import importlib.util
import json
import os
import sys
import time

FORM_SHAPES = [(16, 256, 7168), (64, 256, 7168), (256, 256, 7168)]
# (mode, ranks, tokens, hidden, serving epilogue and a residual per rank)
ALLREDUCE_CASES = [("one_shot", 4, 8, 4096, False), ("two_shot", 4, 8, 4096, False),
                   ("one_shot", 4, 2048, 4096, True), ("two_shot", 4, 2048, 4096, True),
                   ("one_shot", 8, 2048, 4096, False), ("two_shot", 8, 2048, 4096, False),
                   ("one_shot", 8, 32768, 7168, False), ("two_shot", 8, 32768, 7168, False)]


def load_chip_smoke():
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def route_inputs(torch, dev, m, n, k):
    from hpc_ops_tpu_torch.ops.gemm import split_fp32_weight

    g = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
    w32 = torch.randn((n, k), generator=g, device=dev)
    return x, w32, split_fp32_weight(w32)


def route(cs, torch, dev):
    from hpc_ops_tpu_torch.ops.gemm import route_gemm

    out = []
    for m, n, k in cs.ROUTE_SHAPES:
        x, w32, (wh, wl, ws) = route_inputs(torch, dev, m, n, k)
        kern = lambda: route_gemm(x, wh, wl, ws, False)  # noqa: E731
        xf = x.float()
        lib = lambda: xf @ w32.T  # noqa: E731
        out.append(dict(shape=[m, n, k], ms=cs.time_ms(kern), cublas_fp32_ms=cs.time_ms(lib),
                        device_ms=cs.device_ms(kern), cublas_fp32_device_ms=cs.device_ms(lib)))
        del x, w32, wh, wl, xf
        torch.cuda.empty_cache()
    return out


def allreduce(cs, torch, dev):
    gen = torch.Generator(device=dev).manual_seed(2024)
    out = []
    for mode, ws, n, h, serving in ALLREDUCE_CASES:
        kern, _, unfused = cs.allreduce_case(dev, gen, mode, ws, n, h, bf16_norm=serving, own_res=serving)[:3]
        big = n * h >= 2048 * 4096
        line = dict(mode=mode, ranks=ws, tokens=n, hidden=h, serving=serving,
                    ms=cs.time_ms(kern, 5 if big else 20), unfused_ms=cs.time_ms(unfused, 3 if big else 10, 1))
        if n <= 64:
            line["device_ms"] = cs.device_ms(kern, 50)
        out.append(line)
        del kern, unfused
        torch.cuda.empty_cache()
    return out


def host(torch, dev):
    from hpc_ops_tpu_torch.ops.gemm import route_gemm

    x, w32, (wh, wl, ws) = route_inputs(torch, dev, 256, 256, 7168)
    xf = x.float()
    out = {}
    for name, fn in (("route_gemm", lambda: route_gemm(x, wh, wl, ws, False)), ("cublas_fp32", lambda: xf @ w32.T)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[name + "_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    return out


def forms(cs, torch, dev):
    from hpc_ops_tpu_torch.ops import gemm

    real = gemm.route_form
    out = []

    def run(m, n, k, body, tm, tn, splits):
        form = gemm.make_form(body, tm, tn, m, n, splits)
        gemm.route_form = lambda *_: form
        try:
            ms = cs.device_ms(lambda: gemm.route_gemm(x, wh, wl, ws, False), 30)
        finally:
            gemm.route_form = real
        out.append(dict(shape=[m, n, k], body=body, tile=[tm, tn], splits=splits, blocks=form.blocks,
                        device_ms=ms, chosen=real(m, n, k) == form))

    for m, n, k in FORM_SHAPES + [(4096, 256, 7168)]:
        x, _, (wh, wl, ws) = route_inputs(torch, dev, m, n, k)
        if m <= 256:
            for tm in (16, 32, 64):
                tiles = -(-m // tm) * -(-n // 64)
                for splits in range(1, min(33, 2 * 132 // tiles + 1)):
                    run(m, n, k, "small", tm, 64, splits)
        else:
            for splits in (1, 2, 3, 4):
                run(m, n, k, "large", 128, 128, splits)
    return out


def main(root: str, with_forms: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    result = dict(root=root, device=cs.nvidia_smi_line(), route=route(cs, torch, dev),
                  allreduce=allreduce(cs, torch, dev), host=host(torch, dev))
    if with_forms:
        result["forms"] = forms(cs, torch, dev)
    return result


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], "--forms" in sys.argv[2:])), flush=True)
