#!/usr/bin/env python3
"""Serve llama3_8b's dense serving modes (and with ``--moe`` the Mixtral
widths' fp8 and blockwise int8 MoE) eagerly and through the captured
multi-step decode, on one CUDA card.

Usage: ``python3 scripts/multi_step_modes.py [--moe]`` from the root of a
checkout. Each mode is served twice by ``chip_smoke.serve_full`` (8 prompts
of 16 to 2000 tokens, or 512 for the MoE, batch 8, greedy): eagerly, 32 new
tokens, a decode step an engine step; then with ``multi_step=8``, 64 new
tokens, a decode dispatch a replay of the captured graph. Prints one JSON
line a run: decode ms a step, device busy ms a step (torch.profiler's sum
of kernel times and the union of their intervals) and idle share over three
profiled dispatches, kernels a step, device-to-host copies a dispatch, the
device ms a step by kernel class, the graph's capture seconds and pool, and
the share of the multi-step run's first 32 tokens that equal the eager
run's. Tells which launch-bound items the graph leaves on the device.
"""

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTI_STEP, NEW_TOKENS = 8, 64


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def serve(cs, dev, cfg, w, name, kernels_used, longest):
    """The eager run and the multi-step run of one mode; one line each."""
    import torch

    out = {}
    for ms, new in ((1, 32), (MULTI_STEP, NEW_TOKENS)):
        stats, _, _, eng, profiled = cs.serve_full(dev, cfg, w, name, kernels_used, longest=longest,
                                                   multi_step=ms, new_tokens=new)
        prof = profiled.summary()
        line = dict(mode=name, multi_step=ms, decode_ms_per_step=stats["decode_ms_per_step"],
                    **{k: prof[k] for k in ("device_busy_ms_per_step", "device_busy_union_ms_per_step",
                                            "idle_share", "idle_share_union", "kernel_launches_per_step",
                                            "device_ms_per_step")},
                    device_to_host_copies_per_dispatch=prof.get("device_to_host_copies_per_dispatch",
                                                                prof["device_to_host_copies_per_step"]),
                    max_memory_allocated_bytes=stats["max_memory_allocated_bytes"])
        out[ms] = [r.out for r in eng.requests.values()]
        if ms > 1:
            line["graph"] = stats["graph"]
            same = sum(a == b for x, y in zip(out[1], out[ms]) for a, b in zip(x, y[:32]))
            line["tokens_equal_to_eager"] = same / sum(len(x) for x in out[1])
        del eng
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("multi_step_modes.py: no CUDA device", file=sys.stderr)
        return 1
    from hpc_ops_tpu_torch.models import llama

    cs = load_chip_smoke()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": cs.nvidia_smi_line(), "torch": torch.__version__}), flush=True)
    w = llama.init_weights(llama.llama3_8b(), torch.Generator(device=dev).manual_seed(0), device=dev)
    for name, kw, used in (("bf16", {}, cs.BF16_KERNELS), ("int8_kv", dict(int8_kv=True), cs.INT8_KERNELS),
                           ("fp8_kv", dict(fp8_kv=True), cs.FP8_KERNELS)):
        serve(cs, dev, llama.llama3_8b(residual_alpha=1.0 / 8, **kw), w, name, used, 2000)
    layers = []
    for layer in w["layers"]:  # W8A8: int8 copies beside the bf16 weights, one layer at a time
        q = dict(layer)
        for n in ("wqkv", "wo", "w_gate_up", "w_down"):
            q[n], q[n + "_scale"] = llama.quantize_w8(layer[n])
        layers.append(q)
    serve(cs, dev, llama.llama3_8b(dense_int8=True, residual_alpha=1.0 / 8), {**w, "layers": layers},
          "w8a8", cs.BF16_KERNELS, 2000)
    del w, layers
    torch.cuda.empty_cache()
    if "--moe" in sys.argv[1:]:
        for scheme in ("pertensor_fp8", "blockwise_int8"):
            cfg = cs.mixtral_8x7b(scheme)
            w = llama.init_weights(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            serve(cs, dev, cfg, w, f"moe_{scheme}", cs.BF16_KERNELS, 512)
            del w
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
