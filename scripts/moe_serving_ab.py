#!/usr/bin/env python3
"""Serve the Mixtral-8x7B widths with fp8 experts and with int8 experts in
turns, in one process on one card.

Usage, from the root of a checkout on a machine with one CUDA card:
``python3 scripts/moe_serving_ab.py``. Runs ``chip_smoke.py``'s serving run
(``serve_full``: 32 layers, 8 prompts of 16..512 tokens, 32 greedy tokens,
batch 8, three decode steps profiled) four times, fp8, int8, int8, fp8, each
on weights drawn from seed 0 (the same float32 masters) after the previous
run's weights are freed, and prints one JSON line a run: decode ms per step,
prefill tokens/s, and the profiled device busy ms, launches, host wall ms and
idle share per decode step. Alternating the order separates the two schemes
from a drift of the host over the call.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(dev) -> list:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from hpc_ops_tpu_torch.models import llama

    print(cs.nvidia_smi_line(), flush=True)
    runs = []
    for scheme in ("pertensor_fp8", "pertensor_int8", "pertensor_int8", "pertensor_fp8"):
        cfg = cs.mixtral_8x7b(scheme)
        w = llama.init_weights(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        stats, _, _, eng, profiled = cs.serve_full(dev, cfg, w, f"moe {scheme}", cs.BF16_KERNELS,
                                                   config="mixtral_8x7b", longest=512)
        p = profiled.summary()
        run = dict(scheme=scheme, decode_ms_per_step=stats["decode_ms_per_step"],
                   prefill_tokens_per_s=stats["prefill_tokens_per_s"],
                   device_busy_ms_per_step=p["device_busy_ms_per_step"],
                   kernel_launches_per_step=p["kernel_launches_per_step"],
                   wall_ms_per_step=p["wall_ms_per_step"], idle_share=p["idle_share"])
        print(json.dumps(run), flush=True)
        runs.append(run)
        del eng, w
        torch.cuda.empty_cache()
    return runs


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        sys.exit("moe_serving_ab.py: no CUDA device")
    main(torch.device("cuda"))
