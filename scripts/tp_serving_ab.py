#!/usr/bin/env python3
"""Serve llama3_8b on 4 virtual tensor-parallel ranks, and on one device as
a control, with the checkout at ROOT.

Usage: ``python3 scripts/tp_serving_ab.py ROOT [RUNS]`` on a machine with
one CUDA card. ROOT is the root of a checkout of this repository; its
``chip_smoke.py`` and package are imported (its kernels are built there at
first use). Draws llama3_8b's weights from seed 0 once, then RUNS times
(default 2) runs ``chip_smoke.py``'s serving run (``serve_full``: 32
layers, 8 prompts of 16..2000 tokens, 32 greedy tokens, batch 8, three
decode steps profiled) on one device and then on a (dp 1, tp 4) mesh of
virtual ranks, as ``slice_full`` and ``slice_full_tp`` do. Prints one JSON
line a run: decode ms per step, prefill tokens/s, and per profiled decode
step the device busy ms, the collective's device ms, launches, host wall ms
and idle share. The single-device run shows how far the host drifts over
the call. To compare two commits, unpack both and run parent, change,
change, parent in one call on one card.
"""

import json
import sys


def main(root: str, runs: int) -> list:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from hpc_ops_tpu_torch.models import llama
    from hpc_ops_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    w = llama.init_weights(llama.llama3_8b(), torch.Generator(device=dev).manual_seed(0), device=dev)
    cfg = llama.llama3_8b(residual_alpha=1.0 / 8)
    out = []
    for i in range(runs):
        for tp in (1, cs.TP_FULL):
            mesh = make_mesh(tp=tp, dp=1, devices=[dev] * tp) if tp > 1 else None
            stats, _, _, eng, profiled = cs.serve_full(dev, cfg, w, f"tp {tp}", cs.BF16_KERNELS, mesh=mesh)
            p = profiled.summary()
            run = dict(root=root, run=i, tp=tp, decode_ms_per_step=stats["decode_ms_per_step"],
                       prefill_tokens_per_s=stats["prefill_tokens_per_s"],
                       device_busy_ms_per_step=p["device_busy_ms_per_step"],
                       collective_device_ms_per_step=p["device_ms_per_step"].get("allreduce_rmsnorm", 0.0),
                       kernel_launches_per_step=p["kernel_launches_per_step"],
                       wall_ms_per_step=p["wall_ms_per_step"], idle_share=p["idle_share"])
            print(json.dumps(run), flush=True)
            out.append(run)
            del eng
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        sys.exit("tp_serving_ab.py: no CUDA device")
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 2)
