"""Row 2's decode (B 8, kv_len 1-4096, Hq 32, Hkv 8, D 128, pages of 16,
bf16 HND caches) and a dense SDPA over 4096 positions on one CUDA card:
``chip_smoke.device_ms`` (torch.profiler), ``chip_smoke.queued_ms`` (CUDA
events around calls queued behind a spin kernel) and ``chip_smoke.time_ms``
(CUDA events around eager calls), three times each, in one process.

Run from the root of a checkout: ``python3 scripts/compare_device_timers.py
[root]``, where ``root`` (default: this checkout) holds the chip_smoke.py and
the package to time."""
import os
import sys

root = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, root)
os.chdir(root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hpc_ops_tpu_torch.ops.attention.decode import paged_decode_attention  # noqa: E402

gen = torch.Generator().manual_seed(0)
dev = "cuda"
b, BS, HQ, HKV, D = 8, 16, 32, 8, 128
lens = torch.randint(1, 4097, (b,), generator=gen)
lens[0], lens[1], lens[2] = 1, 2048, 4096
tbl = cs.random_table(gen, [int(x) for x in lens], 4096 // BS + 4, 2056, dev)
kv = lens.to(torch.int32).to(dev)
q = torch.randn((b, HQ, D), generator=gen).to(torch.bfloat16).to(dev)
k = torch.randn((HKV, 2056, BS, D), generator=gen).to(torch.bfloat16).to(dev)
v = torch.randn((HKV, 2056, BS, D), generator=gen).to(torch.bfloat16).to(dev)
q4 = torch.randn((b, HQ, 1, D), generator=gen).to(torch.bfloat16).to(dev)
kg = torch.randn((b, HQ, 4096, D), generator=gen).to(torch.bfloat16).to(dev)
print(cs.nvidia_smi_line())
for name, fn in (("decode", lambda: paged_decode_attention(q, k, v, tbl, kv, 1, D**-0.5, "HND")),
                 ("sdpa", lambda: torch.nn.functional.scaled_dot_product_attention(q4, kg, kg))):
    for _ in range(3):
        print(name, "device_ms", cs.device_ms(fn, 50), "queued_ms", cs.queued_ms(fn, 50),
              "time_ms", cs.time_ms(fn, 50), flush=True)
