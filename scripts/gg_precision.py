#!/usr/bin/env python3
"""How close the e4m3 per-tensor grouped GEMM comes to the plain version, and
what that does to the fp8 MoE.

Usage: ``python3 scripts/gg_precision.py [WG ...]`` from the root of a
checkout, on a machine with one CUDA card. WG values (default ``0 3``) are
forced as ``ops/group_gemm.py:gg_form``'s value, one at a time: 0 the
mma.sync body, 3 the register-operand wgmma body. Prints one JSON line:

- ``gemm_wg{W}_tm{T}_k{K}``: the scatter grouped GEMM (4 experts, N 512)
  at m-tiles of T slots (32: a decode step's; 64-512: the prefills' of the
  benchmark's cells, 288 chat's at ~1000 rows): the share of bf16 outputs
  that differ from the plain version's, and the median error against a
  float64 product;
- ``moe_s{S}_{rank}_{ranks}``: ``fuse_moe_pertensor_fp8`` at the inputs of
  the fp8 MoE card test (``tests/test_torch_cuda.py::
  test_fuse_moe_on_the_card_syncs_nothing_and_matches_cpu``; S 32 tokens:
  m-tiles of 32, S 512: m-tiles of 160; top-4 of 16 experts, widths 256)
  with gg_form's own choice: the largest error against the CPU run and how
  far the worst element lies past that test's bar of 0.02 + 2% (negative:
  inside it).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hpc_ops_tpu_torch.ops import group_gemm as gg  # noqa: E402
from hpc_ops_tpu_torch.ops.moe import fuse_moe_pertensor_fp8  # noqa: E402

FP8 = torch.float8_e4m3fn


def fp8(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(FP8)


def moe_inputs(gen, s, k, h, interm, e_local, e_total):
    """The fp8 MoE card test's inputs, drawn in its order."""
    return dict(
        x=fp8(gen, s, h, scale=0.2), gw=fp8(gen, e_local, 2 * interm, h), dw=fp8(gen, e_local, h, interm),
        gs=torch.rand(e_local, generator=gen) * 0.4 + 0.2,
        ds=(torch.rand(e_local, generator=gen) * 0.1 + 0.05) / 16, act=torch.tensor([16.0]),
        ids=torch.randint(0, e_total, (s, k), generator=gen, dtype=torch.int32),
        ts=torch.rand((s, k), generator=gen) / k,
    )


def main(wgs) -> dict:
    cuda = torch.device("cuda")
    out = {}
    for s in (32, 512):
        for rank_ep, size_ep in ((0, 1), (1, 4)):
            gen = torch.Generator().manual_seed(25)
            t = moe_inputs(gen, s, 4, 256, 256, 16 // size_ep, 16)
            args = [t[n] for n in ("x", "gw", "dw", "gs", "ds", "act", "ids", "ts")]
            want = fuse_moe_pertensor_fp8(*args, rank_ep, 16).float()
            got = fuse_moe_pertensor_fp8(*[a.to(cuda) for a in args], rank_ep, 16).float().cpu()
            excess = ((got - want).abs() - (2e-2 + 2e-2 * want.abs())).max()
            out[f"moe_s{s}_{rank_ep}_{size_ep}"] = dict(
                max_abs_err=float((got - want).abs().max()), worst_excess_over_bar=float(excess))
    chosen = gg.gg_form
    try:
        for wg in wgs:
            gg.gg_form = lambda tm, kind, wg=wg: wg
            for tm in (32, 64, 128, 256, 288, 512):
                for k in (256, 4096, 14336):
                    gen = torch.Generator().manual_seed(5)
                    x, w = fp8(gen, 4 * tm, k, scale=8.0), fp8(gen, 4, 512, k, scale=8.0)
                    ys = torch.full((4,), 1.0 / (64.0 * k**0.5))
                    row_idx = torch.randint(0, 4 * tm, (4 * tm,), generator=gen, dtype=torch.int32)
                    grp = torch.arange(4, dtype=torch.int32)
                    want = gg.gg_scatter_ref(x, w, ys, row_idx, grp, tm)
                    got = gg.gg_scatter(x.to(cuda), w.to(cuda), ys.to(cuda), row_idx.to(cuda),
                                        grp.to(cuda), tm).cpu()
                    exact = x.double()[row_idx.long()].reshape(4, tm, k) @ w.double().transpose(1, 2)
                    exact = exact.reshape(4 * tm, 512) * float(ys[0])
                    rel = (got.double() - exact).abs() / exact.abs().clamp_min(1e-6)
                    out[f"gemm_wg{wg}_tm{tm}_k{k}"] = dict(
                        share_off_plain=float((got != want).float().mean()),
                        median_rel_err_vs_exact=float(rel.median()))
    finally:
        gg.gg_form = chosen
    return out


if __name__ == "__main__":
    print(json.dumps(main([int(a) for a in sys.argv[1:]] or [0, 3])), flush=True)
