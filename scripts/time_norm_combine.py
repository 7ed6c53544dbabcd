#!/usr/bin/env python3
"""Time the RMSNorm + fp8 quantiser, the task-map segment combine and the MoE
activation + quantisation of the checkout at ROOT.

Usage: ``python3 scripts/time_norm_combine.py ROOT [--forms]`` on a machine
with one CUDA card. ROOT is the root of a checkout of this repository; its
package is imported (its kernels are built there at first use). The timers
(``profile_kernels``: torch.profiler's device ms of a call, every kernel the
call launches counted, and the kernels a call; ``time_ms``: CUDA events over
back-to-back calls, host time included; ``host_us``: the host's
microseconds a call, 200 calls enqueued without a sync, the least of five
runs), the bounds and the shapes come from the ``chip_smoke.py`` beside this
script, so both checkouts of an A/B run are timed by the same code on the
same inputs. Prints one JSON line:

- ``norm``: ``rmsnorm_quant`` at ``chip_smoke.NORM_SHAPES`` (8 and 2048 rows
  x h 4096 and 5120), plain and MoE forms, a bf16 weight: device ms,
  kernels a call, share of the bytes bound (of device time), wall ms, host
  us a call;
- ``combine``: ``decode_combine`` at each of ``chip_smoke.SCENARIOS``' task
  maps (the numpy scheduler's "tight" map; float32 partials made from a
  seed, shaped by the map: m = -inf, l = 0 and o = 0 on sentinel tasks and
  on a tenth of the rows): the same columns, its error against the plain
  version, and the whole task path's device ms (``attention_decode`` with
  the map over the scenario's bf16 caches: the task kernel and the combine);
- ``act``: ``act_quant`` (e4m3) at every ``chip_smoke.MOE_SHAPES`` entry, at
  Mixtral width, over the rows the MoE's routing gives it: the same columns.

``--forms`` (a checkout that has ``ops/attention/decode.py:combine_form``)
adds the device ms of the combine's forms (rows a block 1, 2, 4 x column
chunks 1, 2, 4) at each scenario, each forced by patching the chooser, and
its largest difference from the chosen form's output.

To compare two commits, unpack both and run parent, change, change, parent
in one call on one card.
"""

import argparse
import importlib.util
import json
import os
import sys


def load_chip_smoke():
    here = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", here)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def timed(cs, call, nbytes, flops=0.0):
    dev_ms, kernels_a_call = cs.profile_kernels(call, 50)
    bd, _ = cs.bound(nbytes, flops)
    return dict(device_ms=dev_ms, kernels_a_call=kernels_a_call, bound_ms=bd, share_of_bound=bd / dev_ms,
                ms=cs.time_ms(call, 100), host_us=cs.host_us(call))


def norm_cases(cs, torch, dev):
    """chip_smoke's inputs for check_rmsnorm_quant: (n, h, is_moe, x, w, scale)."""
    gen = torch.Generator().manual_seed(18)
    for n, h in cs.NORM_SHAPES:
        x = (torch.randn((n, h), generator=gen) * 2).to(torch.bfloat16).to(dev)
        w = (torch.rand(h, generator=gen) + 0.5).to(torch.bfloat16).to(dev)
        for is_moe in (False, True):
            yield n, h, is_moe, x, w, torch.tensor([0.02, 0.05] if is_moe else [0.02], device=dev)


def norm(cs, torch, dev):
    from hpc_ops_tpu_torch.ops.normalization import _F32_EPS, rmsnorm_quant

    out = []
    for n, h, is_moe, x, w, sc in norm_cases(cs, torch, dev):
        call = lambda: rmsnorm_quant(x, w, sc, _F32_EPS, is_moe)  # noqa: E731
        out.append(dict(kernel="rmsnorm_quant", tokens=n, hidden=h, moe=is_moe,
                        **timed(cs, call, cs.norm_bytes(n, h, is_moe), 5 * n * h)))
    return out


def scenario_map(cs, torch, dev, kv_lens):
    from hpc_ops_tpu_torch.ops.attention.scheduler import assign_attention_decode_task

    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    return assign_attention_decode_task(lens, cs.HKV, tile=cs.SCHED_TILE, capacity="tight", impl="np")


def partials(cs, torch, dev, tm, seed):
    """Seeded float32 partials (o, m, l) of the map's shape, neutral on
    sentinel tasks and on a tenth of the rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = cs.HQ // cs.HKV
    o = torch.randn((tm.capacity, rows, cs.D), generator=gen, device=dev)
    m = torch.randn((tm.capacity, rows), generator=gen, device=dev) * 4
    l = torch.rand((tm.capacity, rows), generator=gen, device=dev) * 50 + 1
    blind = (torch.rand((tm.capacity, rows), generator=gen, device=dev) < 0.1) | (tm.batch < 0)[:, None]
    m[blind] = float("-inf")
    l[blind] = 0.0
    o[blind] = 0.0
    return o, m, l


def combine(cs, torch, dev):
    from hpc_ops_tpu_torch.ops.attention.decode import _decode_combine_ref, attention_decode, decode_combine

    out = []
    for si, (case, spec) in enumerate(cs.SCENARIOS.items()):
        kv_lens = [n for count, n in spec for _ in range(count)]
        tm = scenario_map(cs, torch, dev, kv_lens)
        o, m, l = partials(cs, torch, dev, tm, 300 + si)
        err = cs.close_scaled(decode_combine(o, m, l, tm, 1, cs.HQ), _decode_combine_ref(o, m, l, tm, 1, cs.HQ),
                              f"combine {case}")
        line = dict(kernel="decode_combine", case=case, num_tasks=int(tm.num_tasks), capacity=tm.capacity,
                    max_abs_err=err, **timed(cs, lambda: decode_combine(o, m, l, tm, 1, cs.HQ),
                                             *cs.combine_work(tm.capacity, len(kv_lens))))
        q, k, v, tbl, lens, kw = cs.scenario_caches(dev, kv_lens, "bf16", 100 + si)
        line["task_path_device_ms"] = cs.device_ms(
            lambda: attention_decode(q, k, v, tbl, lens, task_map=tm, **kw), 20)
        out.append(line)
        del q, k, v, o, m, l
        torch.cuda.empty_cache()
    return out


def act(cs, torch, dev):
    from hpc_ops_tpu_torch.ops.activation import act_quant
    from hpc_ops_tpu_torch.ops.group_gemm import _pick_tm
    from hpc_ops_tpu_torch.ops.moe import _route_aligned

    gen = torch.Generator(device=dev).manual_seed(17)
    scale = torch.full((1,), cs.FP8_STD, device=dev)
    out = []
    for shape, s in cs.MOE_SHAPES.items():
        _, ids = torch.topk(torch.randn((s, cs.MOE_E), generator=gen, device=dev), cs.MOE_K, dim=-1)
        tile = _pick_tm(max(s * cs.MOE_K // cs.MOE_E, 1), cs.MOE_H)
        row_idx, *_, cu_tiles, _ = _route_aligned(ids.to(torch.int32), cs.MOE_E, 0, tile)
        nv = cu_tiles[-1:] * tile
        valid = int(nv)
        gate_up = (torch.randn((row_idx.shape[0], 2 * cs.MOE_I), generator=gen, device=dev) * 2).to(torch.bfloat16)
        call = lambda: act_quant(gate_up, scale, True, torch.float8_e4m3fn, nv)  # noqa: E731
        out.append(dict(kernel="act_quant", shape=shape, tokens=s, rows=row_idx.shape[0], valid_rows=valid,
                        **timed(cs, call, cs.act_bytes(valid), valid * cs.MOE_I * 12.0)))
    return out


def forms(cs, torch, dev):
    """Device ms of the combine's forms at each scenario, each forced by
    patching the chooser."""
    from hpc_ops_tpu_torch.ops.attention import decode as Dm
    from hpc_ops_tpu_torch.utils.common import cdiv

    out = []
    chosen_combine = Dm.combine_form
    for si, (case, spec) in enumerate(cs.SCENARIOS.items()):
        kv_lens = [n for count, n in spec for _ in range(count)]
        tm = scenario_map(cs, torch, dev, kv_lens)
        o, m, l = partials(cs, torch, dev, tm, 300 + si)
        call = lambda: Dm.decode_combine(o, m, l, tm, 1, cs.HQ)  # noqa: E731
        want = call()
        rows = cs.HQ // cs.HKV
        for rb in (1, 2, 4):
            for splits in (1, 2, 4):
                f = Dm.CombineForm(4, rb, splits, cdiv(cs.D // 4, splits),
                                   tm.num_segs * cdiv(rows, rb) * splits)
                if rb > rows:
                    continue
                Dm.combine_form = lambda *a, f=f: f
                try:
                    got = call()
                    out.append(dict(kernel="decode_combine", case=case, form=f._asdict(),
                                    max_diff=float((got.float() - want.float()).abs().max()),
                                    device_ms=cs.device_ms(call, 50)))
                finally:
                    Dm.combine_form = chosen_combine
        del o, m, l
    return out


def main(root: str, with_forms: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = load_chip_smoke()
    dev = "cuda"
    out = dict(root=root, device=cs.nvidia_smi_line(), norm=norm(cs, torch, dev),
               combine=combine(cs, torch, dev), act=act(cs, torch, dev))
    if with_forms:
        out["forms"] = forms(cs, torch, dev)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--forms", action="store_true")
    args = ap.parse_args()
    print(json.dumps(main(args.root, args.forms)), flush=True)
