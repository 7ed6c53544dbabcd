"""Audit of the serving engine's host path on a card, with the port's
tracer (``hpc_ops_tpu_torch/runtime/tracing.py``).

    python3 scripts/engine_trace_audit.py syncs [--layers 2]
    python3 scripts/engine_trace_audit.py span-cost
    python3 scripts/engine_trace_audit.py cell-cost --cell mistral-7b-bf16.chat --seeds A B [--seconds 45]

``syncs``: serves the two ``servebench`` configurations at their widths
(``--layers`` deep) with the chat mix's engine settings (prefix cache,
2048-row chunks, 8-step captured decode, batch 32) under
``torch.cuda.set_sync_debug_mode("warn")`` after a warm-up, and lists every
call inside a step that synchronises with the device: the innermost
program span open at that moment, the port's call site and the count. One
JSON line a configuration.

``span-cost``: nanoseconds a span site (``with span(...) as sp:
sp.set(...)``) costs with the tracer off and on, over an empty call.

``cell-cost``: a ``servebench`` cell run in this process with ``--trace
0``, with the tracer on for the whole run and off, in turns for each seed
(``--modes``, default on then off, the order reversed every other seed):
the tracer's cost on the end-to-end metrics, and with the tracer on each
span's durations over the window: the host's time in each part of a step
with no profiler running. One JSON line a run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hpc_ops_tpu_torch.runtime import tracing  # noqa: E402

CONFIGS = ("mistral-7b-bf16", "mixtral-8x7b-fp8")
DEVICE = "cuda"
PORT = os.path.join(ROOT, "hpc_ops_tpu_torch") + os.sep


def _innermost(recs: list, t: int) -> str:
    """The path of the innermost span open at time ``t``."""
    best = None
    for i, r in enumerate(recs):
        if r.t0 <= t and (r.t1 is None or t <= r.t1) and (best is None or r.t0 >= recs[best].t0):
            best = i
    path = []
    while best is not None and best >= 0:
        path.append(recs[best].name)
        best = recs[best].parent
    return " > ".join(reversed(path)) or "(no span)"


def syncs(layers: int) -> None:
    from servebench import harness
    from servebench.reference import mistral
    from hpc_ops_tpu_torch.runtime.engine import Engine

    for name in CONFIGS:
        cfg = harness.load_json(os.path.join(ROOT, "servebench", "configs", name + ".json"))
        model = dict(cfg["model"], layers=layers)
        weights = mistral.make_weights(model, 7, torch.device(DEVICE))
        eng = Engine(harness.model_config(model), weights, num_blocks=4096, block_size=16, max_batch=32,
                     max_blocks_per_seq=400, prefill_chunk=2048, multi_step=8, prefix_cache=True,
                     device=DEVICE)
        g = torch.Generator().manual_seed(3)
        shared = torch.randint(1, 30000, (1024,), generator=g).tolist()

        def prompt(n):
            return torch.randint(1, 30000, (n,), generator=g).tolist()

        for n in (300, 700, 1200):  # warm-up: the graph captures at the first dispatch
            eng.add_request(prompt(n), max_new=24)
        eng.add_request(shared + prompt(100), max_new=24)
        while eng.step():
            pass
        torch.cuda.synchronize()
        seen = []

        def hook(message, category, filename, lineno, file=None, line=None):
            t = tracing.now()
            frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(PORT)
                      and not f.filename.endswith("tracing.py")]
            site = " < ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}" for f in frames[::-1][:3])
            seen.append((t, site, str(message).splitlines()[0][:120]))

        tracing.clear()
        tracing.enable()
        with warnings.catch_warnings():  # restores showwarning on the way out
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                # a long prompt in two chunks, a prefix hit, short prompts, decode between them
                for p in (prompt(3000), shared + prompt(200), prompt(400), prompt(150)):
                    eng.add_request(p, max_new=40)
                for _ in range(16):
                    if not eng.step():
                        break
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        tracing.disable()
        recs = tracing.records()
        tally: dict = {}
        for t, site, msg in seen:
            key = (_innermost(recs, t), site, msg)
            tally[key] = tally.get(key, 0) + 1
        steps = [r.attrs.get("kind") for r in recs if r.name == "engine.step"]
        line = {"config": name, "layers": layers, "steps": {k: steps.count(k) for k in set(steps)},
                "syncs": [{"span": k[0], "site": k[1], "message": k[2], "count": n}
                          for k, n in sorted(tally.items(), key=lambda kv: -kv[1])]}
        print(json.dumps(line), flush=True)
        tracing.clear()
        del eng, weights
        gc.collect()
        torch.cuda.empty_cache()


def span_cost(n: int = 1_000_000) -> dict:
    span = tracing.span

    def site():
        with span("audit.site") as sp:
            sp.set("kind", "decode")

    def bare():
        pass

    def per_call(f, calls):
        best = None
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in range(calls):
                f()
            dt = (time.perf_counter_ns() - t0) / calls
            best = dt if best is None else min(best, dt)
        return best

    base = per_call(bare, n)
    off = per_call(site, n) - base
    tracing.clear()
    tracing.enable()
    on = per_call(site, n // 10) - base
    tracing.disable()
    tracing.clear()
    return {"span_site_ns_off": off, "span_site_ns_on": on, "empty_call_ns": base}


def span_stats(recs: list, lo_s: float, hi_s: float) -> dict:
    """Per span name (engine.step by kind, python.gc by generation) of the
    closed records starting in [lo_s, hi_s): count, mean, p50, p99 and max
    ms, and seconds in all."""
    from servebench.stats import percentile

    by: dict = {}
    for r in recs:
        if r.t1 is None or not lo_s * 1e9 <= r.t0 < hi_s * 1e9:
            continue
        key = r.name
        if r.name == "engine.step":
            key += "." + str(r.attrs.get("kind"))
        elif r.name == "python.gc":
            key += ".gen" + str(r.attrs.get("generation"))
        by.setdefault(key, []).append((r.t1 - r.t0) * 1e-6)
    return {k: {"n": len(v), "mean_ms": sum(v) / len(v), "p50_ms": percentile(v, 50),
                "p99_ms": percentile(v, 99), "max_ms": max(v), "total_s": sum(v) * 1e-3}
            for k, v in sorted(by.items())}


def _settle() -> None:
    tracing.disable()
    tracing.clear()
    gc.collect()
    torch.cuda.empty_cache()


def cell_cost(cell: str, seeds: list, seconds: float, modes: list) -> None:
    from servebench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for i, seed in enumerate(seeds):
        for mode in modes if i % 2 == 0 else modes[::-1]:  # which runs first alternates
            tracing.clear()
            if mode == "on":
                tracing.enable()
            t_process = time.perf_counter()
            result, _ = harness.run_cell(bench, cell, seed, seconds, False, t_process)
            t_start = t_process + result["metrics"]["setup_s"]["value"]
            stats = span_stats(tracing.records(), t_start, t_start + seconds)
            _settle()
            print(json.dumps({"cell": cell, "seed": seed, "tracer": mode, "correct": result["correct"],
                              "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                              "spans": stats}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("syncs", "span-cost", "cell-cost"))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--cell", default="mistral-7b-bf16.chat")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--modes", nargs="*", choices=("on", "off"), default=["on", "off"])
    args = ap.parse_args()
    dev = torch.cuda.get_device_name(0) if torch.cuda.is_available() else None
    if dev is None:
        print("engine_trace_audit: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps({"device": dev}), flush=True)
    if args.what == "syncs":
        syncs(args.layers)
    elif args.what == "span-cost":
        print(json.dumps(span_cost()), flush=True)
    else:
        cell_cost(args.cell, args.seeds, args.seconds, args.modes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
