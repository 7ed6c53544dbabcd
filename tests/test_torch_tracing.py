"""The port's tracer (``runtime/tracing.py``) and what the engine records
with it: nothing while off, every span of the serving step with its parent
while on, per-request timestamps in order, a collection inside a span, the
clock offset against torch.profiler's, and ``Engine.stats`` as running
counts equal to the sums over the requests."""

import gc
import os
import subprocess
import sys
import tracemalloc

import pytest
import torch

from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.runtime import tracing
from hpc_ops_tpu_torch.runtime.engine import Engine

torch.set_num_threads(1)

CFG = T.tiny_config()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = list(range(3, 43))  # 40 tokens: two full blocks of 16 shared
PARENT = {  # span -> the span it opens inside
    "engine.admit": "engine.step", "engine.prefill": "engine.step", "engine.sample": "engine.step",
    "engine.inputs": "engine.step", "engine.append": "engine.step", "engine.fetch": "engine.sample",
    "decode_graph.stage": "engine.step", "decode_graph.replay": "engine.step",
    "decode_graph.fetch": "engine.step",
}


@pytest.fixture(scope="module")
def weights():
    return T.init_weights(CFG, device="cpu", seed=1)


@pytest.fixture
def tracer():
    tracing.disable()
    tracing.clear()
    yield tracing
    tracing.disable()
    tracing.clear()


def serve(weights, **kw):
    """Two requests sharing PREFIX, then two more that hit it, through the
    prefix cache, 16-token chunks and 4-step fused decode."""
    eng = Engine(CFG, weights, num_blocks=64, block_size=16, max_batch=4, prefix_cache=True,
                 prefill_chunk=16, multi_step=4, device="cpu", **kw)
    for tail in ([50, 51, 52], [60, 61]):
        eng.add_request(PREFIX + tail, max_new=6)
    while eng.step():
        pass
    for tail in ([70, 71, 72, 73], [80]):
        eng.add_request(PREFIX + tail, max_new=5)
    while eng.step():
        pass
    return eng


def test_off_records_nothing(weights, tracer):
    eng = serve(weights)
    assert all(len(r.out) for r in eng.requests.values())
    assert tracer.records() == []
    assert tracer.span("engine.step") is tracer.NO_SPAN
    assert _on_gc_hooked() is False


def test_off_span_reads_no_clock_and_allocates_nothing(tracer, monkeypatch):
    def no_clock():
        raise AssertionError("the off path read the clock")

    monkeypatch.setattr(tracing, "now", no_clock)
    with tracer.span("engine.step", 3) as sp:
        sp.set("kind", "decode")
    for _ in range(100):
        tracer.span("engine.step")
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(1000):
            tracer.span("engine.step", 3)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # no span, record or dict a call: one would take 1000 x 32 bytes or more
    assert peak - before < 4096


def _on_gc_hooked() -> bool:
    return any(getattr(cb, "__module__", "") == tracing.__name__ for cb in gc.callbacks)


def test_spans_of_a_step_with_their_parents(weights, tracer):
    tracer.enable()
    assert _on_gc_hooked()
    eng = serve(weights)
    tracer.disable()
    recs = tracer.records()
    names = {r.name for r in recs}
    assert names - {"python.gc"} == set(PARENT) | {"engine.step"}
    for r in recs:
        assert r.t1 is not None and r.t0 <= r.t1, r
        if r.name == "python.gc":
            continue
        if r.name == "engine.step":
            assert r.parent == -1
            continue
        p = recs[r.parent]
        assert p.name == PARENT[r.name], r
        assert p.t0 <= r.t0 and r.t1 <= p.t1, (p, r)
    steps = [r for r in recs if r.name == "engine.step"]
    # the two calls that found no work carry no kind
    assert sorted(map(str, (r.attrs.get("kind") for r in steps))) == sorted(
        ["prefill"] * eng.stats["prefill_dispatches"] + ["decode"] * eng.stats["decode_dispatches"]
        + ["None"] * 2)
    for r in steps:
        if r.attrs.get("kind") == "decode":
            assert 1 <= r.attrs["live"] <= 4
    for r in recs:
        if r.name == "engine.prefill":
            assert 0 < r.attrs["rows"] <= 16 and r.attrs["offset"] % 16 == 0
    admits = [r for r in recs if r.name == "engine.admit"]
    assert sorted(r.rid for r in admits) == sorted(eng.requests)
    assert [r.attrs["candidates"] for r in admits] == [0, 1, 2, 3]
    # the prefix hits of the engine's counter, token for token
    shared = sum(r.attrs["shared_tokens"] for r in admits)
    assert shared == eng.prefix_shared_blocks * eng.block_size == 3 * 32  # all but the first
    for r in admits:  # the request's own admission time brackets the span
        req = eng.requests[r.rid]
        assert req.t_admit <= r.t0 <= r.t1 <= req.t_admit + req.admit_ns


def test_request_timestamps_are_ordered(weights, tracer):
    eng = serve(weights)  # kept with the tracer off
    for r in eng.requests.values():
        assert r.t_arrive <= r.t_admit <= r.t_first <= r.t_done, r
        assert 0 <= r.admit_ns <= r.t_first - r.t_admit


def test_a_collection_inside_a_span_is_its_child(tracer):
    tracer.enable()
    with tracer.span("outer"):
        gc.collect()
    tracer.disable()
    recs = tracer.records()
    assert recs[0].name == "outer"
    gcs = [r for r in recs if r.name == "python.gc"]
    assert gcs and gcs[-1].parent == 0 and gcs[-1].attrs["generation"] == 2
    assert recs[0].t0 <= gcs[-1].t0 <= gcs[-1].t1 <= recs[0].t1
    assert not _on_gc_hooked()


READ_UNDER_COLLECTIONS = """
import gc
from hpc_ops_tpu_torch.runtime import tracing
tracing.enable()
gc.set_threshold(1)
for _ in range(2000):
    tracing.records()
    [object() for _ in range(4)]
gc.set_threshold(700)
tracing.disable()
print(sum(r.name == "python.gc" for r in tracing.records()))
"""


def test_records_read_while_collections_run():
    # a collection that starts inside records() opens a python.gc span under
    # the lock records() holds: with a plain lock the process deadlocks, so
    # it runs in a child process with a time limit
    out = subprocess.run([sys.executable, "-c", READ_UNDER_COLLECTIONS], capture_output=True, text=True,
                         timeout=60, cwd=ROOT, check=True)
    assert int(out.stdout.split()[-1]) > 0


def test_clock_offset_maps_onto_the_profiler_clock(tracer):
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with tracer.span("probe"):
                pass
            with record_function("probe.profiler"):
                pass
    tracer.disable()
    spans = [r.t0 + tracer.clock_offset_ns() for r in tracer.records() if r.name == "probe"]
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe.profiler")
    assert len(spans) == len(ranges) == 5
    for a, b in zip(spans, ranges):
        assert abs(a - b) < 1_000_000, (a, b)


def _cancel_mid_run(eng, rids):
    pending = eng.add_request([5, 6, 7], max_new=4)
    eng.cancel(pending)  # before any prefill
    for _ in range(3):
        eng.step()
    eng.cancel(rids[0])  # while it decodes
    while eng.step():
        pass


@pytest.mark.parametrize("mode", ["n_best_multi_step", "speculative"])
def test_stats_are_running_counts_equal_to_the_sums(weights, mode):
    if mode == "n_best_multi_step":
        eng = Engine(CFG, weights, num_blocks=96, block_size=16, max_batch=6, temperature=0.8,
                     multi_step=4, prefix_cache=True, device="cpu")
        rids = [eng.add_request(PREFIX + [9], max_new=7)]
        fam = eng.add_request(PREFIX + [11, 12], max_new=6, n=3)
        eng.cancel(fam[2])  # a child alone, before the prefill ...
        gone = eng.add_request([20, 21, 22], max_new=5, n=2)
        eng.cancel(gone[1])
        eng.cancel(gone[0])  # ... and its parent after it: each counted once
        rids += fam[:2]
    else:
        eng = Engine(CFG, weights, num_blocks=64, block_size=16, max_batch=4, speculative_k=3,
                     draft_fn=lambda toks, k: toks[-k:], device="cpu")  # a draft every step
        rids = [eng.add_request([1, 2, 3, 1, 2, 3, 1, 2], max_new=9),
                eng.add_request([4, 5, 4, 5, 4, 5], max_new=8)]
    _cancel_mid_run(eng, rids)
    if mode == "speculative":
        assert eng.spec_proposed > 0
    reqs = eng.requests.values()
    assert all(r.done for r in reqs)
    assert eng.stats["done"] == sum(r.done for r in reqs) == len(eng.requests)
    assert eng.stats["tokens_out"] == sum(len(r.out) for r in reqs) > 0
    for r in reqs:
        assert r.t_done is not None and r.t_arrive <= r.t_done
