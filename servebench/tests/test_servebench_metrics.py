"""The metric arithmetic on hand-made runs: tails that count unfinished
requests, a rate that falls under a stall, and the work counts of the
rooflines and the MFU against hand counts at small shapes."""

import pytest

from servebench.harness import RequestRecord, Run, StepRecord, metrics_for, reader
from servebench.stats import percentile, spread
from servebench.trace import Slice

MODEL = {"vocab": 100, "hidden": 8, "layers": 2, "q_heads": 4, "kv_heads": 2, "head_dim": 4,
         "intermediate": 16, "moe": None}
MOE = dict(MODEL, moe={"num_experts": 4, "topk": 2, "expert_intermediate": 6})
PEAKS = {"bf16_flops": 1e3, "fp8_flops": 2e3, "hbm_bytes": 1e2}


def make_run(steps=(), requests=(), sl=None, model=MODEL, seconds=10.0, multi_step=1):
    return Run(seconds=seconds, setup_s=3.0, t_start=0.0, t_end=seconds, steps=list(steps),
               requests=list(requests), slice=sl, memory_peak_bytes=3 * 2**30, model=model, mix={},
               block_size=16, max_batch=4, multi_step=multi_step, device_name="test", peaks=PEAKS, chips=1, tp=1)


def req(i, t_send, t_first=None, t_done=None, n_out=0, max_new=4):
    r = RequestRecord(i, [1, 2, 3], max_new, t_send)
    r.t_first, r.t_done, r.n_out = t_first, t_done, n_out
    return r


def test_percentile_and_spread():
    assert percentile([1, 2, 3, 4], 50) == 2.5
    assert percentile(range(101), 95) == 95
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)


def test_ttft_p95_counts_requests_with_no_first_token():
    done = [req(i, 1.0, 1.1, 2.0, 4) for i in range(19)]
    stalled = req(19, 2.0)  # no first token by the window's end (10 s)
    ttft = reader("ttft_p95_ms")
    with_stall = ttft(make_run(requests=done + [stalled]))
    without = ttft(make_run(requests=done))
    assert without == pytest.approx(100.0)
    assert with_stall == pytest.approx(1e3 * percentile([0.1] * 19 + [8.0], 95))
    # requests sent before the window are not TTFT samples
    early = req(20, -1.0, 5.0, 6.0, 4)
    assert ttft(make_run(requests=done + [early])) == pytest.approx(100.0)


def test_tpot_p95_over_requests_finished_in_the_window():
    rs = [req(i, 0.5, 1.0, 1.0 + 0.03 * 9, 10, max_new=10) for i in range(10)]
    rs.append(req(10, 0.5, 1.0, 11.0, 10, max_new=10))  # finished after the window: left out
    assert reader("tpot_p95_ms")(make_run(requests=rs)) == pytest.approx(30.0)


def test_output_rate_falls_when_a_stall_is_injected():
    steady = [StepRecord(i * 0.1, i * 0.1 + 0.1, "decode", 32, ctxs=[10] * 4) for i in range(100)]
    # the same steps, one stalled for 3 s: the last 30 end after the window
    stalled = [StepRecord(s.t0 + (3.0 if i >= 50 else 0), s.t1 + (3.0 if i >= 50 else 0), s.kind, s.tokens,
                          ctxs=s.ctxs) for i, s in enumerate(steady)]
    rate = reader("output_tok_per_s")
    assert rate(make_run(steady)) == pytest.approx(320.0)
    assert rate(make_run(stalled)) == pytest.approx(32 * 70 / 10.0)


def test_span_and_counter_metrics():
    steps = [StepRecord(0.5, 0.7, "prefill", 1, rows=100, offset=0, admitted=100),
             StepRecord(0.7, 0.8, "prefill", 1, rows=40, offset=64, shared=64, admitted=104),
             StepRecord(0.8, 1.2, "decode", 16, ctxs=[101, 105]),
             StepRecord(1.2, 1.6, "decode", 32, ctxs=[102, 106, 50, 60])]
    run = make_run(steps, multi_step=8)
    assert reader("engine.batch_occupancy")(run) == pytest.approx(100.0 * 6 / 8)
    assert reader("engine.prefix_hit_share")(run) == pytest.approx(100.0 * 64 / 204)
    assert reader("decode_graph.ms_per_step")(run) == pytest.approx(800.0 / 16)
    assert reader("model_step.prefill_ms_per_ktok")(run) == pytest.approx(1e6 * 0.3 / 140)
    assert reader("device.peak_mem_gib")(run) == pytest.approx(3.0)
    assert reader("kernels.decode_attn_roofline")(run) is None  # no trace: nothing to read


def test_rooflines_and_mfu_against_hand_counts():
    pre = StepRecord(0, 1, "prefill", 1, rows=3, offset=2)
    dec = StepRecord(1, 2, "decode", 2, ctxs=[5, 7])
    sl = Slice(wall_s=2.0, device=[(0.0, 0.5, "paged_prefill_kernel<128>"),
                                   (1.0, 1.25, "paged_decode_kernel"), (1.25, 1.5, "decode_combine_kernel"),
                                   (0.5, 0.9, "gg_scatter_e4m3_kernel"), (1.5, 1.6, "gg_scatter_e4m3_kernel")],
               spans=[], steps=[pre, dec])
    # prefill, a layer: pairs 3*2 + 3*4/2 = 12; ops 4*4*4*12 = 768; bytes 2*3*4*4*2 + 2*5*2*4*2 = 352
    layer_bound = max(352 / 1e2, 768 / 1e3)
    assert reader("kernels.prefill_attn_roofline")(make_run(sl=sl)) == pytest.approx(100 * 2 * layer_bound / 0.5)
    # decode at multi_step 2: contexts (5, 7) then (6, 8)
    b = 0.0
    for ctxs in ((5, 7), (6, 8)):
        ops = sum(4 * c * 4 * 4 for c in ctxs)
        nbytes = sum(2 * c * 2 * 4 * 2 for c in ctxs) + 2 * 2 * 4 * 4 * 2
        b += 2 * max(nbytes / 1e2, ops / 1e3)
    assert reader("kernels.decode_attn_roofline")(make_run(sl=sl, multi_step=2)) == pytest.approx(100 * b / 0.5)
    # MoE, one call of r rows: gate-up 2*r*2*12*8 ops, down 2*r*2*8*6
    def call(r):
        hit = min(4, 2 * r)
        gu = max((hit * 12 * 8 + 2 * r * 8 + 2 * r * 12 * 2) / 1e2, 2 * r * 2 * 12 * 8 / 2e3)
        dn = max((hit * 8 * 6 + 2 * r * 6 + 2 * r * 8 * 2) / 1e2, 2 * r * 2 * 8 * 6 / 2e3)
        return gu + dn
    moe_bound = 2 * (call(3) + 2 * call(2))
    got = reader("kernels.moe_gemm_roofline")(make_run(sl=sl, model=MOE, multi_step=2))
    assert got == pytest.approx(100 * moe_bound / 0.5)
    assert reader("kernels.moe_gemm_roofline")(make_run(sl=sl)) is None  # a dense model
    # MFU, dense: per token 2 * layers * (qkv 8*16*4/... ) by hand
    per_layer = 8 * (4 + 4) * 4 + 4 * 4 * 8 + 3 * 8 * 16
    tok = 2 * 2 * per_layer
    head = 2 * 8 * 100
    attn = 4 * 4 * 4 * 2
    flops = 3 * tok + head + attn * 12
    flops += 2 * (tok + head) + attn * 12 + 2 * (tok + head) + attn * 14
    assert reader("model_step.mfu")(make_run(sl=sl, multi_step=2)) == pytest.approx(100 * flops / (2.0 * 1e3))
    # idle share: busy union [0, 0.9] and [1.0, 1.6] over 2 s
    assert reader("device.idle_share")(make_run(sl=sl)) == pytest.approx(100 * (1 - 1.5 / 2.0))


def test_slice_breakdown_names_gaps_by_span():
    sl = Slice(wall_s=1.0, device=[(0.0, 0.1, "a"), (0.3, 0.4, "b"), (0.45, 0.5, "a")],
               spans=[(0.05, 0.35, "engine step (prefill)"), (0.4, 0.5, "harness client bookkeeping")])
    assert sl.top_ops(1) == [["a", pytest.approx(0.15)]]
    assert sl.idle_gaps() == [["engine step (prefill)", pytest.approx(0.2)],
                              ["harness client bookkeeping", pytest.approx(0.05)]]


def test_metrics_for_selects_by_cell_and_mode():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x.y"]}],
             "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["z.w"]}]}
    assert [m["name"] for m in metrics_for(bench, "x.y", False)] == ["a", "b"]
    assert [m["name"] for m in metrics_for(bench, "z.w", False)] == ["a"]
    assert [m["name"] for m in metrics_for(bench, "z.w", True)] == ["p", "r"]
    assert [m["name"] for m in metrics_for(bench, "x.y", True)] == ["p", "q"]
