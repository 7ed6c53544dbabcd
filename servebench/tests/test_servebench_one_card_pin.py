"""The one-card path reads what it read before the multi-card path came:
every reader on a fixed hand-made one-card run gives the numbers the
harness gave before (pinned), and a one-card cell still builds the
one-card Engine and reports one card."""

import pytest

from servebench.harness import RequestRecord, Run, StepRecord, reader
from servebench.trace import Slice

MODEL = {"vocab": 1000, "hidden": 64, "layers": 3, "q_heads": 8, "kv_heads": 2, "head_dim": 8,
         "intermediate": 128, "moe": {"num_experts": 4, "topk": 2, "expert_intermediate": 96}}
PEAKS = {"bf16_flops": 1e6, "fp8_flops": 2e6, "hbm_bytes": 1e5}

# the readers' numbers on synthetic() before the multi-card path came
PINNED = {
    "decode_graph.ms_per_step": 62.5,
    "device.idle_share": 34.375000000000014,
    "device.peak_mem_gib": 71.00001149717718,
    "engine.batch_occupancy": 87.5,
    "engine.prefix_hit_share": 27.35042735042735,
    "engine.prefix_match_ms": None,
    "engine.queue_wait_p95_ms": None,
    "kernels.decode_attn_roofline": 11421.257142857152,
    "kernels.moe_gemm_roofline": 7804.799999999999,
    "kernels.prefill_attn_roofline": 2002.773333333334,
    "model_step.mfu": 4411.984,
    "model_step.prefill_ms_per_ktok": 4117.64705882353,
    "output_tok_per_s": 5.8,
    "setup_s": 31.5,
    "tpot_p95_ms": 31.578947368421076,
    "ttft_p95_ms": 413.49999999999955,
}


def synthetic(cards=None):
    steps = [StepRecord(0.5, 0.9, "prefill", 1, rows=120, offset=0, admitted=120),
             StepRecord(0.9, 1.3, "decode", 24, ctxs=[121, 300, 77]),
             StepRecord(1.3, 1.6, "prefill", 1, rows=50, offset=64, shared=64, admitted=114),
             StepRecord(1.6, 2.2, "decode", 32, ctxs=[122, 301, 78, 114]),
             StepRecord(9.8, 10.4, "decode", 32, ctxs=[130, 309, 86, 122])]
    reqs = []
    for i in range(12):
        r = RequestRecord(i, list(range(10 + i)), 20, 0.2 + 0.5 * i)
        r.t_first = r.t_send + 0.1 + 0.03 * i
        r.t_done = r.t_first + 0.4 + 0.05 * (i % 5) if i < 10 else None
        r.n_out = 20 if i < 10 else 3
        reqs.append(r)
    dev = [(0.0, 0.3, "paged_prefill_kernel<128>"), (0.3, 0.5, "gg_scatter_e4m3_rs_kernel"),
           (0.55, 0.6, "paged_decode_kernel"), (0.6, 0.62, "decode_combine_kernel"),
           (0.62, 0.7, "gg_scatter_e4m3_kernel"), (0.9, 1.1, "gg_pertensor_e4m3_rs_kernel"),
           (1.15, 1.2, "Memcpy DtoH"), (1.3, 1.45, "paged_prefill_kernel<128>")]
    spans = [(0.0, 0.8, "engine step (prefill)"), (0.8, 1.0, "harness client bookkeeping"),
             (1.0, 1.5, "engine step (decode)")]
    sl = Slice(wall_s=1.6, device=dev, spans=spans, steps=steps[:3], cards=cards or [])
    return Run(seconds=10.0, setup_s=31.5, t_start=0.0, t_end=10.0, steps=steps, requests=reqs, slice=sl,
               memory_peak_bytes=71 * 2**30 + 12345, model=MODEL, mix={}, block_size=16, max_batch=4,
               multi_step=8, device_name="test", peaks=PEAKS, chips=1, tp=1)


@pytest.mark.parametrize("cards", [None, [0] * 8], ids=["unnamed", "card 0"])
def test_one_card_readers_are_pinned(cards):
    run = synthetic(cards)
    for name, want in PINNED.items():
        got = reader(name)(run)
        assert got == (pytest.approx(want, rel=1e-12) if want is not None else None), name
    assert reader("kernels.allreduce_norm_roofline")(run) is None
    assert run.slice.busy_s() == pytest.approx(1.0499999999999998, rel=1e-12)
    assert run.slice.idle_gaps() == [["engine step (prefill)", pytest.approx(0.2)],
                                     ["engine step (decode)", pytest.approx(0.1)],
                                     ["engine step (prefill)", pytest.approx(0.05)],
                                     ["engine step (decode)", pytest.approx(0.05)]]
    assert run.slice.top_ops(2) == [["paged_prefill_kernel<128>", pytest.approx(0.45)],
                                    ["gg_pertensor_e4m3_rs_kernel", pytest.approx(0.2)]]


def test_one_card_cell_builds_the_one_card_engine(tiny, monkeypatch):
    from conftest import tiny_config, tiny_traffic
    from hpc_ops_tpu_torch.runtime import engine, sharded_engine

    built = []
    real = engine.Engine.__init__

    def spy(self, *a, **kw):
        built.append(kw["num_blocks"])
        real(self, *a, **kw)

    def no_sharded(*a, **kw):
        raise AssertionError("a one-card cell built the ShardedEngine")

    monkeypatch.setattr(engine.Engine, "__init__", spy)
    monkeypatch.setattr(sharded_engine.ShardedEngine, "__init__", no_sharded)
    tiny.add_config(tiny_config(moe=True))
    tiny.add_traffic("tinymix", tiny_traffic())
    cell = tiny.add_cell("tiny-moe", "tinymix")
    result, _ = tiny.run(cell, seed=2**31 + 41)
    assert built == [256]
    assert result["correct"], result["check"]
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert set(result["metrics"]) == {"output_tok_per_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}
