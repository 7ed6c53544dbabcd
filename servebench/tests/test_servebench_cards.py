"""The arithmetic over several cards on hand-made slices: the fused
all-reduce's roofline against a hand count, the MFU over the cards' peak,
and each card's own idle share, averaged."""

import pytest

from servebench.harness import Run, StepRecord, reader
from servebench.trace import Slice

MODEL = {"vocab": 100, "hidden": 8, "layers": 2, "q_heads": 4, "kv_heads": 4, "head_dim": 4,
         "intermediate": 16, "moe": {"num_experts": 4, "topk": 2, "expert_intermediate": 6}}
PEAKS = {"bf16_flops": 1e3, "fp8_flops": 2e3, "hbm_bytes": 1e2, "nvlink_bytes": 50.0}
STEPS = [StepRecord(0, 1, "prefill", 1, rows=3, offset=2), StepRecord(1, 2, "decode", 2, ctxs=[5, 7])]


def make_run(sl, chips=4, tp=4, multi_step=2):
    return Run(seconds=10.0, setup_s=3.0, t_start=0.0, t_end=10.0, steps=list(STEPS), requests=[], slice=sl,
               memory_peak_bytes=2**30, model=MODEL, mix={}, block_size=16, max_batch=4, multi_step=multi_step,
               device_name="test", peaks=PEAKS, chips=chips, tp=tp)


def four_cards():
    device, cards = [], []
    for c in range(4):  # card c: a collective of 0.1 s, then other work; card 0 busiest
        device += [(0.0, 0.1, "allreduce_rmsnorm_rank_kernel"), (0.2, 0.2 + 0.4 / (c + 1), "gg_scatter_e4m3_kernel")]
        cards += [c, c]
    return Slice(wall_s=2.0, device=device, spans=[(0.0, 2.0, "engine step (decode)")], steps=list(STEPS),
                 cards=cards)


def test_allreduce_norm_roofline_against_a_hand_count():
    sl = four_cards()

    def call(r):  # a rank's bound: link 2 * 3/4 * r * 8 * 2 bytes at 50, HBM 4 * r * 8 * 2 at 100
        return max(2 * 0.75 * r * 8 * 2 / 50.0, 4 * r * 8 * 2 / 1e2)

    per_rank = 2 * 2 * (call(3) + 2 * call(2))  # two calls a layer, two layers; decode: two steps of 2 rows
    want = 100 * 4 * per_rank / (4 * 0.1)
    assert reader("kernels.allreduce_norm_roofline")(make_run(sl)) == pytest.approx(want)
    assert reader("kernels.allreduce_norm_roofline")(make_run(sl, chips=1, tp=1)) is None
    no_link = make_run(sl)
    no_link.peaks = {k: v for k, v in PEAKS.items() if k != "nvlink_bytes"}
    assert reader("kernels.allreduce_norm_roofline")(no_link) is None


def test_mfu_is_over_every_card():
    sl = four_cards()
    one = reader("model_step.mfu")(make_run(sl, chips=1, tp=1))
    assert reader("model_step.mfu")(make_run(sl)) == pytest.approx(one / 4)


def test_idle_share_is_each_cards_own_averaged():
    sl = four_cards()
    busy = [0.1 + 0.4 / (c + 1) for c in range(4)]
    want = 100 * sum(1 - b / 2.0 for b in busy) / 4
    assert reader("device.idle_share")(make_run(sl)) == pytest.approx(want)
    assert sl.busy_s() == pytest.approx(sum(busy) / 4)
    assert sl.busy_s(2) == pytest.approx(busy[2])
    # the union of all four cards' intervals would read card 0's idle alone
    union = Slice(wall_s=2.0, device=sl.device, spans=[])
    assert reader("device.idle_share")(make_run(union)) == pytest.approx(100 * (1 - busy[0] / 2.0))
    # idle gaps are card 0's: between its collective and its GEMM
    assert sl.idle_gaps() == [["engine step (decode)", pytest.approx(0.1)]]
    # rooflines sum device time over the cards
    assert sl.device_s(("gg_scatter",)) == pytest.approx(sum(0.4 / (c + 1) for c in range(4)))
