"""kernels.moe_gemm_roofline (%): the least time the e4m3 grouped GEMMs of
the profiled slice could take, over their device time.

Work of one MoE call over r rows (a prefill call's new rows, or a decode
step's live rows; dummy slots are not counted), routed to k experts each:
the gate-up GEMM does 2 * r * k * 2I * H operations and the down GEMM
2 * r * k * I * H. Bytes: each expert the rows reach read once per GEMM
(min(E, r * k) experts: all E from r * k >= E on, which holds at every
batch of these cells), the routed e4m3 inputs read once and the bf16
outputs written once. Bound = max(bytes / HBM rate, ops / e4m3 peak) for
each GEMM, summed over both, the layers and the calls.

Over several cards (tensor parallel: each rank does its share of the heads
or experts) the bound is the whole model's work at one card's peaks and the
device time is summed over the cards: the mean share over the cards.
"""

KERNELS = ("gg_scatter", "gg_pertensor", "gg_bw_")


def call_bound(r, m, peaks):
    moe = m["moe"]
    h, i, k = m["hidden"], moe["expert_intermediate"], moe["topk"]
    hit = min(moe["num_experts"], r * k)
    total = 0.0
    for n_out, k_in in ((2 * i, h), (h, i)):  # gate-up, then down
        ops = 2 * r * k * n_out * k_in
        nbytes = hit * n_out * k_in + r * k * k_in + r * k * n_out * 2
        total += max(nbytes / peaks["hbm_bytes"], ops / peaks["fp8_flops"])
    return total


def read(run):
    sl = run.slice
    if sl is None or run.peaks is None or not run.model.get("moe"):
        return None
    bound = 0.0
    for s in sl.steps:
        calls = [s.rows] if s.kind == "prefill" else [len(s.ctxs)] * run.multi_step
        bound += run.model["layers"] * sum(call_bound(r, run.model, run.peaks) for r in calls if r)
    t = sl.device_s(KERNELS)
    return 100.0 * bound / t if bound and t else None
