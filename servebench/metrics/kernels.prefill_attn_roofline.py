"""kernels.prefill_attn_roofline (%): the least time the paged-prefill
kernels of the profiled slice could take, over their device time.

Work of one prefill call of n new rows after o cached tokens, per layer:
ops 4 * D * Hq * (causal pairs n * o + n (n + 1) / 2); bytes q and output
(2 * n * Hq * D bf16) plus the K and V the rows attend to, read once
(2 * (o + n) * Hkv * D bf16). Bound = max(bytes / HBM rate, ops / bf16
peak), summed over layers and calls.

Over several cards (tensor parallel: each rank does its share of the heads
or experts) the bound is the whole model's work at one card's peaks and the
device time is summed over the cards: the mean share over the cards.
"""

KERNELS = ("paged_prefill",)


def call_work(n, o, m):
    hq, hkv, d = m["q_heads"], m["kv_heads"], m["head_dim"]
    pairs = n * o + n * (n + 1) // 2
    return 4 * d * hq * pairs, 2 * n * hq * d * 2 + 2 * (o + n) * hkv * d * 2


def read(run):
    sl = run.slice
    if sl is None or run.peaks is None:
        return None
    bound = 0.0
    for s in sl.steps:
        if s.kind == "prefill" and s.rows:
            ops, nbytes = call_work(s.rows, s.offset, run.model)
            bound += run.model["layers"] * max(nbytes / run.peaks["hbm_bytes"], ops / run.peaks["bf16_flops"])
    t = sl.device_s(KERNELS)
    return 100.0 * bound / t if bound and t else None
