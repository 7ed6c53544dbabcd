"""kernels.decode_attn_roofline (%): the least time the paged-decode and
combine kernels of the profiled slice could take, over their device time.

Work of one decode step, per layer, from the shapes the harness handed to
the slice's dispatches (a dispatch runs ``multi_step`` steps, step j at each
live request's length + j; dummy slots are not counted):
ops 4 * ctx * Hq * D a request (QK^T and PV); bytes each request's K and V
read once (2 * ctx * Hkv * D bf16) plus its q and output (2 * Hq * D bf16).
Bound = max(bytes / HBM rate, ops / bf16 peak), summed over layers and steps.

Over several cards (tensor parallel: each rank does its share of the heads
or experts) the bound is the whole model's work at one card's peaks and the
device time is summed over the cards: the mean share over the cards.
"""

KERNELS = ("paged_decode", "decode_combine")


def step_work(ctxs, m):
    hq, hkv, d = m["q_heads"], m["kv_heads"], m["head_dim"]
    ops = sum(4 * c * hq * d for c in ctxs)
    nbytes = sum(2 * c * hkv * d * 2 for c in ctxs) + len(ctxs) * 2 * hq * d * 2
    return ops, nbytes


def read(run):
    sl = run.slice
    if sl is None or run.peaks is None:
        return None
    bound = 0.0
    for s in sl.steps:
        if s.kind != "decode" or not s.ctxs:
            continue
        for j in range(run.multi_step):
            ops, nbytes = step_work([c + j for c in s.ctxs], run.model)
            bound += run.model["layers"] * max(nbytes / run.peaks["hbm_bytes"], ops / run.peaks["bf16_flops"])
    t = sl.device_s(KERNELS)
    return 100.0 * bound / t if bound and t else None
