"""kernels.allreduce_norm_roofline (%): the least time the fused all-reduce
+ residual + RMSNorm calls of the profiled slice could take, summed over
the ranks, over their device time summed over the ranks (kernel names
holding ``allreduce_rmsnorm``): the mean share over the ranks.

One call over r rows of hidden H in bf16 on a tp group of w ranks, per
rank: link bytes 2 (w - 1) / w * r * H * 2, the least traffic of an
all-reduce (NCCL's bus-bandwidth count), over the per-direction NVLink
rate; HBM bytes its x and residual read and its output and new residual
written, 4 * r * H * 2, over the HBM rate. A call's bound is the larger.
Two calls a layer: one set a prefill step over its new rows, ``multi_step``
sets a decode dispatch over its live rows (dummy slots are not counted).
None on one card (w 1: no exchange) or where the slice holds no such call.
"""

KERNELS = ("allreduce_rmsnorm",)


def call_bound(r, h, w, peaks):
    link = 2 * (w - 1) / w * r * h * 2
    hbm = 4 * r * h * 2
    return max(link / peaks["nvlink_bytes"], hbm / peaks["hbm_bytes"])


def read(run):
    sl = run.slice
    w = run.tp
    if sl is None or run.peaks is None or w < 2 or "nvlink_bytes" not in run.peaks:
        return None
    h = run.model["hidden"]
    bound = 0.0
    for s in sl.steps:
        calls = [s.rows] if s.kind == "prefill" else [len(s.ctxs)] * run.multi_step
        bound += 2 * run.model["layers"] * sum(call_bound(r, h, w, run.peaks) for r in calls if r)
    t = sl.device_s(KERNELS)
    return 100.0 * w * bound / t if bound and t else None
