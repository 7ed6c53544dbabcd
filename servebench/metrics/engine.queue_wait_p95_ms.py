"""engine.queue_wait_p95_ms: 95th percentile, over every request whose
``t_arrive`` (the engine's timestamp at ``add_request``) falls in the
window, of ``t_admit - t_arrive``: the wait before its first prefill step
began. A request not admitted by the window's end counts its wait so far,
as ``ttft_p95_ms`` does. None where the engine keeps no timestamps."""

from servebench.stats import percentile


def read(run):
    waits = []
    for r in run.requests:
        t_arrive = getattr(r.req, "t_arrive", None)
        if t_arrive is None or not run.in_window(t_arrive * 1e-9):
            continue
        admit = r.req.t_admit * 1e-9 if r.req.t_admit is not None else run.t_end
        waits.append(min(admit, run.t_end) - t_arrive * 1e-9)
    return 1e3 * percentile(waits, 95) if waits else None
