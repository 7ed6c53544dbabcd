"""ttft_p95_ms: 95th percentile, over every request sent in the window, of
its first token's time less its send time. A request with no first token by
the window's end counts its wait so far, so a stall drops no sample."""

from servebench.stats import percentile


def read(run):
    waits = []
    for r in run.requests:
        if not run.in_window(r.t_send) or r.failed:
            continue
        first = r.t_first if r.t_first is not None and r.t_first <= run.t_end else run.t_end
        waits.append(first - r.t_send)
    return 1e3 * percentile(waits, 95) if waits else None
