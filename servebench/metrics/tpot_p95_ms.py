"""tpot_p95_ms: 95th percentile, over every request that finished in the
window with two tokens or more, of (finish - first token) / (tokens - 1)."""

from servebench.stats import percentile


def read(run):
    per = [(r.t_done - r.t_first) / (r.n_out - 1) for r in run.requests
           if not r.failed and r.t_done is not None and run.in_window(r.t_done) and r.n_out > 1]
    return 1e3 * percentile(per, 95) if per else None
