"""model_step.prefill_ms_per_ktok: host-clock time of the window's engine
steps that prefilled (eager forward_step over a prompt or a chunk of it),
over the new prompt rows they ran, per 1000 rows."""


def read(run):
    steps = run.window_steps("prefill")
    rows = sum(s.rows for s in steps)
    if not rows:
        return None
    return 1e6 * sum(s.t1 - s.t0 for s in steps) / rows
