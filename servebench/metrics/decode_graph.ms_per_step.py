"""decode_graph.ms_per_step: host-clock time of the window's engine steps
that dispatched decode (a replay of the captured multi-step graph each),
over the decode steps they ran (multi_step a dispatch)."""


def read(run):
    steps = run.window_steps("decode")
    if not steps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / (len(steps) * run.multi_step)
