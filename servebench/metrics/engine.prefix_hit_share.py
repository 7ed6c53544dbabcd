"""engine.prefix_hit_share (%): prompt tokens that prefix hits shared, from
the engine's ``prefix_shared_blocks`` counter read around each step, over
the prompt tokens of the requests whose first prefill ran in the window."""


def read(run):
    steps = run.window_steps("prefill")
    admitted = sum(s.admitted for s in steps)
    if not admitted:
        return None
    return 100.0 * sum(s.shared for s in steps) / admitted
