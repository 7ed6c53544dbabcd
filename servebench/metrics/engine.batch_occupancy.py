"""engine.batch_occupancy (%): live requests in each decode dispatch of the
window over the engine's max_batch, averaged over those dispatches."""


def read(run):
    steps = run.window_steps("decode")
    if not steps:
        return None
    return 100.0 * sum(len(s.ctxs) for s in steps) / (len(steps) * run.max_batch)
