"""engine.prefix_match_ms: mean, over the requests whose admission (the
engine's ``Request.t_admit``, at the start of its first prefill step) falls
in the window, of ``Request.admit_ns``: the prefix match over the resident
requests and the sharing of the matched pages. None where the engine keeps
no admission times."""


def read(run):
    took = []
    for r in run.requests:
        admit_ns = getattr(r.req, "admit_ns", None)
        if admit_ns is not None and run.in_window(r.req.t_admit * 1e-9):
            took.append(admit_ns)
    return 1e-6 * sum(took) / len(took) if took else None
