"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the window finished is
drawn from the seed, the longest of them always in it, until it holds
``sample_tokens`` served tokens and ``sample_requests`` requests. The plain reference runs each sampled
prompt with its served tokens; for every served token the gap is how far
the reference's logit of that token lies below the reference's best logit
at that position (0 where they agree). Two numbers are read:

* ``widest_gap``: the largest gap over the sample's served tokens;
* ``mean_gap``: the mean gap over them.

A number is compared where the configuration's ``check`` block gives it a
limit. The control (the reference one precision step down,
``precision="control"``) is read the same way, from the token the control
puts first at each position. The widest gap is one near-tie of the sample,
so the control's reads only 1-3 times the program's; the mean gap grows
with the square of the error (how often a near-tie flips times by how
much) and separates them, so the configurations compare the mean gap.
"""

from __future__ import annotations

import numpy as np

SAMPLE_STREAM = 5  # the seed stream the sample is drawn from


def sample(requests: list, t_start: float, t_end: float, seed: int, min_tokens: int,
           min_requests: int = 1) -> list:
    """The requests finished in the window to compare: the longest (prompt
    plus output) first, then others in a seeded order until the sample holds
    ``min_requests`` requests and ``min_tokens`` served tokens."""
    done = [r for r in requests if not r.failed and r.t_done is not None and t_start < r.t_done <= t_end]
    if not done:
        return []
    done.sort(key=lambda r: r.index)
    longest = max(done, key=lambda r: (r.prompt_len + r.n_out, -r.index))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed) % 2**64, SAMPLE_STREAM]).permutation(len(rest))
    out, n = [longest], longest.n_out
    for i in order:
        if n >= min_tokens and len(out) >= min_requests:
            break
        out.append(rest[int(i)])
        n += rest[int(i)].n_out
    return out


def reference_inputs(picked: list) -> tuple:
    """(sequences, rows): each prompt with its served tokens but the last,
    and the rows whose logits chose the served tokens."""
    seqs = [list(r.prompt) + list(r.out[:-1]) for r in picked]
    rows = [list(range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.out))) for r in picked]
    return seqs, rows


def gaps(ref_logits: list, chosen: list) -> list:
    """Per token, the reference's best logit minus its logit of the chosen
    token; ``chosen[i]`` holds sequence i's tokens (served, or the
    control's first choices)."""
    import torch

    out = []
    for lg, toks in zip(ref_logits, chosen):
        t = torch.as_tensor(toks, device=lg.device, dtype=torch.long)
        best = lg.max(dim=-1).values
        out.extend((best - lg.gather(1, t[:, None])[:, 0]).tolist())
    return out


def readings(gap_list: list) -> dict:
    if not gap_list:
        return {}
    return {"widest_gap": max(gap_list), "mean_gap": sum(gap_list) / len(gap_list)}


def judge(read: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every limited number present
    and at or under its limit."""
    table = {}
    ok = bool(read)
    for name, limit in limits.items():
        v = read.get(name)
        table[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, table
