"""model_step.mfu (%): model FLOPs of the profiled slice's tokens over its
wall time at the bf16 dense peak of the run's cards (``run.chips`` times a
card's: the whole model's FLOPs over the whole mesh's peak).

Tokens are the new prompt rows of its prefill calls and the live rows of
its decode steps (dummy slots are not counted). A token costs 2 FLOPs per
active matmul parameter: per layer the QKV and output projections and the
MLP (dense: gate, up and down; MoE: the router and top-k experts' gate, up
and down), plus the LM head once per logits row (one per prefill call, one
per live decode row), plus attention: 4 * D * Hq per causal pair (prefill)
or per cached position (decode), per layer.
"""


def token_flops(m):
    h, d = m["hidden"], m["head_dim"]
    per_layer = h * (m["q_heads"] + 2 * m["kv_heads"]) * d + m["q_heads"] * d * h
    moe = m.get("moe")
    if moe:
        per_layer += h * moe["num_experts"] + moe["topk"] * 3 * h * moe["expert_intermediate"]
    else:
        per_layer += 3 * h * m["intermediate"]
    return 2 * m["layers"] * per_layer


def step_flops(s, m, multi_step):
    attn = 4 * m["head_dim"] * m["q_heads"] * m["layers"]
    head = 2 * m["hidden"] * m["vocab"]
    if s.kind == "prefill":
        pairs = s.rows * s.offset + s.rows * (s.rows + 1) // 2
        return s.rows * token_flops(m) + head + attn * pairs
    total = 0
    for j in range(multi_step):
        total += len(s.ctxs) * (token_flops(m) + head) + attn * sum(c + j for c in s.ctxs)
    return total


def read(run):
    sl = run.slice
    if sl is None or run.peaks is None or sl.wall_s <= 0:
        return None
    flops = sum(step_flops(s, run.model, run.multi_step) for s in sl.steps)
    return 100.0 * flops / (sl.wall_s * run.chips * run.peaks["bf16_flops"]) if flops else None
