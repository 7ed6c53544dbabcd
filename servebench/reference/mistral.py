"""Mistral-family decoder (Mistral-7B, Mixtral-8x7B) in plain PyTorch.

Two parts, both independent of the program under test:

* :func:`make_weights` draws a configuration's weights on the device from a
  seed, in the layout the served engine reads (``x @ w`` with ``w`` [in,
  out]; experts ``[E, 2I, H]`` gate rows then up rows and ``[E, H, I]``, as
  e4m3 codes with one float32 scale per expert). The same tensors go to the
  engine and to :func:`logits`.
* :func:`logits` is the model's forward pass in float32 (TF32 off) over
  whole token sequences, layer by layer, with no cache and no batching: the
  published block (RMSNorm, GQA attention with rotate-half RoPE, SwiGLU MLP
  or top-k routed SwiGLU experts with softmax over the chosen router
  logits), with the configuration's ``residual_alpha`` scaling each
  residual branch. Expert weights are their e4m3 codes times their scale,
  which is what the configuration serves; activations stay float32.

``precision="control"`` computes the same pass one precision step below
each part the configuration states: every bf16 weight that enters a
product, the activation entering it and the K/V kept for attention are
rounded to e4m3 with one scale a tensor (amax / 448); the e4m3 expert
weights become int4 codes (-7..7) with one scale an expert matrix, and the
experts' inputs are e4m3 as stated; products accumulate in float32. That is
the control that the comparison has to fail.
"""

from __future__ import annotations

import math

import torch

E4M3 = torch.float8_e4m3fn
E4M3_MAX = 448.0
CODE_STD = 64.0  # expert codes ~ N(0, 64^2): the largest of 10^9 draws stays under 448


def _lin(gen, shape, fan_in, device, dtype=torch.bfloat16):
    w = torch.empty(shape, dtype=dtype, device=device)
    w.normal_(generator=gen)
    return w.mul_(1.0 / math.sqrt(fan_in))


def cos_sin_table(max_position: int, head_dim: int, theta: float, device) -> torch.Tensor:
    """[max_position, head_dim] float32: cos of each position's angles in
    the first half, sin in the second (the engine's table)."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim)
    ang = torch.arange(max_position, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return torch.cat([ang.cos(), ang.sin()], dim=-1).float()


def make_weights(m: dict, seed: int, device) -> dict:
    """The weights of model ``m`` (a configuration's ``model`` block) drawn
    on ``device`` from ``seed``: dense matrices normal / sqrt(fan_in) in
    bf16 in one draw, the embedding normal, norm gains 1 + 0.1 normal in
    float32, experts drawn a layer at a time as e4m3 codes."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    h, d, L = m["hidden"], m["head_dim"], m["layers"]
    qkv_out = (m["q_heads"] + 2 * m["kv_heads"]) * d
    moe = m.get("moe")
    shapes = [("wqkv", (h, qkv_out), h), ("wo", (m["q_heads"] * d, h), m["q_heads"] * d)]
    if moe:
        shapes.append(("router", (h, moe["num_experts"]), h))
    else:
        shapes += [("w_gate_up", (h, 2 * m["intermediate"]), h),
                   ("w_down", (m["intermediate"], h), m["intermediate"])]
    per_layer = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.empty(per_layer * L, dtype=torch.bfloat16, device=device)
    flat.normal_(generator=gen)
    norms = torch.empty((L, 2, h), dtype=torch.float32, device=device).normal_(generator=gen)
    norms.mul_(0.1).add_(1.0)
    layers, off = [], 0
    for li in range(L):
        layer = {"attn_norm": norms[li, 0], "mlp_norm": norms[li, 1]}
        for name, shape, fan_in in shapes:
            n = math.prod(shape)
            layer[name] = flat[off : off + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
            off += n
        layers.append(layer)
    if moe:
        e, i = moe["num_experts"], moe["expert_intermediate"]
        scratch = torch.empty((e, 2 * i, h), dtype=torch.bfloat16, device=device)
        for layer in layers:
            for name, shape, fan_in in (("moe_gate_up", (e, 2 * i, h), h), ("moe_down", (e, h, i), i)):
                g = scratch.view(-1)[: math.prod(shape)].view(shape).normal_(generator=gen)
                layer[name] = g.mul_(CODE_STD).clamp_(-E4M3_MAX, E4M3_MAX).to(E4M3)
                layer[name + "_scale"] = torch.full((e,), 1.0 / (CODE_STD * math.sqrt(fan_in)),
                                                    dtype=torch.float32, device=device)
        del scratch
    embed = torch.empty((m["vocab"], h), dtype=torch.bfloat16, device=device).normal_(generator=gen)
    return {
        "embed": embed,
        "final_norm": torch.empty(h, dtype=torch.float32, device=device).normal_(generator=gen)
        .mul_(0.1).add_(1.0),
        "lm_head": _lin(gen, (h, m["vocab"]), h, device),
        "layers": layers,
        "cos_sin": cos_sin_table(m["max_position"], d, m["rope_base"], device),
    }


def _q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at one scale for the tensor, back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / s).to(E4M3).float() * s


def _q4(t: torch.Tensor) -> torch.Tensor:
    """``t`` as int4 codes (-7..7) at one scale for the tensor, in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 7.0
    return (t / s).round_().clamp_(-7, 7).mul_(s)


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope(x, pos, theta):
    """Rotate-half RoPE of x [T, heads, D] at positions pos [T]."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = pos.double()[:, None] * inv[None, :]
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    a, b = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v, q_chunk=2048):
    """Causal GQA attention of one sequence: q [T, Hq, D], k and v [T, Hkv,
    D], in float32, queries in chunks."""
    t, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty_like(q)
    kk = k.permute(1, 0, 2)  # [Hkv, T, D]
    vv = v.permute(1, 0, 2)
    qq = q.view(t, hkv, g, d).permute(1, 2, 0, 3)  # [Hkv, G, T, D]
    scale = 1.0 / math.sqrt(d)
    for lo in range(0, t, q_chunk):
        hi = min(t, lo + q_chunk)
        s = torch.matmul(qq[:, :, lo:hi], kk[:, None, :hi].transpose(-1, -2)) * scale  # [Hkv, G, c, hi]
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        s.masked_fill_(cols > rows, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vv[:, None, :hi])  # [Hkv, G, c, D]
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, hq, d)
    return out


def _moe(x, layer, moe, q, ctl):
    """Top-k routed SwiGLU experts of rows x [N, H]: softmax over the chosen
    router logits, each expert's rows through its dequantised weights. Under
    the control the expert weights are int4 and their inputs e4m3 (one scale
    for all rows, as the served step has)."""
    w4 = _q4 if ctl else (lambda t: t)
    x = q(x)
    logits = x @ q(layer["router"].float())
    top_v, top_i = torch.topk(logits, moe["topk"], dim=-1)
    gate = torch.softmax(top_v, dim=-1)
    out = torch.zeros_like(x)
    i_dim = moe["expert_intermediate"]
    for e in range(moe["num_experts"]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        wgu = w4(layer["moe_gate_up"][e].float() * layer["moe_gate_up_scale"][e])
        wd = w4(layer["moe_down"][e].float() * layer["moe_down_scale"][e])
        gu = x[rows] @ wgu.t()
        act = torch.nn.functional.silu(gu[:, :i_dim]) * gu[:, i_dim:]
        out.index_add_(0, rows, (q(act) @ wd.t()) * gate[rows, slot][:, None])
        del wgu, wd
    return out


@torch.no_grad()
def logits(weights: dict, m: dict, seqs: list, want: list, precision: str = "float32") -> list:
    """Float32 logits of each sequence in ``seqs`` (lists of token ids) at
    the positions ``want[i]`` (a list of row indices of sequence i):
    ``[len(want[i]), vocab]`` tensors. Layer by layer over all sequences, so
    one layer's float32 weights are live at a time."""
    if precision not in ("float32", "control"):
        raise ValueError(f"unknown precision {precision!r}")
    ctl = precision == "control"
    q = _q8 if ctl else (lambda t: t)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        dev = weights["embed"].device
        hq, hkv, d = m["q_heads"], m["kv_heads"], m["head_dim"]
        eps, alpha, theta = m["norm_eps"], m["residual_alpha"], m["rope_base"]
        embed = q(weights["embed"].float()) if ctl else weights["embed"]
        xs = [embed[torch.tensor(s, device=dev)].float() for s in seqs]
        del embed
        for layer in weights["layers"]:
            wqkv, wo = q(layer["wqkv"].float()), q(layer["wo"].float())
            for j, x in enumerate(xs):
                t = x.shape[0]
                qkv = q(_rmsnorm(x, layer["attn_norm"], eps)) @ wqkv
                qh = qkv[:, : hq * d].view(t, hq, d)
                kh = qkv[:, hq * d : (hq + hkv) * d].view(t, hkv, d)
                vh = qkv[:, (hq + hkv) * d :].view(t, hkv, d)
                pos = torch.arange(t, device=dev)
                qh, kh = _rope(qh, pos, theta), _rope(kh, pos, theta)
                if ctl:  # the KV cache one step down
                    kh, vh = _q8(kh), _q8(vh)
                attn = _attention(qh, kh, vh).reshape(t, hq * d)
                x = x + alpha * (q(attn) @ wo)
                hn = _rmsnorm(x, layer["mlp_norm"], eps)
                if m.get("moe"):
                    mlp = _moe(hn, layer, m["moe"], q, ctl)
                else:
                    gu = q(hn) @ q(layer["w_gate_up"].float())
                    i_dim = gu.shape[1] // 2
                    act = torch.nn.functional.silu(gu[:, :i_dim]) * gu[:, i_dim:]
                    mlp = q(act) @ q(layer["w_down"].float())
                xs[j] = x + alpha * mlp
            del wqkv, wo
        head = q(weights["lm_head"].float())
        out = []
        for x, rows in zip(xs, want):
            hn = _rmsnorm(x[torch.as_tensor(rows, device=dev)], weights["final_norm"], eps)
            out.append(q(hn) @ head)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
