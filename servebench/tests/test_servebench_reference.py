"""The plain reference at a tiny size against an independent float64
computation written from the published block, token by token with a
growing cache, and the control's distance from it."""

import math

import pytest
import torch

from conftest import tiny_config
from servebench.harness import reference

REF = reference("mistral")


def float64_logits(w, m, tokens):
    """Mistral/Mixtral block in float64, one token at a time over a KV cache."""
    f = lambda t: t.double()  # noqa: E731
    hq, hkv, d, eps, a = m["q_heads"], m["kv_heads"], m["head_dim"], m["norm_eps"], m["residual_alpha"]

    def norm(x, g):
        return x / torch.sqrt((x * x).mean() + eps) * f(g)

    def rope(x, p):
        inv = 1.0 / m["rope_base"] ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
        c, s = torch.cos(p * inv), torch.sin(p * inv)
        x1, x2 = x[..., : d // 2], x[..., d // 2 :]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)

    caches = [([], []) for _ in w["layers"]]
    out = []
    for p, tok in enumerate(tokens):
        x = f(w["embed"][tok])
        for layer, (ks, vs) in zip(w["layers"], caches):
            qkv = norm(x, layer["attn_norm"]) @ f(layer["wqkv"])
            q = rope(qkv[: hq * d].view(hq, d), p)
            ks.append(rope(qkv[hq * d : (hq + hkv) * d].view(hkv, d), p))
            vs.append(qkv[(hq + hkv) * d :].view(hkv, d))
            K, V = torch.stack(ks), torch.stack(vs)  # [T, hkv, d]
            heads = []
            for h in range(hq):
                g = h // (hq // hkv)
                att = torch.softmax(K[:, g] @ q[h] / math.sqrt(d), 0)
                heads.append(att @ V[:, g])
            x = x + a * (torch.cat(heads) @ f(layer["wo"]))
            hn = norm(x, layer["mlp_norm"])
            moe = m["moe"]
            if moe is None:
                gu = hn @ f(layer["w_gate_up"])
                i = gu.shape[0] // 2
                y = (torch.nn.functional.silu(gu[:i]) * gu[i:]) @ f(layer["w_down"])
            else:
                r = hn @ f(layer["router"])
                top = torch.topk(r, moe["topk"])
                gates = torch.softmax(top.values, 0)
                y = torch.zeros_like(x)
                for gate, e in zip(gates, top.indices.tolist()):
                    wgu = f(layer["moe_gate_up"][e]) * f(layer["moe_gate_up_scale"][e])
                    wd = f(layer["moe_down"][e]) * f(layer["moe_down_scale"][e])
                    gu = wgu @ hn
                    i = gu.shape[0] // 2
                    y = y + gate * (wd @ (torch.nn.functional.silu(gu[:i]) * gu[i:]))
            x = x + a * y
        out.append(norm(x, w["final_norm"]) @ f(w["lm_head"]))
    return torch.stack(out)


@pytest.mark.parametrize("moe", [False, True])
def test_reference_matches_float64(moe):
    torch.set_num_threads(2)
    m = tiny_config(moe)["model"]
    m = dict(m, layers=2)
    w = REF.make_weights(m, 2**31 + 3, "cpu")
    seqs = [[5, 17, 300, 2, 9, 44, 3, 1, 511, 0, 7], [8, 8, 8]]
    rows = [list(range(4, 11)), [0, 1, 2]]
    got = REF.logits(w, m, seqs, rows)
    for s, r, g in zip(seqs, rows, got):
        want = float64_logits(w, m, s)[r]
        assert torch.allclose(g.double(), want, atol=2e-4, rtol=1e-4), (g.double() - want).abs().max()
    # the control is one precision step down: visibly further from float64
    ctl = REF.logits(w, m, seqs, rows, precision="control")
    far = max((c.double() - float64_logits(w, m, s)[r]).abs().max().item() for s, r, c in zip(seqs, rows, ctl))
    assert far > 20 * 2e-4


def test_weights_follow_the_seed_and_the_layout():
    m = tiny_config(True)["model"]
    a = REF.make_weights(m, 7, "cpu")
    b = REF.make_weights(m, 7, "cpu")
    c = REF.make_weights(m, 8, "cpu")
    assert torch.equal(a["layers"][1]["moe_down"].view(torch.uint8), b["layers"][1]["moe_down"].view(torch.uint8))
    assert not torch.equal(a["layers"][0]["wqkv"], c["layers"][0]["wqkv"])
    layer = a["layers"][0]
    e, i, h = 4, 256, 256
    assert layer["moe_gate_up"].shape == (e, 2 * i, h) and layer["moe_gate_up"].dtype == torch.float8_e4m3fn
    assert layer["moe_down"].shape == (e, h, i) and layer["moe_down_scale"].shape == (e,)
    assert layer["wqkv"].shape == (h, (4 + 2 * 2) * 64) and layer["wqkv"].dtype == torch.bfloat16
    assert torch.isfinite(layer["moe_gate_up"].float()).all()
