"""``reference/mixtral_layerwise.py``: layers drawn when asked for, equal on
every draw, from the distributions and codes of ``mistral.py``, and its
``logits`` those of ``mistral.py`` on the same weights."""

import math

import pytest
import torch

from conftest import tiny_config
from servebench.harness import reference

LW = reference("mixtral_layerwise")
MISTRAL = reference("mistral")


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@pytest.fixture
def model():
    torch.set_num_threads(2)
    return dict(tiny_config(True)["model"], layers=3)


def test_lazy_layers_are_equal_on_every_draw(model):
    w = LW.make_weights(model, 2**33 + 5, "cpu")
    again = LW.make_weights(model, 2**33 + 5, "cpu")
    other = LW.make_weights(model, 2**33 + 6, "cpu")
    assert len(w["layers"]) == 3
    first, second = w["layers"][1], w["layers"][1]
    assert first is not second and set(first) == set(again["layers"][1])
    for k in first:
        assert torch.equal(_bits(first[k]), _bits(second[k])), k
        assert torch.equal(_bits(first[k]), _bits(again["layers"][1][k])), k
    assert torch.equal(w["embed"], again["embed"]) and torch.equal(w["lm_head"], again["lm_head"])
    assert not torch.equal(w["layers"][0]["wqkv"], first["wqkv"])  # a stream a layer
    assert not torch.equal(other["layers"][1]["wqkv"], first["wqkv"])
    assert torch.equal(w["layers"][-1]["wo"], w["layers"][2]["wo"])
    with pytest.raises(IndexError):
        w["layers"][3]
    assert LW.for_sharding(w) is w  # nothing to stage on the CPU


def test_layers_have_mistral_layout_and_distributions(model):
    m = dict(model, hidden=512, q_heads=8, kv_heads=4)
    lw = LW.make_weights(m, 11, "cpu")
    ref = MISTRAL.make_weights(m, 11, "cpu")
    a, b = lw["layers"][0], ref["layers"][0]
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    for k in ("embed", "lm_head", "final_norm", "cos_sin"):
        assert lw[k].shape == ref[k].shape and lw[k].dtype == ref[k].dtype, k
    assert torch.equal(lw["cos_sin"], ref["cos_sin"])
    h, inter = m["hidden"], m["moe"]["expert_intermediate"]
    for k, fan_in in (("wqkv", h), ("wo", m["q_heads"] * m["head_dim"]), ("router", h)):
        for w in (a, b):
            assert abs(w[k].float().std().item() * math.sqrt(fan_in) - 1.0) < 0.05, k
    for k, fan_in in (("moe_gate_up", h), ("moe_down", inter)):
        assert torch.equal(a[k + "_scale"], b[k + "_scale"])
        sa, sb = a[k].float().std().item(), b[k].float().std().item()
        assert abs(sa / sb - 1.0) < 0.02, k
    for k in ("attn_norm", "mlp_norm"):
        assert abs(a[k].mean().item() - 1.0) < 0.03 and abs(a[k].std().item() - 0.1) < 0.02


@pytest.mark.parametrize("precision", ["float32", "control"])
def test_logits_are_mistral_on_the_same_weights(model, precision):
    w = LW.make_weights(model, 2**31 + 17, "cpu")
    whole = {**w, "layers": list(w["layers"])}
    seqs = [[5, 17, 300, 2, 9, 44, 3, 1, 511, 0, 7], [8, 8, 8]]
    rows = [list(range(4, 11)), [0, 1, 2]]
    got = LW.logits(w, model, seqs, rows, precision)
    want = MISTRAL.logits(whole, model, seqs, rows, precision)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
