"""What decides ``correct`` fails what it must: the control (the reference
one precision step down) reads far above the program on the same samples
and is not correct under the configurations' own limits, and a run whose served tokens are altered where they are produced, in the
decode graph or in prefill's sampling, comes out not correct under the
cells' own limits."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH, tiny_config, tiny_traffic


def limits_of(config):
    return json.load(open(os.path.join(BENCH, "configs", config + ".json")))["check"]


@pytest.mark.parametrize("moe", [False, True])
def test_control_reads_far_above_the_program(tiny, moe):
    """The control reads far above the program, and the harness's own
    comparison, under the configuration's limits, finds it not correct
    while the program passes. The full vocabulary and 8 layers give the
    near-ties and the depth over which a rounding error grows into a gap."""
    config = "mixtral-8x7b-fp8" if moe else "mistral-7b-bf16"
    tiny.add_config(tiny_config(moe, limits=limits_of(config), vocab=32000, layers=8))
    tiny.add_traffic("tinymix", dict(tiny_traffic(), sample_tokens=240))
    cell = tiny.add_cell("tiny-moe" if moe else "tiny-dense", "tinymix")
    prog, ctl = [], []
    for seed in (11, 12, 13):
        result, _ = tiny.run(cell, seed, seconds=6.0, control=True)
        prog.append(result["check"]["mean_gap"]["value"])
        ctl.append(result["control"]["mean_gap"])
        assert result["correct"], result["check"]
        assert not result["control_correct"], result["control_check"]
    assert min(ctl) > 3 * max(prog), (prog, ctl)


@pytest.mark.parametrize("where", ["decode_graph", "prefill_sample"])
@pytest.mark.parametrize("config", ["mixtral-8x7b-fp8", "mistral-7b-bf16"])
def test_altered_tokens_are_not_correct(tiny, monkeypatch, where, config):
    from hpc_ops_tpu_torch.runtime import decode_graph, engine

    tiny.add_config(tiny_config(moe=config.startswith("mixtral"), limits=limits_of(config)))
    tiny.add_traffic("tinymix", tiny_traffic())
    cell = tiny.add_cell("tiny-moe" if config.startswith("mixtral") else "tiny-dense", "tinymix")
    if where == "decode_graph":
        base = decode_graph.DecodeMultiGraph.__call__

        def altered(self, *a, **kw):
            toks, lps = base(self, *a, **kw)
            toks = np.array(toks)
            toks[-1] = (toks[-1] + 1) % 512  # the last step's token of every slot
            return toks, lps

        monkeypatch.setattr(decode_graph.DecodeMultiGraph, "__call__", altered)
    else:
        base = engine.Engine._sample

        def altered(self, logits, rids=None):
            toks, lps = base(self, logits, rids)
            return [(t + 1) % 512 for t in toks], lps

        monkeypatch.setattr(engine.Engine, "_sample", altered)
    result, _ = tiny.run(cell, seed=21)
    assert not result["correct"], result["check"]
