"""The harness finds a configuration, a traffic mix and a metric reader
dropped into a copy of it as files, by name alone: no existing file is
edited. The run drives the CPU path of the engine end to end."""

import os

import pytest

from conftest import tiny_config, tiny_traffic


def test_new_files_are_found_by_name(tiny):
    tiny.add_config(tiny_config(moe=True))
    tiny.add_traffic("tinymix", tiny_traffic())
    with open(os.path.join(tiny.root, "metrics", "test.requests_done.py"), "w") as f:
        f.write("def read(run):\n    return float(sum(r.t_done is not None for r in run.requests))\n")
    tiny.bench["end_to_end"].append({"name": "test.requests_done", "unit": "requests", "better": "higher",
                                     "bound": 0.25, "source": "host_clock"})
    cell = tiny.add_cell("tiny-moe", "tinymix")
    result, lines = tiny.run(cell, seed=2**31 + 99)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"output_tok_per_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s",
                                      "test.requests_done"}
    assert result["metrics"]["test.requests_done"]["value"] >= 4
    assert result["metrics"]["test.requests_done"]["unit"] == "requests"
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "check" and list(result["check"]) == ["mean_gap"]
    assert lines == [f"mean_gap {result['check']['mean_gap']['value']} limit 0.005"]


def test_per_layer_metrics_of_a_cpu_run(tiny):
    tiny.add_config(tiny_config(moe=False))
    tiny.add_traffic("tinyprefix", tiny_traffic(prefix=True))
    cell = tiny.add_cell("tiny-dense", "tinyprefix")
    tiny.list_like(cell, "mistral-7b-bf16.shared_prefix")  # an Engine cell: its engine metrics read here
    from servebench import harness
    import time

    result, _ = harness.run_cell(tiny.bench, cell, 5, 1.5, True, time.perf_counter(), root=tiny.root,
                                 device="cpu", num_blocks=256)
    m = result["metrics"]
    # no card, no trace: device readings are left out, spans and counters read
    assert "kernels.decode_attn_roofline" not in m and "model_step.mfu" not in m
    assert m["engine.prefix_hit_share"]["value"] > 50.0
    assert 0 < m["engine.batch_occupancy"]["value"] <= 100.0
    assert m["decode_graph.ms_per_step"]["value"] > 0
    assert result["correct"], result["check"]


def test_configurations_give_every_field_of_the_port():
    import json

    from conftest import ROOT
    from hpc_ops_tpu_torch.models.llama import ModelConfig, MoEConfig

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    names = {"vocab": "vocab_size", "hidden": "hidden_size", "layers": "num_hidden_layers",
             "q_heads": "num_attention_heads", "kv_heads": "num_key_value_heads",
             "rope_base": "rope_theta", "norm_eps": "rms_norm_eps", "max_position": "max_position_embeddings"}
    for entry in bench["configs"]:
        cfg = json.load(open(os.path.join(ROOT, entry["file"])))
        m, pub = cfg["model"], cfg["published"]
        assert set(m) == set(ModelConfig._fields), entry["name"]
        assert m["moe"] is None or set(m["moe"]) == set(MoEConfig._fields)
        assert cfg["reduced"] == entry["reduced"] == []
        for ours, theirs in names.items():
            assert m[ours] == pub[theirs], (entry["name"], ours)
        assert m["head_dim"] == pub.get("head_dim", pub["hidden_size"] // pub["num_attention_heads"])
        if m["moe"]:
            assert m["moe"]["num_experts"] == pub["num_local_experts"]
            assert m["moe"]["topk"] == pub["num_experts_per_tok"]
            assert m["moe"]["expert_intermediate"] == pub["intermediate_size"]
        else:
            assert m["intermediate"] == pub["intermediate_size"]
        assert set(cfg["check"]) <= {"widest_gap", "mean_gap"} and cfg["check"]


@pytest.mark.parametrize("kv", ["bf16", "fp8_kv", "int8_kv"])
def test_kv_block_bytes_follow_the_cache_type(kv):
    """A block's bytes come from the engine's own caches, so a configuration
    with another KV type sizes its pool with no edit to the harness."""
    import torch

    from servebench import harness
    from servebench.reference import mistral
    from hpc_ops_tpu_torch.runtime.engine import Engine

    cfg = tiny_config(moe=False)
    m = dict(cfg["model"], fp8_kv=kv == "fp8_kv", int8_kv=kv == "int8_kv")
    weights = mistral.make_weights(m, 3, torch.device("cpu"))
    eng = Engine(harness.model_config(m), weights, num_blocks=10, block_size=16, max_batch=1,
                 max_blocks_per_seq=8, device=torch.device("cpu"))
    per_elem = 2 if kv == "bf16" else 1
    assert harness.cache_block_bytes(eng, 10) == 2 * m["layers"] * m["kv_heads"] * 16 * m["head_dim"] * per_elem
