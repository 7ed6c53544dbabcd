"""Shared pieces of the benchmark's CPU tests: a temporary copy of the
harness with a tiny configuration and a tiny traffic mix added as files,
found by name alone, and a one-call CPU run of a cell in it."""

import json
import os
import shutil
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "servebench")


def tiny_config(moe: bool, limits=None, **sizes) -> dict:
    """A tiny Mistral-family configuration; ``sizes`` override its model's
    sizes (vocab 512, 2 layers by default)."""
    cfg = json.load(open(os.path.join(BENCH, "configs", "mixtral-8x7b-fp8.json")))
    cfg["name"] = "tiny-moe" if moe else "tiny-dense"
    cfg["model"].update(vocab=512, hidden=256, layers=2, q_heads=4, kv_heads=2, head_dim=64,
                        intermediate=512, max_position=4096)
    cfg["model"].update(sizes)
    cfg["model"]["moe"] = ({"num_experts": 4, "topk": 2, "expert_intermediate": 256,
                            "scheme": "pertensor_fp8", "act_clip": 8.0} if moe else None)
    cfg["check"] = limits or {"mean_gap": 0.005}
    return cfg


def tiny_traffic(prefix: bool = False) -> dict:
    mix = json.load(open(os.path.join(BENCH, "traffic", "shared_prefix.json" if prefix else "chat.json")))
    mix.update(name="tiny", clients=4, stratum=8, sample_tokens=24)
    mix["prompt"].update(median=40, min=8, max=120)
    mix["output"].update(median=10, min=4, max=24)
    mix["engine"].update(max_batch=4, multi_step=4)
    if prefix:
        mix["shared_prefix"].update(count=3, tokens=64)
    else:
        mix["engine"]["prefill_chunk"] = 32
    return mix


class TinyCopy:
    """A copy of servebench/ under ``tmp`` with files added by name."""

    def __init__(self, tmp):
        self.root = os.path.join(str(tmp), "servebench")
        shutil.copytree(BENCH, self.root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
        self.bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

    def add_config(self, cfg: dict) -> None:
        path = f"servebench/configs/{cfg['name']}.json"
        json.dump(cfg, open(os.path.join(os.path.dirname(self.root), path), "w"))
        self.bench["configs"].append({"name": cfg["name"], "source": "test", "file": path,
                                      "reduced": [], "why": "test"})

    def add_traffic(self, name: str, mix: dict) -> None:
        json.dump(mix, open(os.path.join(self.root, "traffic", name + ".json"), "w"))

    def add_cell(self, config: str, traffic: str, chips: int = 1) -> str:
        name = f"{config}.{traffic}"
        self.bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                        "chips": chips, "why": "test"})
        return name

    def list_like(self, cell: str, like: str) -> None:
        """Add ``cell`` to every metric's ``workloads`` that lists ``like``,
        as a PR that adds a cell of the same engine does."""
        for m in self.bench["per_layer"] + self.bench["end_to_end"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)

    def run(self, cell: str, seed: int, seconds: float = 1.5, **kw):
        from servebench import harness

        torch.manual_seed(0)
        return harness.run_cell(self.bench, cell, seed, seconds, False, time.perf_counter(),
                                root=self.root, device="cpu", num_blocks=256, **kw)


@pytest.fixture
def tiny(tmp_path):
    torch.set_num_threads(2)
    return TinyCopy(tmp_path)
