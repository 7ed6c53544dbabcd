"""The command's contract where there is no card, and its output on one."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT


def test_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card exit is not reachable")
    p = subprocess.run([sys.executable, "servebench/run.py", "--workload", "mixtral-8x7b-fp8.chat",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_unknown_workload_is_refused():
    p = subprocess.run([sys.executable, "servebench/run.py", "--workload", "nope.nope", "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card, tiny):
    from conftest import tiny_config, tiny_traffic
    import time

    from servebench import harness

    tiny.add_config(tiny_config(moe=True))
    tiny.add_traffic("tinymix", tiny_traffic())
    cell = tiny.add_cell("tiny-moe", "tinymix")
    result, _ = harness.run_cell(tiny.bench, cell, 2**31 + 1, 2.0, True, time.perf_counter(), root=tiny.root,
                                 device="cuda", num_blocks=512)
    json.dumps(result)
    assert result["correct"], result["check"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["kernels.decode_attn_roofline"]["value"] <= 105
    assert os.path.isdir(os.path.join(ROOT, "build", "kernels"))
