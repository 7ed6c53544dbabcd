"""The port's record/replay harness (port of tests/test_replay.py): a
recorded call replays bit-identically from memory and from disk; an in-place
op is recorded with its inputs as they were before the call; a call whose
output changes between runs is caught."""

import copy
import os
import pickle

import pytest
import torch

import hpc_ops_tpu_torch.ops.activation as act_mod
import hpc_ops_tpu_torch.ops.sampler as sampler_mod
from hpc_ops_tpu_torch.config import SoftmaxPolicy
from hpc_ops_tpu_torch.utils.replay import CallRecord, TraceHook, replay_record

torch.set_num_threads(1)


def test_record_and_replay(tmp_path):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((32, 512), generator=gen).to(torch.bfloat16)
    scale = torch.tensor([1.3], dtype=torch.float32)
    with TraceHook([act_mod.act_mul_and_quant], out_dir=str(tmp_path)) as hook:
        out = act_mod.act_mul_and_quant(x, scale)
    assert act_mod.act_mul_and_quant.__name__ == "act_mul_and_quant"
    assert len(hook.records) == 1
    rec = hook.records[0]
    assert rec.path.endswith(".pkl") and os.path.exists(rec.path)
    assert torch.equal(rec.outputs.data.view(torch.uint8), out.view(torch.uint8))
    assert rec.outputs.device == "cpu"
    replay_record(rec)  # from memory
    replay_record(rec.path)  # from disk


def test_in_place_op_records_its_inputs_before_the_call(tmp_path):
    """The sampler writes the penalty mask in place: the record keeps the mask
    it was given, so the replay draws the same token and writes the same
    bits."""
    gen = torch.Generator().manual_seed(1)
    logits = torch.randn((3, 64), generator=gen)
    mask = torch.zeros((4, 8), dtype=torch.uint8)
    with TraceHook([sampler_mod.fused_sampler], out_dir=str(tmp_path)) as hook:
        sampler_mod.fused_sampler(logits, penalty_mask=mask, slot_id=torch.tensor([0, 1, 3]),
                                  repetition_penalty=1.2, temperature=0.7, topk=8,
                                  softmax_policy=SoftmaxPolicy.AFTER_TOPK, seed=5)
    rec = hook.records[0]
    assert not rec.kwargs["penalty_mask"].data.any() and mask.any()
    replay_record(rec.path)


def test_replay_catches_a_changed_output(tmp_path):
    x = torch.randn((16, 256), generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    with TraceHook([act_mod.act_mul_and_quant], out_dir=str(tmp_path)) as hook:
        act_mod.act_mul_and_quant(x, torch.tensor([2.0]))
    rec = hook.records[0]
    bad = CallRecord(rec.name, rec.module, rec.args, rec.kwargs, copy.deepcopy(rec.outputs))
    bad.outputs.raw[0] ^= 1  # one bit of the first code
    with pytest.raises(AssertionError, match="differs from recorded"):
        replay_record(bad)
    with open(rec.path, "rb") as fh:
        assert pickle.load(fh).outputs.data.shape == (16, 128)
