"""A configuration with ``mesh`` runs on the port's ShardedEngine over the
cell's chips: a tiny MoE at tp 4 over four CPU ranks end to end, a token
altered where the sharded engine produces it is not correct, and a cell is
refused where its chips are not tp x dp or its mix shares prefixes (the
sharded engine has no prefix cache)."""

import pytest

from conftest import tiny_config, tiny_traffic

E2E = {"output_tok_per_s", "ttft_p95_ms", "tpot_p95_ms", "setup_s"}


def mesh_cell(tiny, traffic=None, chips=4):
    cfg = tiny_config(moe=True, q_heads=8, kv_heads=4)
    cfg.update(reference="mixtral_layerwise", mesh={"tp": 4, "dp": 1})
    tiny.add_config(cfg)
    tiny.add_traffic("tinymix", traffic or tiny_traffic())
    return tiny.add_cell("tiny-moe", "tinymix", chips=chips)


def test_mesh_cell_runs_on_the_sharded_engine(tiny, monkeypatch):
    from hpc_ops_tpu_torch.runtime import engine, sharded_engine

    built = []
    real = sharded_engine.ShardedEngine.__init__

    def spy(self, cfg, weights, mesh, **kw):
        built.append((mesh.shape, kw["num_blocks"], kw["max_batch"], kw["multi_step"]))
        real(self, cfg, weights, mesh, **kw)

    def no_engine(*a, **kw):
        raise AssertionError("a mesh cell built the one-card Engine")

    monkeypatch.setattr(sharded_engine.ShardedEngine, "__init__", spy)
    monkeypatch.setattr(engine.Engine, "__init__", no_engine)
    cell = mesh_cell(tiny)
    result, lines = tiny.run(cell, seed=2**31 + 7, seconds=2.0)
    assert built == [({"dp": 1, "tp": 4}, 256, 4, 4)]
    assert result["correct"], result["check"]
    assert result["device"]["count"] == 4
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == E2E
    assert lines == [f"mean_gap {result['check']['mean_gap']['value']} limit 0.005"]


def test_mesh_cell_with_altered_tokens_is_not_correct(tiny, monkeypatch):
    from hpc_ops_tpu_torch.runtime import sharded_engine

    base = sharded_engine.ShardedEngine._sample

    def altered(self, logits):
        toks, lps = base(self, logits)
        return [(int(t) + 1) % 512 for t in toks], lps

    monkeypatch.setattr(sharded_engine.ShardedEngine, "_sample", altered)
    cell = mesh_cell(tiny)
    result, _ = tiny.run(cell, seed=2**31 + 8, seconds=2.0)
    assert not result["correct"], result["check"]


def test_chips_must_be_the_mesh(tiny):
    cell = mesh_cell(tiny, chips=2)
    with pytest.raises(ValueError, match="tp x dp"):
        tiny.run(cell, seed=3)


def test_a_mix_that_shares_prefixes_is_refused(tiny):
    cell = mesh_cell(tiny, traffic=tiny_traffic(prefix=True))
    with pytest.raises(ValueError, match="no prefix cache"):
        tiny.run(cell, seed=4)


def test_a_failing_rank_ends_the_run(tiny, monkeypatch):
    """A rank that raises fails the run at once with its own error: the
    other ranks, waiting at the collective, are released, nothing hangs."""
    import time

    from hpc_ops_tpu_torch.models import llama

    real = llama.forward_step

    def failing(*a, axis_name=None, **kw):
        if axis_name is not None and axis_name.rank == 2:
            raise RuntimeError("rank 2 failed")
        return real(*a, axis_name=axis_name, **kw)

    monkeypatch.setattr(llama, "forward_step", failing)
    cell = mesh_cell(tiny)
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 2 failed"):
        tiny.run(cell, seed=5)
    assert time.perf_counter() - t < 60


def test_the_watchdog_follows_the_run_and_is_cancelled(tiny, monkeypatch):
    """On the cards a mesh run arms the watchdog for its own window, trace
    and reference passes, and cancels it whether it returns or raises; a
    one-card run arms none."""
    from hpc_ops_tpu_torch import kernels

    from servebench import harness

    assert harness.watchdog_s(45, False, False) == 315
    assert harness.watchdog_s(200, True, True) == 180 + 200 + 60 + 180
    calls = []
    monkeypatch.setattr(kernels, "lib", lambda: None)
    monkeypatch.setattr(harness.faulthandler, "dump_traceback_later",
                        lambda s, exit: calls.append(("arm", s, exit)))
    monkeypatch.setattr(harness.faulthandler, "cancel_dump_traceback_later", lambda: calls.append("cancel"))

    def body(*args):
        if args[4]:
            raise RuntimeError("a rank failed")
        return "result", []

    monkeypatch.setattr(harness, "_run_cell", body)
    cell = mesh_cell(tiny)
    assert harness.run_cell(tiny.bench, cell, 1, 45, False, 0.0, root=tiny.root) == ("result", [])
    with pytest.raises(RuntimeError, match="a rank failed"):
        harness.run_cell(tiny.bench, cell, 1, 200, True, 0.0, root=tiny.root, control=True)
    assert calls == [("arm", 315, True), "cancel", ("arm", 620, True), "cancel"]
    calls.clear()
    one_card = dict(tiny_config(moe=True), name="tiny-one-card")
    tiny.add_config(one_card)
    one = tiny.add_cell("tiny-one-card", "tinymix")
    assert harness.run_cell(tiny.bench, one, 1, 45, False, 0.0, root=tiny.root) == ("result", [])
    assert calls == []
