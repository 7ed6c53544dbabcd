"""The readers of the engine's own per-request times: queue wait from
``Request.t_arrive`` and ``t_admit`` (a request never admitted counts its
wait so far), the prefix match from ``Request.admit_ns``, None where the
engine keeps no such times, and both read in a CPU run of a cell."""

import time
from types import SimpleNamespace

import pytest

from conftest import tiny_config, tiny_traffic
from servebench.harness import RequestRecord, Run, reader, run_cell
from servebench.stats import percentile


def make_run(requests):
    return Run(seconds=10.0, setup_s=3.0, t_start=0.0, t_end=10.0, steps=[], requests=list(requests),
               slice=None, memory_peak_bytes=0, model={}, mix={}, block_size=16, max_batch=4,
               multi_step=1, device_name="test", peaks=None)


def engine_req(i, arrive, admit=None, admit_ms=None):
    """A harness record whose engine Request holds times in seconds (kept
    in ns, as the engine keeps them)."""
    r = RequestRecord(i, [1, 2, 3], 4, arrive)
    r.req = SimpleNamespace(t_arrive=int(arrive * 1e9), t_admit=None if admit is None else int(admit * 1e9),
                            admit_ns=None if admit_ms is None else int(admit_ms * 1e6))
    return r


def test_queue_wait_counts_requests_never_admitted():
    rs = [engine_req(i, 1.0, 1.05) for i in range(19)]
    rs.append(engine_req(19, 4.0))  # never admitted: 6 s by the window's end
    rs.append(engine_req(20, -1.0, 0.5))  # arrived before the window: no sample
    rs.append(engine_req(21, 9.0, 12.0))  # admitted after the window: 1 s so far
    wait = reader("engine.queue_wait_p95_ms")
    assert wait(make_run(rs)) == pytest.approx(1e3 * percentile([0.05] * 19 + [6.0, 1.0], 95))
    failed = RequestRecord(22, [1], 4, 2.0)  # add_request refused it: no engine Request
    assert wait(make_run([failed])) is None
    assert wait(make_run([])) is None


def test_prefix_match_is_the_mean_admission_in_the_window():
    rs = [engine_req(0, 0.5, 1.0, admit_ms=4.0), engine_req(1, 2.0, 3.0, admit_ms=10.0),
          engine_req(2, -2.0, -1.0, admit_ms=50.0),  # admitted before the window
          engine_req(3, 9.0, 11.0, admit_ms=70.0),  # after it
          engine_req(4, 9.5)]  # not admitted yet
    match = reader("engine.prefix_match_ms")
    assert match(make_run(rs)) == pytest.approx(7.0)
    assert match(make_run(rs[2:])) is None
    assert match(make_run([RequestRecord(5, [1], 4, 1.0)])) is None


def test_engine_times_read_in_a_cpu_run(tiny):
    tiny.add_config(tiny_config(moe=False))
    tiny.add_traffic("tinyprefix", tiny_traffic(prefix=True))
    cell = tiny.add_cell("tiny-dense", "tinyprefix")
    tiny.list_like(cell, "mistral-7b-bf16.shared_prefix")  # an Engine cell: its engine metrics read here
    result, _ = run_cell(tiny.bench, cell, 2**31 + 7, 1.5, True, time.perf_counter(), root=tiny.root,
                         device="cpu", num_blocks=256)
    m = result["metrics"]
    assert m["engine.queue_wait_p95_ms"]["value"] >= 0 and m["engine.queue_wait_p95_ms"]["unit"] == "ms"
    assert m["engine.prefix_match_ms"]["value"] > 0
    assert result["correct"], result["check"]
