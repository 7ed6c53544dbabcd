"""One run of one cell: set-up, a closed-loop window on the engine, the
metrics, and the comparison that decides ``correct``.

Every piece is found by name: the configuration's file from
``BENCHMARK.json``, its reference module ``reference/<reference>.py``, the
traffic mix ``traffic/<name>.json`` and each metric's reader
``metrics/<name>.py`` (a ``read(run)`` that returns a number, or None when
it finds nothing to read).

The loop is closed: a client sends its next request as soon as the last
one finishes, at the end of the engine step that finished it. Steps end in
a device-to-host copy of their tokens, so the host clock after
``Engine.step()`` is the time the tokens reached the client. Set-up ends
once as many requests have finished as there are clients; the window then
runs ``seconds`` of steps. The order of steps and requests depends on the
seed alone, not on timing.
"""

from __future__ import annotations

import faulthandler
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

import torch

from servebench import check, generator
from servebench.peaks import peaks_of
from servebench.trace import CLIENTS, STEP, Profiler

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "hpc_ops_tpu")


@dataclass
class RequestRecord:
    index: int  # position in the request stream
    prompt: list
    max_new: int
    t_send: float
    req: object = None  # the engine's Request
    t_first: float | None = None
    t_done: float | None = None
    n_out: int = 0
    failed: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def out(self) -> list:
        return self.req.out if self.req is not None else []


@dataclass
class StepRecord:
    t0: float
    t1: float
    kind: str  # "prefill" or "decode"
    tokens: int  # output tokens the step delivered
    rows: int = 0  # prefill: new prompt rows run
    offset: int = 0  # prefill: tokens already in the cache before those rows
    shared: int = 0  # prefill: prompt tokens a prefix hit shared in this step
    admitted: int = 0  # prefill: prompt tokens of a request whose first prefill this was
    ctxs: list = field(default_factory=list)  # decode: each live request's length at dispatch


class ClosedLoop:
    """Clients over one engine, each with at most one request in flight."""

    def __init__(self, eng, stream: generator.Stream, clients: int):
        self.eng, self.stream = eng, stream
        self.live: list = [None] * clients
        self.requests: list = []
        self.steps: list = []
        self.completions = 0
        self.profiler = None  # set while a slice is traced

    def _send(self, c: int, spec, t: float) -> None:
        while True:
            rec = RequestRecord(spec.index, spec.prompt, spec.max_new, t)
            self.requests.append(rec)
            try:
                rid = self.eng.add_request(spec.prompt, max_new=spec.max_new)
            except ValueError:
                rec.failed, rec.t_done = True, t
                spec = self.stream.next_request()
                continue
            rec.req = self.eng.requests[rid]
            self.live[c] = rec
            return

    def start(self, t: float) -> None:
        for c, spec in enumerate(self.stream.first_requests()):
            self._send(c, spec, t)

    def step(self) -> None:
        before = [(r, len(r.req.out), r.req.prefilled, r.req.done) for r in self.live]
        shared0 = getattr(self.eng, "prefix_shared_blocks", 0)  # 0 where the engine has no prefix cache
        t0 = time.perf_counter()
        if self.profiler is not None:
            with self.profiler.range(STEP):
                progressed = self.eng.step()
        else:
            progressed = self.eng.step()
        t1 = time.perf_counter()
        if not progressed:
            raise RuntimeError("the engine found no work with every client waiting")
        shared = (getattr(self.eng, "prefix_shared_blocks", 0) - shared0) * self.eng.block_size
        tokens = sum(len(r.req.out) - n for r, n, _, _ in before)
        grown = [(r, p) for r, _, p, _ in before if r.req.prefilled > p]
        if grown:
            r, p = grown[0]
            rows = r.req.prefilled - p - shared
            st = StepRecord(t0, t1, "prefill", tokens, rows=rows, offset=p + shared, shared=shared,
                            admitted=r.prompt_len if p == 0 else 0)
        else:
            ctxs = [r.prompt_len + n for r, n, _, done in before if n > 0 and not done]
            st = StepRecord(t0, t1, "decode", tokens, ctxs=ctxs)
        self.steps.append(st)
        if self.profiler is not None:
            with self.profiler.range(CLIENTS):
                self._collect(t1)
        else:
            self._collect(t1)

    def _collect(self, t: float) -> None:
        for c, r in enumerate(self.live):
            n = len(r.req.out)
            if n and r.t_first is None:
                r.t_first = t
            r.n_out = n
            if r.req.done:
                r.t_done = t
                r.failed = n < r.max_new
                self.completions += 1
                self._send(c, self.stream.next_request(), t)


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def in_window(self, t: float) -> bool:
        return self.t_start < t <= self.t_end

    def window_steps(self, kind: str | None = None) -> list:
        return [s for s in self.steps if self.in_window(s.t1) and (kind is None or s.kind == kind)]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = HERE):
    """The ``read`` of ``metrics/<name>.py``."""
    return _module(os.path.join(root, "metrics", name + ".py"), "servebench_metric_" + name.replace(".", "_")).read


def reference(name: str, root: str = HERE):
    return _module(os.path.join(root, "reference", name + ".py"), "servebench_reference_" + name)


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: end-to-end with
    ``trace`` 0, per-layer with ``trace`` 1."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def model_config(model: dict):
    """The port's ModelConfig from a configuration's ``model`` block."""
    from hpc_ops_tpu_torch.models.llama import ModelConfig, MoEConfig

    kw = dict(model)
    moe = kw.pop("moe", None)
    return ModelConfig(**kw, moe=MoEConfig(**moe) if moe else None)


def cache_block_bytes(eng, num_blocks: int) -> int:
    """Bytes a KV block takes in ``eng``'s caches, whatever their layout and
    type (bf16 or e4m3 K and V, an int8 slab)."""
    return sum(t.numel() * t.element_size() for c in eng.caches for t in c.values()) // num_blocks


def size_pool(eng_cls, mc, weights, mix: dict, device, max_blocks: int) -> int:
    """KV blocks that fill the card's memory left after the weights and the
    activation peak of the mix's largest prefill (one run of it on a small
    pool, which also builds and warms the prefill path). A fixed 2 GiB and a
    quarter of that peak stay free for the decode graph's pool, cuBLAS and
    fragmentation. A block's bytes are those of the probe's own caches."""
    e = mix["engine"]
    rows = e.get("prefill_chunk") or generator.longest_request(mix) - mix["output"]["max"]
    bs = e["block_size"]
    probe = eng_cls(mc, weights, num_blocks=max_blocks + 2, block_size=bs, max_batch=1,
                    max_blocks_per_seq=max_blocks, prefill_chunk=e.get("prefill_chunk"), device=device)
    block_bytes = cache_block_bytes(probe, max_blocks + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    probe.run([[1] * rows], max_new=1)
    torch.cuda.synchronize()
    act = torch.cuda.max_memory_allocated() - base
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    reserve = 2 * 2**30 + int(1.25 * act)
    return max(int((free - reserve) // block_bytes), max_blocks + 2)


# What a multi-card run may take after its kernel build before it exits
# non-zero (:func:`watchdog_s`), from the tp-4 cell on four H100 80GB
SETUP_ALLOWANCE_S = 180  # weights, pool, capture and warm-up: 103-126 s warm
REFERENCE_ALLOWANCE_S = 90  # one pass of the reference over the sample: 17-26 s
TRACE_ALLOWANCE_S = 60  # the slice's last step and reading the trace: about 12 s


def watchdog_s(seconds: float, trace: bool, control: bool) -> float:
    """Seconds a multi-card run may last after its kernel build: set-up,
    the window of ``seconds``, the trace's reading with ``trace`` and the
    reference's passes, two with ``control``."""
    return (SETUP_ALLOWANCE_S + seconds + (TRACE_ALLOWANCE_S if trace else 0)
            + REFERENCE_ALLOWANCE_S * (2 if control else 1))


def make_cell_mesh(cfg: dict, cell: dict, dev):
    """The mesh of a configuration's ``mesh`` block (``tp`` and ``dp``) over
    the cell's ``chips``: a rank a card, cards 0 to chips - 1 (or as many
    CPU ranks, in the tests)."""
    from hpc_ops_tpu_torch.parallel.mesh import make_mesh

    tp, dp = int(cfg["mesh"]["tp"]), int(cfg["mesh"].get("dp", 1))
    if tp * dp != int(cell["chips"]):
        raise ValueError(f"{cell['name']}: chips {cell['chips']} is not the mesh's tp x dp = {tp * dp}")
    if dp != 1:
        raise ValueError("the closed loop records one prefill a step: a mesh with dp > 1 is not measured yet")
    devices = [torch.device("cuda", i) for i in range(tp)] if dev.type == "cuda" else [dev] * tp
    return make_mesh(tp=tp, dp=dp, devices=devices)


def mesh_cards(mesh) -> list:
    """The distinct devices of ``mesh``'s ranks, in index order."""
    return sorted(set(mesh.grid.flat), key=lambda d: d.index or 0)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def size_sharded_pool(mc, weights, mix: dict, mesh, max_blocks: int) -> int:
    """KV blocks a row shard for :class:`ShardedEngine`, with no second copy
    of the weights on any card. A probe engine of ONE layer at the
    configuration's widths, over the same mesh, gives each card's bytes of
    a layer's weight shares, of the leaves outside the layers (those the
    harness does not hold already), of a KV block of one layer, and the
    activation peak of the mix's largest prefill (which also warms the
    prefill path). Each card's free memory, once the probe is gone, less
    its share of the whole model's weights and the one-card reserve (2 GiB
    and a quarter over that peak), over a block's bytes: the least over the
    cards, so that the fullest card fills as a one-card cell does."""
    from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine

    e = mix["engine"]
    rows = e.get("prefill_chunk") or generator.longest_request(mix) - mix["output"]["max"]
    cards = mesh_cards(mesh)
    held = {t.data_ptr() for t in weights.values() if isinstance(t, torch.Tensor)}
    n = max_blocks + 2
    probe = ShardedEngine(mc._replace(layers=1), {**weights, "layers": [weights["layers"][0]]}, mesh,
                          num_blocks=n, block_size=e["block_size"], max_batch=1, max_blocks_per_seq=max_blocks,
                          prefill_chunk=e.get("prefill_chunk"))
    layer_b, rest_b, block_b = {}, {}, {}
    for r, card in enumerate(mesh.grid[0]):  # dp 1: one row shard, a rank a card
        rw = probe.weights[r]
        layer_b[card] = _nbytes(rw["layers"][0].values())
        rest_b[card] = _nbytes(t for k, t in rw.items() if k != "layers" and t.data_ptr() not in held)
        block_b[card] = _nbytes(probe.caches[0][r][0].values()) // n
    base = {}
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
        base[c] = torch.cuda.memory_allocated(c)
    probe.run([[1] * rows], max_new=1)
    act = {}
    for c in cards:
        torch.cuda.synchronize(c)
        act[c] = torch.cuda.max_memory_allocated(c) - base[c]
    del probe
    gc.collect()
    blocks = []
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info(c)
        need = rest_b[c] + mc.layers * layer_b[c] + 2 * 2**30 + int(1.25 * act[c])
        blocks.append((free - need) // (mc.layers * block_b[c]))
        log(f"{c}: free {free / 2**30:.2f} GiB, weights {(rest_b[c] + mc.layers * layer_b[c]) / 2**30:.2f} GiB "
            f"({layer_b[c] / 2**20:.1f} MiB a layer), prefill peak {act[c] / 2**30:.2f} GiB, "
            f"{mc.layers * block_b[c]} bytes a KV block: {blocks[-1]} blocks")
    return max(int(min(blocks)), max_blocks + 2)


def build_sharded(cfg: dict, cell: dict, mc, ref, weights, mix: dict, dev, max_blocks: int,
                  num_blocks: int | None) -> tuple:
    """(engine, mesh, KV blocks) of a configuration with ``mesh``: the port's
    ShardedEngine over the cell's cards, its pool sized by
    :func:`size_sharded_pool`, the weights handed over as the reference's
    ``for_sharding`` gives them. ShardedEngine keeps no prefix cache: a mix
    that shares prefixes is refused."""
    from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine

    e = mix["engine"]
    if mix.get("shared_prefix"):
        raise ValueError(f"{cell['name']}: ShardedEngine has no prefix cache, so a mix with shared_prefix "
                         "would measure none")
    if e.get("prefix_cache"):
        log("ShardedEngine has no prefix cache: built without one")
    mesh = make_cell_mesh(cfg, cell, dev)
    eng_w = ref.for_sharding(weights)
    cuda = dev.type == "cuda"
    if num_blocks is None:
        num_blocks = size_sharded_pool(mc, eng_w, mix, mesh, max_blocks)
    cards = mesh_cards(mesh)
    if cuda:
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
    eng = ShardedEngine(mc, eng_w, mesh, num_blocks=num_blocks, block_size=e["block_size"],
                        max_batch=int(mix["clients"]), max_blocks_per_seq=max_blocks,
                        prefill_chunk=e.get("prefill_chunk"), multi_step=e["multi_step"])
    if cuda:
        for c in cards:
            log(f"{c}: weights and pool placed: {torch.cuda.memory_allocated(c) / 2**30:.2f} GiB allocated, "
                f"peak while placing {torch.cuda.max_memory_allocated(c) / 2**30:.2f} GiB")
    return eng, mesh, num_blocks


def cell_config(bench: dict, cell_name: str, root: str = HERE) -> tuple:
    """(the cell's entry, its configuration's file as a dict)."""
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, load_json(os.path.join(os.path.dirname(root), cfg_entry["file"]))


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, t_process: float,
             root: str = HERE, device: str = "cuda", num_blocks: int | None = None,
             control: bool = False) -> tuple:
    """One run. Returns (result line as a dict, lines of numbers beside
    their limits). ``num_blocks`` fixes the KV pool (the CPU tests); on a
    card the pool is sized by :func:`size_pool`. ``control`` also reads the
    control's numbers on the same sample (under ``"control"``) and judges
    them under the configuration's limits (``"control_correct"``, which a
    sound comparison reads false).

    A configuration with ``mesh`` runs on the port's ShardedEngine over
    the cell's ``chips`` (:func:`build_sharded`): the memory peak
    is the fullest card's, the trace keeps each event's card, and on the
    cards the run exits non-zero if it has not ended :func:`watchdog_s`
    after the kernel build, so a rank that fails never leaves it hanging."""
    from hpc_ops_tpu_torch import kernels

    args = (bench, cell_name, seed, seconds, trace, t_process, root, device, num_blocks, control)
    if torch.device(device).type != "cuda":
        return _run_cell(*args)
    kernels.lib()  # the kernel build (cached in the checkout's build/)
    if not cell_config(bench, cell_name, root)[1].get("mesh"):
        return _run_cell(*args)
    faulthandler.dump_traceback_later(watchdog_s(seconds, trace, control), exit=True)
    try:
        return _run_cell(*args)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, t_process: float,
              root: str, device: str, num_blocks: int | None, control: bool) -> tuple:
    from hpc_ops_tpu_torch.runtime.engine import Engine

    cell, cfg = cell_config(bench, cell_name, root)
    mix = generator.load_traffic(cell["traffic"], root)
    model = cfg["model"]
    ref = reference(cfg["reference"], root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    e = mix["engine"]
    clients = int(mix["clients"])
    if e["max_batch"] != clients:
        raise ValueError("a closed loop runs as many clients as the engine's max_batch")
    bs, ms = e["block_size"], e["multi_step"]
    max_blocks = math.ceil((generator.longest_request(mix) + ms) / bs) + 1

    sharded = bool(cfg.get("mesh"))
    weights = ref.make_weights(model, seed, dev)
    mc = model_config(model)
    if sharded:
        eng, mesh, num_blocks = build_sharded(cfg, cell, mc, ref, weights, mix, dev, max_blocks, num_blocks)
        cards = mesh_cards(mesh)
    else:
        if num_blocks is None:
            num_blocks = size_pool(Engine, mc, weights, mix, dev, max_blocks)
        eng = Engine(mc, weights, num_blocks=num_blocks, block_size=bs, max_batch=clients,
                     max_blocks_per_seq=max_blocks, prefill_chunk=e.get("prefill_chunk"),
                     multi_step=ms, prefix_cache=bool(e.get("prefix_cache")), device=dev)
        cards = [dev]
    log(f"weights and a pool of {num_blocks} KV blocks ready at {time.perf_counter() - t_process:.1f} s")
    loop = ClosedLoop(eng, generator.Stream(mix, seed, model["vocab"]), clients)
    loop.start(time.perf_counter())
    while loop.completions < clients:  # warm-up: the graph captures at the first dispatch
        loop.step()

    log(f"warm-up: {len(loop.steps)} steps, {loop.completions} requests done, set-up "
        f"{time.perf_counter() - t_process:.1f} s")
    slice_s = float(mix["trace_slice_s"])
    prof = (Profiler(torch, cards) if sharded else Profiler(torch)) if trace and cuda else None
    if prof is not None:
        prof.warm()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    slice_from = slice_at = None  # the slice: its first step's index, its start time
    while True:
        now = time.perf_counter()
        if prof is not None and slice_from is None and now >= t_end - slice_s:
            prof.start()
            loop.profiler, slice_from, slice_at = prof, len(loop.steps), time.perf_counter()
        slice_open = slice_at is not None and loop.profiler is not None and now - slice_at < slice_s
        if now >= t_end and not slice_open:
            break
        loop.step()
    tr = None
    if prof is not None:
        loop.profiler = None
        t = time.perf_counter()
        tr = prof.stop([s.kind for s in loop.steps[slice_from:]])
        tr.steps = loop.steps[slice_from:]
        log(f"trace: {len(tr.steps)} steps, {len(tr.device)} device events, read in "
            f"{time.perf_counter() - t:.1f} s")
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise ForbiddenModules(found)

    if sharded:  # the fullest card's
        peak = max(torch.cuda.max_memory_allocated(c) for c in cards) if cuda else 0
    else:
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(cards[0] if sharded else dev) if cuda else "cpu"
    chips = int(cell["chips"])
    run = Run(seconds=seconds, setup_s=t_start - t_process, t_start=t_start, t_end=t_end,
              steps=loop.steps, requests=loop.requests, slice=tr, memory_peak_bytes=peak,
              model=model, mix=mix, block_size=bs, max_batch=clients, multi_step=ms,
              device_name=kind, peaks=peaks_of(kind) if cuda else None, chips=chips,
              tp=int(cfg["mesh"]["tp"]) if sharded else 1)
    metrics = {}
    for m in metrics_for(bench, cell_name, trace):
        v = reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    sent = [r for r in loop.requests if run.in_window(r.t_send)]
    failed = sum(r.failed for r in sent)
    picked = check.sample(loop.requests, t_start, t_end, seed, int(mix["sample_tokens"]),
                          int(mix["sample_requests"]))
    served = [list(r.out) for r in picked]
    seqs, rows = check.reference_inputs(picked)
    # the program's state goes before the reference runs: the peak is read
    loop_steps = loop.steps
    del eng, loop, run, picked
    gc.collect()
    if cuda and sharded:
        for c in cards:  # every card of the mesh
            with torch.cuda.device(c):
                torch.cuda.empty_cache()
    elif cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_logits = ref.logits(weights, model, seqs, rows)
    log(f"window: {sum(1 for x in loop_steps if t_start < x.t1 <= t_end)} steps, {len(sent)} requests sent; "
        f"reference over {len(seqs)} requests, {sum(map(len, seqs))} tokens, in {time.perf_counter() - t:.1f} s")
    read = check.readings(check.gaps(ref_logits, served))
    log("read: " + ", ".join(f"{k} {v}" for k, v in read.items()))
    correct, table = check.judge(read, cfg["check"])
    result = {
        "correct": bool(correct and failed == 0),
        "attempted": len(sent),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.wall_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    if control:  # the control judged as the program is, under the same limits
        ctl = ref.logits(weights, model, seqs, rows, precision="control")
        firsts = [lg.argmax(dim=-1).tolist() for lg in ctl]
        ctl_read = check.readings(check.gaps(ref_logits, firsts))
        result["control"] = ctl_read
        result["control_correct"], result["control_check"] = check.judge(ctl_read, cfg["check"])
    result["check"] = table
    lines = [f"{k} {v['value']} limit {v['limit']}" for k, v in table.items()]
    return result, lines


def log(msg: str) -> None:
    print("servebench: " + msg, file=sys.stderr, flush=True)


class ForbiddenModules(RuntimeError):
    """The JAX stack or the JAX package was loaded in the measuring process."""
