#!/usr/bin/env python3
"""Meshes over distinct CUDA cards, held to the same meshes of virtual ranks.

Run from the root of a checkout on a machine with 2 or more cards:
``python3 scripts/distinct_devices.py`` (``--cpu N`` rehearses the same
checks on N CPU ranks, where every "card" is the CPU). Prints one JSON line
a check and exits non-zero if one fails (at once where a collective is not
bit-equal, after every serving case otherwise):

* the fused all-reduce + RMSNorm on ``make_mesh(tp=n)`` over every card (the
  per-device form, each launch reading its peers' partials over peer
  memory), both schedules and epilogues, bit-equal to the plain version;
* its eager wall time a call at slice_full_tp's decode shape (8 x 4096 a
  rank), host included;
* ``ShardedEngine`` on ``tiny_config`` over a rank a card (``make_mesh(tp=n)``,
  ``make_hybrid_mesh(2, n // 2)``) and a tp group a card
  (``make_hybrid_mesh(2, 2)`` over two cards), eager and ``multi_step=4``
  (the captured graph spanning the cards), greedy and at temperature 0.8:
  tokens equal to the same mesh of virtual ranks on card 0;
* ring attention over 2 and n cards (the K/V exchange copies a neighbour's
  blocks onto the receiver's card) against causal SDPA in float32.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hpc_ops_tpu_torch.models import llama  # noqa: E402
from hpc_ops_tpu_torch.parallel import make_mesh  # noqa: E402
from hpc_ops_tpu_torch.parallel.collective_kernels import _allreduce_rmsnorm_ref, collective_rmsnorm  # noqa: E402
from hpc_ops_tpu_torch.parallel.mesh import make_hybrid_mesh, run_ranks  # noqa: E402
from hpc_ops_tpu_torch.parallel.ring_attention import ring_attention  # noqa: E402
from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def sync(cards):
    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def main() -> int:
    if "--cpu" in sys.argv:
        n = int(sys.argv[sys.argv.index("--cpu") + 1])
        cards = [torch.device("cpu")] * n
    else:
        n = torch.cuda.device_count()
        if n < 2:
            print(f"distinct_devices.py: needs 2 CUDA cards, this machine has {n}", file=sys.stderr)
            return 1
        cards = [torch.device("cuda", i) for i in range(n)]
        emit(cards=n, names=[torch.cuda.get_device_name(i) for i in range(n)],
             peer=[[a == b or torch.cuda.can_device_access_peer(a, b) for b in cards] for a in cards])
    home = cards[0]
    gen = torch.Generator().manual_seed(3)
    xs = [(torch.randn((128, 4096), generator=gen) * 0.5).to(torch.bfloat16) for _ in range(n)]
    res = torch.randn((128, 4096), generator=gen).to(torch.bfloat16)
    w = torch.rand(4096, generator=gen) + 0.5
    mesh = make_mesh(tp=n, devices=cards)
    for mode in ("one_shot", "two_shot"):
        for bf16_norm in (False, True):
            want = _allreduce_rmsnorm_ref(xs, res, w, 1e-5, mode, bf16_norm)
            outs = run_ranks(mesh, lambda g, _: collective_rmsnorm(
                g, xs[g.rank].to(g.device), res.to(g.device), w.to(g.device), 1e-5, mode, bf16_norm))[0]
            sync(cards)
            ok = all(torch.equal(o.cpu(), want[0]) and torch.equal(r.cpu(), want[1]) for o, r in outs)
            emit(collective=mode, bf16_norm=bf16_norm, ranks=n, bit_equal=ok)
            if not ok:
                return 1
    x8 = [torch.randn((8, 4096), generator=gen).to(torch.bfloat16).to(d) for d in cards]
    w8 = [torch.ones(4096, device=d) for d in cards]

    def call(g, _):
        return collective_rmsnorm(g, x8[g.rank], x8[g.rank], w8[g.rank], 1e-5, "one_shot", False)

    for _ in range(5):
        run_ranks(mesh, call)
    sync(cards)
    t0 = time.perf_counter()
    for _ in range(50):
        run_ranks(mesh, call)
    sync(cards)
    emit(eager_collective_ms_per_call=(time.perf_counter() - t0) / 50 * 1e3, ranks=n, tokens=8, hidden=4096)

    cfg = llama.tiny_config()
    weights = llama.init_weights(cfg, torch.Generator(device=home).manual_seed(0), device=home)
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61))]
    cases = {
        f"tp{n}_rank_a_card": (lambda: make_mesh(tp=n, devices=cards),
                               lambda: make_mesh(tp=n, devices=[home] * n)),
        f"hybrid_2x{n // 2}_rank_a_card": (lambda: make_hybrid_mesh(2, n // 2, devices=cards),
                                           lambda: make_hybrid_mesh(2, n // 2, devices=[home] * n)),
        "hybrid_2x2_group_a_card": (lambda: make_hybrid_mesh(2, 2, devices=[cards[0]] * 2 + [cards[1]] * 2),
                                    lambda: make_hybrid_mesh(2, 2, devices=[home] * 4)),
    }
    failed = False
    for name, (over, virtual) in cases.items():
        for ms, temperature in ((1, 0.0), (4, 0.0), (1, 0.8), (4, 0.8)):
            try:
                got, want = (ShardedEngine(cfg, weights, make(), num_blocks=64, block_size=16, max_batch=4,
                                           multi_step=ms, temperature=temperature, seed=5).run(prompts, max_new=12)
                             for make in (over, virtual))
                emit(case=name, multi_step=ms, temperature=temperature, equal=got == want)
                failed |= got != want
            except Exception as e:  # noqa: BLE001 - every case is reported, the run fails below
                emit(case=name, multi_step=ms, temperature=temperature, error=repr(e)[:500])
                failed = True

    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((1, 4 * 256, 8, 64), generator=g) for _ in range(3))
    want = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True).transpose(1, 2)
    for ws in sorted({2, n}):
        m = make_mesh(tp=ws, devices=cards[:ws])
        shards = [t.chunk(ws, dim=1) for t in (q, k, v)]
        outs = run_ranks(m, lambda grp, _: ring_attention(*(s[grp.rank].to(grp.device) for s in shards), grp,
                                                         causal=True))[0]
        err = float((torch.cat([o.cpu() for o in outs], dim=1) - want).abs().max())
        emit(ring_attention_ranks=ws, max_err=err)
        failed |= not err < 2e-4
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
