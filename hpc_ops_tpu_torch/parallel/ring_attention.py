"""Ring attention: sequence-parallel exact attention over a ring of ranks (port
of ``parallel/ring_attention.py``).

The sequence is sharded over the ranks of a group; each rank holds its q, k
and v shard. Exact (optionally causal) attention is computed by rotating the
K/V blocks around the ring, rank i sending to rank i + 1, while each rank
accumulates a float32 online softmax, so no rank holds more than its own
K/V shard and the one block in flight. The JAX version is plain jnp under
``shard_map`` with ``ppermute``; here ``axis_name`` is the rank's
:class:`~hpc_ops_tpu_torch.parallel.mesh.RankGroup` (call it once per rank,
under :func:`~hpc_ops_tpu_torch.parallel.mesh.run_ranks`), and a ``ppermute``
is an exchange of the ranks' K/V tensors at the group's rendezvous. On a
card a rank receives its neighbour's tensors themselves where both lie on
one device (virtual ranks), its stream ordered after the sender's, and
nothing is copied; from a neighbour on another device it receives a copy
on its own device.

Semantics: dense attention over the full sequence. With ``causal=True``
query row g attends to key rows <= g in global positions (shard r's rows are
offset by r x the shard's length). Local shapes q [B, S_loc, Hq, D], k/v
[B, S_loc, Hkv, D(v)], GQA by Hq = G x Hkv; returns the local output shard
[B, S_loc, Hq, Dv] in q's dtype (float32 sums).

``schedule="ring"`` computes every (q shard, K/V block) pair and masks;
``"zigzag"`` (causal only) takes inputs laid out by :func:`zigzag_layout`
(shard i holds global blocks i and 2p-1-i) and computes only the causally
live block pairs, equal work on every rank.
"""

from __future__ import annotations

import torch

__all__ = ["ring_attention", "zigzag_layout", "zigzag_unlayout"]

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _order(p: int) -> list:
    return [b for i in range(p) for b in (i, 2 * p - 1 - i)]


def zigzag_layout(x: torch.Tensor, p: int, axis: int = 1) -> torch.Tensor:
    """Reorder a global sequence axis into zigzag sharding order: the
    sequence is split into 2p blocks and shard i owns blocks (i, 2p-1-i),
    an early and a late block, which balances causal work across the ring.
    Shard the result over the ranks; invert outputs with
    :func:`zigzag_unlayout`."""
    s = x.shape[axis]
    if s % (2 * p):
        raise ValueError(f"seq {s} must divide into 2p={2 * p} blocks")
    blocks = torch.chunk(x, 2 * p, dim=axis)
    return torch.cat([blocks[b] for b in _order(p)], dim=axis)


def zigzag_unlayout(x: torch.Tensor, p: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`zigzag_layout`."""
    order = _order(p)
    blocks = torch.chunk(x, 2 * p, dim=axis)
    return torch.cat([blocks[order.index(b)] for b in range(2 * p)], dim=axis)


def _ppermute_action(rendezvous, slots):
    """Runs in the last rank to arrive: rank r receives rank r-1's payload.
    On a card this thread's stream waits on every sender's arrival event and
    records the event that every receiver's stream then waits on. A sender
    on another device than its receiver has its tensors copied onto the
    receiver's device, on the sender's stream with the receiver's waiting
    on the copy (torch's two-way barrier of a copy between devices)."""
    p = len(slots)
    got = [slots[(r - 1) % p].payload for r in range(p)]
    if slots[0].event is None:
        return (), got
    stream = torch.cuda.current_stream()
    for s in slots:
        stream.wait_event(s.event)
    done = torch.cuda.Event()
    done.record(stream)
    for r, dev in enumerate(rendezvous.devices):
        src = slots[(r - 1) % p]
        if any(t.device != dev for t in src.payload):
            with torch.cuda.stream(slots[r].stream), torch.cuda.stream(src.stream):
                got[r] = tuple(t.to(dev) for t in src.payload)
            for t in got[r]:  # written on the sender's stream: its allocator must know
                t.record_stream(src.stream)
    return (done,), got


def _rotate(group, kv: tuple) -> tuple:
    """``ppermute`` of ``kv`` to rank (i + 1) % p: returns rank i - 1's (a
    copy on this rank's device where the sender's lies on another)."""
    got = group.exchange(tuple(kv), _ppermute_action)
    if group.stream is not None:
        for t in got:  # the sender's allocator must not reuse it while this stream reads
            t.record_stream(group.stream)
    return got


def _heads_major(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> float32 [B, H, S, D]."""
    return x.float().permute(0, 2, 1, 3)


def _block(qh, kf, vf, mask):
    """(m, l, o) of queries ``qh`` [B, Hkv, G, Sq, D] (scaled) against one
    K/V block [B, Hkv, Sk, D]; masked entries (``mask`` [Sq, Sk], True =
    kept) contribute nothing, so a fully masked row has l = o = 0."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kf)
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    return m, e.sum(dim=-1, keepdim=True), torch.einsum("bhgqk,bhkd->bhgqd", e, vf)


def _merge(acc, blk):
    m_a, l_a, o_a = acc
    m_b, l_b, o_b = blk
    m_n = torch.maximum(m_a, m_b)
    a_a, a_b = torch.exp(m_a - m_n), torch.exp(m_b - m_n)
    return m_n, l_a * a_a + l_b * a_b, o_a * a_a + o_b * a_b


def _init(like, dv):
    m0 = torch.full_like(like[..., :1], _NEG_INF)
    return m0, torch.zeros_like(m0), torch.zeros(like.shape[:-1] + (dv,), dtype=torch.float32,
                                                  device=like.device)


def _normalise(acc) -> torch.Tensor:
    _, l_f, o_f = acc
    return o_f / torch.clamp(l_f, min=1e-38)


def _unfold(out, dtype) -> torch.Tensor:
    """[B, Hkv, G, S, Dv] float32 -> [B, S, Hkv * G, Dv] in ``dtype``."""
    b, hkv, g, s, dv = out.shape
    return out.reshape(b, hkv * g, s, dv).transpose(1, 2).to(dtype)


def ring_attention(
    q: torch.Tensor,  # [B, S_loc, Hq, D] (local shard)
    k: torch.Tensor,  # [B, S_loc, Hkv, D]
    v: torch.Tensor,  # [B, S_loc, Hkv, Dv]
    axis_name,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
    schedule: str = "ring",
) -> torch.Tensor:
    """Exact sequence-parallel attention (see the module docstring), called
    by every rank of the group ``axis_name`` with its own shards.

    ``schedule="zigzag"`` (causal only) expects inputs laid out by
    :func:`zigzag_layout`: each rank computes 2 live block pairs a ring step
    (3 on its own blocks) instead of the ring schedule's 4."""
    if not hasattr(axis_name, "exchange"):
        raise TypeError(f"axis_name must be a RankGroup (run the rank under run_ranks), "
                        f"got {axis_name!r}")
    b, s_loc, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = (1.0 / d**0.5) if sm_scale is None else sm_scale
    p, my = axis_name.size, axis_name.rank
    # fold GQA into the heads: [B, Hkv, G, S_loc, D], scaled in float32
    qf = _heads_major(q).reshape(b, hkv, group, s_loc, d) * scale
    dv = v.shape[-1]
    if schedule == "zigzag":
        if not causal:
            raise ValueError("zigzag scheduling is a causal-balancing layout")
        return _ring_zigzag(qf, k, v, axis_name, p, my, q.dtype)
    if schedule != "ring":
        raise ValueError(f"unknown schedule {schedule!r}")
    pos = torch.arange(s_loc, device=q.device)

    def local_block(kv, src):
        """Attend qf against the K/V block that came from rank ``src``."""
        mask = (src * s_loc + pos)[None, :] <= (my * s_loc + pos)[:, None] if causal else None
        return _block(qf, _heads_major(kv[0]), _heads_major(kv[1]), mask)

    kv = (k, v)
    acc = _merge(_init(qf, dv), local_block(kv, my))  # step 0: the local block
    # rotate first, steps 1..p-1: p-1 rotations, none discarded after the last
    for i in range(1, p):
        kv = _rotate(axis_name, kv)
        acc = _merge(acc, local_block(kv, (my - i) % p))
    return _unfold(_normalise(acc), q.dtype)


def _ring_zigzag(qf, k, v, group, p, my, dtype):
    """Causal ring attention over the zigzag layout: each rank's local
    sequence is [block my | block 2p-1-my]; a ring step computes only the
    block pairs the causal structure makes live."""
    s_loc, dv = qf.shape[3], v.shape[-1]
    blk = s_loc // 2
    q_lo, q_hi = qf[..., :blk, :], qf[..., blk:, :]
    ar = torch.arange(blk, device=qf.device)
    tri = ar[None, :] <= ar[:, None]  # [q, k] causal triangle of one block
    mix = torch.cat([torch.ones((blk, blk), dtype=torch.bool, device=qf.device), tri], dim=1)

    def compute(kv, src, acc_lo, acc_hi):
        kf, vf = _heads_major(kv[0]), _heads_major(kv[1])
        k_lo, v_lo = kf[..., :blk, :], vf[..., :blk, :]
        if src < my:  # q_lo and q_hi attend all of the early block
            lo, hi = _block(q_lo, k_lo, v_lo, None), _block(q_hi, k_lo, v_lo, None)
        elif src == my:  # the diagonals, and q_hi over its earlier half
            lo, hi = _block(q_lo, k_lo, v_lo, tri), _block(q_hi, kf, vf, mix)
        else:  # q_lo attends nothing, q_hi both blocks
            return acc_lo, _merge(acc_hi, _block(q_hi, kf, vf, None))
        return _merge(acc_lo, lo), _merge(acc_hi, hi)

    kv = (k, v)
    acc_lo, acc_hi = compute(kv, my, _init(q_lo, dv), _init(q_hi, dv))
    for i in range(1, p):
        kv = _rotate(group, kv)
        acc_lo, acc_hi = compute(kv, (my - i) % p, acc_lo, acc_hi)
    return _unfold(torch.cat([_normalise(acc_lo), _normalise(acc_hi)], dim=-2), dtype)
