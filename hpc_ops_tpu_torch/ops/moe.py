"""Fused MoE: routing + grouped GEMMs + act-quant + top-k reduce (port of
``ops/moe.py``, the per-tensor fp8 and int8 pipelines).

EP semantics: routing ids are global; local experts are
[rank_ep*E_local, (rank_ep+1)*E_local); off-rank tokens are dropped locally
(topk_pos = -1 -> no contribution in reduce).

The scatter pipeline (``impl="auto"`` or ``"scatter"``): routing sorts the
(token, k) pairs by local expert and gives each expert's pairs m-tile-aligned
slots, building only an index vector; both grouped GEMMs fetch their rows by
index inside the kernel (``ops/group_gemm.py:gg_scatter``), so no
expert-grouped copy of the tokens exists in memory; ``act_quant`` sits
between them and :func:`reduce` gathers each token's k expert rows (a gather,
not a scatter-add: no atomics). With int8 weights and
``gate_up_interleaved=True`` (the int8 serving path) the gate-up GEMM writes
the activation's int8 codes from its own accumulators (``act_fuse``) into the
tile-aligned layout, and the down GEMM reads them by whole row blocks
(``gg_pertensor``): no bf16 intermediate, no activation launch, no row
gather. The routing is plain tensor code, as it is plain jnp in the JAX
package, and never brings a count to the host: the number of tiles that hold
real rows reaches the kernels as a device scalar.

``impl="gather"`` copies the tokens into the expert-grouped aligned layout
and runs both GEMMs as ``gg_pertensor``; ``impl="ref"`` is the plain float32
pipeline over that copy.

The blockwise pipelines (``fuse_moe_blockwise_fp8`` / ``_int8``: x scales per
(token, 128-group), weight scales per 128 x 128 block) route the same way.
``scheme="scatter"`` (the default) runs the gate-up GEMM as
``gg_bw_scatter`` over the routed token rows and the down GEMM as
``gg_bw_aligned`` over the gate-up output's own slots; the other schemes copy
the tokens and their scales into the aligned layout and run both GEMMs as
``gg_bw_aligned``. Between the GEMMs sits plain tensor code, as in the JAX
package: silu(gate) * up in float32, then a per-(row, 128-group)
re-quantisation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import FP8_DTYPE
from hpc_ops_tpu_torch.ops.activation import act_mul_and_quant
from hpc_ops_tpu_torch.ops.group_gemm import (
    BLOCKWISE_SCHEMES,
    _cu,
    _dot,
    _flat_tiles,
    _pick_tm,
    _take,
    _tile_groups,
    act_pair,
    cdiv_dyn,
    gg_bw_aligned,
    gg_bw_scatter,
    gg_pertensor,
    gg_scatter,
)
from hpc_ops_tpu_torch.ops.quant import blockwise_fp8_quant, blockwise_int8_quant
from hpc_ops_tpu_torch.utils.common import cdiv


class GatherResult(NamedTuple):
    x_gathered: torch.Tensor  # [rows_pad, H] expert-grouped (tile-aligned rows)
    topk_pos: torch.Tensor  # [S, K] int32 row index (or -1 if dropped)
    seqlens: torch.Tensor  # [E] tokens per local expert
    cu_seqlens: torch.Tensor  # [E+1]
    tiles: torch.Tensor  # [E] m-tiles per expert
    cu_tiles: torch.Tensor  # [E+1]
    grp: torch.Tensor  # flat-tile -> expert
    row_blk: torch.Tensor  # flat-tile -> row block
    new_row_valid: torch.Tensor  # [S*K] bool


class _Sorted(NamedTuple):
    """(token, k) pairs sorted by local expert; dropped pairs sort last."""

    valid: torch.Tensor  # [S*K] bool, pair routed to a local expert
    order: torch.Tensor  # [S*K] int64 sorted position -> flat pair
    expert: torch.Tensor  # [S*K] int64 local expert per sorted position (E: dropped)
    local: torch.Tensor  # [S*K] bool per sorted position: not dropped
    seqlens: torch.Tensor  # [E] int32
    cu: torch.Tensor  # [E+1] int32


def _sort_pairs(topk_ids, num_expert: int, rank_ep: int) -> _Sorted:
    flat = topk_ids.reshape(-1).long()
    if rank_ep:
        flat = flat - rank_ep * num_expert
    valid = (flat >= 0) & (flat < num_expert)
    key = torch.where(valid, flat, num_expert)
    order = torch.argsort(key, stable=True)
    # a count per expert without torch.bincount, which reads its size on the host
    counts = torch.zeros((num_expert + 1,), dtype=torch.int32, device=key.device)
    counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    seqlens = counts[:num_expert]
    expert = key[order]
    return _Sorted(valid, order, expert, expert < num_expert, seqlens, _cu(seqlens))


def _aligned_rows(p: _Sorted, num_expert: int, tm: int, dropped_row: int):
    """Tile-aligned row of each sorted position: expert e's j-th pair lands on
    row cu_tiles[e]*tm + j; dropped pairs on ``dropped_row``. Returns
    (aligned [S*K] int64, tiles [E], cu_tiles [E+1])."""
    tiles = cdiv_dyn(p.seqlens, tm)
    cu_tiles = _cu(tiles)
    j = torch.arange(p.order.shape[0], device=p.order.device)
    e_c = p.expert.clamp(max=num_expert - 1)
    aligned = cu_tiles[e_c] * tm + (j - p.cu[e_c])
    return torch.where(p.local, aligned, dropped_row), tiles, cu_tiles


def _topk_pos(p: _Sorted, rows, shape):
    """Row of each (token, k) pair (``rows`` is per sorted position), -1 dropped."""
    inv = torch.argsort(p.order)  # flat pair -> sorted position
    return torch.where(p.valid, rows[inv], -1).to(torch.int32).reshape(shape)


def _gather_aligned(x, topk_ids, num_expert: int, rank_ep: int, tm: int):
    """Sort (token, k) pairs by local expert; place rows tile-aligned."""
    s, k = topk_ids.shape
    p = _sort_pairs(topk_ids, num_expert, rank_ep)
    total_tiles_max = cdiv(s * k, tm) + num_expert
    rows_pad = (total_tiles_max + 1) * tm  # +1 trash tile for dropped pairs
    aligned, tiles, cu_tiles = _aligned_rows(p, num_expert, tm, rows_pad - 1)
    tokens = _take(x, p.order // k)
    xg = torch.zeros((rows_pad, x.shape[1]), dtype=torch.float32, device=x.device)
    xg[aligned] = torch.where(p.local[:, None], tokens.float(), 0.0)
    grp, row_blk, _, _ = _flat_tiles(p.seqlens, tm, total_tiles_max)
    return GatherResult(
        xg.to(x.dtype), _topk_pos(p, aligned, (s, k)), p.seqlens, p.cu, tiles, cu_tiles, grp,
        row_blk, p.valid,
    )


def _route_aligned(topk_ids, num_expert: int, rank_ep: int, tm: int):
    """Routing metadata only, no token materialization. Returns
    (row_idx [num_tiles*tm] int32 source token per aligned slot, -1 empty;
    topk_pos [S, K]; seqlens; cu_seqlens; tiles; cu_tiles; grp [num_tiles])."""
    s, k = topk_ids.shape
    p = _sort_pairs(topk_ids, num_expert, rank_ep)
    num_tiles = cdiv(s * k, tm) + num_expert
    aligned, tiles, cu_tiles = _aligned_rows(p, num_expert, tm, num_tiles * tm)
    row_idx = torch.full((num_tiles * tm + 1,), -1, dtype=torch.int32, device=topk_ids.device)
    row_idx[aligned] = torch.where(p.local, p.order // k, -1).to(torch.int32)
    grp, _ = _tile_groups(cu_tiles, num_tiles)
    return row_idx[:-1], _topk_pos(p, aligned, (s, k)), p.seqlens, p.cu, tiles, cu_tiles, grp


def count_and_gather(
    x,
    topk_ids,
    num_expert: int,
    rank_ep: int,
    intermediate_size: int = 0,
    num_seq_per_group_avg: int = 32,
):
    """Returns the expert-compacted token buffer plus routing metadata:
    (output [S*K, H], topk_pos [S*K] int32 (-1 dropped), seqlens [E],
    cu_seqlens [E+1], tiles [E], cu_tiles [E+1])."""
    del intermediate_size
    k = topk_ids.shape[1]
    p = _sort_pairs(topk_ids, num_expert, rank_ep)
    tiles = cdiv_dyn(p.seqlens, _pick_tm(num_seq_per_group_avg))
    tokens = _take(x, p.order // k)
    xg = torch.where(p.valid[p.order][:, None], tokens.float(), 0.0).to(x.dtype)
    pos = torch.arange(p.order.shape[0], device=x.device)
    return xg, _topk_pos(p, pos, (-1,)), p.seqlens, p.cu, tiles, _cu(tiles)


def moe_reduce_ref(x, topk_pos, topk_scale, shared_output=None):
    """Plain PyTorch version of :func:`moe_reduce` (float32, the slots added
    in order, each dropped by a select)."""
    s, k = topk_pos.shape
    if shared_output is None:
        out = torch.zeros((s, x.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        out = shared_output.float()
    for j in range(k):
        pos = topk_pos[:, j]
        rows = x[pos.clamp(min=0).long()].float()
        w = topk_scale[:, j].float()
        # select, not multiply by 0: rows no valid slot points at may hold NaN
        out = out + torch.where((pos >= 0)[:, None], rows * w[:, None], 0.0)
    return out.to(torch.bfloat16)


REDUCE_THREADS = (256, 128, 64)  # threads a block of the reduce kernel, one 8-column group at a time


class ReduceForm(NamedTuple):
    """A launch of the top-k reduce (csrc/moe.cu): ``chunks`` blocks of
    ``threads`` a token, each walking its chunk's 8-column groups;
    ``blocks`` in the grid."""

    threads: int
    chunks: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def reduce_form(tokens: int, h: int) -> ReduceForm:
    """The reduce kernel's form for ``tokens`` x ``h``. Threads: the largest
    block whose grid, one 8-column group a thread, holds two blocks an SM,
    else the smallest (a decode step), never more than the row's groups
    rounded up to a warp. Chunks: a token's row is split only as far as the
    grid needs two blocks an SM, so a prefill of hundreds of tokens takes one
    block a token that walks its row, and 8 tokens at h 4096 take 8 chunks
    (64 blocks of 64 threads)."""
    groups = cdiv(h, 8)
    for t in REDUCE_THREADS:
        if tokens * cdiv(groups, t) >= 2 * kernels.SMS:
            break
    t = min(t, max(32, cdiv(groups, 32) * 32))
    chunks = max(1, min(cdiv(groups, t), cdiv(2 * kernels.SMS, max(tokens, 1))))
    return ReduceForm(t, chunks, tokens * chunks)


def moe_reduce(
    x: torch.Tensor,  # [rows, H] bf16
    topk_pos: torch.Tensor,  # [S, K] int32, -1 dropped
    topk_scale: torch.Tensor,  # [S, K]
    shared_output=None,  # [S, H] bf16
) -> torch.Tensor:
    """``out[s] = sum_k topk_scale[s,k] * x[topk_pos[s,k]] (+ shared_output[s])``,
    [S, H] bf16. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. Inputs already in the kernel's types, layouts and device
    pass unconverted."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return moe_reduce_ref(x, topk_pos, topk_scale, shared_output)
        raise ValueError(f"moe_reduce: unsupported device {x.device}")
    s, k = topk_pos.shape
    h = x.shape[-1]
    if x.dtype != torch.bfloat16 or x.dim() != 2 or not x.is_contiguous() or h % 8:
        raise ValueError("moe_reduce: x must be contiguous bf16 [rows, H] with H % 8 == 0")
    if topk_scale.shape != topk_pos.shape:
        raise ValueError("moe_reduce: topk_scale must have topk_pos's shape")
    dev = x.get_device()
    pos, sc = topk_pos, topk_scale
    if pos.dtype != torch.int32 or not pos.is_contiguous() or pos.get_device() != dev:
        pos = pos.to(device=x.device, dtype=torch.int32).contiguous()
    if sc.dtype != torch.float32 or not sc.is_contiguous() or sc.get_device() != dev:
        sc = sc.to(device=x.device, dtype=torch.float32).contiguous()
    sh_ptr = None
    if shared_output is not None:
        if shared_output.shape != (s, h) or shared_output.get_device() != dev:
            raise ValueError("moe_reduce: shared_output must be [S, H] on x's device")
        sh = shared_output
        if sh.dtype != torch.bfloat16 or not sh.is_contiguous():
            sh = sh.to(torch.bfloat16).contiguous()
        sh_ptr = sh.data_ptr()
    out = torch.empty((s, h), dtype=torch.bfloat16, device=x.device)
    form = reduce_form(s, h)
    rc = kernels.lib().hpc_moe_reduce(
        x.data_ptr(), pos.data_ptr(), sc.data_ptr(), sh_ptr, out.data_ptr(), s, k, h,
        form.threads, form.chunks, kernels.stream_ptr(x),
    )
    kernels.check(rc, "hpc_moe_reduce")
    kernels.count(moe_reduce)
    return out


moe_reduce.launches = 0


def reduce(x, topk_pos, topk_scale, shared_output=None, impl: str = "auto"):
    """Top-k weighted combine:
    out[s] = sum_k topk_scale[s,k] * x[topk_pos[s,k]] (+ shared_output[s]).
    topk_pos < 0 contributes nothing. Returns [S, H] bf16. ``impl="ref"``
    keeps the plain path."""
    if impl == "ref":
        return moe_reduce_ref(x, topk_pos, topk_scale, shared_output)
    return moe_reduce(x.to(torch.bfloat16), topk_pos, topk_scale, shared_output)


def _naive_group_gemm(xg, w, g: GatherResult, scale, tm):
    """Plain oracle over the aligned layout (for impl='ref')."""
    out = torch.zeros((xg.shape[0], w.shape[1]), dtype=torch.float32, device=xg.device)
    for ei in range(w.shape[0]):
        s, length = int(g.cu_tiles[ei]) * tm, int(g.seqlens[ei])
        if length == 0:
            continue
        out[s : s + length] = _dot(xg[s : s + length], w[ei]) * scale[ei]
    return out.to(torch.bfloat16)


def interleave_gate_up(w, tn: int = 512):
    """Pre-shuffle [E, 2I, K] gate-up weights for the fused-activation GEMM.

    Output block j (of ``h2 = min(tn, 2I) / 2`` rows twice) holds gate rows
    [j*h2, (j+1)*h2) followed by the matching up rows, so the GEMM epilogue
    can apply silu(gate)*up on its own accumulator tile. A one-time
    transform at weight load, bit for bit the JAX package's.
    """
    e, n2, k = w.shape
    i = n2 // 2
    h2 = min(tn, n2) // 2
    if i % h2:
        raise ValueError(f"interleave_gate_up: intermediate {i} is not a multiple of {h2}")
    wb = w.view(torch.uint8) if w.dtype == FP8_DTYPE else w
    out = torch.stack([wb[:, :i].reshape(e, i // h2, h2, k), wb[:, i:].reshape(e, i // h2, h2, k)],
                      dim=2).reshape(e, n2, k)
    return out.view(FP8_DTYPE) if w.dtype == FP8_DTYPE else out


def _deinterleave_gate_up(w):
    """Inverse of :func:`interleave_gate_up` at its default block: [gate; up]."""
    e, n2, k = w.shape
    h2 = act_pair(n2)
    blocks = w.reshape(e, n2 // (2 * h2), 2, h2, k)
    return torch.cat([blocks[:, :, 0].reshape(e, n2 // 2, k),
                      blocks[:, :, 1].reshape(e, n2 // 2, k)], dim=1)


def fuse_moe_pertensor_fp8(
    x,
    gate_up_weight,
    down_weight,
    gate_up_scale,
    down_scale,
    act_and_mul_scale,
    topk_ids,
    topk_scale,
    rank_ep: int,
    num_expert_total: int,
    use_bf16_mul: bool = True,
    shared_output=None,
    *,
    num_seq_per_group_avg: int | None = None,
    impl: str = "auto",
    gate_up_interleaved: bool = False,
):
    """Per-tensor-scale fused MoE forward over e4m3 (or, through
    :func:`fuse_moe_pertensor_int8`, int8) operands.

    x: [S, H]; gate_up_weight: [E_local, 2I, H]; down_weight: [E_local, H, I];
    gate_up_scale/down_scale: [E_local] f32; act_and_mul_scale: [1] f32;
    topk_ids/topk_scale: [S, K]. Returns [S, H] bf16.

    ``impl``: "auto"/"scatter" (the scatter kernels), "gather" (an
    expert-grouped copy of the tokens and the aligned GEMM) or "ref" (plain
    float32 over that copy). ``gate_up_interleaved`` (int8 weights only):
    gate_up_weight was shuffled by :func:`interleave_gate_up`; the scatter
    path then fuses the activation into the gate-up GEMM and runs the down
    GEMM over aligned row blocks, ``impl="ref"`` undoes the shuffle first
    (the JAX package's ``ref`` and ``gather`` read the shuffled rows as
    [gate; up]), and ``impl="gather"`` refuses it.
    """
    if impl not in ("auto", "scatter", "gather", "ref"):
        raise ValueError(f"fuse_moe_pertensor_fp8: unknown impl {impl!r}")
    int8 = down_weight.dtype == torch.int8
    if gate_up_interleaved and not int8:
        raise ValueError("gate_up_interleaved (the fused activation epilogue) takes int8 weights")
    if gate_up_interleaved and impl == "gather":
        raise ValueError("impl='gather' takes a [gate; up] weight, not an interleaved one")
    e_local = gate_up_weight.shape[0]
    if num_seq_per_group_avg is None:
        s_, k_ = topk_ids.shape
        # expected rows per LOCAL expert: off-rank tokens are dropped, so
        # divide by the GLOBAL expert count
        num_seq_per_group_avg = max(s_ * k_ // max(num_expert_total, 1), 1)
    tm = _pick_tm(num_seq_per_group_avg, x.shape[1])
    act_dtype = torch.int8 if int8 else FP8_DTYPE

    if impl in ("ref", "gather"):
        g = _gather_aligned(x, topk_ids, e_local, rank_ep, tm)
        if impl == "ref":
            gw = _deinterleave_gate_up(gate_up_weight) if gate_up_interleaved else gate_up_weight
            gate_up = _naive_group_gemm(g.x_gathered, gw, g, gate_up_scale, tm)
            down_in = act_mul_and_quant(
                gate_up, act_and_mul_scale, use_bf16_mul, out_dtype=act_dtype, impl="ref"
            )
            down = _naive_group_gemm(down_in, down_weight, g, down_scale, tm)
        else:
            nvt = g.cu_tiles[-1:]
            gate_up = gg_pertensor(g.x_gathered, gate_up_weight, gate_up_scale, g.grp, g.row_blk,
                                   tm, nvt)
            down_in = act_mul_and_quant(gate_up, act_and_mul_scale, use_bf16_mul,
                                        out_dtype=act_dtype, num_valid=nvt * tm)
            down = gg_pertensor(down_in, down_weight, down_scale, g.grp, g.row_blk, tm, nvt)
        return reduce(down, g.topk_pos, topk_scale, shared_output)

    row_idx, topk_pos, _, _, _, cu_tiles, grp = _route_aligned(topk_ids, e_local, rank_ep, tm)
    nvt = cu_tiles[-1:]  # tiles holding real rows, on the device; the rest are skipped
    if gate_up_interleaved:
        # [(nt + 1) * tm, I] int8 codes, the trash tile appended
        down_in = gg_scatter(x, gate_up_weight, gate_up_scale, row_idx, grp, tm, nvt,
                             act_fuse=True, act_scale=act_and_mul_scale, use_bf16_mul=use_bf16_mul)
        nt = grp.shape[0]
        t = torch.arange(nt, dtype=torch.int32, device=grp.device)
        row_blk = torch.where(t < nvt, t, nt)  # skipped tiles point at the trash tile
        down = gg_pertensor(down_in, down_weight, down_scale, grp, row_blk, tm, nvt)
        return reduce(down, topk_pos, topk_scale, shared_output)
    gate_up = gg_scatter(x, gate_up_weight, gate_up_scale, row_idx, grp, tm, nvt)
    down_in = act_mul_and_quant(
        gate_up, act_and_mul_scale, use_bf16_mul, out_dtype=act_dtype,
        num_valid=nvt * tm,  # skip alignment-padding rows
    )
    # identity rows: every slot of a valid tile is multiplied and written, as in
    # the JAX package; reduce never reads the rows of empty slots
    ident = torch.arange(row_idx.shape[0], dtype=torch.int32, device=row_idx.device)
    down = gg_scatter(down_in, down_weight, down_scale, ident, grp, tm, nvt)
    return reduce(down, topk_pos, topk_scale, shared_output)


def fuse_moe(
    x,
    gate_up_weight,
    down_weight,
    gate_up_scale,
    down_scale,
    act_and_mul_scale,
    topk_ids,
    topk_scale,
    rank_ep: int,
    num_expert_total: int,
    use_bf16_mul: bool = True,
    shared_output=None,
    **kw,
):
    """Alias of :func:`fuse_moe_pertensor_fp8`."""
    return fuse_moe_pertensor_fp8(
        x, gate_up_weight, down_weight, gate_up_scale, down_scale, act_and_mul_scale, topk_ids,
        topk_scale, rank_ep, num_expert_total, use_bf16_mul, shared_output, **kw,
    )


def count_and_build_indices(topk_ids, num_expert: int, rank_ep: int,
                            num_seq_per_group_avg: int | None = None):
    """Routing metadata without token materialization: returns
    (row_indices, topk_pos, seqlens, cu_seqlens, tiles, cu_tiles, grp), the
    inputs of :func:`hpc_ops_tpu_torch.ops.group_gemm.group_gemm_fp8_scatter`.
    """
    s_, k_ = topk_ids.shape
    if num_seq_per_group_avg is None:
        num_seq_per_group_avg = max(s_ * k_ // max(num_expert, 1), 1)
    return _route_aligned(topk_ids, num_expert, rank_ep, _pick_tm(num_seq_per_group_avg))


def fuse_moe_pertensor_int8(
    x,
    gate_up_weight,
    down_weight,
    gate_up_scale,
    down_scale,
    act_and_mul_scale,
    topk_ids,
    topk_scale,
    rank_ep: int,
    num_expert_total: int,
    use_bf16_mul: bool = True,
    shared_output=None,
    **kw,
):
    """Per-tensor int8 fused MoE: :func:`fuse_moe_pertensor_fp8` with int8 x
    and weights (exact int32 sums on the card's int8 tensor cores). The
    activation stage re-quantises to int8 (``act_and_mul_scale`` maps the
    activation range onto [-127, 127]); gate_up_scale/down_scale fold the
    operand scales as in the fp8 variant. ``gate_up_interleaved=True`` is the
    serving path (see :func:`fuse_moe_pertensor_fp8`)."""
    if x.dtype != torch.int8 or gate_up_weight.dtype != torch.int8 or down_weight.dtype != torch.int8:
        raise ValueError("fuse_moe_pertensor_int8 takes int8 x and weights, not "
                         f"{x.dtype}, {gate_up_weight.dtype}, {down_weight.dtype}")
    return fuse_moe_pertensor_fp8(
        x, gate_up_weight, down_weight, gate_up_scale, down_scale, act_and_mul_scale, topk_ids,
        topk_scale, rank_ep, num_expert_total, use_bf16_mul, shared_output, **kw,
    )


def _gather_scale_aligned(x_scale, g: GatherResult):
    """The per-token blockwise scales in the aligned layout of ``g``: row
    ``g.topk_pos[s, j]`` gets ``x_scale[s]``; every other row 0."""
    s, k = g.topk_pos.shape
    rows_pad = g.x_gathered.shape[0]
    pos = g.topk_pos.reshape(-1).long()
    kept = pos >= 0
    tokens = torch.arange(s * k, device=pos.device) // k
    out = torch.zeros((rows_pad, x_scale.shape[1]), dtype=torch.float32, device=x_scale.device)
    # dropped pairs all write zeros into the trash tile's last row
    out[torch.where(kept, pos, rows_pad - 1)] = torch.where(kept[:, None], x_scale[tokens].float(), 0.0)
    return out


def _act_requant(gate_up, quant):
    """The stage between the blockwise GEMMs, plain tensor code as in the JAX
    package: silu(gate) * up in float32 from the bf16 gate-up output ([gate;
    up] columns), re-quantised per (row, 128-group). Returns the down GEMM's
    codes and scales (+ 1e-8, as the JAX package passes them)."""
    interm = gate_up.shape[1] // 2
    gate = gate_up[:, :interm].float()
    up = gate_up[:, interm:].float()
    down_in, down_in_scale = quant(gate * torch.sigmoid(gate) * up)
    return down_in, down_in_scale + 1e-8


def _fuse_moe_blockwise(x, x_scale, gate_up_weight, gate_up_weight_scale, down_weight,
                        down_weight_scale, topk_ids, topk_scale, rank_ep, shared_output,
                        num_seq_per_group_avg, scheme, quant):
    if scheme not in BLOCKWISE_SCHEMES:
        raise ValueError(f"fuse_moe_blockwise: unknown scheme {scheme!r}")
    e_local = gate_up_weight.shape[0]
    if scheme == "scatter":
        # routing builds an index vector only: the gate-up GEMM fetches the
        # token rows and their scales by index, the down GEMM reads the
        # gate-up output's slots as whole row blocks (the JAX package feeds
        # its scatter kernel identity indices there: the same rows)
        tm = _pick_tm(num_seq_per_group_avg, x.shape[1])
        row_idx, topk_pos, _, _, _, cu_tiles, grp = _route_aligned(topk_ids, e_local, rank_ep, tm)
        nvt = cu_tiles[-1:]  # tiles holding real rows, on the device
        gate_up = gg_bw_scatter(x, gate_up_weight, x_scale, gate_up_weight_scale, row_idx, grp,
                                tm, nvt)
        down_in, down_in_scale = _act_requant(gate_up, quant)
        row_blk = torch.arange(grp.shape[0], dtype=torch.int32, device=grp.device)
        down = gg_bw_aligned(down_in, down_weight, down_in_scale, down_weight_scale, grp, row_blk,
                             tm, nvt)
        return reduce(down, topk_pos, topk_scale, shared_output)
    tm = _pick_tm(num_seq_per_group_avg)
    g = _gather_aligned(x, topk_ids, e_local, rank_ep, tm)
    sx_g = _gather_scale_aligned(x_scale, g)
    nvt = g.cu_tiles[-1:]
    gate_up = gg_bw_aligned(g.x_gathered, gate_up_weight, sx_g, gate_up_weight_scale, g.grp,
                            g.row_blk, tm, nvt)
    down_in, down_in_scale = _act_requant(gate_up, quant)
    down = gg_bw_aligned(down_in, down_weight, down_in_scale, down_weight_scale, g.grp, g.row_blk,
                         tm, nvt)
    return reduce(down, g.topk_pos, topk_scale, shared_output)


def fuse_moe_blockwise_fp8(
    x,
    x_scale,
    gate_up_weight,
    gate_up_weight_scale,
    down_weight,
    down_weight_scale,
    topk_ids,
    topk_scale,
    rank_ep: int,
    num_expert_total: int,
    shared_output=None,
    *,
    num_seq_per_group_avg: int = 32,
    scheme: str = "scatter",
):
    """Blockwise-scale fp8 fused MoE forward.

    x: [S, H] e4m3 with x_scale [S, H//128] f32 (natural layout);
    gate_up_weight: [E_local, 2I, H] e4m3 ([gate; up] rows) with
    gate_up_weight_scale [E_local, 2I//128, >= H//128];
    down_weight: [E_local, H, I] e4m3 with down_weight_scale
    [E_local, H//128, >= I//128]; topk_ids/topk_scale: [S, K].
    Returns [S, H] bf16. The intermediate is re-quantised to e4m3 with one
    scale per (row, 128-group).

    ``scheme``: "scatter" (the default, see the module docstring), "prescale"
    or "fp8" (the aligned-row copy; all three compute the same function on
    the card: see :func:`hpc_ops_tpu_torch.ops.group_gemm.group_gemm_blockwise_fp8`).
    """
    del num_expert_total  # the routing counts local experts only
    if not (x.dtype == gate_up_weight.dtype == down_weight.dtype == FP8_DTYPE):
        raise ValueError("fuse_moe_blockwise_fp8 takes float8_e4m3fn x and weights, not "
                         f"{x.dtype}, {gate_up_weight.dtype}, {down_weight.dtype}")
    if scheme == "int8":
        raise ValueError("fuse_moe_blockwise_fp8: scheme 'int8' takes int8 operands")
    return _fuse_moe_blockwise(x, x_scale, gate_up_weight, gate_up_weight_scale, down_weight,
                               down_weight_scale, topk_ids, topk_scale, rank_ep, shared_output,
                               num_seq_per_group_avg, scheme, blockwise_fp8_quant)


def fuse_moe_blockwise(x, x_scale, *args, **kw):
    """Alias of :func:`fuse_moe_blockwise_fp8`."""
    return fuse_moe_blockwise_fp8(x, x_scale, *args, **kw)


def fuse_moe_blockwise_int8(
    x,
    x_scale,
    gate_up_weight,
    gate_up_weight_scale,
    down_weight,
    down_weight_scale,
    topk_ids,
    topk_scale,
    rank_ep: int,
    num_expert_total: int,
    shared_output=None,
    *,
    num_seq_per_group_avg: int = 32,
    scheme: str = "scatter",
):
    """Blockwise-scale int8 fused MoE forward: :func:`fuse_moe_blockwise_fp8`
    over int8 codes (quantise with
    :func:`hpc_ops_tpu_torch.ops.quant.blockwise_int8_quant`), the
    intermediate re-quantised to int8 per (row, 128-group). ``scheme``:
    "scatter" (the default, as in the JAX package's code), "prescale", "fp8"
    or "int8"; on the card all four sum each 128-group's int8 products
    exactly and promote them into float32."""
    del num_expert_total
    if not (x.dtype == gate_up_weight.dtype == down_weight.dtype == torch.int8):
        raise ValueError("fuse_moe_blockwise_int8 takes int8 x and weights, not "
                         f"{x.dtype}, {gate_up_weight.dtype}, {down_weight.dtype}")
    return _fuse_moe_blockwise(x, x_scale, gate_up_weight, gate_up_weight_scale, down_weight,
                               down_weight_scale, topk_ids, topk_scale, rank_ep, shared_output,
                               num_seq_per_group_avg, scheme, blockwise_int8_quant)


__all__ = [
    "count_and_gather",
    "count_and_build_indices",
    "interleave_gate_up",
    "reduce",
    "moe_reduce",
    "moe_reduce_ref",
    "ReduceForm",
    "reduce_form",
    "fuse_moe",
    "fuse_moe_pertensor_fp8",
    "fuse_moe_pertensor_int8",
    "fuse_moe_blockwise_fp8",
    "fuse_moe_blockwise_int8",
    "fuse_moe_blockwise",
]
