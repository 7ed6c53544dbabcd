"""Grouped GEMM over varlen token groups (port of ``ops/group_gemm.py``).

Ported in full. With one scale per group: the scatter grouped GEMM
(:func:`gg_scatter`, e4m3 or int8 operands, and over int8 the MoE gate-up
epilogue ``act_fuse``) and the aligned grouped GEMM over pre-packed row
blocks (:func:`gg_pertensor`). With blockwise scales (one per (row,
128-group of K) of x, one per 128 x 128 block of the weight): the scatter
(:func:`gg_bw_scatter`) and aligned (:func:`gg_bw_aligned`) forms. All are
CUDA kernels of ``csrc/group_gemm.cu``. Over them: the entry points
(``group_gemm_fp8_scatter``, the packed ``group_gemm_pertensor_fp8`` /
``group_gemm_fp8`` / ``group_gemm_pertensor_int8``, the blockwise
``group_gemm_blockwise_fp8`` / ``group_gemm_blockwise_int8`` and
``reformat_x_scale``); the flat m-tile bookkeeping they share with the MoE
routing (``_flat_tiles``, ``_pick_tm``, ``cdiv_dyn``) and the float32
oracles ``group_gemm_ref`` and ``group_gemm_blockwise_ref``. Every group's
rows are padded to the m-tile ``tm`` so that group regions tile the row
space exactly: ``grp[t]`` names the group of flat tile ``t`` and
``row_idx[slot]`` the source row of each aligned slot (-1: empty, its
output row holds anything).

fp8 is ``torch.float8_e4m3fn``, decoded exactly, its products accumulated in
float32; int8 products are summed exactly as integers and converted to
float32 once (with blockwise scales: once per 128-group, then promoted into a
float32 accumulator). The result is bf16.

The kernels (``csrc/group_gemm.cu``) multiply on Hopper's tensor cores.
The int8 forms and the blockwise e4m3 forms run ``wgmma`` on 8-bit operands
in blocks of 64 rows for each of one or two warpgroups. The per-tensor e4m3
forms multiply exact fp16 values of their operands with float32 sums, as
the plain version sums: from m-tiles of 64 slots on a register-operand
``wgmma`` body (the weights converted in registers, the gathered rows in
shared memory), at decode m-tiles on an ``mma.sync`` body. :func:`gg_form`
picks body and block from host integers alone; the e4m3 launches are also
counted by body (:data:`E4M3_BODIES`).
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import FP8_DTYPE
from hpc_ops_tpu_torch.ops.activation import act_quant_ref
from hpc_ops_tpu_torch.utils.common import cdiv, round_up

BLOCK = 128  # the blockwise scale group along K and the weight's scale block
def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along dim 0; fp8 rows move as bytes."""
    if t.dtype == FP8_DTYPE:
        return t.view(torch.uint8)[idx].view(FP8_DTYPE)
    return t[idx]


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along dim 0 with the rows of ``idx < 0`` zeroed; fp8 rows
    move as bytes."""
    b = t.view(torch.uint8) if t.dtype == FP8_DTYPE else t
    out = torch.where((idx >= 0)[:, None], b[idx.long().clamp(min=0)], 0)
    return out.view(FP8_DTYPE) if t.dtype == FP8_DTYPE else out


def _cu(counts: torch.Tensor) -> torch.Tensor:
    """[n] counts -> [n+1] int32 prefix sums starting at 0."""
    out = torch.zeros((counts.shape[0] + 1,), dtype=torch.int32, device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=out[1:])
    return out


def _operand(t: torch.Tensor) -> torch.Tensor:
    """A GEMM operand for the plain versions: int8 codes in float64, whose
    sums of int8 products stay exact integers (the card has no int32 matrix
    product), anything else in float32."""
    return t.double() if t.dtype == torch.int8 else t.float()


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [N, K]^T as float32: exact integer sums rounded once for
    int8, float32 sums of exactly decoded values otherwise."""
    return (_operand(x) @ _operand(w).T).float()


# --------------------------------------------------------------------- refs


def group_gemm_ref(x, weight, seqlens, cu_seqlens, y_scale=None):
    """float32 oracle: out[rows of g] = x_g @ weight[g]^T * y_scale[g]."""
    total = x.shape[0]
    g, n, _ = weight.shape
    out = torch.zeros((total, n), dtype=torch.float32, device=x.device)
    xf = x.float()
    for gi in range(g):
        s, length = int(cu_seqlens[gi]), int(seqlens[gi])
        if length == 0:
            continue
        o = xf[s : s + length] @ weight[gi].float().T
        if y_scale is not None:
            o = o * y_scale[gi]
        out[s : s + length] = o
    return out.to(torch.bfloat16)


# ----------------------------------------------------------------- flat tiles


def cdiv_dyn(x, d: int):
    return (x + (d - 1)) // d


def _tile_groups(cu_tiles, total_tiles_max: int):
    """(grp[t] int32, valid[t]) for t < total_tiles_max from the [G+1] tile
    prefix sums: tile t belongs to the group whose range holds it; tiles at or
    past cu_tiles[-1] are not valid and belong to group 0."""
    t = torch.arange(total_tiles_max, dtype=torch.int32, device=cu_tiles.device)
    valid = t < cu_tiles[-1]
    # past the last range searchsorted gives G, which only invalid tiles reach
    grp = torch.searchsorted(cu_tiles[1:], t, right=True, out_int32=True)
    return torch.where(valid, grp, 0), valid


def _flat_tiles(seqlens, tm: int, total_tiles_max: int):
    """Map flat m-tile -> (group, row_block) for tm-aligned group packing.

    Returns (grp[t], row_blk[t], g_starts[g] aligned row offsets,
    total_tiles [] tensor). Tiles >= total_tiles belong to group 0 and point
    at row block total_tiles_max.
    """
    cu_tiles = _cu(cdiv_dyn(seqlens, tm))
    grp, valid = _tile_groups(cu_tiles, total_tiles_max)
    t = torch.arange(total_tiles_max, dtype=torch.int32, device=seqlens.device)
    row_blk = torch.where(valid, t, total_tiles_max)
    return grp, row_blk, cu_tiles[:-1] * tm, cu_tiles[-1]


def _pick_tm(num_seq_per_group_avg: int, k: int | None = None) -> int:
    """m-tile for about ``num_seq_per_group_avg`` rows per group: the next
    multiple of 32 above 9/8 of it, at most 512 (the headroom keeps a typical
    group in one tile; a second tile streams the group's weight again). The
    JAX package's rule, wide-K cap included, so both packages lay rows out
    alike."""
    tm = min(max(round_up(num_seq_per_group_avg * 9 // 8, 32), 32), 512)
    if k is not None:
        while tm > 256 and 2 * tm * round_up(k, 1024) > 8 * 1024 * 1024:
            tm = max(round_up(tm // 2, 32), 256)
    return tm


# ---------------------------------------------------------------- kernel path


def act_pair(n: int, pair: int | None = None) -> int:
    """Rows of gate (and of up) in one interleaved block of an ``act_fuse``
    gate-up weight with ``n`` rows: ``min(512, n) / 2`` unless given, the
    ``h2`` of :func:`hpc_ops_tpu_torch.ops.moe.interleave_gate_up`."""
    pair = min(512, n) // 2 if pair is None else pair
    if pair < 1 or n % (2 * pair):
        raise ValueError(f"act_fuse: {n} weight rows are not whole blocks of 2 * {pair}")
    return pair


def deinterleave_columns(y: torch.Tensor, pair: int):
    """Columns of a GEMM over an interleaved gate-up weight -> (gate, up),
    each [rows, n / 2] in the natural order of the intermediate columns."""
    rows, n = y.shape
    blocks = y.reshape(rows, n // (2 * pair), 2, pair)
    return blocks[:, :, 0].reshape(rows, n // 2), blocks[:, :, 1].reshape(rows, n // 2)


def gg_scatter_ref(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles=None, *,
                   act_fuse=False, act_scale=None, use_bf16_mul=True, pair=None):
    """Plain PyTorch version of :func:`gg_scatter` (one product per m-tile:
    float32 over decoded e4m3, exact integer sums over int8). Empty slots
    give 0 here and every tile is computed (and with ``act_fuse`` the trash
    tile is 0): all three are unspecified in the kernel's output."""
    del num_valid_tiles
    idx = row_idx.long()
    xg = torch.where((idx >= 0)[:, None], _operand(_take(x, idx.clamp(min=0))), 0.0)
    n = weight.shape[1]
    num_tiles = grp.shape[0]
    if act_fuse:
        pair = act_pair(n, pair)
        out = torch.zeros(((num_tiles + 1) * tm, n // 2), dtype=torch.int8, device=x.device)
    else:
        out = torch.empty((num_tiles * tm, n), dtype=torch.bfloat16, device=x.device)
    g = grp.long()
    for t in range(num_tiles):
        rows = slice(t * tm, (t + 1) * tm)
        w_t = _operand(_take(weight, g[t : t + 1])[0])
        y = ((xg[rows] @ w_t.T).float() * y_scale.float()[g[t : t + 1]]).to(torch.bfloat16)
        if act_fuse:
            gate, up = deinterleave_columns(y, pair)
            y = act_quant_ref(torch.cat([gate, up], 1), act_scale, use_bf16_mul, torch.int8)
        out[rows] = y
    return out


GG_KINDS = ("int8", "e4m3", "blockwise")
GG_MMA_SYNC, GG_RS = 0, 3  # the two bodies of the e4m3 per-tensor forms


def gg_form(tm: int, kind: str) -> int:
    """The body and block of a grouped-GEMM launch for m-tiles of ``tm``
    slots, the launchers' last argument. ``kind``: "int8" (the int8
    per-tensor forms, ``act_fuse`` included), "e4m3" (the e4m3 per-tensor
    forms) or "blockwise" (both blockwise forms).

    - e4m3 at decode m-tiles (32 slots): 0 (``GG_MMA_SYNC``), the mma.sync
      body, blocks of 32 rows by 128 weight rows. A decode step routes a
      few rows to each expert, so the weights' stream bounds it.
    - e4m3 from 64 slots up: 3 (``GG_RS``), the register-operand wgmma body,
      blocks of 128 weight rows by up to 256 slots. Both bodies multiply the
      same fp16 values into float32 sums (``csrc/group_gemm.cu``).
    - int8 from 128 slots up: 2, the 8-bit wgmma body with two consumer
      warpgroups (128 rows a block; no float32 accumulator beside its sums,
      so the block fits its registers and streams each weight panel for
      twice the rows).
    - Everything else: 1, that body with one warpgroup (64 rows).

    Host integers only: it never reads the device."""
    if kind not in GG_KINDS:
        raise ValueError(f"gg_form: kind is one of {GG_KINDS}, not {kind!r}")
    if kind == "e4m3":
        return GG_MMA_SYNC if tm <= 32 else GG_RS
    return 2 if kind == "int8" and tm >= 128 else 1


class _BodyLaunches:
    """Launches of one body of the e4m3 per-tensor forms: :func:`gg_scatter`
    and :func:`gg_pertensor` count each e4m3 launch on their own count and
    on its body's (``kernels.launch_counts()`` lists both)."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


E4M3_BODIES = {GG_MMA_SYNC: _BodyLaunches("gg_e4m3_mma_sync"), GG_RS: _BodyLaunches("gg_e4m3_rs")}


def _check_operands(name, x, weight, y_scale, index_tensors):
    """Device, type, shape and contiguity checks shared by the launchers
    (``y_scale`` None: the blockwise forms). Returns the element type code of
    the operands (0 int8, 1 e4m3)."""
    if x.dtype != weight.dtype or x.dtype not in (torch.int8, FP8_DTYPE):
        raise ValueError(f"{name}: x and weight must both be int8 or both float8_e4m3fn, "
                         f"not {x.dtype} and {weight.dtype}")
    g, n, k = weight.shape
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"{name}: x must be [rows, K] for a weight of [G, N, K]")
    if k % 16 or n % 2:
        raise ValueError(f"{name}: the kernel takes K % 16 == 0 and even N")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"{name}: x and weight must be contiguous")
    for t in (weight, *index_tensors, *([] if y_scale is None else [y_scale])):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if y_scale is not None and y_scale.shape[0] != g:
        raise ValueError(f"{name}: one y_scale per group")
    return 0 if x.dtype == torch.int8 else 1


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _valid_tiles(num_valid_tiles, num_tiles: int, dev) -> torch.Tensor:
    if num_valid_tiles is None:
        return torch.full((1,), num_tiles, dtype=torch.int32, device=dev)
    # stays on the device: the kernel reads the count through the pointer
    return torch.as_tensor(num_valid_tiles, device=dev).reshape(1).to(torch.int32).contiguous()


def gg_scatter(
    x: torch.Tensor,  # [rows, K] e4m3 or int8 (original, un-gathered rows)
    weight: torch.Tensor,  # [G, N, K], x's type
    y_scale: torch.Tensor,  # [G] f32
    row_idx: torch.Tensor,  # [num_tiles * tm] int32 source row per slot, -1 empty
    grp: torch.Tensor,  # [num_tiles] int32 group of each m-tile
    tm: int,
    num_valid_tiles=None,  # [1] int32 on the device: tiles at or past it are skipped
    *,
    act_fuse: bool = False,
    act_scale=None,  # [1] f32, with act_fuse
    use_bf16_mul: bool = True,
    pair: int | None = None,
) -> torch.Tensor:
    """``out[slot] = x[row_idx[slot]] @ weight[grp[slot // tm]]^T * y_scale[grp]``,
    [num_tiles * tm, N] bf16.

    ``act_fuse`` (int8 operands, a gate-up weight laid out by
    ``interleave_gate_up``): the MoE's gate-up epilogue. Each slot's gate and
    up values (rounded to bf16 as the GEMM would write them) become
    ``clip(round(silu(gate) * up * act_scale[0]), +-127)`` int8 codes
    (``use_bf16_mul`` as in ``act_mul_and_quant``) in natural column order:
    [(num_tiles + 1) * tm, N / 2] int8, a trash tile included so that the
    result feeds :func:`gg_pertensor` directly. ``pair`` is the interleave
    block's half, ``min(512, N) / 2`` by default.

    CPU tensors take the plain version; CUDA tensors launch a kernel (e4m3:
    this wrapper's, int8: :func:`gg_scatter_i8` or :func:`gg_scatter_i8_act`)
    or raise. Empty slots, skipped tiles and the trash tile hold anything on
    the card.
    """
    if act_fuse:
        pair = act_pair(weight.shape[1], pair)
        if act_scale is None:
            raise ValueError("gg_scatter: act_fuse needs act_scale")
        if weight.dtype != torch.int8:
            raise ValueError("gg_scatter: the act_fuse epilogue takes int8 operands")
    kw = dict(act_fuse=act_fuse, act_scale=act_scale, use_bf16_mul=use_bf16_mul, pair=pair)
    if x.device.type == "cpu":
        return gg_scatter_ref(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"gg_scatter: unsupported device {x.device}")
    if act_fuse:
        return gg_scatter_i8_act(x, weight, y_scale, act_scale, row_idx, grp, tm, num_valid_tiles,
                                 use_bf16_mul, pair)
    if weight.dtype == torch.int8:
        return gg_scatter_i8(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles)
    out = _launch_scatter("hpc_gg_scatter_e4m3", x, weight, y_scale, row_idx, grp, tm,
                          num_valid_tiles, FP8_DTYPE)
    kernels.count(gg_scatter)
    return out


def _launch_scatter(fn, x, weight, y_scale, row_idx, grp, tm, num_valid_tiles, dtype, act=None):
    """Launch a scatter form; returns its output or raises."""
    name = fn.removeprefix("hpc_")
    _check_operands(name, x, weight, y_scale, (row_idx, grp))
    if x.dtype != dtype:
        raise ValueError(f"{name}: takes {dtype} operands, not {x.dtype}")
    num_tiles = grp.shape[0]
    if row_idx.shape[0] != num_tiles * tm:
        raise ValueError(f"{name}: row_idx must be [num_tiles * tm]")
    dev = x.device
    sc = y_scale.to(torch.float32).contiguous()
    nvt = _valid_tiles(num_valid_tiles, num_tiles, dev)
    g, n, k = weight.shape
    # the converted index vectors stay referenced until the launch is queued
    rows, groups = _int32(row_idx), _int32(grp)
    common = (rows.data_ptr(), groups.data_ptr(), nvt.data_ptr())
    form = gg_form(tm, "int8" if dtype == torch.int8 else "e4m3")
    tail = (kernels.stream_ptr(x), g, form)
    if act is None:
        out = torch.empty((num_tiles * tm, n), dtype=torch.bfloat16, device=dev)
        rc = getattr(kernels.lib(), fn)(x.data_ptr(), weight.data_ptr(), sc.data_ptr(), *common,
                                        out.data_ptr(), num_tiles, tm, n, k, *tail)
    else:
        act_scale, use_bf16_mul, pair = act
        if pair % 64:
            raise ValueError(f"{name}: the kernel takes interleave blocks of a multiple of 64 rows")
        am = act_scale.reshape(1).to(device=dev, dtype=torch.float32).contiguous()
        out = torch.empty(((num_tiles + 1) * tm, n // 2), dtype=torch.int8, device=dev)
        rc = getattr(kernels.lib(), fn)(
            x.data_ptr(), weight.data_ptr(), sc.data_ptr(), am.data_ptr(), *common, out.data_ptr(),
            num_tiles, tm, n, k, pair, int(bool(use_bf16_mul)), *tail)
    kernels.check(rc, fn)
    if dtype == FP8_DTYPE:
        kernels.count(E4M3_BODIES[form])
    return out


def gg_scatter_i8(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles=None):
    """:func:`gg_scatter` over int8 operands on the card (exact int32 sums,
    converted to float32, times ``y_scale[grp]``, rounded to bf16); CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return gg_scatter_ref(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles)
    out = _launch_scatter("hpc_gg_scatter_i8", x, weight, y_scale, row_idx, grp, tm,
                          num_valid_tiles, torch.int8)
    kernels.count(gg_scatter_i8)
    return out


def gg_scatter_i8_act(x, weight, y_scale, act_scale, row_idx, grp, tm, num_valid_tiles=None,
                      use_bf16_mul=True, pair=None):
    """:func:`gg_scatter` with ``act_fuse`` on the card: the int8 gate-up GEMM
    whose epilogue writes the activation's int8 codes; CPU tensors take the
    plain version."""
    pair = act_pair(weight.shape[1], pair)
    if x.device.type == "cpu":
        return gg_scatter_ref(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles, act_fuse=True,
                              act_scale=act_scale, use_bf16_mul=use_bf16_mul, pair=pair)
    out = _launch_scatter("hpc_gg_scatter_i8_act", x, weight, y_scale, row_idx, grp, tm,
                          num_valid_tiles, torch.int8, (act_scale, use_bf16_mul, pair))
    kernels.count(gg_scatter_i8_act)
    return out


for _w in (gg_scatter, gg_scatter_i8, gg_scatter_i8_act):
    _w.launches = 0


def gg_pertensor_ref(x_al, weight, y_scale, grp, row_blk, tm, num_valid_tiles=None):
    """Plain PyTorch version of :func:`gg_pertensor`. Rows that no valid tile
    writes are 0 here and unspecified in the kernel's output."""
    n = weight.shape[1]
    out = torch.zeros((x_al.shape[0], n), dtype=torch.bfloat16, device=x_al.device)
    nvt = grp.shape[0]
    if num_valid_tiles is not None:
        nvt = min(nvt, int(torch.as_tensor(num_valid_tiles).reshape(-1)[0]))
    sc = y_scale.float()
    for t in range(nvt):
        r0, g = int(row_blk[t]) * tm, int(grp[t])
        out[r0 : r0 + tm] = (_dot(x_al[r0 : r0 + tm], weight[g]) * sc[g]).to(torch.bfloat16)
    return out


def gg_pertensor(
    x_al: torch.Tensor,  # [rows, K] e4m3 or int8, group rows in tm-aligned blocks
    weight: torch.Tensor,  # [G, N, K], x_al's type
    y_scale: torch.Tensor,  # [G] f32
    grp: torch.Tensor,  # [num_tiles] int32 group of each m-tile
    row_blk: torch.Tensor,  # [num_tiles] int32 row block of each m-tile
    tm: int,
    num_valid_tiles=None,  # [1] int32 on the device: tiles at or past it are skipped
) -> torch.Tensor:
    """Aligned grouped GEMM (``_gg_pertensor_pallas``): for each tile
    ``t < num_valid_tiles``, rows ``row_blk[t]*tm .. +tm`` of the [rows, N]
    bf16 output are ``x_al[same rows] @ weight[grp[t]]^T * y_scale[grp[t]]``.
    No row index: a tile reads and writes whole row blocks. Rows no valid
    tile covers hold anything on the card.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if x_al.device.type == "cpu":
        return gg_pertensor_ref(x_al, weight, y_scale, grp, row_blk, tm, num_valid_tiles)
    if x_al.device.type != "cuda":
        raise ValueError(f"gg_pertensor: unsupported device {x_al.device}")
    elem = _check_operands("gg_pertensor", x_al, weight, y_scale, (grp, row_blk))
    num_tiles = grp.shape[0]
    if row_blk.shape[0] != num_tiles or x_al.shape[0] % tm:
        raise ValueError("gg_pertensor: one row block per tile, x_al in whole row blocks")
    dev = x_al.device
    g, n, k = weight.shape
    sc = y_scale.to(torch.float32).contiguous()
    nvt = _valid_tiles(num_valid_tiles, num_tiles, dev)
    groups, blocks = _int32(grp), _int32(row_blk)
    out = torch.empty((x_al.shape[0], n), dtype=torch.bfloat16, device=dev)
    form = gg_form(tm, "int8" if elem == 0 else "e4m3")
    rc = kernels.lib().hpc_gg_pertensor(
        x_al.data_ptr(), weight.data_ptr(), sc.data_ptr(), groups.data_ptr(), blocks.data_ptr(),
        nvt.data_ptr(), out.data_ptr(), num_tiles, tm, n, k, elem, kernels.stream_ptr(x_al), g,
        form,
    )
    kernels.check(rc, "hpc_gg_pertensor")
    kernels.count(gg_pertensor)
    if elem == 1:
        kernels.count(E4M3_BODIES[form])
    return out


gg_pertensor.launches = 0


# --------------------------------------------------------------- blockwise


def _bw_promote(xo, wo, sx, sw):
    """One m-tile of a blockwise GEMM in the kernels' order, float32 [rows, N]:
    per 128-group of K the partial sum of x[rows, kg] . w[:, kg] (exact for
    int8; float32 for e4m3), promoted as ``acc + (partial * sx[:, kg]) *
    sw[n // 128, kg]``, groups in order. ``xo`` and ``wo`` are operands from
    :func:`_operand`, ``sx`` [rows, >= K/128] and ``sw`` [N/128, >= K/128]."""
    swe = sw.float().repeat_interleave(BLOCK, dim=0)  # [N, >= kb]
    sx = sx.float()
    acc = torch.zeros((xo.shape[0], wo.shape[0]), dtype=torch.float32, device=xo.device)
    for kg in range(xo.shape[1] // BLOCK):
        cols = slice(kg * BLOCK, (kg + 1) * BLOCK)
        part = (xo[:, cols] @ wo[:, cols].T).float()
        acc = acc + (part * sx[:, kg : kg + 1]) * swe[:, kg]
    return acc


def gg_bw_scatter_ref(x, weight, sx, sw, row_idx, grp, tm, num_valid_tiles=None):
    """Plain PyTorch version of :func:`gg_bw_scatter`, in the kernel's order
    of sums (int8: bit-equal). Empty slots give 0 here and every tile is
    computed; both are unspecified in the kernel's output."""
    del num_valid_tiles
    idx = row_idx.long()
    real = (idx >= 0)[:, None]
    src = idx.clamp(min=0)
    xg = torch.where(real, _operand(_take(x, src)), 0.0)
    sxg = torch.where(real, sx[src].float(), 0.0)
    out = torch.empty((grp.shape[0] * tm, weight.shape[1]), dtype=torch.bfloat16, device=x.device)
    for t, g in enumerate(grp.tolist()):
        rows = slice(t * tm, (t + 1) * tm)
        out[rows] = _bw_promote(xg[rows], _operand(weight[g]), sxg[rows], sw[g]).to(torch.bfloat16)
    return out


def gg_bw_aligned_ref(x_al, weight, sx_al, sw, grp, row_blk, tm, num_valid_tiles=None):
    """Plain PyTorch version of :func:`gg_bw_aligned`. Rows that no valid
    tile writes are 0 here and unspecified in the kernel's output."""
    out = torch.zeros((x_al.shape[0], weight.shape[1]), dtype=torch.bfloat16, device=x_al.device)
    nvt = grp.shape[0]
    if num_valid_tiles is not None:
        nvt = min(nvt, int(torch.as_tensor(num_valid_tiles).reshape(-1)[0]))
    for t in range(nvt):
        r0, g = int(row_blk[t]) * tm, int(grp[t])
        rows = slice(r0, r0 + tm)
        out[rows] = _bw_promote(_operand(x_al[rows]), _operand(weight[g]), sx_al[rows],
                                sw[g]).to(torch.bfloat16)
    return out


def _check_blocks(name, weight):
    """The JAX package's shape rules of the blockwise GEMMs: K and N in whole
    128-blocks, K <= 16384."""
    _, n, k = weight.shape
    if k % BLOCK or n % BLOCK or k > 128 * BLOCK:
        raise ValueError(f"{name}: takes K and N in multiples of 128 and K <= 16384, not N {n}, K {k}")


def _check_blockwise(name, x, weight, sx, sw):
    """The blockwise kernels' shape rules. Returns the float32 scales."""
    _check_blocks(name, weight)
    g, n, k = weight.shape
    kb = k // BLOCK
    if sx.dim() != 2 or sx.shape[0] != x.shape[0] or sx.shape[1] < kb:
        raise ValueError(f"{name}: sx must be [rows of x, >= K/128]")
    if sw.dim() != 3 or tuple(sw.shape[:2]) != (g, n // BLOCK) or sw.shape[2] < kb:
        raise ValueError(f"{name}: sw must be [G, N/128, >= K/128]")
    return sx.to(torch.float32).contiguous(), sw.to(torch.float32).contiguous()


def _launch_bw(form, x, weight, sx, sw, rows, grp, tm, num_valid_tiles):
    """Launch a blockwise form; returns its output or raises."""
    name = f"gg_bw_{form}"
    sx, sw = _check_blockwise(name, x, weight, sx, sw)
    elem = _check_operands(name, x, weight, None, (sx, sw, rows, grp))
    num_tiles = grp.shape[0]
    dev = x.device
    g, n, k = weight.shape
    nvt = _valid_tiles(num_valid_tiles, num_tiles, dev)
    rows, groups = _int32(rows), _int32(grp)
    out_rows = num_tiles * tm if form == "scatter" else x.shape[0]
    out = torch.empty((out_rows, n), dtype=torch.bfloat16, device=dev)
    fn = f"hpc_{name}_{'i8' if elem == 0 else 'e4m3'}"
    rc = getattr(kernels.lib(), fn)(
        x.data_ptr(), weight.data_ptr(), sx.data_ptr(), sw.data_ptr(), rows.data_ptr(),
        groups.data_ptr(), nvt.data_ptr(), out.data_ptr(), num_tiles, tm, n, k, sx.stride(0),
        sw.stride(1), kernels.stream_ptr(x), g, gg_form(tm, "blockwise"))
    kernels.check(rc, fn)
    return out


def gg_bw_scatter(
    x: torch.Tensor,  # [rows, K] int8 or e4m3 (original, un-gathered rows)
    weight: torch.Tensor,  # [G, N, K], x's type
    sx: torch.Tensor,  # [rows, >= K/128] f32 scale of each (row, 128-group of K)
    sw: torch.Tensor,  # [G, N/128, >= K/128] f32 scale of each 128 x 128 weight block
    row_idx: torch.Tensor,  # [num_tiles * tm] int32 source row per slot, -1 empty
    grp: torch.Tensor,  # [num_tiles] int32 group of each m-tile
    tm: int,
    num_valid_tiles=None,  # [1] int32 on the device: tiles at or past it are skipped
) -> torch.Tensor:
    """Blockwise scatter grouped GEMM (``_gg_bw_scatter_pallas``), [num_tiles
    * tm, N] bf16: with ``r = row_idx[s]`` and ``g = grp[s // tm]``,
    ``out[s, n] = sum_kg (sum_{k in kg} x[r, k] w[g, n, k]) * sx[r, kg] *
    sw[g, n // 128, kg]``, the sum over kg taken in order in float32. Rows
    are fetched by index inside the kernel and so are their scales; only the
    first K/128 columns of ``sx`` and ``sw`` are read.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Empty slots and skipped tiles hold anything on the card.
    """
    if x.device.type == "cpu":
        return gg_bw_scatter_ref(x, weight, sx, sw, row_idx, grp, tm, num_valid_tiles)
    if x.device.type != "cuda":
        raise ValueError(f"gg_bw_scatter: unsupported device {x.device}")
    if row_idx.shape[0] != grp.shape[0] * tm:
        raise ValueError("gg_bw_scatter: row_idx must be [num_tiles * tm]")
    out = _launch_bw("scatter", x, weight, sx, sw, row_idx, grp, tm, num_valid_tiles)
    kernels.count(gg_bw_scatter)
    return out


def gg_bw_aligned(
    x_al: torch.Tensor,  # [rows, K] int8 or e4m3, group rows in tm-aligned blocks
    weight: torch.Tensor,  # [G, N, K], x_al's type
    sx_al: torch.Tensor,  # [rows, >= K/128] f32, the scales of x_al's rows
    sw: torch.Tensor,  # [G, N/128, >= K/128] f32
    grp: torch.Tensor,  # [num_tiles] int32 group of each m-tile
    row_blk: torch.Tensor,  # [num_tiles] int32 row block of each m-tile
    tm: int,
    num_valid_tiles=None,  # [1] int32 on the device: tiles at or past it are skipped
) -> torch.Tensor:
    """Blockwise aligned grouped GEMM, the counterpart of both
    ``_gg_blockwise_kernel`` and ``_gg_bw_prescale_kernel``: for each tile
    ``t < num_valid_tiles``, rows ``row_blk[t]*tm .. +tm`` of the [rows, N]
    bf16 output are :func:`gg_bw_scatter`'s function of the same rows of
    ``x_al`` and ``sx_al`` with group ``grp[t]``. Rows no valid tile covers
    hold anything on the card.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if x_al.device.type == "cpu":
        return gg_bw_aligned_ref(x_al, weight, sx_al, sw, grp, row_blk, tm, num_valid_tiles)
    if x_al.device.type != "cuda":
        raise ValueError(f"gg_bw_aligned: unsupported device {x_al.device}")
    if row_blk.shape[0] != grp.shape[0] or x_al.shape[0] % tm:
        raise ValueError("gg_bw_aligned: one row block per tile, x_al in whole row blocks")
    out = _launch_bw("aligned", x_al, weight, sx_al, sw, row_blk, grp, tm, num_valid_tiles)
    kernels.count(gg_bw_aligned)
    return out


for _w in (gg_bw_scatter, gg_bw_aligned):
    _w.launches = 0


def gg_blockwise_prescale_aligned(x_al, weight, sx_al, sw_compact, grp, row_blk, tm, tn,
                                  interpret=False, num_valid_tiles=None):
    """The JAX package's aligned-rows blockwise entry (its scheme
    "prescale"): :func:`gg_bw_aligned` under JAX's signature. ``x_al`` [rows,
    K] int8 or e4m3 codes in tm-aligned group blocks, ``sx_al`` [rows, >=
    K/128] and ``sw_compact`` [G, N/128, >= K/128] float32 scales; returns
    [rows, N] bf16. ``tn`` and ``interpret`` are TPU hints, accepted and
    unused."""
    del tn, interpret
    return gg_bw_aligned(x_al, weight, sx_al, sw_compact, grp, row_blk, tm, num_valid_tiles)


# --------------------------------------------------------------- public API


def group_gemm_fp8_scatter(
    x,
    weight,
    y_scale,
    row_indices,
    grp,
    num_seq_per_group_avg: int = 32,
    *,
    tn: int = 256,
    impl: str = "auto",
):
    """Low-latency scatter grouped GEMM: ``out[slot] = x[row_indices[slot]] @
    W[grp[slot // tm]]^T * y_scale[grp]``.

    x: [total_tokens, K] fp8 (original, un-gathered tokens);
    row_indices: [num_tiles * tm] int32 source row per aligned output slot
    (-1 = empty slot, output garbage, dropped by the consumer);
    grp: [num_tiles] int32 expert/group of each m-tile.
    Returns [num_tiles * tm, N] bf16 in the tile-aligned layout. ``tn`` is
    the TPU kernel's tile hint: accepted and ignored.
    """
    del tn
    tm = _pick_tm(num_seq_per_group_avg, x.shape[1])
    if impl == "ref":
        idx = row_indices.long()
        per_slot = grp.long().repeat_interleave(tm)
        xg = torch.where((idx >= 0)[:, None], _take(x, idx.clamp(min=0)).float(), 0.0)
        o = torch.einsum("sk,snk->sn", xg, _take(weight, per_slot).float())
        return (o * y_scale.float()[per_slot][:, None]).to(torch.bfloat16)
    return gg_scatter(x, weight, y_scale, row_indices, grp, tm)


def _packed_slots(seqlens, cu_seqlens, total: int, tm: int, dev):
    """The tm-aligned layout of rows packed by group, built on the device (no
    host read): (grp [num_tiles], row_idx [num_tiles * tm] packed row of each
    slot or -1, total_tiles [1], new_row [total] slot of each packed row)."""
    g = seqlens.shape[0]
    seqlens = seqlens.to(device=dev, dtype=torch.int32)
    cu = cu_seqlens.to(device=dev, dtype=torch.int32)
    total_tiles_max = cdiv(total, tm) + g
    cu_tiles = _cu(cdiv_dyn(seqlens, tm))
    total_tiles = cu_tiles[g:]
    grp, _ = _tile_groups(cu_tiles, total_tiles_max)
    slot = torch.arange(total_tiles_max * tm, dtype=torch.int32, device=dev)
    tile = slot // tm
    g_of = grp.long()[tile.long()]
    row_in_group = (tile - cu_tiles[g_of]) * tm + slot % tm
    valid = (tile < total_tiles) & (row_in_group < seqlens[g_of])
    row_idx = torch.where(valid, cu[g_of] + row_in_group, -1).to(torch.int32)
    row = torch.arange(total, dtype=torch.int32, device=dev)
    req = torch.searchsorted(cu[1:].contiguous(), row, right=True).clamp(max=g - 1)
    new_row = cu_tiles[req] * tm + (row - cu[req])
    return grp, row_idx, total_tiles, new_row.long()


def group_gemm_pertensor_fp8(
    x,
    weight,
    seqlens,
    cu_seqlens,
    y_scale,
    num_seq_per_group_avg: int | None = None,
    *,
    tn: int = 256,
    tk: int = 512,
    impl: str = "auto",
):
    """Per-group-scale grouped GEMM over packed rows: rows of group g ->
    ``x_g @ W_g^T * y_scale[g]``.

    x: [total_seq, K] e4m3 (or int8 with an int8 weight) packed by group;
    weight: [G, N, K]; seqlens/cu_seqlens: [G]/[G+1] int32; y_scale: [G] f32.
    Returns [total_seq, N] bf16. The slot -> row map of the tm-aligned
    layout is vector math on the device (no host read), then
    :func:`gg_scatter` fetches the rows by index and the result is gathered
    back to packed rows. ``tn`` and ``tk`` are the TPU kernel's tile hints:
    accepted and ignored. ``impl="ref"``: the float32 oracle.
    """
    del tn, tk
    if impl == "ref":
        return group_gemm_ref(x, weight, seqlens, cu_seqlens, y_scale)
    total, k = x.shape
    g = seqlens.shape[0]
    if num_seq_per_group_avg is None:
        # the m-tile follows the average group population; undersized tiles
        # multiply the weight traffic
        num_seq_per_group_avg = max(total // max(g, 1), 1)
    tm = _pick_tm(num_seq_per_group_avg, k)
    grp, row_idx, total_tiles, new_row = _packed_slots(seqlens, cu_seqlens, total, tm, x.device)
    return gg_scatter(x, weight, y_scale, row_idx, grp, tm, total_tiles)[new_row]


def group_gemm_fp8(x, weight, seqlens, cu_seqlens, y_scale, num_seq_per_group_avg=32, **kw):
    """Alias of :func:`group_gemm_pertensor_fp8` (the JAX package keeps both names)."""
    return group_gemm_pertensor_fp8(
        x, weight, seqlens, cu_seqlens, y_scale, num_seq_per_group_avg, **kw
    )


def group_gemm_pertensor_int8(
    x, weight, seqlens, cu_seqlens, y_scale, num_seq_per_group_avg=None, **kw
):
    """Per-group-scale INT8 grouped GEMM: :func:`group_gemm_pertensor_fp8`
    with int8 x and weight (exact int32 sums on the card's int8 tensor-core
    path). ``y_scale[g]`` folds both operand scales (x_scale * w_scale[g]);
    quantise with :func:`hpc_ops_tpu_torch.ops.quant.scaled_int8_quant`."""
    if x.dtype != torch.int8 or weight.dtype != torch.int8:
        raise ValueError(f"group_gemm_pertensor_int8 takes int8 x and weight, not "
                         f"{x.dtype} and {weight.dtype}")
    return group_gemm_pertensor_fp8(
        x, weight, seqlens, cu_seqlens, y_scale, num_seq_per_group_avg, **kw
    )


def group_gemm_blockwise_ref(x, weight, seqlens, cu_seqlens, x_scale_nat, w_scale):
    """Blockwise float32 oracle (the JAX package's): for the packed rows of
    each group ``out[m, n] = sum_kb (x_kb @ w_kb^T)[m, n] * sx[m, kb] *
    sw[g, n // 128, kb]``, summed over kb at once. x_scale_nat: [total,
    K//128] (natural layout); w_scale: [G, N//128, >= K//128]. Rows outside
    every group are 0."""
    total, k = x.shape
    g, n, _ = weight.shape
    kb = k // BLOCK
    out = torch.zeros((total, n), dtype=torch.float32, device=x.device)
    xf = x.float().reshape(total, kb, BLOCK)
    wf = weight.float().reshape(g, n, kb, BLOCK)
    for gi in range(g):
        s, length = int(cu_seqlens[gi]), int(seqlens[gi])
        if length == 0:
            continue
        part = torch.einsum("mkd,nkd->mnk", xf[s : s + length], wf[gi])
        sx = x_scale_nat[s : s + length].float()
        swe = w_scale[gi][:, :kb].float().repeat_interleave(BLOCK, dim=0)  # [n, kb]
        out[s : s + length] = (part * sx[:, None, :] * swe[None, :, :]).sum(-1)
    return out.to(torch.bfloat16)


BLOCKWISE_SCHEMES = ("scatter", "prescale", "fp8", "int8")


def _group_gemm_blockwise(
    x,
    weight,
    seqlens,
    cu_seqlens,
    x_scale,
    w_scale,
    num_seq_per_group_avg: int | None = None,
    *,
    x_scale_layout: str = "transposed",
    tn: int = 256,
    impl: str = "auto",
    scheme: str = "scatter",
):
    del tn
    if scheme not in BLOCKWISE_SCHEMES:
        raise ValueError(f"blockwise grouped GEMM: unknown scheme {scheme!r}")
    if scheme == "int8" and (x.dtype != torch.int8 or weight.dtype != torch.int8):
        raise ValueError("blockwise grouped GEMM: scheme 'int8' takes int8 operands")
    _check_blocks("blockwise grouped GEMM", weight)
    total, g = x.shape[0], weight.shape[0]
    if num_seq_per_group_avg is None:
        num_seq_per_group_avg = max(total // max(g, 1), 1)
    # the m-tile of reformat_x_scale's layout; the slots of both kernels follow it
    tm = _pick_tm(num_seq_per_group_avg)
    grp, row_idx, total_tiles, new_row = _packed_slots(seqlens, cu_seqlens, total, tm, x.device)
    if x_scale_layout == "transposed":  # [K//128, slots]: column new_row[r] is row r's
        sxt = x_scale.T
        sx_nat = sxt[new_row.clamp(max=sxt.shape[0] - 1)]
    elif x_scale_layout == "natural":
        sx_nat = x_scale[:total]
    else:
        raise ValueError(f"blockwise grouped GEMM: unknown x_scale_layout {x_scale_layout!r}")
    if impl == "ref":
        return group_gemm_blockwise_ref(x, weight, seqlens, cu_seqlens, sx_nat, w_scale)
    if scheme == "scatter":
        out_al = gg_bw_scatter(x, weight, sx_nat, w_scale, row_idx, grp, tm, total_tiles)
    else:  # the aligned-row schemes over a copy of the rows and their scales
        x_al = _take_rows(x, row_idx)
        sx_al = _take_rows(sx_nat.float(), row_idx)
        row_blk = torch.arange(grp.shape[0], dtype=torch.int32, device=x.device)
        out_al = gg_bw_aligned(x_al, weight, sx_al, w_scale, grp, row_blk, tm, total_tiles)
    return out_al[new_row]


def group_gemm_blockwise_fp8(
    x,
    weight,
    seqlens,
    cu_seqlens,
    x_scale,
    w_scale,
    num_seq_per_group_avg: int | None = None,
    **kw,
):
    """Blockwise (128-group) fp8 grouped GEMM.

    x: [total_seq, K] e4m3; weight: [G, N, K] e4m3;
    x_scale: reference layout [K//128, total_seq_pad] f32
    (``x_scale_layout="transposed"``, see :func:`reformat_x_scale`) or
    natural [total_seq, K//128] (``"natural"``);
    w_scale: [G, N//128, >= K//128] f32. Returns [total_seq, N] bf16.

    ``scheme``: "scatter" (the default: rows and their scales fetched by
    index inside :func:`gg_bw_scatter`), or "prescale", "fp8" and "int8"
    (int8 operands only), which copy the rows and their scales into the
    tm-aligned layout and run :func:`gg_bw_aligned`. The TPU kernels behind
    the schemes differ in how they fold the scales (bf16 pre-scaled operands
    or per-group promotion); on the card all four compute the same function
    with exact per-group promotion in float32. ``tn`` is the TPU kernel's
    tile hint: accepted and ignored. ``impl="ref"``: the float32 oracle
    :func:`group_gemm_blockwise_ref`. K and N are multiples of 128 and K is at
    most 16384, as in the JAX package.
    """
    kw.setdefault("scheme", "scatter")
    return _group_gemm_blockwise(
        x, weight, seqlens, cu_seqlens, x_scale, w_scale, num_seq_per_group_avg, **kw,
    )


def group_gemm_blockwise_int8(
    x,
    weight,
    seqlens,
    cu_seqlens,
    x_scale,
    w_scale,
    num_seq_per_group_avg: int | None = None,
    **kw,
):
    """Blockwise (128-group) int8 grouped GEMM: :func:`group_gemm_blockwise_fp8`
    over int8 codes (quantise with
    :func:`hpc_ops_tpu_torch.ops.quant.blockwise_int8_quant`). Each 128-group's
    int8 products are summed exactly in int32 on the tensor cores and promoted
    into float32, in every scheme."""
    if x.dtype != torch.int8 or weight.dtype != torch.int8:
        raise ValueError(f"group_gemm_blockwise_int8 takes int8 x and weight, not "
                         f"{x.dtype} and {weight.dtype}")
    kw.setdefault("scheme", "scatter")
    return _group_gemm_blockwise(
        x, weight, seqlens, cu_seqlens, x_scale, w_scale, num_seq_per_group_avg, **kw,
    )


def reformat_x_scale(x_scale, seqlens, cu_seqlens, num_seq_per_group_avg: int = 32):
    """Reference-layout conversion: [total_seq, K//128] -> [K//128,
    compact_total_seq_pad] with each group's rows starting at a multiple of
    the m-tile ``_pick_tm(num_seq_per_group_avg)`` (the layout the
    ``"transposed"`` x scales of the blockwise GEMMs are read in)."""
    tm = _pick_tm(num_seq_per_group_avg)
    total, kb = x_scale.shape
    g = seqlens.shape[0]
    dev = x_scale.device
    seqlens = seqlens.to(device=dev, dtype=torch.int32)
    cu = cu_seqlens.to(device=dev, dtype=torch.int32)
    g_starts = _cu(cdiv_dyn(seqlens, tm))[:-1] * tm
    total_pad = (cdiv(total, tm) + g) * tm
    row = torch.arange(total, dtype=torch.int32, device=dev)
    req = torch.searchsorted(cu[1:].contiguous(), row, right=True).clamp(max=g - 1)
    new_row = torch.where(row < cu[g], g_starts[req] + row - cu[req], total_pad - 1)
    out = torch.zeros((total_pad, kb), dtype=torch.float32, device=dev)
    out[new_row.long()] = x_scale.float()
    return out.T.contiguous()


__all__ = [
    "group_gemm_fp8",
    "group_gemm_pertensor_int8",
    "group_gemm_pertensor_fp8",
    "group_gemm_blockwise_fp8",
    "group_gemm_blockwise_int8",
    "group_gemm_fp8_scatter",
    "group_gemm_ref",
    "group_gemm_blockwise_ref",
    "reformat_x_scale",
    "gg_form",
    "gg_scatter",
    "gg_scatter_i8",
    "gg_scatter_i8_act",
    "gg_scatter_ref",
    "gg_pertensor",
    "gg_pertensor_ref",
    "gg_bw_scatter",
    "gg_bw_scatter_ref",
    "gg_bw_aligned",
    "gg_bw_aligned_ref",
    "gg_blockwise_prescale_aligned",
]
