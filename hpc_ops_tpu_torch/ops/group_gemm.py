"""Grouped GEMM over varlen token groups (port of ``ops/group_gemm.py``).

Ported: the scatter grouped GEMM with one scale per group
(``group_gemm_fp8_scatter`` over :func:`gg_scatter`, the CUDA kernel of
``csrc/group_gemm.cu``), the flat m-tile bookkeeping it shares with the MoE
routing (``_flat_tiles``, ``_pick_tm``, ``cdiv_dyn``) and the float32 oracle
``group_gemm_ref``. Every group's rows are padded to the m-tile ``tm`` so that
group regions tile the row space exactly: ``grp[t]`` names the group of flat
tile ``t`` and ``row_idx[slot]`` the source row of each aligned slot (-1:
empty, its output row holds anything).

fp8 is ``torch.float8_e4m3fn``, decoded exactly; the products accumulate in
float32 and the result is bf16. The packed-rows entry points and the
blockwise-scale GEMMs are ROADMAP queue 1 item 3 and raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.config import FP8_DTYPE
from hpc_ops_tpu_torch.utils.common import round_up

_LATER = "is not ported yet: ROADMAP queue 1 item 3 (MoE)"


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along dim 0; fp8 rows move as bytes."""
    if t.dtype == FP8_DTYPE:
        return t.view(torch.uint8)[idx].view(FP8_DTYPE)
    return t[idx]


def _cu(counts: torch.Tensor) -> torch.Tensor:
    """[n] counts -> [n+1] int32 prefix sums starting at 0."""
    out = torch.zeros((counts.shape[0] + 1,), dtype=torch.int32, device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=out[1:])
    return out


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


def gg_scatter_ref(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles=None):
    """Plain PyTorch version of :func:`gg_scatter` (float32 products, one
    matmul per m-tile). Empty slots give 0 here and every tile is computed:
    both are unspecified in the kernel's output."""
    del num_valid_tiles
    idx = row_idx.long()
    xg = torch.where((idx >= 0)[:, None], _take(x, idx.clamp(min=0)).float(), 0.0)
    n = weight.shape[1]
    out = torch.empty((row_idx.shape[0], n), dtype=torch.bfloat16, device=x.device)
    g = grp.long()
    for t in range(grp.shape[0]):
        rows = slice(t * tm, (t + 1) * tm)
        w_t = _take(weight, g[t : t + 1])[0].float()
        out[rows] = ((xg[rows] @ w_t.T) * y_scale.float()[g[t : t + 1]]).to(torch.bfloat16)
    return out


def gg_scatter(
    x: torch.Tensor,  # [rows, K] e4m3 (original, un-gathered rows)
    weight: torch.Tensor,  # [G, N, K] e4m3
    y_scale: torch.Tensor,  # [G] f32
    row_idx: torch.Tensor,  # [num_tiles * tm] int32 source row per slot, -1 empty
    grp: torch.Tensor,  # [num_tiles] int32 group of each m-tile
    tm: int,
    num_valid_tiles=None,  # [1] int32 on the device: tiles at or past it are skipped
) -> torch.Tensor:
    """``out[slot] = x[row_idx[slot]] @ weight[grp[slot // tm]]^T * y_scale[grp]``,
    [num_tiles * tm, N] bf16.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Empty slots and skipped tiles hold anything on the card.
    """
    if x.device.type == "cpu":
        return gg_scatter_ref(x, weight, y_scale, row_idx, grp, tm, num_valid_tiles)
    if x.device.type != "cuda":
        raise ValueError(f"gg_scatter: unsupported device {x.device}")
    if x.dtype != FP8_DTYPE or weight.dtype != FP8_DTYPE:
        raise NotImplementedError(
            f"gg_scatter: {x.dtype} x {weight.dtype} operands (int8, bf16) {_LATER}"
        )
    num_tiles = grp.shape[0]
    g, n, k = weight.shape
    if x.dim() != 2 or x.shape[1] != k or row_idx.shape[0] != num_tiles * tm:
        raise ValueError("gg_scatter: x must be [rows, K] and row_idx [num_tiles * tm]")
    if k % 16 or n % 2:
        raise ValueError("gg_scatter: the kernel takes K % 16 == 0 and even N")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("gg_scatter: x and weight must be contiguous")
    dev = x.device
    for t in (weight, y_scale, row_idx, grp):
        if t.device != dev:
            raise ValueError("gg_scatter: all tensors must be on one device")
    if y_scale.shape[0] != g:
        raise ValueError("gg_scatter: one y_scale per group")
    sc = y_scale.to(torch.float32).contiguous()
    rows = row_idx.to(torch.int32).contiguous()
    groups = grp.to(torch.int32).contiguous()
    if num_valid_tiles is None:
        nvt = torch.full((1,), num_tiles, dtype=torch.int32, device=dev)
    else:
        # stays on the device: the kernel reads the count through the pointer
        nvt = torch.as_tensor(num_valid_tiles, device=dev).reshape(1).to(torch.int32).contiguous()
    out = torch.empty((num_tiles * tm, n), dtype=torch.bfloat16, device=dev)
    rc = kernels.lib().hpc_gg_scatter_e4m3(
        x.data_ptr(), weight.data_ptr(), sc.data_ptr(), rows.data_ptr(), groups.data_ptr(),
        nvt.data_ptr(), out.data_ptr(), num_tiles, tm, n, k, kernels.stream_ptr(x),
    )
    kernels.check(rc, "hpc_gg_scatter_e4m3")
    gg_scatter.launches += 1
    return out


gg_scatter.launches = 0


# --------------------------------------------------------------- public API


def group_gemm_fp8_scatter(
    x,
    weight,
    y_scale,
    row_indices,
    grp,
    num_seq_per_group_avg: int = 32,
    *,
    impl: str = "auto",
):
    """Low-latency scatter grouped GEMM: ``out[slot] = x[row_indices[slot]] @
    W[grp[slot // tm]]^T * y_scale[grp]``.

    x: [total_tokens, K] fp8 (original, un-gathered tokens);
    row_indices: [num_tiles * tm] int32 source row per aligned output slot
    (-1 = empty slot, output garbage, dropped by the consumer);
    grp: [num_tiles] int32 expert/group of each m-tile.
    Returns [num_tiles * tm, N] bf16 in the tile-aligned layout.
    """
    tm = _pick_tm(num_seq_per_group_avg, x.shape[1])
    if impl == "ref":
        idx = row_indices.long()
        per_slot = grp.long().repeat_interleave(tm)
        xg = torch.where((idx >= 0)[:, None], _take(x, idx.clamp(min=0)).float(), 0.0)
        o = torch.einsum("sk,snk->sn", xg, _take(weight, per_slot).float())
        return (o * y_scale.float()[per_slot][:, None]).to(torch.bfloat16)
    return gg_scatter(x, weight, y_scale, row_indices, grp, tm)


def _later(name):
    def raiser(*args, **kw):
        raise NotImplementedError(f"{name} {_LATER}")

    raiser.__name__ = name
    raiser.__doc__ = f"``{name}`` of the JAX package; {_LATER}."
    return raiser


group_gemm_pertensor_fp8 = _later("group_gemm_pertensor_fp8")
group_gemm_fp8 = _later("group_gemm_fp8")
group_gemm_pertensor_int8 = _later("group_gemm_pertensor_int8")
group_gemm_blockwise_fp8 = _later("group_gemm_blockwise_fp8")
group_gemm_blockwise_int8 = _later("group_gemm_blockwise_int8")
group_gemm_blockwise_ref = _later("group_gemm_blockwise_ref")
reformat_x_scale = _later("reformat_x_scale")


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
    "gg_scatter",
    "gg_scatter_ref",
]
