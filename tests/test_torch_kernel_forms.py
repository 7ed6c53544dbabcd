"""The host-side choosers of four kernels' launches, on the CPU.

``ops/rope_kernel.py:rope_form`` picks the rope store's word width, lanes a
head and heads a block (csrc/rope_store.cu), ``ops/moe.py:reduce_form`` the
top-k reduce's threads a block (csrc/moe.cu), ``ops/normalization.py:
norm_form`` the RMSNorm + fp8 kernel's word width (csrc/normalization.cu),
``ops/attention/decode.py:
combine_form`` the segment combine's rows and column chunks a block
(csrc/decode.cu). The kernels run only on the card (tests/test_torch_cuda.py);
these tests hold the choosers to what the kernels assume: every element of a
head's half (a row; a segment's outputs) owned by exactly one lane and chunk
(thread and word; block), words that the pointers' alignment allows, blocks
within the launch bounds, a grid that spreads a decode step over the card,
and a RopeShape whose fields mirror the kernel's struct.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import re

import pytest
import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.ops.attention.decode import (
    COMBINE_MIN_ITEMS,
    COMBINE_ROWS,
    COMBINE_THREADS,
    combine_form,
)
from hpc_ops_tpu_torch.ops.attention.scheduler import assign_attention_decode_task
from hpc_ops_tpu_torch.ops.moe import REDUCE_THREADS, reduce_form
from hpc_ops_tpu_torch.ops.normalization import NORM_THREADS, norm_form
from hpc_ops_tpu_torch.ops.rope_kernel import (
    ROPE_MAX_ELEMS,
    ROPE_MAX_THREADS,
    _align,
    _rope_shape,
    _RopeShape,
    rope_form,
)
from hpc_ops_tpu_torch.utils.common import cdiv

torch.set_num_threads(1)

ROPE_DIMS = [2, 42, 64, 96, 100, 128, 256, 510, 512]
ROPE_HEADS = [3, 12, 48, 130]  # hq + 2 * hkv: tiny, d256's 8 + 2 * 2, llama3_8b, GQA 128 over 1
ROPE_ROWS = [1, 8, 200, 2048]


@pytest.mark.parametrize("d", ROPE_DIMS)
def test_rope_form_owns_each_element_once_within_the_launch_bounds(d):
    """For every head count, row count and alignment: vec the widest word of
    8, 4, 2 or 1 elements that divides d / 2 and fits the alignment; lanes a
    power of two up to 32; the lanes' chunks cover the half once each within
    the kernel's 8 elements a lane; whole warps of at most 256 threads; the
    grid one block per row and group of heads."""
    half = d // 2
    for heads in ROPE_HEADS:
        for rows in ROPE_ROWS:
            for align in (16, 8, 4, 2):
                f = rope_form(d, heads, rows, align)
                assert half % f.vec == 0 and 2 * f.vec <= align
                assert all(half % v or 2 * v > align for v in (8, 4, 2) if v > f.vec)
                assert f.lanes in (1, 2, 4, 8, 16, 32) and f.vec * f.chunks <= ROPE_MAX_ELEMS
                cols = sorted((lane + j * f.lanes) * f.vec + e for lane in range(f.lanes)
                              for j in range(ROPE_MAX_ELEMS // f.vec) for e in range(f.vec)
                              if (lane + j * f.lanes) * f.vec < half)
                assert cols == list(range(half))
                assert f.chunks == cdiv(half, f.vec * f.lanes)
                assert f.threads == f.heads_per_block * f.lanes <= ROPE_MAX_THREADS
                assert f.threads % 32 == 0
                assert f.blocks == rows * cdiv(heads, f.heads_per_block)
                assert rope_form(d, heads, rows, align) == f  # host integers only


def test_rope_form_spreads_a_decode_step_and_widens_blocks_at_prefill():
    """llama3_8b (48 heads of 128): a decode step of 8 rows is 96 one-warp
    blocks of 4 heads (the old kernel: 8 blocks); a 2048-row prefill is two
    blocks of 24 heads a row; GQA 128 over 1 at decode fills two blocks an SM."""
    decode = rope_form(128, 48, 8)
    assert (decode.vec, decode.lanes, decode.heads_per_block, decode.threads) == (8, 8, 4, 32)
    assert decode.blocks == 96
    prefill = rope_form(128, 48, 2048)
    assert (prefill.heads_per_block, prefill.threads, prefill.blocks) == (24, 192, 4096)
    assert rope_form(128, 130, 8).blocks >= 2 * kernels.SMS
    assert rope_form(256, 12, 8).lanes == 16 and rope_form(64, 48, 8).lanes == 4


def test_rope_form_narrows_the_word_for_misaligned_pointers_and_odd_halves():
    assert [rope_form(128, 48, 8, a).vec for a in (16, 8, 4, 2)] == [8, 4, 2, 1]
    assert rope_form(100, 8, 8).vec == 2 and rope_form(42, 8, 8).vec == 1
    assert rope_form(510, 3, 8).chunks == 8  # 255 one-element words over 32 lanes
    assert _align(0) == 16 and _align(1 << 40) == 16 and _align(48) == 16
    assert _align(24) == 8 and _align(0x7F00_0000_0004) == 4 and _align(0x1000 | 6) == 2


def test_rope_shape_mirrors_the_kernel_struct():
    """_RopeShape's fields are csrc/rope_store.cu's RopeShape's, in order and
    type (int or int64_t), so the kernel reads what the wrapper wrote."""
    with open(os.path.join(kernels.CSRC_DIR, "rope_store.cu")) as f:
        body = re.search(r"struct RopeShape \{(.*?)\};", f.read(), re.S).group(1)
    fields = []
    for ctype, names in re.findall(r"^\s*(int64_t|int)\s+([^;]+);", body, re.M):
        fields += [(n.strip(), ctypes.c_int64 if ctype == "int64_t" else ctypes.c_int)
                   for n in names.split(",")]
    assert fields == list(_RopeShape._fields_)
    assert ctypes.sizeof(_RopeShape) == 64 and _RopeShape.num_slots.offset == 56


def test_rope_shape_is_built_once_per_shape():
    args = (8, 32, 8, 128, 8192, 8, 260, 16, 0, 1, 32768, 16)
    shape, addr = _rope_shape(*args)
    assert _rope_shape(*args)[1] == addr == ctypes.addressof(shape)
    f = rope_form(128, 48, 8, 16)
    assert (shape.vec, shape.lanes, shape.heads_per_block) == (f.vec, f.lanes, f.heads_per_block)
    assert (shape.rows, shape.num_slots, shape.head_major) == (8, 32768, 1)


REDUCE_CASES = [(1, 4096), (8, 4096), (8, 5120), (8, 14336), (33, 4096), (200, 4096), (512, 4096),
                (2048, 4096), (2048, 5120), (2048, 14336), (1, 64), (3, 8)]


@pytest.mark.parametrize("tokens,h", REDUCE_CASES)
def test_reduce_form_covers_the_row_within_the_launch_bounds(tokens, h):
    """Whole warps of 32 to 256 threads; a token's chunks, each walking its
    8-column groups, cover its row once, none empty; the largest block whose
    grid (a group a thread) holds two blocks an SM, the smallest where none
    does; the row split no further than two blocks an SM need."""
    f = reduce_form(tokens, h)
    t, groups = f.threads, h // 8
    assert t % 32 == 0 and 32 <= t <= 256 and f.blocks == tokens * f.chunks
    grids = {u: tokens * cdiv(groups, u) for u in REDUCE_THREADS}
    big = [u for u in REDUCE_THREADS if grids[u] >= 2 * kernels.SMS]
    assert t == min(big[0] if big else REDUCE_THREADS[-1], max(32, cdiv(groups, 32) * 32))
    per = cdiv(groups, f.chunks)
    owned = sorted(g for c in range(f.chunks) for tid in range(t)
                   for g in range(c * per + tid, min(groups, (c + 1) * per), t))
    assert owned == list(range(groups))
    assert all(c * per < groups for c in range(f.chunks))
    assert f.chunks == 1 or f.blocks - tokens < 2 * kernels.SMS
    assert reduce_form(tokens, h) == f  # host integers only


def test_reduce_form_spreads_a_decode_step():
    """Mixtral's decode step (8 tokens, h 4096) is 64 blocks of 64 threads,
    one 8-column group a thread (the old kernel: 8 blocks of 256); 512 and
    2048 tokens take one block of 256 a token, two groups a thread."""
    assert tuple(reduce_form(8, 4096)) == (64, 8, 64)
    assert tuple(reduce_form(512, 4096)) == (256, 1, 512)
    assert tuple(reduce_form(2048, 4096)) == (256, 1, 2048)


NORM_HIDDEN = [8, 320, 4096, 5120, 7168, 8192, 16384, 65544]  # multiples of 8 up to past 64K
NORM_ROWS = [1, 5, 8, 2048]


def source_constant(name, source):
    with open(os.path.join(kernels.CSRC_DIR, source)) as f:
        return int(re.search(rf"constexpr int {name} = (\d+)", f.read()).group(1))


@pytest.mark.parametrize("h", NORM_HIDDEN)
def test_norm_form_owns_each_element_once_within_the_launch_bounds(h):
    """At every row count and alignment of a and of the weight (bf16 or
    float32): vec the widest word of 8, 4, 2 or 1 elements that both allow
    (a word of the float32 weight loads at most 16 bytes at once); one
    block of the kernel's 256 threads a row; each element of the row in
    exactly one (thread, word), thread t taking words t, t + 256, ..."""
    checked = set()
    for n, a_align, w_align, w_elem in itertools.product(NORM_ROWS, (16, 8, 4, 2), (16, 8, 4, 2), (2, 4)):
        if w_align < w_elem:  # a float32 pointer is 4-byte aligned
            continue
        f = norm_form(n, h, a_align, w_align, w_elem)
        fits = [v for v in (8, 4, 2, 1) if 2 * v <= a_align and min(16, w_elem * v) <= w_align]
        assert f.vec == fits[0] and h % f.vec == 0
        assert (f.threads, f.blocks) == (NORM_THREADS, n)
        assert norm_form(n, h, a_align, w_align, w_elem) == f  # host integers only
        if f.vec in checked:
            continue
        checked.add(f.vec)
        owned = sorted(c + e for t in range(f.threads) for c in range(t * f.vec, h, f.threads * f.vec)
                       for e in range(f.vec))
        assert owned == list(range(h))
    assert source_constant("kThreads", "normalization.cu") == NORM_THREADS


def test_norm_form_narrows_the_word_for_misaligned_pointers():
    """16-byte words where both pointers allow them; a bf16 view 2, 4 or 8
    bytes off a 16-byte boundary takes 1, 2 or 4 elements a word; a float32
    weight 8 or 4 bytes off takes 2 or 1."""
    assert norm_form(2048, 4096).vec == 8 and norm_form(8, 5120, 16, 16, 4).vec == 8
    assert [norm_form(8, 4096, a).vec for a in (16, 8, 4, 2)] == [8, 4, 2, 1]
    assert [norm_form(8, 4096, 16, a).vec for a in (16, 8, 4, 2)] == [8, 4, 2, 1]
    assert [norm_form(8, 4096, 16, a, 4).vec for a in (16, 8, 4)] == [8, 2, 1]
    assert _align(0x7F00_0000_0002) == 2 and norm_form(8, 4096, _align(0x7F00_0000_0002)).vec == 1


def scenario_segments():
    """The decode benchmark's scenarios as chip_smoke.py runs them: (case,
    segments, capacity of the "tight" map)."""
    scen = {"uniform_512": [(64, 512)], "skewed_mix": [(32, 128), (32, 4096)],
            "skewed_extreme": [(1, 16384), (15, 64)], "one_64k_7x4k": [(1, 65536), (7, 4096)],
            "one_128k_31x4k": [(1, 131072), (31, 4096)]}
    for case, spec in scen.items():
        lens = torch.tensor([n for count, n in spec for _ in range(count)], dtype=torch.int32)
        tm = assign_attention_decode_task(lens, 8, tile=2048, capacity="tight", impl="np")
        yield case, tm.num_segs, tm.capacity


COMBINE_GEOMETRY = [(4, 128), (12, 128), (1, 64), (32, 96), (128, 128), (128, 66), (8, 256), (40, 4)]


def combine_blocks(f, rows, dv, first, count):
    """(segment, row, column group) of every output item, by block, for
    ``count`` blocks from ``first`` (the kernel's decomposition of blockIdx)."""
    groups = dv // f.vec
    out = []
    for blk in range(first, first + count):
        cs_, rest = blk % f.col_splits, blk // f.col_splits
        rbk, seg = rest % cdiv(rows, f.rows_per_block), rest // cdiv(rows, f.rows_per_block)
        out.append([(seg, r, g) for r in range(rbk * f.rows_per_block, min(rows, (rbk + 1) * f.rows_per_block))
                    for g in range(cs_ * f.groups_per_block, min(groups, (cs_ + 1) * f.groups_per_block))])
    return out


@pytest.mark.parametrize("rows,dv", COMBINE_GEOMETRY)
def test_combine_form_owns_each_output_once_within_the_launch_bounds(rows, dv):
    """G * sq rows up to 128, dv with and without 16-byte words: at most 8
    rows and 256 (row, column group) items a block, no empty block, every
    output of every segment in exactly one block, rows and then columns
    split only while the grid has fewer blocks than half the SMs and a
    block more than a warp's items."""
    for num_segs in (1, 8, 64, 128, 256, 512):
        for align in (16, 4):
            f = combine_form(num_segs, rows, dv, align)
            assert f.vec == (4 if dv % 4 == 0 and align == 16 else 1)
            groups = dv // f.vec
            items = f.rows_per_block * f.groups_per_block
            assert 1 <= f.rows_per_block <= min(COMBINE_ROWS, rows) and items <= COMBINE_THREADS
            assert f.groups_per_block == cdiv(groups, f.col_splits) and f.col_splits <= groups
            assert f.blocks == num_segs * cdiv(rows, f.rows_per_block) * f.col_splits
            per_seg = f.blocks // num_segs
            for seg in {0, num_segs - 1}:  # a segment's blocks: every output once
                blocks = combine_blocks(f, rows, dv, seg * per_seg, per_seg)
                assert all(blocks) and sorted(x for b in blocks for x in b) == [
                    (seg, r, g) for r in range(rows) for g in range(groups)]
            if f.blocks < kernels.SMS // 2:
                assert items <= COMBINE_MIN_ITEMS or (f.rows_per_block == 1 and f.col_splits == groups)
            assert combine_form(num_segs, rows, dv, align) == f  # host integers only
    assert source_constant("kWarps", "decode.cu") == COMBINE_ROWS
    assert 32 * COMBINE_ROWS == COMBINE_THREADS


@pytest.mark.parametrize("case,num_segs,capacity", list(scenario_segments()))
def test_combine_form_spreads_the_decode_scenarios(case, num_segs, capacity):
    """Llama3_8b heads (G 4, sq 1, D 128): every segment's 4 rows in one
    block (128 items, two task slices) where the segments are at least
    half the SMs; one_64k_7x4k's 64 segments take two blocks of 2 rows each
    (64 items, four task slices: its 16-task segments' float4 loads in one
    round trip). At most 512 blocks: one wave at four blocks an SM."""
    f = combine_form(num_segs, 4, 128)
    want = {"uniform_512": (4, 512), "skewed_mix": (4, 512), "skewed_extreme": (4, 128),
            "one_64k_7x4k": (2, 128), "one_128k_31x4k": (4, 256)}[case]
    assert (f.rows_per_block, f.blocks) == want and f.col_splits == 1 and f.vec == 4
    assert capacity <= 512  # one compaction pass a block (csrc/decode.cu kCombineScan)
