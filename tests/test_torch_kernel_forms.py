"""The host-side choosers of two kernels' launches, on the CPU.

``ops/rope_kernel.py:rope_form`` picks the rope store's word width, lanes a
head and heads a block (csrc/rope_store.cu), ``ops/moe.py:reduce_form`` the
top-k reduce's threads a block (csrc/moe.cu). The kernels run only on the
card (tests/test_torch_cuda.py); these tests hold the choosers to what the
kernels assume: every element of a head's half owned by exactly one lane
and chunk, words that the pointers' alignment allows, blocks within the
launch bounds, a grid that spreads a decode step over the card, and a
RopeShape whose fields mirror the kernel's struct.
"""

from __future__ import annotations

import ctypes
import os
import re

import pytest
import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.ops.moe import REDUCE_THREADS, reduce_form
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
