"""Each CUDA kernel of the port against its plain PyTorch version.

The tests marked ``cuda`` need a card and skip without one; run them there
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(tests/conftest.py imports JAX; this file does not). The unmarked tests check
on the CPU that each wrapper takes its plain version for CPU tensors and
counts no launch.

Tolerances: attention within 1e-2 abs/rel in bf16 output (int8 slabs too:
kernel and plain version read the same codes); RoPE within one bf16 ulp
(where QK-norm runs before the rotation, in the ragged-prefill and
head-shape cases, plus 2^-22 of |n1| + |n2| of each NeoX pair: the norm's
sum in another order moves the normalised inputs by about a float32 ulp,
and where n1 * c - n2 * s cancels, the two products' roundings are many
ulps of the small result; rotation_envelope);
int8 codes equal, or one apart on at most 0.1% of them (a rounding tie);
untouched cache bytes bit-identical. e4m3 caches: attention within the same
1e-2 (kernel and plain version decode the same codes exactly, subnormals
included, which one test checks at 4e-3 on subnormal K codes and another
exactly on every V code); the fp8 store's codes on the card equal to the
CPU's, or one step apart on at most 0.1%. MoE: the grouped GEMM within one bf16
step (2^-7 relative) plus 1e-3 of the largest output (both sum exact e4m3
products in float32, in another order); activation codes equal, or one apart
on at most 0.1% (expf against torch.sigmoid); the top-k reduce bit-equal.
Task-map decode: the task kernel's float32 partials within 1e-3 abs/rel of
the plain version's on rows that saw a key (float32 sums in another order,
the card's __expf), and exactly m = -inf, l = 0, o = 0 on the others; the
combine within 1e-2 in bf16 output, as the attention kernels.
int8 MoE: both grouped GEMMs bit-equal (exact integer sums, one conversion,
one scaling, one bf16 rounding on both sides); the fused activation codes
equal (the epilogue computes as the activation kernel and the plain version
do, on the card's expf). Blockwise grouped GEMMs: int8 bit-equal (exact
int32 sums per 128-group, then the same float32 promotions in the same
order), e4m3 as the e4m3 grouped GEMM; a blockwise MoE on the card against
the CPU run within 3e-2 abs + 5e-2 rel over int8 and 5e-2 + 8e-2 over e4m3
(the tolerances of tests/test_moe.py: the activation is re-quantised
between the GEMMs, so a gate-up value one rounding apart can move a
group's codes).
"""

import ctypes
import statistics

import pytest
import torch

from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.ops.activation import act_quant, act_quant_ref
from hpc_ops_tpu_torch.ops.attention.decode import (
    _decode_combine_ref,
    _decode_nhd_fused_ref,
    _decode_qt0_ref,
    _decode_ref,
    _decode_tasks_ref,
    _hnd_views,
    attention_decode,
    decode_combine,
    paged_decode_attention,
    paged_decode_nhd_fused,
    paged_decode_qt0,
    paged_decode_tasks,
)
from hpc_ops_tpu_torch.ops.attention.paging import hnd_to_nhd, pack_kv_fused, pack_kv_fused_nhd
from hpc_ops_tpu_torch.ops.attention.scheduler import TaskMap, assign_attention_decode_task
from hpc_ops_tpu_torch.ops.attention.prefill import (
    _prefill_nhd_fused_ref,
    _prefill_ref,
    paged_prefill_attention,
    paged_prefill_nhd_fused,
)
from hpc_ops_tpu_torch.ops import group_gemm
from hpc_ops_tpu_torch.ops.group_gemm import (
    _pick_tm,
    gg_bw_aligned,
    gg_bw_aligned_ref,
    gg_bw_scatter,
    gg_bw_scatter_ref,
    gg_form,
    gg_pertensor,
    gg_pertensor_ref,
    gg_scatter,
    gg_scatter_i8,
    gg_scatter_i8_act,
    gg_scatter_ref,
)
from hpc_ops_tpu_torch.ops.moe import (
    _act_requant,
    _route_aligned,
    fuse_moe_blockwise_fp8,
    fuse_moe_blockwise_int8,
    fuse_moe_pertensor_fp8,
    fuse_moe_pertensor_int8,
    interleave_gate_up,
    moe_reduce,
    moe_reduce_ref,
)
from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache
from hpc_ops_tpu_torch.ops.rope_kernel import (
    rope_store_rows,
    rope_store_rows_int8,
    rope_store_rows_int8_ref,
    rope_store_rows_ref,
    row_slots,
)
from hpc_ops_tpu_torch.utils.testing import assert_allclose, max_bf16_ulp_err

torch.set_num_threads(1)

BS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def randn(gen, *shape):
    return torch.randn(shape, generator=gen).to(torch.bfloat16)


def paged(gen, lens, hq, hkv, d, sq=1, layout="HND", q_rows=None):
    """q, caches and a shuffled -1 padded page table covering ``lens``."""
    max_blocks = max(lens) // BS + 2
    nb = len(lens) * max_blocks + 2
    perm = torch.randperm(nb, generator=gen)
    tbl = torch.full((len(lens), max_blocks), -1, dtype=torch.int32)
    off = 0
    for i, n in enumerate(lens):
        k = -(-n // BS)
        tbl[i, :k] = perm[off : off + k]
        off += k
    shape = (hkv, nb, BS, d) if layout == "HND" else (nb, BS, hkv, d)
    rows = len(lens) * sq if q_rows is None else q_rows
    return randn(gen, rows, hq, d), randn(gen, *shape), randn(gen, *shape), tbl, torch.tensor(lens, dtype=torch.int32)


def rope_case(gen, layout, rows=8, hq=32, hkv=8, d=128, num_blocks=256):
    """A decode batch: one new row per request at a random length, each on
    its own pages of a shuffled -1 padded table."""
    qkv = randn(gen, rows, (hq + 2 * hkv) * d)
    cos_sin = make_cos_sin_cache(8192, d, 500000.0, device="cpu")
    seq_lens = torch.randint(1, 16 * (num_blocks // rows), (rows,), generator=gen, dtype=torch.int32)
    q_index = torch.arange(rows + 1, dtype=torch.int32)
    perm = torch.randperm(num_blocks, generator=gen).to(torch.int32)
    per = num_blocks // rows
    tbl = torch.cat([perm.view(rows, per), torch.full((rows, 2), -1, dtype=torch.int32)], 1)
    slots_total = num_blocks * BS
    shape = (hkv, slots_total, d) if layout == "HND" else (slots_total, hkv, d)
    w = torch.rand(d, generator=gen) + 0.5
    return (qkv, cos_sin, seq_lens, q_index, tbl, w, w), randn(gen, *shape), randn(gen, *shape), dict(
        hq=hq, hkv=hkv, d=d, dv=d, block_size=BS, head_major=layout == "HND")


def test_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(0)
    counts = (rope_store_rows.launches, paged_decode_attention.launches,
              paged_prefill_attention.launches)
    args, k0, v0, kw = rope_case(gen, "HND", hq=4, hkv=2, num_blocks=16)
    a = rope_store_rows(*args, k0.clone(), v0.clone(), qk_norm_policy=1, **kw)
    b = rope_store_rows_ref(*args, k0.clone(), v0.clone(), qk_norm_policy=1, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    q, k, v, tbl, lens = paged(gen, [5, 20], 4, 2, 64)
    assert torch.equal(paged_decode_attention(q, k, v, tbl, lens, 1, 0.1, "HND"),
                       _decode_ref(q, k, v, tbl, lens, 1, 0.1, "HND"))
    cu = torch.tensor([0, 2, 9], dtype=torch.int32)
    q = randn(gen, 11, 4, 64)
    assert torch.equal(paged_prefill_attention(q, k, v, cu, tbl, lens, 7, 0.1, "HND"),
                       _prefill_ref(q, k, v, cu, tbl, lens, 7, 0.1, "HND"))
    assert counts == (rope_store_rows.launches, paged_decode_attention.launches,
                      paged_prefill_attention.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [0, 1, 2])
@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_rope_kernel_matches_plain(cuda, layout, policy):
    gen = torch.Generator().manual_seed(1)
    args, k0, v0, kw = rope_case(gen, layout)
    dargs = [a.to(cuda) for a in args]
    kq, kk, kv = rope_store_rows(*dargs, k0.clone().to(cuda), v0.clone().to(cuda),
                                 qk_norm_policy=policy, **kw)
    pq, pk, pv = rope_store_rows_ref(*args, k0.clone(), v0.clone(), qk_norm_policy=policy, **kw)
    torch.cuda.synchronize()
    assert max_bf16_ulp_err(kq, pq) <= 1.0
    kk, kv = kk.cpu(), kv.cpu()
    _, slots = row_slots(8, args[2], args[3], args[4], BS, k0.shape[1 if layout == "HND" else 0])
    written = torch.zeros(k0.shape, dtype=torch.bool)
    if layout == "HND":
        written[:, slots] = True
    else:
        written[slots] = True
    assert torch.equal(kk[~written], k0[~written]) and torch.equal(kv[~written], v0[~written])
    assert torch.equal(kv, pv)
    assert max_bf16_ulp_err(kk[written], pk[written]) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_decode_kernel_matches_plain(cuda, layout, sq):
    gen = torch.Generator().manual_seed(2)
    lens = [1, 16, 17, 300, 1024, 4095, 3, 64]
    q, k, v, tbl, kv_lens = paged(gen, lens, 32, 8, 128, sq=sq, layout=layout)
    want = _decode_ref(q, k, v, tbl, kv_lens, sq, 128**-0.5, layout)
    got = paged_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), tbl.to(cuda),
                                 kv_lens.to(cuda), sq, 128**-0.5, layout)
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="decode")


@pytest.mark.cuda
def test_decode_kernel_ignores_nan_past_kv_len(cuda):
    """Positions at or past kv_len add nothing, even when the page holds NaN."""
    gen = torch.Generator().manual_seed(3)
    q, k, v, tbl, kv_lens = paged(gen, [3, 20], 8, 2, 128)
    want = _decode_ref(q, k, v, tbl, kv_lens, 1, 128**-0.5, "HND")
    for i, n in enumerate(kv_lens.tolist()):
        page = int(tbl[i, n // BS])
        k[:, page, n % BS :] = float("nan")
        v[:, page, n % BS :] = float("nan")
    got = paged_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), tbl.to(cuda),
                                 kv_lens.to(cuda), 1, 128**-0.5, "HND")
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="nan tail")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "layout,q_lens,kv_lens,pad",
    [("HND", [13, 7, 250], [13, 100, 300], 11), ("NHD", [13, 7, 250], [13, 100, 300], 0),
     ("HND", [1024], [1024], 0)],
)
def test_prefill_kernel_matches_plain(cuda, layout, q_lens, kv_lens, pad):
    gen = torch.Generator().manual_seed(4)
    q, k, v, tbl, kv = paged(gen, kv_lens, 32, 8, 128, layout=layout, q_rows=sum(q_lens) + pad)
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    want = _prefill_ref(q, k, v, cu, tbl, kv, max(q_lens), 128**-0.5, layout)
    got = paged_prefill_attention(q.to(cuda), k.to(cuda), v.to(cuda), cu.to(cuda), tbl.to(cuda),
                                  kv.to(cuda), max(q_lens), 128**-0.5, layout)
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="prefill")


# ------------------------------------------------------- int8 NHD_FUSED slabs
SC = torch.tensor([0.05])


def slab_case(gen, lens, hq, hkv, d, sq=1, int8=True, q_rows=None):
    """q, an NHD_FUSED slab (int8 codes or bf16), the page table and lengths."""
    q, k, v, tbl, kv_lens = paged(gen, lens, hq, hkv, d, sq=sq, q_rows=q_rows)
    slab = pack_kv_fused_nhd(k, v)
    if int8:
        slab = torch.randint(-127, 128, tuple(slab.shape), generator=gen, dtype=torch.int8)
    return q, slab, tbl, kv_lens


def int8_rope_case(gen, rows=8, pad=0, hq=32, hkv=8, d=128, num_blocks=256):
    """A decode batch into an int8 slab; ``pad`` rows past q_index[-1]."""
    args, _, _, _ = rope_case(gen, "NHD", rows=rows + pad, hq=hq, hkv=hkv, d=d,
                              num_blocks=num_blocks)
    qkv, cos_sin, seq_lens, q_index, tbl, w, _ = args
    seq_lens, q_index, tbl = seq_lens[:rows], q_index[: rows + 1], tbl[:rows]
    slab = torch.randint(-127, 128, (num_blocks, 2 * BS, hkv * d), generator=gen, dtype=torch.int8)
    scales = (torch.tensor([0.031]), torch.tensor([0.047]))
    return (qkv, cos_sin, seq_lens, q_index, tbl, w, w), slab, scales, dict(hq=hq, hkv=hkv, d=d,
                                                                            block_size=BS)


def test_int8_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(10)
    counts = (rope_store_rows_int8.launches, paged_decode_nhd_fused.launches,
              paged_prefill_nhd_fused.launches)
    args, slab, scales, kw = int8_rope_case(gen, hq=4, hkv=2, num_blocks=16)
    a = rope_store_rows_int8(*args, slab.clone(), *scales, qk_norm_policy=1, **kw)
    b = rope_store_rows_int8_ref(*args, slab.clone(), *scales, qk_norm_policy=1, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    q, slab, tbl, lens = slab_case(gen, [5, 20], 4, 2, 64)
    assert torch.equal(paged_decode_nhd_fused(q, slab, tbl, lens, 1, 0.1, SC, SC),
                       _decode_nhd_fused_ref(q, slab, tbl, lens, 1, 0.1, SC, SC))
    cu = torch.tensor([0, 2, 9], dtype=torch.int32)
    q = randn(gen, 11, 4, 64)
    assert torch.equal(paged_prefill_nhd_fused(q, slab, cu, tbl, lens, 7, 0.1, SC, SC),
                       _prefill_nhd_fused_ref(q, slab, cu, tbl, lens, 7, 0.1, SC, SC))
    assert counts == (rope_store_rows_int8.launches, paged_decode_nhd_fused.launches,
                      paged_prefill_nhd_fused.launches)


def check_int8_store(got, want, before, written):
    """Untouched bytes equal; written codes equal or one apart on <= 0.1%."""
    assert torch.equal(got[~written], before[~written])
    diff = (got[written].int() - want[written].int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [0, 1, 2])
def test_rope_int8_kernel_matches_plain(cuda, policy):
    gen = torch.Generator().manual_seed(11)
    args, slab, scales, kw = int8_rope_case(gen)
    dargs = [a.to(cuda) for a in args]
    kq, ks = rope_store_rows_int8(*dargs, slab.clone().to(cuda), *(x.to(cuda) for x in scales),
                                  qk_norm_policy=policy, **kw)
    pq, ps = rope_store_rows_int8_ref(*args, slab.clone(), *scales, qk_norm_policy=policy, **kw)
    torch.cuda.synchronize()
    assert max_bf16_ulp_err(kq, pq) <= 1.0
    _, slots = row_slots(8, args[2], args[3], args[4], BS, slab.shape[0] * 2 * BS, fused=True)
    written = torch.zeros(slab.shape[0] * 2 * BS, dtype=torch.bool)
    written[slots] = written[slots + BS] = True
    written = written.view(slab.shape[0], 2 * BS, 1).expand(slab.shape)
    check_int8_store(ks.cpu(), ps, slab, written)


@pytest.mark.cuda
def test_rope_int8_kernel_invalid_rows_clip_to_the_last_page_rows(cuda):
    """A row past q_index[-1] goes to K slot nb*2*bs - 1 - bs and V to the
    slab's last slot, as the plain version says; nothing else moves."""
    gen = torch.Generator().manual_seed(12)
    args, slab, scales, kw = int8_rope_case(gen, rows=7, pad=1)
    nb = slab.shape[0]
    _, slots = row_slots(8, args[2], args[3], args[4], BS, nb * 2 * BS, fused=True)
    assert int(slots[7]) == nb * 2 * BS - 1 - BS
    kq, ks = rope_store_rows_int8(*[a.to(cuda) for a in args], slab.clone().to(cuda),
                                  *(x.to(cuda) for x in scales), qk_norm_policy=0, **kw)
    pq, ps = rope_store_rows_int8_ref(*args, slab.clone(), *scales, qk_norm_policy=0, **kw)
    torch.cuda.synchronize()
    written = torch.zeros(nb * 2 * BS, dtype=torch.bool)
    written[slots] = written[slots + BS] = True
    written = written.view(nb, 2 * BS, 1).expand(slab.shape)
    ks = ks.cpu()
    check_int8_store(ks, ps, slab, written)
    assert not torch.equal(ks[-1, -1], slab[-1, -1])  # the V row of a pad row landed there


# ------------------------------------------- the rope store's shapes and forms
# A ragged prefill of 2048 rows: new rows a request (one request empty) and
# each request's length with them, 5 pad rows past q_index[-1]; with a
# cos|sin table of 2048 positions two requests run past its end, and the last
# request's last page is -1, so its rows there have no valid slot either.
RAGGED_Q, RAGGED_KV, RAGGED_PAD, RAGGED_POS = [700, 0, 1, 512, 300, 530], [700, 50, 4000, 1024, 300, 2600], 5, 2048
# (head_dim, Hq, Hkv): fault F5's head shapes, llama3_8b's, and two whose
# half is not a multiple of 8 (the kernel's 4-byte and 2-byte words)
ROPE_SHAPES = {"d64": (64, 32, 8), "d96": (96, 32, 8), "d128": (128, 32, 8), "d256": (256, 8, 2),
               "g128": (128, 128, 1), "d100": (100, 4, 2), "d42": (42, 4, 2)}


def ragged_rope_case(gen, q_lens, kv_lens, hq, hkv, d, pad=0, max_pos=8192, hole=True):
    """Plain-version inputs of a ragged batch over a shuffled page table with
    a few spare pages; ``hole``: the last request's last page id is -1."""
    pages = [-(-n // BS) for n in kv_lens]
    nb = sum(pages) + 3
    perm = torch.randperm(nb, generator=gen).to(torch.int32)
    tbl = torch.full((len(kv_lens), max(pages) + 2), -1, dtype=torch.int32)
    off = 0
    for i, n in enumerate(pages):
        tbl[i, :n] = perm[off : off + n]
        off += n
    if hole:
        tbl[-1, pages[-1] - 1] = -1
    qkv = randn(gen, sum(q_lens) + pad, (hq + 2 * hkv) * d)
    cos_sin = make_cos_sin_cache(max_pos, d, 500000.0, device="cpu")
    q_index = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    w = torch.rand(d, generator=gen) + 0.5
    return (qkv, cos_sin, torch.tensor(kv_lens, dtype=torch.int32), q_index, tbl, w, w), nb


def clip_candidates(args, hq, hkv, d, policy, num_slots, fused, bs=BS):
    """(slot of every row, the clip slot, K and V float32 rows [n, hkv, d] of
    the rows that land on it, their K envelopes): rows with no valid slot all
    write the clip slot, and which row's chunk wins there is a race."""
    from hpc_ops_tpu_torch.ops.rope_kernel import _rope_rows_f32

    qkv, cos_sin, seq_lens, q_index, tbl, w, _ = args
    pos, slots = row_slots(qkv.shape[0], seq_lens, q_index, tbl, bs, num_slots, fused=fused)
    clip = num_slots - 1 - (bs if fused else 0)
    _, k, v = _rope_rows_f32(qkv, cos_sin, pos, w, w, hq, hkv, d, d, policy)
    on = slots == clip
    return slots, clip, k[on], v[on], rotation_envelope(args, hq, hkv, d, policy)[1][on]


def bf16_ulp(want):
    w = want.double()
    return torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0**-126))) - 7)


def one_of(got, cands, ulps, env=None):
    """Every element of ``got`` within ``ulps`` of its bf16 ulp (ulps 0:
    equal), plus 2^-22 of ``env`` where given, of the same element of one of
    ``cands``."""
    g, c = got.double(), cands.double()
    tol = ulps * bf16_ulp(c) + (0.0 if env is None else 2.0**-22 * env.double())
    return bool(((g[None] - c).abs() <= tol).any(0).all())


def rotation_envelope(args, hq, hkv, d, policy):
    """Per row and q/k head, |n1| + |n2| of each NeoX pair (both halves) of
    what the rotation multiplies: with QK-norm before RoPE (policy 2) the
    kernel's sum of squares runs in another order than the plain version's,
    the normalised inputs differ by an ulp or so of float32, and the two
    products' roundings differ by up to 2^-24 of each product; where
    n1 * c - n2 * s cancels, that is many ulps of the small result. Zero for
    the other policies, whose rotation reads the same inputs on both sides
    (RoPE then norm scales each element: no cancellation after it).
    Returns (q [rows, hq * d], k [rows, hkv, d])."""
    from hpc_ops_tpu_torch.ops.rope_kernel import _head_rmsnorm

    qkv, w = args[0], args[5]
    rows = qkv.shape[0]
    x = qkv.float()
    q = x[:, : hq * d].reshape(rows, hq, d)
    k = x[:, hq * d : (hq + hkv) * d].reshape(rows, hkv, d)
    if policy != 2:
        return torch.zeros(rows, hq * d), torch.zeros(rows, hkv, d)

    def env(t):
        n = _head_rmsnorm(t, w).abs()
        half = n[..., : d // 2] + n[..., d // 2 :]
        return torch.cat([half, half], dim=-1)

    return env(q).reshape(rows, hq * d), env(k)


def within_ulp(got, want, env):
    """|got - want| <= one bf16 ulp of want + 2^-22 * env, element by element."""
    return bool(((got.double() - want.double()).abs() <= bf16_ulp(want) + 2.0**-22 * env.double()).all())


def cache_envelope(env_k, slots, shape, layout):
    """The K envelope [rows, hkv, d] placed as the plain version stores K."""
    out = torch.zeros(shape)
    if layout == "HND":
        out[:, slots.long()] = env_k.transpose(0, 1)
    else:
        out[slots.long()] = env_k
    return out


def check_bf16_store(got_q, got_k, got_v, want, k0, v0, cand, layout, env):
    """q and K within one bf16 ulp of the plain version (plus the rotation's
    envelope term with QK-norm before RoPE: ``rotation_envelope``), V
    bit-equal, every other cache byte unchanged; at the clip slot each
    element from one of the rows that land there."""
    pq, pk, pv = want
    slots, clip, ck, cv, ek = cand
    env_q, env_k = env
    assert within_ulp(got_q, pq, env_q)
    hnd = layout == "HND"
    written = torch.zeros(k0.shape, dtype=torch.bool)
    keep = slots[slots != clip].long()
    if hnd:
        written[:, keep] = True
    else:
        written[keep] = True
    touched = written.clone()
    if hnd:
        touched[:, clip] = True
    else:
        touched[clip] = True
    assert torch.equal(got_k[~touched], k0[~touched]) and torch.equal(got_v[~touched], v0[~touched])
    assert torch.equal(got_v[written], pv[written])
    assert within_ulp(got_k[written], pk[written], env_k[written])
    if ck.shape[0]:
        at = (lambda t: t[:, clip]) if hnd else (lambda t: t[clip])
        assert one_of(at(got_k), ck.to(torch.bfloat16), 1, ek)
        assert one_of(at(got_v), cv.to(torch.bfloat16), 0)


def check_int8_rows(got_q, got_slab, want, slab0, cand, scales, policy, env_q, bs=BS):
    """q within one bf16 ulp (plus the rotation's envelope term, as in
    check_bf16_store); codes equal with QK-norm off, else equal or one
    apart on at most 0.1%; every other slab byte unchanged; at the clip
    slots each code from one of the rows that land there."""
    from hpc_ops_tpu_torch.ops.rope_kernel import quantize_int8

    pq, ps = want
    slots, clip, ck, cv, _ = cand
    nb = slab0.shape[0]
    assert within_ulp(got_q, pq, env_q)
    flat_got, flat_want, flat0 = (t.view(nb * 2 * bs, -1) for t in (got_slab, ps, slab0))
    keep = slots[slots != clip].long()
    written = torch.zeros(nb * 2 * bs, dtype=torch.bool)
    written[keep] = written[keep + bs] = True
    touched = written.clone()
    touched[clip] = touched[clip + bs] = True
    assert torch.equal(flat_got[~touched], flat0[~touched])
    diff = (flat_got[written].int() - flat_want[written].int()).abs()
    if policy == 0:
        assert int(diff.max()) == 0
    else:
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    if ck.shape[0]:
        kc = quantize_int8(ck, 1.0 / scales[0].reshape(()).float()).view(ck.shape[0], -1)
        vc = quantize_int8(cv, 1.0 / scales[1].reshape(()).float()).view(cv.shape[0], -1)
        for got, cands in ((flat_got[clip], kc), (flat_got[clip + bs], vc)):
            assert bool(((got.int()[None] - cands.int()).abs() <= (policy != 0)).any(0).all())


def run_bf16_case(cuda, args, nb, hq, hkv, d, layout, policy):
    shape = (hkv, nb * BS, d) if layout == "HND" else (nb * BS, hkv, d)
    gen = torch.Generator().manual_seed(hq * d + policy)
    k0, v0 = randn(gen, *shape), randn(gen, *shape)
    kw = dict(hq=hq, hkv=hkv, d=d, dv=d, block_size=BS, qk_norm_policy=policy, head_major=layout == "HND")
    got = rope_store_rows(*[a.to(cuda) for a in args], k0.clone().to(cuda), v0.clone().to(cuda), **kw)
    want = rope_store_rows_ref(*args, k0.clone(), v0.clone(), **kw)
    torch.cuda.synchronize()
    cand = clip_candidates(args, hq, hkv, d, policy, nb * BS, False)
    env_q, env_k = rotation_envelope(args, hq, hkv, d, policy)
    env = (env_q, cache_envelope(env_k, cand[0], shape, layout))
    check_bf16_store(*(t.cpu() for t in got), want, k0, v0, cand, layout, env)


def run_int8_case(cuda, args, nb, hq, hkv, d, policy):
    gen = torch.Generator().manual_seed(hq * d + policy + 1)
    slab = torch.randint(-127, 128, (nb, 2 * BS, hkv * d), generator=gen, dtype=torch.int8)
    scales = (torch.tensor([0.031]), torch.tensor([0.047]))
    kw = dict(hq=hq, hkv=hkv, d=d, block_size=BS, qk_norm_policy=policy)
    got = rope_store_rows_int8(*[a.to(cuda) for a in args], slab.clone().to(cuda),
                               *(x.to(cuda) for x in scales), **kw)
    want = rope_store_rows_int8_ref(*args, slab.clone(), *scales, **kw)
    torch.cuda.synchronize()
    cand = clip_candidates(args, hq, hkv, d, policy, nb * 2 * BS, True)
    env_q = rotation_envelope(args, hq, hkv, d, policy)[0]
    check_int8_rows(*(t.cpu() for t in got), want, slab, cand, scales, policy, env_q)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [0, 1, 2])
@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_rope_kernel_ragged_prefill_matches_plain(cuda, layout, policy):
    """2048 ragged rows: an empty request, positions past the cos|sin
    table's end, pad rows and rows on a -1 page (all at the clip slot)."""
    gen = torch.Generator().manual_seed(31)
    args, nb = ragged_rope_case(gen, RAGGED_Q, RAGGED_KV, 32, 8, 128, pad=RAGGED_PAD, max_pos=RAGGED_POS)
    assert args[0].shape[0] == 2048
    run_bf16_case(cuda, args, nb, 32, 8, 128, layout, policy)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [0, 1, 2])
def test_rope_int8_kernel_ragged_prefill_matches_plain(cuda, policy):
    gen = torch.Generator().manual_seed(32)
    args, nb = ragged_rope_case(gen, RAGGED_Q, RAGGED_KV, 32, 8, 128, pad=RAGGED_PAD, max_pos=RAGGED_POS)
    run_int8_case(cuda, args, nb, 32, 8, 128, policy)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [0, 2])
@pytest.mark.parametrize("kind", ["HND", "NHD", "int8"])
@pytest.mark.parametrize("shape", list(ROPE_SHAPES))
def test_rope_kernels_head_shapes_match_plain(cuda, shape, kind, policy):
    """Every head shape at a decode batch and a small ragged prefill with a
    pad row and a -1 page; d 100 and 42 take the kernel's narrower words."""
    from hpc_ops_tpu_torch.ops.rope_kernel import rope_form

    d, hq, hkv = ROPE_SHAPES[shape]
    gen = torch.Generator().manual_seed(33 + d + hq)
    for q_lens, kv_lens, pad in (([1] * 8, [1, 17, 300, 1024, 4095, 3, 64, 2000], 0),
                                 ([5, 1, 40], [5, 90, 50], 2)):
        args, nb = ragged_rope_case(gen, q_lens, kv_lens, hq, hkv, d, pad=pad, hole=pad > 0)
        if kind == "int8":
            run_int8_case(cuda, args, nb, hq, hkv, d, policy)
        else:
            run_bf16_case(cuda, args, nb, hq, hkv, d, kind, policy)
    assert rope_form(d, hq + 2 * hkv, 8).vec == {"d100": 2, "d42": 1}.get(shape, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["qkv", "cos_sin", "cache"])
def test_rope_kernels_take_misaligned_views(cuda, view):
    """A view that starts off a 16-byte boundary takes a narrower word: the
    same results, bf16 and int8."""
    from hpc_ops_tpu_torch.ops.rope_kernel import _align

    gen = torch.Generator().manual_seed(34)
    args, nb = ragged_rope_case(gen, [3, 1, 9], [30, 7, 9], 8, 2, 128, pad=1)
    qkv, cos_sin = args[0].to(cuda), args[1].to(cuda)
    if view == "qkv":  # 2 bytes off
        qkv = torch.empty(qkv.numel() + 1, dtype=qkv.dtype, device=cuda)[1:].view(qkv.shape).copy_(qkv)
        assert _align(qkv.data_ptr()) == 2
    elif view == "cos_sin":  # 4 bytes off
        cos_sin = torch.empty(cos_sin.numel() + 1, device=cuda)[1:].view(cos_sin.shape).copy_(cos_sin)
    dargs = (qkv, cos_sin, *(a.to(cuda) for a in args[2:]))
    for int8 in (False, True):
        if int8:
            slab0 = torch.randint(-127, 128, (nb, 2 * BS, 2 * 128), generator=gen, dtype=torch.int8)
            slab = slab0.to(cuda)
            if view == "cache":  # 1 byte off
                slab = torch.empty(slab.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(slab.shape).copy_(slab)
            sc = (torch.tensor([0.03]), torch.tensor([0.05]))
            kw = dict(hq=8, hkv=2, d=128, block_size=BS, qk_norm_policy=0)
            got = rope_store_rows_int8(*dargs, slab, *(x.to(cuda) for x in sc), **kw)
            want = rope_store_rows_int8_ref(*args, slab0.clone(), *sc, **kw)
            torch.cuda.synchronize()
            check_int8_rows(*(t.cpu() for t in got), want, slab0,
                            clip_candidates(args, 8, 2, 128, 0, nb * 2 * BS, True), sc, 0,
                            torch.zeros(want[0].shape))
        else:
            k0, v0 = randn(gen, 2, nb * BS, 128), randn(gen, 2, nb * BS, 128)
            kc, vc = k0.to(cuda), v0.to(cuda)
            if view == "cache":  # 2 bytes off
                kc = torch.empty(kc.numel() + 1, dtype=kc.dtype, device=cuda)[1:].view(kc.shape).copy_(kc)
            kw = dict(hq=8, hkv=2, d=128, dv=128, block_size=BS, qk_norm_policy=0, head_major=True)
            got = rope_store_rows(*dargs, kc, vc, **kw)
            want = rope_store_rows_ref(*args, k0.clone(), v0.clone(), **kw)
            torch.cuda.synchronize()
            check_bf16_store(*(t.cpu() for t in got), want, k0, v0,
                             clip_candidates(args, 8, 2, 128, 0, nb * BS, False), "HND",
                             (torch.zeros(want[0].shape), torch.zeros(k0.shape)))


def rope_raise_cases(cuda):
    """(name, call, message) for every ValueError of the two CUDA wrappers."""
    gen = torch.Generator().manual_seed(35)
    args, nb = ragged_rope_case(gen, [3, 1], [30, 7], 4, 2, 64)
    qkv, cs, lens, qi, tbl, w, _ = (a.to(cuda) for a in args)
    k, v = randn(gen, 2, nb * BS, 64).to(cuda), randn(gen, 2, nb * BS, 64).to(cuda)
    slab = torch.zeros((nb, 2 * BS, 128), dtype=torch.int8, device=cuda)
    sc = torch.tensor([0.05], device=cuda)
    kw = dict(hq=4, hkv=2, d=64, dv=64, block_size=BS, qk_norm_policy=0, head_major=True)
    kw8 = dict(hq=4, hkv=2, d=64, block_size=BS, qk_norm_policy=0)

    def bf16(*a, **over):
        return lambda: rope_store_rows(*a, **{**kw, **over})

    def i8(*a, **over):
        return lambda: rope_store_rows_int8(*a, **{**kw8, **over})

    base = (qkv, cs, lens, qi, tbl, w, w)
    odd = qkv.t().contiguous().t()  # the same shape, not contiguous
    return [
        ("bf16 device", bf16(qkv.to("meta"), *base[1:], k, v), "unsupported device"),
        ("bf16 policy", bf16(*base, k, v, qk_norm_policy=3), "QKNormPolicy"),
        ("bf16 dtype", bf16(*base, k.float(), v), "bf16 caches only"),
        ("bf16 dv", bf16(*base, k, v, dv=32), "dv == d"),
        ("bf16 qkv shape", bf16(qkv[:, :-64].contiguous(), *base[1:], k, v), "qkv must be"),
        ("bf16 qkv layout", bf16(odd, *base[1:], k, v), "qkv must be"),
        ("bf16 caches", bf16(*base, k.transpose(0, 1).contiguous().transpose(0, 1), v), "contiguous"),
        ("bf16 cos_sin", bf16(qkv, cs[:, :32], *base[2:], k, v), "cos_sin must be"),
        ("bf16 tables", bf16(qkv, cs, lens, qi[:-1], tbl, w, w, k, v), "disagree on requests"),
        ("bf16 one device", bf16(qkv, cs, lens.cpu(), qi, tbl, w, w, k, v), "one device"),
        ("int8 device", i8(qkv.to("meta"), *base[1:], slab, sc, sc), "unsupported device"),
        ("int8 policy", i8(*base, slab, sc, sc, qk_norm_policy=3), "QKNormPolicy"),
        ("int8 dtype", i8(*base, slab.to(torch.bfloat16), sc, sc), "int8 slab"),
        ("int8 qkv shape", i8(qkv[:, :-64].contiguous(), *base[1:], slab, sc, sc), "qkv must be"),
        ("int8 slab shape", i8(*base, slab, sc, sc, block_size=8), "slab must be"),
        ("int8 slab layout", i8(*base, slab.transpose(0, 1).contiguous().transpose(0, 1), sc, sc),
         "slab must be"),
        ("int8 cos_sin", i8(qkv, cs[:, :32], *base[2:], slab, sc, sc), "cos_sin must be"),
        ("int8 tables", i8(qkv, cs, lens, qi, tbl[:1], w, w, slab, sc, sc), "disagree on requests"),
        ("int8 scales", i8(*base, slab, sc.double(), sc), "scales must be"),
        ("int8 scale size", i8(*base, slab, sc, sc.repeat(2)), "scales must be"),
        ("int8 one device", i8(*base, slab, sc, sc.cpu()), "one device"),
    ]


@pytest.mark.cuda
def test_rope_wrappers_still_raise_value_error(cuda):
    """Every ValueError the CUDA wrappers raise, bf16 and int8, still raises,
    and no launch is counted for it."""
    before = (rope_store_rows.launches, rope_store_rows_int8.launches)
    for name, call, message in rope_raise_cases(cuda):
        with pytest.raises(ValueError, match=message):
            call()
    assert (rope_store_rows.launches, rope_store_rows_int8.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("int8,sq", [(True, 1), (True, 3), (False, 1), (False, 2)])
def test_decode_nhd_fused_kernel_matches_plain(cuda, int8, sq):
    gen = torch.Generator().manual_seed(13)
    # kv_len >= sq: every draft row sees at least one key
    lens = [max(n, sq) for n in (1, 16, 17, 300, 1024, 4095, 3, 64)]
    q, slab, tbl, kv_lens = slab_case(gen, lens, 32, 8, 128, sq=sq, int8=int8)
    sc = SC if int8 else None
    want = _decode_nhd_fused_ref(q, slab, tbl, kv_lens, sq, 128**-0.5, sc, sc)
    got = paged_decode_nhd_fused(q.to(cuda), slab.to(cuda), tbl.to(cuda), kv_lens.to(cuda), sq,
                                 128**-0.5, sc, sc)
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="decode nhd_fused")


def nan_past_kv_len(slab, tbl, kv_lens):
    """Fill every K and V row at or past each request's kv_len with NaN."""
    bs = slab.shape[1] // 2
    for i, n in enumerate(kv_lens.tolist()):
        for blk in range(n // bs, tbl.shape[1]):
            page = int(tbl[i, blk])
            if page >= 0:
                start = n % bs if blk == n // bs else 0
                slab[page, start:bs] = float("nan")
                slab[page, bs + start :] = float("nan")


@pytest.mark.cuda
def test_nhd_fused_kernels_ignore_nan_past_kv_len(cuda):
    """bf16 slab with NaN past kv_len: neither kernel lets it through."""
    gen = torch.Generator().manual_seed(14)
    q, slab, tbl, kv_lens = slab_case(gen, [3, 20, 33], 8, 2, 128, int8=False)
    want = _decode_nhd_fused_ref(q, slab, tbl, kv_lens, 1, 128**-0.5, None, None)
    cu = torch.tensor([0, 3, 10, 40], dtype=torch.int32)  # chunked: 7 of 20, 30 of 33
    qp = randn(gen, 40, 8, 128)
    want_p = _prefill_nhd_fused_ref(qp, slab, cu, tbl, kv_lens, 30, 128**-0.5, None, None)
    nan_past_kv_len(slab, tbl, kv_lens)
    d = dict(device=cuda)
    got = paged_decode_nhd_fused(q.to(**d), slab.to(**d), tbl.to(**d), kv_lens.to(**d), 1,
                                 128**-0.5)
    got_p = paged_prefill_nhd_fused(qp.to(**d), slab.to(**d), cu.to(**d), tbl.to(**d),
                                    kv_lens.to(**d), 30, 128**-0.5)
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="decode nan tail")
    assert_allclose(got_p.float(), want_p.float(), atol=1e-2, rtol=1e-2, name="prefill nan tail")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q_lens,kv_lens,pad",
    [([13, 7, 250], [13, 100, 300], 11), ([512], [2048], 0), ([1024], [1024], 0)],
)
def test_prefill_nhd_fused_kernel_matches_plain(cuda, q_lens, kv_lens, pad):
    gen = torch.Generator().manual_seed(15)
    q, slab, tbl, kv = slab_case(gen, kv_lens, 32, 8, 128, q_rows=sum(q_lens) + pad)
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    want = _prefill_nhd_fused_ref(q, slab, cu, tbl, kv, max(q_lens), 128**-0.5, SC, SC)
    got = paged_prefill_nhd_fused(q.to(cuda), slab.to(cuda), cu.to(cuda), tbl.to(cuda),
                                  kv.to(cuda), max(q_lens), 128**-0.5, SC, SC)
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="prefill nhd_fused")


@pytest.mark.cuda
def test_nhd_fused_kernels_reject_a_misaligned_slab(cuda):
    gen = torch.Generator().manual_seed(16)
    q, slab, tbl, kv_lens = slab_case(gen, [20], 8, 2, 128)
    flat = torch.zeros(slab.numel() + 1, dtype=torch.int8, device=cuda)
    bad = flat[1:].view(slab.shape)  # one byte off 16-byte alignment
    d = dict(device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_nhd_fused(q.to(**d), bad, tbl.to(**d), kv_lens.to(**d), 1, 0.1)
    cu = torch.tensor([0, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        paged_prefill_nhd_fused(randn(gen, 20, 8, 128).to(**d), bad, cu, tbl.to(**d),
                                kv_lens.to(**d), 20, 0.1)


# ------------------------------------------------------------------ fp8 MoE
FP8 = torch.float8_e4m3fn


def fp8(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(FP8)


def gg_case(gen, tm, fill, k, n, groups=3, tokens=50):
    """x, weight, scales and a ragged routing: tile t holds fill[t] real rows."""
    x, w = fp8(gen, tokens, k, scale=0.25), fp8(gen, groups, n, k, scale=0.25)
    y_scale = torch.rand(groups, generator=gen) + 0.5
    grp = torch.randint(0, groups, (len(fill),), generator=gen, dtype=torch.int32)
    row_idx = torch.full((len(fill) * tm,), -1, dtype=torch.int32)
    for t, f in enumerate(fill):
        row_idx[t * tm : t * tm + f] = torch.randint(0, tokens, (f,), generator=gen, dtype=torch.int32)
    return x, w, y_scale, row_idx, grp


def assert_gemm_close(got, want, name):
    want = want.float()
    assert_allclose(got.float().cpu(), want, atol=1e-3 * float(want.abs().max()), rtol=2**-7,
                    name=name)


def ordinals(codes):
    """Signed ordinals of e4m3 or int8 codes (adjacent codes differ by 1)."""
    if codes.dtype == torch.int8:
        return codes.int()
    b = codes.view(torch.uint8).int()
    return torch.where(b >= 128, -(b & 0x7F), b & 0x7F)


def test_moe_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(20)
    counts = (gg_scatter.launches, act_quant.launches, moe_reduce.launches)
    x, w, y_scale, row_idx, grp = gg_case(gen, 32, [3, 32], 64, 48)
    assert torch.equal(gg_scatter(x, w, y_scale, row_idx, grp, 32),
                       gg_scatter_ref(x, w, y_scale, row_idx, grp, 32))
    gu, sc = randn(gen, 40, 128), torch.tensor([1.3])
    nv = torch.tensor([33], dtype=torch.int32)
    assert torch.equal(act_quant(gu, sc, True, FP8, nv).view(torch.uint8),
                       act_quant_ref(gu, sc, True, FP8, nv).view(torch.uint8))
    pos = torch.tensor([[0, -1], [5, 2]], dtype=torch.int32)
    ts = torch.rand((2, 2), generator=gen)
    assert torch.equal(moe_reduce(gu, pos, ts), moe_reduce_ref(gu, pos, ts))
    assert counts == (gg_scatter.launches, act_quant.launches, moe_reduce.launches)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tm,fill,k,n",
    [(32, [5, 32, 7, 1, 0], 256, 384),  # the 32-row block; an empty tile
     (32, [2, 2, 1], 4096, 1024),  # decode-like: two rows a tile, long K
     (64, [64, 33, 1], 512, 256),  # the 64-row block
     (160, [160, 129, 17], 256, 384),  # the 128-row block with a 32-row rest
     (512, [512, 300], 1024, 256),  # four 128-row blocks a tile
     (32, [9, 32], 208, 200),  # K and N that end inside a stage and a block
     # the m-tiles the MoE picks in serving, at Mixtral's K (gate-up 4096, down 14336)
     (64, [64, 40, 0, 17], 4096, 200),  # an empty tile; N ends inside a block of weight rows
     (128, [128, 1, 90], 14336, 256),  # a tile of one real row
     (256, [256, 200, 0, 255], 4096, 384),
     (288, [288, 257, 31, 0], 4096, 320),  # chat's: a whole 256-slot block, then 1 or 31 slots
     (512, [512, 450, 70], 14336, 136)],  # long_prompt's; N ends 8 rows into a block
)
def test_gg_scatter_kernel_matches_plain(cuda, tm, fill, k, n):
    """Against the plain version on the real slots, one launch, counted on
    the body gg_form picks (the mma.sync body at m-tiles of 32, the
    register-operand body from 64)."""
    gen = torch.Generator().manual_seed(21)
    x, w, y_scale, row_idx, grp = gg_case(gen, tm, fill, k, n)
    want = gg_scatter_ref(x, w, y_scale, row_idx, grp, tm)
    n0, body = gg_scatter.launches, group_gemm.E4M3_BODIES[gg_form(tm, "e4m3")]
    b0 = body.launches
    got = gg_scatter(*(t.to(cuda) for t in (x, w, y_scale, row_idx, grp)), tm)
    torch.cuda.synchronize()
    assert gg_scatter.launches == n0 + 1 and body.launches == b0 + 1
    valid = row_idx >= 0
    assert_gemm_close(got[valid.to(cuda)], want[valid], "gg_scatter")


@pytest.mark.cuda
def test_gg_scatter_kernel_stops_at_num_valid_tiles(cuda):
    """Tiles at or past num_valid_tiles are not computed: their rows point
    far outside x, which a block that ran would fault on; the tiles before
    are as without the count."""
    gen = torch.Generator().manual_seed(22)
    x, w, y_scale, row_idx, grp = gg_case(gen, 32, [5, 32, 7, 1], 256, 384)
    want = gg_scatter_ref(x, w, y_scale, row_idx, grp, 32)
    row_idx[64:] = 2**30
    nvt = torch.tensor([2], dtype=torch.int32, device=cuda)
    got = gg_scatter(*(t.to(cuda) for t in (x, w, y_scale, row_idx, grp)), 32, nvt)
    torch.cuda.synchronize()
    valid = (row_idx >= 0)[:64]
    assert_gemm_close(got[:64][valid.to(cuda)], want[:64][valid], "gg_scatter nvt")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [FP8, torch.int8])
@pytest.mark.parametrize("use_bf16_mul", [True, False])
def test_act_quant_kernel_matches_plain(cuda, out_dtype, use_bf16_mul):
    gen = torch.Generator().manual_seed(23)
    gu = randn(gen, 70, 2 * 1536) * 2
    sc = torch.tensor([1.7 if out_dtype == FP8 else 20.0])
    for nv in (None, torch.tensor([41], dtype=torch.int32)):
        want = act_quant_ref(gu, sc, use_bf16_mul, out_dtype, nv)
        got = act_quant(gu.to(cuda), sc.to(cuda), use_bf16_mul, out_dtype,
                        None if nv is None else nv.to(cuda))
        torch.cuda.synchronize()
        rows = slice(0, None if nv is None else int(nv))
        d = (ordinals(got.cpu()[rows]) - ordinals(want[rows])).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("has_shared", [False, True])
def test_moe_reduce_kernel_matches_plain_and_drops_nan_rows(cuda, has_shared):
    gen = torch.Generator().manual_seed(24)
    rows, s, k, h = 512, 100, 8, 4096
    x = randn(gen, rows, h)
    pos = torch.randint(1, rows, (s, k), generator=gen, dtype=torch.int32)
    pos[pos == 37] = 11
    pos[torch.rand((s, k), generator=gen) < 0.3] = -1
    pos[0] = -1  # a token with every slot dropped
    x[37] = x[0] = float("nan")  # rows that only dropped slots can point at
    ts = torch.rand((s, k), generator=gen)
    shared = randn(gen, s, h) if has_shared else None
    want = moe_reduce_ref(x, pos, ts, shared)
    got = moe_reduce(x.to(cuda), pos.to(cuda), ts.to(cuda),
                     None if shared is None else shared.to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [4096, 5120, 14336])
@pytest.mark.parametrize("tokens", [1, 8, 2048])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_moe_reduce_kernel_bit_equal_at_every_form(cuda, k, tokens, h):
    """Bit-equal to the plain version (run on the card) with and without a
    shared expert: slots dropped at random, one token with every slot
    dropped, NaN in every row no valid slot points at."""
    from hpc_ops_tpu_torch.ops.moe import reduce_form

    gen = torch.Generator(device=cuda).manual_seed(k * 1000 + tokens + h)
    rows = tokens * k + 3
    x = torch.randn((rows, h), generator=gen, device=cuda).to(torch.bfloat16)
    pos = torch.randperm(rows, generator=gen, device=cuda)[: tokens * k].view(tokens, k).to(torch.int32)
    pos[torch.rand((tokens, k), generator=gen, device=cuda) < 0.25] = -1
    pos[tokens // 2] = -1
    read = torch.zeros(rows, dtype=torch.bool, device=cuda)
    read[pos[pos >= 0].long()] = True
    x[~read] = float("nan")
    ts = torch.rand((tokens, k), generator=gen, device=cuda)
    for shared in (None, torch.randn((tokens, h), generator=gen, device=cuda).to(torch.bfloat16)):
        got = moe_reduce(x, pos, ts, shared)
        want = moe_reduce_ref(x, pos, ts, shared)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, want)
        if shared is None:
            assert not got[tokens // 2].float().any()
    assert 32 <= reduce_form(tokens, h).threads <= 256


def moe_inputs(gen, s, k, h, interm, e_local, e_total):
    return dict(
        x=fp8(gen, s, h, scale=0.2), gw=fp8(gen, e_local, 2 * interm, h), dw=fp8(gen, e_local, h, interm),
        gs=torch.rand(e_local, generator=gen) * 0.4 + 0.2,
        ds=(torch.rand(e_local, generator=gen) * 0.1 + 0.05) / 16, act=torch.tensor([16.0]),
        ids=torch.randint(0, e_total, (s, k), generator=gen, dtype=torch.int32),
        ts=torch.rand((s, k), generator=gen) / k,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("rank_ep,size_ep,s", [(0, 1, 32), (1, 4, 32), (0, 1, 512), (1, 4, 512)],
                         ids=["0-1", "1-4", "0-1-512", "1-4-512"])
def test_fuse_moe_on_the_card_syncs_nothing_and_matches_cpu(cuda, rank_ep, size_ep, s):
    """The whole pipeline on the card under sync debug mode "error": any copy
    of a count to the host would raise. Against the CPU run (plain versions)
    within 2e-2 abs + 2e-2 rel on outputs up to 4: summation order, one bf16
    rounding per GEMM and rare activation code steps. 32 tokens give a
    decode step's m-tiles of 32, 512 a prefill's of 160."""
    gen = torch.Generator().manual_seed(25)
    e_total = 16
    t = moe_inputs(gen, s, 4, 256, 256, e_total // size_ep, e_total)
    args = [t[n] for n in ("x", "gw", "dw", "gs", "ds", "act", "ids", "ts")]
    want = fuse_moe_pertensor_fp8(*args, rank_ep, e_total)
    dargs = [a.to(cuda) for a in args]
    fuse_moe_pertensor_fp8(*dargs, rank_ep, e_total)  # builds the library, warms the allocator
    torch.cuda.synchronize()
    n0 = gg_scatter.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fuse_moe_pertensor_fp8(*dargs, rank_ep, e_total)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert gg_scatter.launches == n0 + 2 and _pick_tm(s * 4 // e_total, 256) == {32: 32, 512: 160}[s]
    assert_allclose(got.float().cpu(), want.float(), atol=2e-2, rtol=2e-2, name="fuse_moe card")


@pytest.mark.cuda
def test_moe_garbage_rows_do_not_reach_the_output(cuda):
    """Empty slots and tiles past the valid count hold anything: fill them
    with NaN after each GEMM, as tests/test_moe.py does for the JAX kernel,
    and the reduced output stays finite and equal to the plain pipeline's."""
    gen = torch.Generator().manual_seed(26)
    e_local, e_total, tm = 4, 16, 32
    t = {n: v.to(cuda) for n, v in moe_inputs(gen, 40, 4, 256, 256, e_local, e_total).items()}
    row_idx, topk_pos, _, _, _, cu_tiles, grp = _route_aligned(t["ids"], e_local, 1, tm)
    nvt = cu_tiles[-1:]
    garbage = (row_idx < 0)[:, None]
    ident = torch.arange(row_idx.shape[0], dtype=torch.int32, device=cuda)
    outs = {}
    for name, gemm, act, red in (("kernel", gg_scatter, act_quant, moe_reduce),
                                 ("plain", gg_scatter_ref, act_quant_ref, moe_reduce_ref)):
        gate_up = gemm(t["x"], t["gw"], t["gs"], row_idx, grp, tm, nvt)
        gate_up = torch.where(garbage, float("nan"), gate_up.float()).to(torch.bfloat16)
        down_in = act(gate_up, t["act"], True, FP8, nvt * tm)
        down = gemm(down_in, t["dw"], t["ds"], ident, grp, tm, nvt)
        down = torch.where(garbage, float("nan"), down.float()).to(torch.bfloat16)
        outs[name] = red(down, topk_pos, t["ts"])
    torch.cuda.synchronize()
    assert int((row_idx < 0).sum()) > tm and int((topk_pos < 0).sum()) > 0
    assert torch.isfinite(outs["kernel"].float()).all()
    assert_allclose(outs["kernel"].float().cpu(), outs["plain"].float().cpu(), atol=2e-2, rtol=2e-2,
                    name="moe with NaN garbage rows")


# ------------------------------------------------------------------ int8 MoE
def i8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


def i8_case(gen, tm, fill, k, n, groups=3, tokens=50):
    """gg_case over int8 codes (standard deviation about 73), with scales that
    bring the outputs near 1."""
    x, w, _, row_idx, grp = gg_case(gen, tm, fill, k, n, groups, tokens)
    y_scale = (torch.rand(groups, generator=gen) + 0.5) / (5400.0 * k**0.5)
    return i8(gen, tokens, k), i8(gen, groups, n, k), y_scale, row_idx, grp


def test_int8_moe_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(40)
    counts = (gg_scatter_i8.launches, gg_scatter_i8_act.launches, gg_pertensor.launches)
    x, w, y_scale, row_idx, grp = i8_case(gen, 32, [3, 32], 64, 256)
    args = (x, w, y_scale, row_idx, grp, 32)
    assert torch.equal(gg_scatter(*args), gg_scatter_ref(*args))
    act = dict(act_fuse=True, act_scale=torch.tensor([20.0]))
    assert torch.equal(gg_scatter(*args, **act), gg_scatter_ref(*args, **act))
    x_al, blk = i8(gen, 96, 64), torch.tensor([2, 0], dtype=torch.int32)
    assert torch.equal(gg_pertensor(x_al, w, y_scale, grp, blk, 32),
                       gg_pertensor_ref(x_al, w, y_scale, grp, blk, 32))
    assert counts == (gg_scatter_i8.launches, gg_scatter_i8_act.launches, gg_pertensor.launches)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tm,fill,k,n",
    [(32, [5, 32, 7, 1, 0], 256, 384),  # the 32-row block; an empty tile
     (32, [2, 2, 1], 4096, 1024),  # decode-like: two rows a tile, long K
     (64, [64, 33, 1], 512, 256),  # the 64-row block
     (160, [160, 129, 17], 256, 384),  # the 128-row block with a 32-row rest
     (512, [512, 300], 1024, 256),  # four 128-row blocks a tile
     (32, [9, 32], 208, 200)],  # K and N that end inside a stage and a block
)
def test_gg_scatter_i8_kernel_matches_plain(cuda, tm, fill, k, n):
    gen = torch.Generator().manual_seed(41)
    x, w, y_scale, row_idx, grp = i8_case(gen, tm, fill, k, n)
    want = gg_scatter_ref(x, w, y_scale, row_idx, grp, tm)
    n0 = gg_scatter_i8.launches
    got = gg_scatter(*(t.to(cuda) for t in (x, w, y_scale, row_idx, grp)), tm)
    torch.cuda.synchronize()
    assert gg_scatter_i8.launches == n0 + 1
    valid = row_idx >= 0
    assert float(want[valid].float().abs().max()) > 1.0
    assert torch.equal(got.cpu()[valid], want[valid])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tm,fill,k,n,pair",
    [(32, [5, 32, 7, 1, 0], 256, 512, 256),  # tiny_config's expert: pair 256
     (32, [2, 2, 1], 4096, 1024, 512),  # decode-like, the widest pair
     (64, [64, 33, 1], 512, 512, 128),
     (160, [160, 129, 17], 256, 256, 64),  # the 128-row block, the narrowest pair
     (512, [512, 300], 1024, 1024, 256)],
)
@pytest.mark.parametrize("use_bf16_mul", [True, False])
def test_gg_scatter_i8_act_kernel_matches_plain(cuda, tm, fill, k, n, pair, use_bf16_mul):
    gen = torch.Generator().manual_seed(42)
    x, w, y_scale, row_idx, grp = i8_case(gen, tm, fill, k, n)
    kw = dict(act_fuse=True, act_scale=torch.tensor([40.0]), use_bf16_mul=use_bf16_mul, pair=pair)
    want = gg_scatter_ref(x, w, y_scale, row_idx, grp, tm, **kw)
    n0 = gg_scatter_i8_act.launches
    kw["act_scale"] = kw["act_scale"].to(cuda)
    got = gg_scatter(*(t.to(cuda) for t in (x, w, y_scale, row_idx, grp)), tm, **kw)
    torch.cuda.synchronize()
    assert gg_scatter_i8_act.launches == n0 + 1
    assert got.dtype == torch.int8 and tuple(got.shape) == ((len(fill) + 1) * tm, n // 2)
    valid = row_idx >= 0
    codes = want[: len(fill) * tm][valid]
    assert int(codes.abs().max()) > 60 and float((codes.abs() == 127).float().mean()) < 0.05
    assert torch.equal(got.cpu()[: len(fill) * tm][valid], codes)


@pytest.mark.cuda
def test_gg_scatter_i8_act_kernel_stops_at_num_valid_tiles(cuda):
    """As test_gg_scatter_kernel_stops_at_num_valid_tiles, for the fused
    epilogue: rows of skipped tiles point far outside x."""
    gen = torch.Generator().manual_seed(43)
    x, w, y_scale, row_idx, grp = i8_case(gen, 32, [5, 32, 7, 1], 256, 512)
    kw = dict(act_fuse=True, act_scale=torch.tensor([40.0]))
    want = gg_scatter_ref(x, w, y_scale, row_idx, grp, 32, **kw)
    row_idx[64:] = 2**30
    nvt = torch.tensor([2], dtype=torch.int32, device=cuda)
    kw["act_scale"] = kw["act_scale"].to(cuda)
    got = gg_scatter(*(t.to(cuda) for t in (x, w, y_scale, row_idx, grp)), 32, nvt, **kw)
    torch.cuda.synchronize()
    valid = (row_idx >= 0)[:64]
    assert torch.equal(got.cpu()[:64][valid], want[:64][valid])


@pytest.mark.cuda
@pytest.mark.parametrize("tm,k,n", [(32, 4096, 1024), (64, 512, 256), (160, 256, 384),
                                    (512, 1024, 256), (32, 208, 200),
                                    # the MoE's serving m-tiles at Mixtral's K
                                    (64, 4096, 200), (128, 14336, 256), (256, 4096, 384),
                                    (288, 4096, 320), (512, 14336, 136)])
@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_gg_pertensor_kernel_matches_plain(cuda, dtype, tm, k, n):
    """Tiles write row blocks in another order than theirs, the last valid
    one the trash block; tiles past num_valid_tiles point at a block they
    must not write. e4m3 launches are counted on the body gg_form picks."""
    gen = torch.Generator().manual_seed(44)
    num_tiles, nvt = 4, 3
    rows = (num_tiles + 1) * tm
    if dtype == "int8":
        x, w = i8(gen, rows, k), i8(gen, 3, n, k)
        y_scale = (torch.rand(3, generator=gen) + 0.5) / (5400.0 * k**0.5)
    else:
        x, w = fp8(gen, rows, k, scale=0.25), fp8(gen, 3, n, k, scale=0.25)
        y_scale = torch.rand(3, generator=gen) + 0.5
    grp = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    blk = torch.tensor([1, 0, 4, 2], dtype=torch.int32)
    nv = torch.tensor([nvt], dtype=torch.int32)
    want = gg_pertensor_ref(x, w, y_scale, grp, blk, tm, nv)
    n0, bodies = gg_pertensor.launches, {f: b.launches for f, b in group_gemm.E4M3_BODIES.items()}
    got = gg_pertensor(*(t.to(cuda) for t in (x, w, y_scale, grp, blk)), tm, nv.to(cuda))
    torch.cuda.synchronize()
    assert gg_pertensor.launches == n0 + 1
    chosen = gg_form(tm, dtype) if dtype == "e4m3" else None
    assert {f: b.launches - bodies[f] for f, b in group_gemm.E4M3_BODIES.items()} == {
        f: int(f == chosen) for f in bodies}
    written = torch.zeros(rows, dtype=torch.bool)
    for t in range(nvt):
        written[int(blk[t]) * tm : (int(blk[t]) + 1) * tm] = True
    got = got.cpu()
    assert float(want[written].float().abs().max()) > 0.5
    if dtype == "int8":
        assert torch.equal(got[written], want[written])
    else:
        assert_gemm_close(got[written], want[written], "gg_pertensor e4m3")


def int8_moe_inputs(gen, s, k, h, interm, e_local, e_total):
    """moe_inputs over int8 codes: gate and up near 1, activation codes near
    the int8 range at act_scale 40 (a few saturate), outputs near 1."""
    return dict(
        x=i8(gen, s, h), gw=i8(gen, e_local, 2 * interm, h), dw=i8(gen, e_local, h, interm),
        gs=(torch.rand(e_local, generator=gen) + 0.5) / (5400.0 * h**0.5),
        ds=(torch.rand(e_local, generator=gen) + 0.5) / (73.0 * interm**0.5 * 40.0 * 0.5),
        act=torch.tensor([40.0]),
        ids=torch.randint(0, e_total, (s, k), generator=gen, dtype=torch.int32),
        ts=torch.rand((s, k), generator=gen) / k,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("rank_ep,size_ep", [(0, 1), (1, 2)])
def test_fuse_moe_int8_on_the_card_syncs_nothing_and_matches_cpu(cuda, rank_ep, size_ep, fused):
    """The int8 pipeline (fused: activation in the gate-up GEMM, aligned down
    GEMM) on the card under sync debug mode "error", against the CPU run of
    the plain versions within 2e-2 abs + 2e-2 rel: the GEMMs are exact on
    both, and the CPU's expf may move an activation code by one step."""
    gen = torch.Generator().manual_seed(45)
    e_total = 8
    t = int8_moe_inputs(gen, 40, 2, 256, 256, e_total // size_ep, e_total)
    if fused:
        t["gw"] = interleave_gate_up(t["gw"])
    args = [t[n] for n in ("x", "gw", "dw", "gs", "ds", "act", "ids", "ts")]
    kw = dict(gate_up_interleaved=fused)
    want = fuse_moe_pertensor_int8(*args, rank_ep, e_total, **kw)
    dargs = [a.to(cuda) for a in args]
    fuse_moe_pertensor_int8(*dargs, rank_ep, e_total, **kw)  # builds the library, warms the allocator
    torch.cuda.synchronize()
    counts = (gg_scatter_i8.launches, gg_scatter_i8_act.launches, gg_pertensor.launches,
              act_quant.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fuse_moe_pertensor_int8(*dargs, rank_ep, e_total, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(counts, (
        gg_scatter_i8.launches, gg_scatter_i8_act.launches, gg_pertensor.launches,
        act_quant.launches)))
    assert launched == ((0, 1, 1, 0) if fused else (2, 0, 0, 1))
    assert float(want.float().abs().max()) > 0.2
    assert_allclose(got.float().cpu(), want.float(), atol=2e-2, rtol=2e-2, name="int8 moe card")


@pytest.mark.cuda
def test_moe_int8_fused_garbage_rows_do_not_reach_the_output(cuda):
    """test_moe_garbage_rows_do_not_reach_the_output for the fused int8 path:
    the codes of empty slots and of the trash tile are set to -127 after the
    gate-up GEMM, and the down GEMM's rows of empty slots, skipped tiles and
    the trash tile to NaN; the reduced output stays finite and equal to the
    plain chain's."""
    gen = torch.Generator().manual_seed(46)
    e_local, e_total, tm = 4, 16, 32
    t = {n: v.to(cuda) for n, v in int8_moe_inputs(gen, 40, 4, 256, 256, e_local, e_total).items()}
    gw = interleave_gate_up(t["gw"])
    row_idx, topk_pos, _, _, _, cu_tiles, grp = _route_aligned(t["ids"], e_local, 1, tm)
    nvt = cu_tiles[-1:]
    nt = grp.shape[0]
    ar = torch.arange(nt, dtype=torch.int32, device=cuda)
    row_blk = torch.where(ar < nvt, ar, nt)
    garbage = torch.cat([row_idx < 0, torch.ones(tm, dtype=torch.bool, device=cuda)])[:, None]
    outs = {}
    for name, gemm, aligned, red in (("kernel", gg_scatter, gg_pertensor, moe_reduce),
                                     ("plain", gg_scatter_ref, gg_pertensor_ref, moe_reduce_ref)):
        codes = gemm(t["x"], gw, t["gs"], row_idx, grp, tm, nvt, act_fuse=True, act_scale=t["act"])
        codes = torch.where(garbage, torch.full_like(codes, -127), codes)
        down = aligned(codes, t["dw"], t["ds"], grp, row_blk, tm, nvt)
        down = torch.where(garbage, float("nan"), down.float()).to(torch.bfloat16)
        outs[name] = red(down, topk_pos, t["ts"])
    torch.cuda.synchronize()
    assert int((row_idx < 0).sum()) > tm and int((topk_pos < 0).sum()) > 0
    assert int(nvt) < nt  # skipped tiles exist
    assert torch.isfinite(outs["kernel"].float()).all()
    assert torch.equal(outs["kernel"].cpu(), outs["plain"].cpu())


# ------------------------------------------------------------ blockwise MoE
def bw_scales(gen, rows, k, groups, n, pad=0):
    """Per-(row, 128-group) x scales and per-block w scales near 1/73 (int8
    codes) or 1 (e4m3), with ``pad`` unread columns."""
    sx = (torch.rand(rows, k // 128 + pad, generator=gen) + 0.5) / 73.0
    sw = (torch.rand(groups, n // 128, k // 128 + pad, generator=gen) + 0.5) / (k**0.5)
    return sx, sw


def bw_case(gen, dtype, tm, fill, k, n, groups=3, tokens=50, pad=0):
    """gg_case with blockwise scales: int8 codes or e4m3 values, outputs near 1."""
    _, _, _, row_idx, grp = gg_case(gen, tm, fill, 128, 128, groups, tokens)
    if dtype == "int8":
        x, w = i8(gen, tokens, k), i8(gen, groups, n, k)
    else:
        x, w = fp8(gen, tokens, k, scale=8.0), fp8(gen, groups, n, k, scale=8.0)
    sx, sw = bw_scales(gen, tokens, k, groups, n, pad)
    if dtype != "int8":
        sx, sw = sx * 73.0 / 8.0, sw / 8.0
    return x, w, sx, sw, row_idx, grp


def assert_bw_equal(got, want, dtype, name):
    if dtype == "int8":
        assert torch.equal(got.cpu(), want), name
    else:
        assert_gemm_close(got, want, name)


def test_blockwise_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(60)
    counts = (gg_bw_scatter.launches, gg_bw_aligned.launches)
    x, w, sx, sw, row_idx, grp = bw_case(gen, "int8", 32, [3, 32], 256, 128)
    assert torch.equal(gg_bw_scatter(x, w, sx, sw, row_idx, grp, 32),
                       gg_bw_scatter_ref(x, w, sx, sw, row_idx, grp, 32))
    x_al, blk = i8(gen, 96, 256), torch.tensor([2, 0], dtype=torch.int32)
    sx_al = bw_scales(gen, 96, 256, 3, 128)[0]
    assert torch.equal(gg_bw_aligned(x_al, w, sx_al, sw, grp, blk, 32),
                       gg_bw_aligned_ref(x_al, w, sx_al, sw, grp, blk, 32))
    assert counts == (gg_bw_scatter.launches, gg_bw_aligned.launches)


BW_SHAPES = [
    (32, [5, 32, 7, 1, 0], 256, 384, 0),  # the 32-row block; an empty tile
    (32, [2, 2, 1], 4096, 1024, 0),  # decode-like: two rows a tile, long K
    (64, [64, 33, 1], 512, 256, 3),  # the 64-row block; padded scale columns
    (160, [160, 129, 17], 256, 384, 0),  # three 64-row blocks a tile, the last ragged
    (512, [512, 300], 1024, 256, 1),  # eight 64-row blocks a tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("tm,fill,k,n,pad", BW_SHAPES)
@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_gg_bw_scatter_kernel_matches_plain(cuda, dtype, tm, fill, k, n, pad):
    gen = torch.Generator().manual_seed(61)
    x, w, sx, sw, row_idx, grp = bw_case(gen, dtype, tm, fill, k, n, pad=pad)
    want = gg_bw_scatter_ref(x, w, sx, sw, row_idx, grp, tm)
    n0 = gg_bw_scatter.launches
    got = gg_bw_scatter(*(t.to(cuda) for t in (x, w, sx, sw, row_idx, grp)), tm)
    torch.cuda.synchronize()
    assert gg_bw_scatter.launches == n0 + 1
    valid = row_idx >= 0
    assert float(want[valid].float().abs().max()) > 1.0
    assert_bw_equal(got[valid.to(cuda)], want[valid], dtype, f"gg_bw_scatter {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("tm,k,n", [(32, 4096, 1024), (64, 512, 256), (160, 256, 384), (512, 1024, 256)])
@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_gg_bw_aligned_kernel_matches_plain(cuda, dtype, tm, k, n):
    """As test_gg_pertensor_kernel_matches_plain: tiles write row blocks out
    of order, the last valid one the trash block; tiles past
    num_valid_tiles point at a block they must not write."""
    gen = torch.Generator().manual_seed(62)
    num_tiles, nvt = 4, 3
    rows = (num_tiles + 1) * tm
    x, w, _, sw, _, _ = bw_case(gen, dtype, tm, [1], k, n, tokens=rows)
    sx_al = bw_scales(gen, rows, k, 3, n)[0] * (1.0 if dtype == "int8" else 73.0 / 8.0)
    grp = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    blk = torch.tensor([1, 0, 4, 2], dtype=torch.int32)
    nv = torch.tensor([nvt], dtype=torch.int32)
    want = gg_bw_aligned_ref(x, w, sx_al, sw, grp, blk, tm, nv)
    n0 = gg_bw_aligned.launches
    got = gg_bw_aligned(*(t.to(cuda) for t in (x, w, sx_al, sw, grp, blk)), tm, nv.to(cuda))
    torch.cuda.synchronize()
    assert gg_bw_aligned.launches == n0 + 1
    written = torch.zeros(rows, dtype=torch.bool)
    for t in range(nvt):
        written[int(blk[t]) * tm : (int(blk[t]) + 1) * tm] = True
    assert float(want[written].float().abs().max()) > 0.5
    assert_bw_equal(got.cpu()[written], want[written], dtype, f"gg_bw_aligned {dtype}")


@pytest.mark.cuda
def test_gg_bw_scatter_kernel_stops_at_num_valid_tiles(cuda):
    """Rows of skipped tiles point far outside x and its scales."""
    gen = torch.Generator().manual_seed(63)
    x, w, sx, sw, row_idx, grp = bw_case(gen, "int8", 32, [5, 32, 7, 1], 256, 384)
    want = gg_bw_scatter_ref(x, w, sx, sw, row_idx, grp, 32)
    row_idx[64:] = 2**30
    nvt = torch.tensor([2], dtype=torch.int32, device=cuda)
    got = gg_bw_scatter(*(t.to(cuda) for t in (x, w, sx, sw, row_idx, grp)), 32, nvt)
    torch.cuda.synchronize()
    valid = (row_idx >= 0)[:64]
    assert torch.equal(got.cpu()[:64][valid], want[:64][valid])


def bw_moe_inputs(gen, dtype, s, k, h, interm, e_local, e_total):
    """Blockwise MoE operands: x and experts quantised per group and block
    from Gaussians, outputs near 0.1-1."""
    from hpc_ops_tpu_torch.ops.quant import blockwise_fp8_quant, blockwise_int8_quant

    quant = blockwise_int8_quant if dtype == "int8" else blockwise_fp8_quant
    top = 127.0 if dtype == "int8" else 448.0

    def experts(n, kk):
        wf = torch.randn((e_local, n, kk), generator=gen) / kk**0.5
        blocks = wf.view(e_local, n // 128, 128, kk // 128, 128)
        sw = blocks.abs().amax(dim=(2, 4)) / top + 1e-8
        q = blocks / sw[:, :, None, :, None]
        q = q.round().clamp(-127, 127).to(torch.int8) if dtype == "int8" else q.to(FP8)
        return q.view(e_local, n, kk), sw

    x8, sx = quant(torch.randn((s, h), generator=gen))
    gw, gsw = experts(2 * interm, h)
    dw, dsw = experts(h, interm)
    return dict(x=x8, sx=sx, gw=gw, gsw=gsw, dw=dw, dsw=dsw,
                ids=torch.randint(0, e_total, (s, k), generator=gen, dtype=torch.int32),
                ts=torch.rand((s, k), generator=gen) / k)


BW_NAMES = ("x", "sx", "gw", "gsw", "dw", "dsw", "ids", "ts")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["scatter", "prescale"])
@pytest.mark.parametrize("rank_ep,size_ep", [(0, 1), (1, 2)])
@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_fuse_moe_blockwise_on_the_card_syncs_nothing_and_matches_cpu(cuda, dtype, rank_ep, size_ep,
                                                                       scheme):
    """The blockwise pipeline on the card under sync debug mode "error":
    one scatter and one aligned GEMM (scatter) or two aligned GEMMs, and one
    reduce; against the CPU run of the plain versions (module docstring)."""
    gen = torch.Generator().manual_seed(64)
    e_total = 8
    t = bw_moe_inputs(gen, dtype, 40, 2, 256, 256, e_total // size_ep, e_total)
    fn = fuse_moe_blockwise_int8 if dtype == "int8" else fuse_moe_blockwise_fp8
    args = [t[n] for n in BW_NAMES]
    want = fn(*args, rank_ep, e_total, scheme=scheme)
    dargs = [a.to(cuda) for a in args]
    fn(*dargs, rank_ep, e_total, scheme=scheme)  # builds the library, warms the allocator
    torch.cuda.synchronize()
    counts = (gg_bw_scatter.launches, gg_bw_aligned.launches, moe_reduce.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*dargs, rank_ep, e_total, scheme=scheme)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(counts, (gg_bw_scatter.launches, gg_bw_aligned.launches,
                                                     moe_reduce.launches)))
    assert launched == ((1, 1, 1) if scheme == "scatter" else (0, 2, 1))
    assert float(want.float().abs().max()) > 0.1
    atol, rtol = (3e-2, 5e-2) if dtype == "int8" else (5e-2, 8e-2)
    assert_allclose(got.float().cpu(), want.float(), atol=atol, rtol=rtol, name=f"{dtype} bw moe card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_moe_blockwise_garbage_rows_do_not_reach_the_output(cuda, dtype):
    """The scatter pipeline's stages chained by hand, with the gate-up rows of
    empty slots and skipped tiles and then the down rows set to NaN: the
    reduced output stays finite and equal to the plain chain's (int8) or
    within the e4m3 tolerance."""
    from hpc_ops_tpu_torch.ops.quant import blockwise_fp8_quant, blockwise_int8_quant

    gen = torch.Generator().manual_seed(65)
    e_local, e_total, tm = 4, 16, 32
    t = {n: v.to(cuda) for n, v in bw_moe_inputs(gen, dtype, 40, 4, 256, 256, e_local, e_total).items()}
    quant = blockwise_int8_quant if dtype == "int8" else blockwise_fp8_quant
    row_idx, topk_pos, _, _, _, cu_tiles, grp = _route_aligned(t["ids"], e_local, 1, tm)
    nvt = cu_tiles[-1:]
    ar = torch.arange(grp.shape[0], dtype=torch.int32, device=cuda)
    garbage = (row_idx < 0)[:, None]
    outs = {}
    for name, scat, al, red in (("kernel", gg_bw_scatter, gg_bw_aligned, moe_reduce),
                                ("plain", gg_bw_scatter_ref, gg_bw_aligned_ref, moe_reduce_ref)):
        gu = scat(t["x"], t["gw"], t["sx"], t["gsw"], row_idx, grp, tm, nvt)
        gu = torch.where(garbage, float("nan"), gu.float()).to(torch.bfloat16)
        d_in, d_sx = _act_requant(gu, quant)
        down = al(d_in, t["dw"], d_sx, t["dsw"], grp, ar, tm, nvt)
        down = torch.where(garbage, float("nan"), down.float()).to(torch.bfloat16)
        outs[name] = red(down, topk_pos, t["ts"])
    torch.cuda.synchronize()
    assert int((row_idx < 0).sum()) > tm and int((topk_pos < 0).sum()) > 0
    assert int(nvt) < grp.shape[0]  # skipped tiles exist
    assert torch.isfinite(outs["kernel"].float()).all()
    if dtype == "int8":
        assert torch.equal(outs["kernel"].cpu(), outs["plain"].cpu())
    else:
        assert_allclose(outs["kernel"].float().cpu(), outs["plain"].float().cpu(), atol=5e-2,
                        rtol=8e-2, name="e4m3 bw moe garbage")


# --------------------------------- the grouped GEMMs on wgmma: tiling edges
# name: (tm, real rows of each tile, K, N, group of each tile, num_valid_tiles)
WG_CASES = {
    "tm512_k4096": (512, [512, 300], 4096, 256, [0, 2], None),
    # same-sign products at the type's bound: an unpromoted fp8 sum drifts
    "k14336_bound": (64, [64, 17], 14336, 256, [1, 0], None),
    "two_tiles_tm64": (64, [64, 40], 512, 384, [1, 1], None),  # two m-tiles of one expert
    "empty_half": (256, [256, 30], 256, 256, [2, 2], None),  # 64-row halves with no real row
    "nvt_mid": (128, [128, 70, 128, 9], 256, 256, [0, 1, 1, 2], 2),  # stops mid-grid
    "decode_tm32": (32, [2, 3, 1], 4096, 256, [0, 1, 2], None),  # a decode step's m-tiles
}
WG_FORMS = ("scatter_e4m3", "scatter_i8", "scatter_i8_act", "pertensor_e4m3", "pertensor_i8",
            "bw_scatter_e4m3", "bw_scatter_i8", "bw_aligned_e4m3", "bw_aligned_i8")
WG_PARAMS = ([(f, c, None) for f in WG_FORMS for c in WG_CASES]
             + [("scatter_i8_act", "two_tiles_tm64", pair) for pair in (64, 128)])


def wg_values(gen, i8_ops, shape, bound):
    """int8 codes or e4m3 values; at the bound, positive ones near it."""
    if i8_ops:
        return torch.randint(100 if bound else -127, 128, shape, generator=gen, dtype=torch.int8)
    if bound:
        return (torch.rand(shape, generator=gen) * 192.0 + 256.0).to(FP8)
    return fp8(gen, *shape, scale=8.0)


def wg_case(form, case, pair):
    """(wrapper, launching wrapper, its args, the plain version's args, kw,
    plain function, rows to compare) of one grouped-GEMM form at one WG_CASES
    edge, CPU tensors."""
    gen = torch.Generator().manual_seed(64)
    tm, fill, k, n, tile_grp, nvt = WG_CASES[case]
    act = form == "scatter_i8_act"
    if act:  # whole interleave blocks of 2 * pair rows
        pair = pair or 128
        n = 2 * pair * max(1, n // (2 * pair))
    i8_ops, bound = form.endswith(("i8", "act")), case == "k14336_bound"
    nt, groups, tokens = len(fill), 3, max(600, 2 * sum(fill))
    grp = torch.tensor(tile_grp, dtype=torch.int32)
    w = wg_values(gen, i8_ops, (groups, n, k), bound)
    std = 114.0 if bound else (73.0 if i8_ops else 8.0)  # of the values' magnitude
    nv = None if nvt is None else torch.tensor([nvt], dtype=torch.int32)
    n_valid = nt if nvt is None else nvt
    if form.startswith(("pertensor", "bw_aligned")):
        x = wg_values(gen, i8_ops, ((nt + 1) * tm, k), bound)
        blk = torch.tensor([nt - t for t in range(nt)], dtype=torch.int32)
        if nvt is not None:  # skipped tiles point at a valid tile's block: a write would show
            blk[nvt:] = blk[0]
        rows = torch.zeros((nt + 1) * tm, dtype=torch.bool)
        for t in range(n_valid):
            rows[int(blk[t]) * tm : (int(blk[t]) + 1) * tm] = True
    else:
        x = wg_values(gen, i8_ops, (tokens, k), bound)
        row_idx = torch.full((nt * tm,), -1, dtype=torch.int32)
        for t, f in enumerate(fill):
            row_idx[t * tm : t * tm + f] = torch.randint(0, tokens, (f,), generator=gen,
                                                         dtype=torch.int32)
        rows = (row_idx >= 0) & (torch.arange(nt * tm) < n_valid * tm)
        plain_idx, row_idx = row_idx, row_idx.clone()
        if nvt is not None:  # rows of skipped tiles point far outside x
            row_idx[nvt * tm :] = 2**30
    if form.startswith("bw"):
        sx, sw = bw_scales(gen, x.shape[0], k, groups, n)
        if not i8_ops:
            sx = sx * 73.0 / std
        if form.startswith("bw_scatter"):
            return (gg_bw_scatter, gg_bw_scatter, (x, w, sx, sw, row_idx, grp, tm, nv),
                    (x, w, sx, sw, plain_idx, grp, tm, nv), {}, gg_bw_scatter_ref, rows)
        args = (x, w, sx, sw, grp, blk, tm, nv)
        return gg_bw_aligned, gg_bw_aligned, args, args, {}, gg_bw_aligned_ref, rows
    y_scale = (torch.rand(groups, generator=gen) + 0.5) / (std * std * (k if bound else k**0.5))
    if form.startswith("pertensor"):
        args = (x, w, y_scale, grp, blk, tm, nv)
        return gg_pertensor, gg_pertensor, args, args, {}, gg_pertensor_ref, rows
    kw = dict(act_fuse=True, act_scale=torch.tensor([20.0]), pair=pair) if act else {}
    launched = gg_scatter_i8_act if act else (gg_scatter_i8 if i8_ops else gg_scatter)
    return (gg_scatter, launched, (x, w, y_scale, row_idx, grp, tm, nv),
            (x, w, y_scale, plain_idx, grp, tm, nv), kw, gg_scatter_ref, rows)


def form_kind(form):
    """The ``kind`` that :func:`gg_form` takes for a WG_FORMS form."""
    return ("int8" if form in ("scatter_i8", "scatter_i8_act", "pertensor_i8")
            else "blockwise" if form.startswith("bw") else "e4m3")


def record_forms(monkeypatch, force=None):
    """Patch the wrappers' gg_form to record (tm, kind, its value) for every
    launch, and to return ``force`` where it is given."""
    seen, chosen = [], group_gemm.gg_form

    def form(tm, kind):
        seen.append((tm, kind, chosen(tm, kind) if force is None else force))
        return seen[-1][2]

    monkeypatch.setattr(group_gemm, "gg_form", form)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("form,case,pair", WG_PARAMS)
def test_gg_wgmma_matches_plain(cuda, monkeypatch, form, case, pair):
    """Every form at the edges of its tiling against the plain version (int8
    bit-equal, act codes equal, e4m3 within one bf16 step plus 1e-3 of the
    largest output), one launch, the body and block height gg_form picks."""
    kind, tm = form_kind(form), WG_CASES[case][0]
    fn, launched, args, plain_args, kw, plain, rows = wg_case(form, case, pair)
    want = plain(*plain_args, **kw)
    n0 = launched.launches
    kw_dev = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()}
    seen = record_forms(monkeypatch)
    got = fn(*(a.to(cuda) if torch.is_tensor(a) else a for a in args), **kw_dev)
    torch.cuda.synchronize()
    assert launched.launches == n0 + 1 and seen == [(tm, kind, gg_form(tm, kind))]
    got = got.cpu()[: rows.shape[0]][rows]
    want = want[: rows.shape[0]][rows]
    if form == "scatter_i8_act":
        assert int(want.abs().max()) > 10 and float((want.abs() == 127).float().mean()) < 0.5
    else:
        assert float(want.float().abs().max()) > 0.5
    if form.endswith(("i8", "act")):
        assert torch.equal(got, want), f"{form} {case}: differs from the plain version"
    else:
        assert_gemm_close(got, want, f"{form} {case}")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scatter_e4m3", "pertensor_e4m3", "scatter_i8_act", "pertensor_i8",
                                  "bw_scatter_i8", "bw_aligned_e4m3"])
def test_gg_block_heights_agree(cuda, monkeypatch, form):
    """Every body and block a form has (one warpgroup; two for the int8
    per-tensor forms; the mma.sync body's blocks of 32 rows and the
    register-operand body's of 256 slots for the e4m3 per-tensor forms),
    forced through gg_form, gives the plain version's function on one input
    (m-tiles of 256: one block of 256 slots, two of 128 rows, four of 64,
    eight of 32)."""
    fn, launched, args, plain_args, kw, plain, rows = wg_case(form, "empty_half", None)
    want = plain(*plain_args, **kw)[: rows.shape[0]][rows]
    dev_args = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    kw_dev = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()}
    wgs = {"blockwise": (1,), "int8": (1, 2), "e4m3": (0, 3)}[form_kind(form)]
    for wg in wgs:
        seen = record_forms(monkeypatch, force=wg)
        got = fn(*dev_args, **kw_dev)
        torch.cuda.synchronize()
        assert seen == [(256, form_kind(form), wg)]
        got = got.cpu()[: rows.shape[0]][rows]
        if form.endswith(("i8", "act")):
            assert torch.equal(got, want), f"{form} wg {wg}"
        else:
            assert_gemm_close(got, want, f"{form} wg {wg}")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scatter_e4m3", "pertensor_e4m3"])
def test_gg_e4m3_pertensor_forms_have_no_8bit_wgmma_body(cuda, monkeypatch, form):
    """The e4m3 per-tensor forms run on their two bodies only (0 and 3): the
    8-bit wgmma body's forms (1 and 2) are refused at launch."""
    fn, _, args, _, kw, _, _ = wg_case(form, "two_tiles_tm64", None)
    dev_args = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    for wg in (1, 2):
        record_forms(monkeypatch, force=wg)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            fn(*dev_args, **kw)


# ------------------------------------------------------------- e4m3 KV caches
def fp8_paged(gen, lens, hq, hkv, d, sq=1, layout="HND", q_rows=None, std=0.05):
    """As ``paged`` with e4m3 caches. ``std`` 0.05 puts about a quarter of the
    codes below 2^-6, the subnormal range."""
    q, k, v, tbl, kv_lens = paged(gen, lens, hq, hkv, d, sq=sq, layout=layout, q_rows=q_rows)
    return q, (k.float() * std).to(FP8), (v.float() * std).to(FP8), tbl, kv_lens


def token_scales(gen, k, layout):
    """[nb, bs, Hkv, 1] float32 K scales for a cache in ``layout``, and [Hkv] V scales."""
    hkv, nb = (k.shape[0], k.shape[1]) if layout == "HND" else (k.shape[2], k.shape[0])
    return (torch.rand((nb, BS, hkv, 1), generator=gen) * 30 + 5,
            torch.rand(hkv, generator=gen) * 20 + 10)


KS, VS = torch.tensor([17.0]), torch.tensor([23.0])
QT0 = QuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD


def test_fp8_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(30)
    counts = (paged_decode_attention.launches, paged_decode_qt0.launches,
              paged_prefill_attention.launches)
    q, k, v, tbl, lens = fp8_paged(gen, [5, 20], 4, 2, 64)
    ktok, vhead = token_scales(gen, k, "HND")
    assert torch.equal(paged_decode_attention(q, k, v, tbl, lens, 1, 0.1, "HND", KS, VS),
                       _decode_ref(q, k, v, tbl, lens, 1, 0.1, "HND", KS, VS))
    assert torch.equal(paged_decode_qt0(q, k, v, ktok, vhead, tbl, lens, 1, 0.1, "HND"),
                       _decode_qt0_ref(q, k, v, ktok, vhead, tbl, lens, 1, 0.1, "HND"))
    cu = torch.tensor([0, 2, 9], dtype=torch.int32)
    q = randn(gen, 11, 4, 64)
    assert torch.equal(
        paged_prefill_attention(q, k, v, cu, tbl, lens, 7, 0.1, "HND", None, vhead, ktok),
        _prefill_ref(q, k, v, cu, tbl, lens, 7, 0.1, "HND", None, vhead, ktok))
    assert counts == (paged_decode_attention.launches, paged_decode_qt0.launches,
                      paged_prefill_attention.launches)


# kv_len 1, a page boundary, a length inside a page, long ones; -1 pads the table
FP8_LENS = (1, 16, 17, 300, 1024, 4095, 3, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(32, 8), (4, 1)])
@pytest.mark.parametrize("layout,sq", [("HND", 1), ("HND", 3), ("NHD", 1), ("NHD", 3)])
def test_decode_e4m3_kernel_matches_plain(cuda, layout, sq, hq, hkv):
    gen = torch.Generator().manual_seed(31)
    lens = [max(n, sq) for n in FP8_LENS]
    q, k, v, tbl, kv_lens = fp8_paged(gen, lens, hq, hkv, 128, sq=sq, layout=layout)
    want = _decode_ref(q, k, v, tbl, kv_lens, sq, 128**-0.5, layout, KS, VS)
    n0 = paged_decode_attention.launches
    got = paged_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), tbl.to(cuda),
                                 kv_lens.to(cuda), sq, 128**-0.5, layout, KS, VS)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="decode e4m3")


@pytest.mark.cuda
def test_decode_int8_split_caches_match_plain(cuda):
    """The split-cache launcher takes int8 codes too (the slab's element types)."""
    gen = torch.Generator().manual_seed(32)
    q, k, v, tbl, kv_lens = paged(gen, [1, 17, 300, 64], 32, 8, 128)
    k, v = (torch.randint(-127, 128, tuple(t.shape), generator=gen, dtype=torch.int8) for t in (k, v))
    want = _decode_ref(q, k, v, tbl, kv_lens, 1, 128**-0.5, "HND", SC, SC)
    got = paged_decode_attention(q.to(cuda), k.to(cuda), v.to(cuda), tbl.to(cuda),
                                 kv_lens.to(cuda), 1, 128**-0.5, "HND", SC, SC)
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="decode int8 HND")


@pytest.mark.cuda
def test_e4m3_kernels_decode_every_v_code_exactly(cuda):
    """One key per request: the output is its V row. The rows hold all 254
    finite e4m3 codes (subnormals included), which bf16 represents exactly, so
    decode, QuantType-0 decode and prefill must return them bit for bit."""
    codes = torch.arange(256, dtype=torch.uint8)
    codes[codes % 128 == 127] = 0  # the two NaN codes
    v = torch.zeros((1, 2, BS, 128), dtype=torch.uint8)
    v[0, :, 0] = codes.view(2, 128)
    v = v.view(FP8)
    k = torch.ones((1, 2, BS, 128)).to(FP8)
    q = torch.ones((2, 1, 128), dtype=torch.bfloat16)
    tbl = torch.tensor([[0], [1]], dtype=torch.int32)
    lens = torch.tensor([1, 1], dtype=torch.int32)
    cu = torch.tensor([0, 1, 2], dtype=torch.int32)
    ktok = torch.ones((2, BS, 1, 1))
    want = codes.view(FP8).float().view(2, 1, 128)
    d = [t.to(cuda) for t in (q, k, v, tbl, lens)]
    outs = {
        "decode": paged_decode_attention(*d, 1, 0.1, "HND"),
        "qt0": paged_decode_qt0(*d[:3], ktok.to(cuda), None, *d[3:], 1, 0.1, "HND"),
        "prefill": paged_prefill_attention(*d[:3], cu.to(cuda), *d[3:], 1, 0.1, "HND"),
    }
    for name, got in outs.items():
        assert torch.equal(got.float().cpu(), want), name


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode", "qt0", "prefill"])
def test_e4m3_kernels_decode_subnormal_k_codes(cuda, kernel):
    """Request r sees two keys: one whose K holds code r in one dim (codes 0
    to 15: zero, the 7 subnormal steps of 2^-9, then the first normal values)
    with V = 1, and a zero key with V = 0, so its output is sigmoid(scale *
    k_r). At a logit scale of 64 one subnormal step moves the output by 0.03
    and the limit is 4e-3: a decode that flushed subnormals to zero fails."""
    n = 16
    k = torch.zeros((1, n, BS, 128), dtype=torch.uint8)
    k[0, :, 0, 5] = torch.arange(n, dtype=torch.uint8)  # page r, slot 0: code r
    k = k.view(FP8)
    v = torch.zeros((1, n, BS, 128))
    v[0, :, 0] = 1.0  # slot 0: ones; slot 1 (the zero key): zeros
    v = v.to(FP8)
    q = torch.zeros((n, 1, 128), dtype=torch.bfloat16)
    q[:, 0, 5] = 1.0
    tbl = torch.arange(n, dtype=torch.int32)[:, None]
    lens = torch.full((n,), 2, dtype=torch.int32)
    cu = torch.arange(n + 1, dtype=torch.int32)  # prefill: one query row at position 1
    ktok = torch.ones((n, BS, 1, 1))
    want = torch.sigmoid(64.0 * torch.arange(n, dtype=torch.uint8).view(FP8).float())
    assert float(want[1] - want[0]) > 0.03
    for dev in ("cpu", cuda):
        dq, dk, dv, dtbl, dlens = (t.to(dev) for t in (q, k, v, tbl, lens))
        if kernel == "decode":
            o = paged_decode_attention(dq, dk, dv, dtbl, dlens, 1, 64.0, "HND")
        elif kernel == "qt0":
            o = paged_decode_qt0(dq, dk, dv, ktok.to(dev), None, dtbl, dlens, 1, 64.0, "HND")
        else:
            o = paged_prefill_attention(dq, dk, dv, cu.to(dev), dtbl, dlens, 1, 64.0, "HND")
        assert_allclose(o[:, 0, 0].float(), want, atol=4e-3, rtol=0, name=f"{kernel} on {dev}")


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 3])
def test_decode_nhd_fused_e4m3_kernel_matches_plain(cuda, sq):
    gen = torch.Generator().manual_seed(33)
    lens = [max(n, sq) for n in FP8_LENS]
    q, k, v, tbl, kv_lens = fp8_paged(gen, lens, 32, 8, 128, sq=sq)
    slab = pack_kv_fused_nhd(k.view(torch.uint8), v.view(torch.uint8)).view(FP8)
    want = _decode_nhd_fused_ref(q, slab, tbl, kv_lens, sq, 128**-0.5, KS, VS)
    got = paged_decode_nhd_fused(q.to(cuda), slab.to(cuda), tbl.to(cuda), kv_lens.to(cuda), sq,
                                 128**-0.5, KS, VS)
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="decode nhd_fused e4m3")


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(32, 8), (4, 1)])
@pytest.mark.parametrize("layout,sq", [("HND", 1), ("NHD", 3)])
def test_decode_qt0_kernel_matches_plain(cuda, layout, sq, hq, hkv):
    gen = torch.Generator().manual_seed(34)
    lens = [max(n, sq) for n in FP8_LENS]
    q, k, v, tbl, kv_lens = fp8_paged(gen, lens, hq, hkv, 128, sq=sq, layout=layout)
    ktok, vhead = token_scales(gen, k, layout)
    want = _decode_qt0_ref(q, k, v, ktok, vhead, tbl, kv_lens, sq, 128**-0.5, layout)
    n0 = paged_decode_qt0.launches
    got = paged_decode_qt0(q.to(cuda), k.to(cuda), v.to(cuda), ktok.to(cuda), vhead.to(cuda),
                           tbl.to(cuda), kv_lens.to(cuda), sq, 128**-0.5, layout)
    torch.cuda.synchronize()
    assert paged_decode_qt0.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="decode qt0")


@pytest.mark.cuda
@pytest.mark.parametrize("pertoken", [False, True])
@pytest.mark.parametrize(
    "layout,hq,hkv,q_lens,kv_lens,pad",
    [("HND", 32, 8, [13, 7, 250], [13, 100, 300], 11), ("NHD", 32, 8, [13, 7, 250], [13, 100, 300], 0),
     ("HND", 4, 1, [1, 40], [1, 57], 0), ("HND", 32, 8, [1024], [1024], 0)],
)
def test_prefill_e4m3_kernel_matches_plain(cuda, layout, hq, hkv, q_lens, kv_lens, pad, pertoken):
    """Per-tensor scales, or per-token K scales with a V scale per kv head."""
    gen = torch.Generator().manual_seed(35)
    q, k, v, tbl, kv = fp8_paged(gen, kv_lens, hq, hkv, 128, layout=layout,
                                 q_rows=sum(q_lens) + pad)
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    ktok, vhead = token_scales(gen, k, layout)
    scales = (None, vhead, ktok) if pertoken else (KS, VS, None)
    want = _prefill_ref(q, k, v, cu, tbl, kv, max(q_lens), 128**-0.5, layout, *scales)
    got = paged_prefill_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), cu.to(cuda), tbl.to(cuda), kv.to(cuda), max(q_lens),
        128**-0.5, layout, *(None if t is None else t.to(cuda) for t in scales))
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="prefill e4m3")


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,kv_lens,pad", [([13, 7, 250], [13, 100, 300], 11), ([512], [2048], 0)])
def test_prefill_nhd_fused_e4m3_kernel_matches_plain(cuda, q_lens, kv_lens, pad):
    gen = torch.Generator().manual_seed(36)
    q, k, v, tbl, kv = fp8_paged(gen, kv_lens, 32, 8, 128, q_rows=sum(q_lens) + pad)
    slab = pack_kv_fused_nhd(k.view(torch.uint8), v.view(torch.uint8)).view(FP8)
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    want = _prefill_nhd_fused_ref(q, slab, cu, tbl, kv, max(q_lens), 128**-0.5, KS, VS)
    got = paged_prefill_nhd_fused(q.to(cuda), slab.to(cuda), cu.to(cuda), tbl.to(cuda),
                                  kv.to(cuda), max(q_lens), 128**-0.5, KS, VS)
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="prefill nhd_fused e4m3")


@pytest.mark.cuda
def test_fp8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator().manual_seed(37)
    q, k, v, tbl, kv_lens = fp8_paged(gen, [20], 8, 2, 128)
    ktok, vhead = token_scales(gen, k, "HND")
    d = dict(device=cuda)
    dq, dk, dv, dtbl, dlens = (t.to(**d) for t in (q, k, v, tbl, kv_lens))
    cu = torch.tensor([0, 20], dtype=torch.int32, device=cuda)
    qp = randn(gen, 20, 8, 128).to(**d)
    # rows one byte off 16-byte alignment
    bad = torch.zeros(k.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(FP8).view(k.shape)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_attention(dq, bad, dv, dtbl, dlens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_qt0(dq, bad, dv, ktok.to(**d), None, dtbl, dlens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="aligned"):
        paged_prefill_attention(qp, dk, bad, cu, dtbl, dlens, 20, 0.1, "HND")
    # a head_dim of 72 makes 16-byte rows in bf16 but not in one-byte elements
    q72, k72, v72, tbl72, lens72 = fp8_paged(gen, [20], 8, 2, 72)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_attention(q72.to(**d), k72.to(**d), v72.to(**d), tbl72.to(**d),
                               lens72.to(**d), 1, 0.1, "HND")
    # mixed devices and mixed or unknown cache types
    with pytest.raises(ValueError, match="one device"):
        paged_decode_attention(dq, dk, dv, tbl, dlens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="one device"):
        paged_decode_qt0(dq, dk, v, ktok.to(**d), None, dtbl, dlens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="share one of"):
        paged_decode_attention(dq, dk, dv.float().to(torch.bfloat16), dtbl, dlens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="share one of"):
        paged_prefill_attention(qp, dk.float(), dv.float(), cu, dtbl, dlens, 20, 0.1, "HND")
    # QuantType 0 takes e4m3 caches and scales paged like them
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        paged_decode_qt0(dq, dk.float().to(torch.bfloat16), dv.float().to(torch.bfloat16),
                         ktok.to(**d), None, dtbl, dlens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="K scales must be"):
        paged_decode_qt0(dq, dk, dv, ktok[:-1].to(**d), None, dtbl, dlens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="K scales must be"):
        paged_prefill_attention(qp, dk, dv, cu, dtbl, dlens, 20, 0.1, "HND", None, None, ktok)
    with pytest.raises(ValueError, match="replace the per-tensor"):
        paged_prefill_attention(qp, dk, dv, cu, dtbl, dlens, 20, 0.1, "HND", KS, None, ktok.to(**d))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["HND", "NHD"])
def test_rope_fp8_store_on_the_card_matches_cpu(cuda, layout):
    """The fp8 store is plain PyTorch: on the card it must write the CPU's
    codes (both divide and round in IEEE float32), with a decode step under
    sync debug mode "error" (it reads nothing on the host)."""
    from hpc_ops_tpu_torch.ops.rope import rope_norm_store_kv_fp8

    gen = torch.Generator().manual_seed(38)
    args, k0, v0, kw = rope_case(gen, layout, hq=8, hkv=2, num_blocks=64)
    shape = (2, 64, BS, 128) if layout == "HND" else (64, BS, 2, 128)
    one = torch.ones(1)

    def run(dev, sync_error=False):
        k = (k0.float() * 0.05).to(FP8).view(shape).to(dev)
        v = (v0.float() * 0.05).to(FP8).view(shape).to(dev)
        a = [t.to(dev) for t in args]
        sc = one.to(dev)
        call = lambda: rope_norm_store_kv_fp8(  # noqa: E731
            k, v, *a[:5], False, sc, sc, 1, q_norm_weight=a[5],
            k_norm_weight=a[6], qk_norm_policy=1, cache_layout=layout, zero_tails=False)
        if sync_error:
            call()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            q, qs, _, k, v = call()
        finally:
            if sync_error:
                torch.cuda.set_sync_debug_mode("default")
        return [t.cpu() for t in (q, qs, k, v)]

    want, got = run("cpu"), run(cuda, sync_error=True)
    assert_allclose(got[1], want[1], rtol=1e-6, atol=0, name="q_scale")
    for name, g, w in zip(("q", "", "K", "V"), got, want):
        if name:
            dlt = (ordinals(g) - ordinals(w)).abs()
            assert int(dlt.max()) <= 1 and float((dlt > 0).float().mean()) <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 40])
def test_int8_matmul_on_the_card_is_exact(cuda, rows):
    """Fewer than 17 rows are padded for the library's int8 product and cut again."""
    from hpc_ops_tpu_torch.models.llama import _int8_matmul

    gen = torch.Generator().manual_seed(39)
    x8 = torch.randint(-127, 128, (rows, 512), generator=gen, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (512, 264), generator=gen, dtype=torch.int8)
    got = _int8_matmul(x8.to(cuda), w8.to(cuda))
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows, 264)
    assert torch.equal(got.cpu(), _int8_matmul(x8, w8))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp8_kv", "dense_int8", "moe_pertensor_int8", "moe_blockwise_int8"])
def test_forward_step_on_the_card_syncs_nothing_and_matches_cpu(cuda, mode):
    """forward_step on the card, a prefill then a decode step, the decode
    step under sync debug mode "error" (the engine's one copy a step is its
    own, of the sampled tokens); logits within 0.15 abs / 0.1 rel of the CPU
    run's (the tolerance of the model tests)."""
    from hpc_ops_tpu_torch.models import llama as T

    if mode.startswith("moe_"):
        cfg = T.tiny_config(moe=True)
        cfg = cfg._replace(moe=cfg.moe._replace(scheme=mode[len("moe_"):]))
    else:
        cfg = T.tiny_config(**{mode: True})
    w = T.init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", cuda):
        t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        wd = {**{k: v.to(dev) for k, v in w.items() if k != "layers"},
              "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in w["layers"]]}
        caches = T.init_cache(cfg, num_blocks=8, block_size=BS, device=dev)
        tbl = t([[0, 1, -1], [2, 3, -1]])
        lp, caches = T.forward_step(wd, caches, cfg, t(list(range(12))), t([7, 5]), t([0, 7, 12]),
                                    tbl, is_prefill=True, max_seqlens_q=7)
        step = (t([3, 5]), t([8, 6]), t([0, 1, 2]), tbl)
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ld, _ = T.forward_step(wd, caches, cfg, *step, is_prefill=False, max_seqlens_q=1)
        finally:
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode("default")
        outs[str(dev)] = (lp.float().cpu(), ld.float().cpu())
    for name, c, g in zip(("prefill", "decode"), outs["cpu"], outs[str(cuda)]):
        assert_allclose(g, c, atol=0.15, rtol=0.1, name=f"{mode} {name} logits")


# --------------------------------------------- FUSED and task-map decode
def fused_caches(gen, lens, kind, sq=1, hq=32, hkv=8, d=128):
    """q, K and V (HND) of ``kind`` (bf16, int8 codes, e4m3), the page table,
    lengths and the kind's per-tensor scales."""
    q, k, v, tbl, kv_lens = paged(gen, lens, hq, hkv, d, sq=sq)
    if kind == "int8":
        k, v = (torch.randint(-127, 128, tuple(t.shape), generator=gen, dtype=torch.int8) for t in (k, v))
        return q, k, v, tbl, kv_lens, SC, SC
    if kind == "e4m3":
        return q, (k.float() * 0.05).to(FP8), (v.float() * 0.05).to(FP8), tbl, kv_lens, KS, VS
    return q, k, v, tbl, kv_lens, None, None


def layout_caches(k, v, layout):
    """HND K and V in ``layout``: (kcache, vcache) for attention_decode."""
    if layout == "HND":
        return k, v
    if layout == "NHD":
        return hnd_to_nhd(k).contiguous(), hnd_to_nhd(v).contiguous()
    pack = pack_kv_fused if layout == "FUSED" else pack_kv_fused_nhd
    if k.element_size() == 1:  # 1-byte caches are packed as bytes
        return pack(k.view(torch.uint8), v.view(torch.uint8)).view(k.dtype), None
    return pack(k, v), None


def test_task_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(40)
    counts = (paged_decode_attention.launches, paged_decode_tasks.launches, decode_combine.launches)
    q, k, v, tbl, lens, _, _ = fused_caches(gen, [5, 40], "bf16", hq=4, hkv=2, d=64)
    kv, _ = layout_caches(k, v, "FUSED")
    kh, vh = _hnd_views(kv, None, "FUSED", 64)
    assert torch.equal(attention_decode(q, kv, None, tbl, lens, new_kv_included=True, sm_scale=0.1,
                                        cache_layout="FUSED"),
                       _decode_ref(q, kh, vh, tbl, lens, 1, 0.1, "HND"))
    tm = assign_attention_decode_task(lens, 2, tile=16, min_process_len=16, num_tasks_target=4,
                                      capacity=8, impl="np")
    parts = paged_decode_tasks(q, k, v, tbl, lens, tm, 1, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(parts, _decode_tasks_ref(q, k, v, tbl, lens, tm, 1, 0.1)))
    assert torch.equal(decode_combine(*parts, tm, 1, 4), _decode_combine_ref(*parts, tm, 1, 4))
    assert counts == (paged_decode_attention.launches, paged_decode_tasks.launches, decode_combine.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("kind", ["bf16", "int8", "e4m3"])
def test_decode_fused_kernel_matches_plain(cuda, kind, sq):
    """The head-major FUSED slab through attention_decode: the decode kernel
    over strided views of the slab, short requests (the TPU's packed kernel,
    KV <= 1024) and long ones in one call."""
    gen = torch.Generator().manual_seed(41)
    lens = [max(n, sq) for n in (1, 16, 17, 300, 1024, 4095, 3, 64)]
    q, k, v, tbl, kv_lens, ks, vs = fused_caches(gen, lens, kind, sq=sq)
    kv, _ = layout_caches(k, v, "FUSED")
    kh, vh = _hnd_views(kv, None, "FUSED", 128)
    want = _decode_ref(q, kh, vh, tbl, kv_lens, sq, 128**-0.5, "HND", ks, vs)
    n0 = paged_decode_attention.launches
    got = attention_decode(q.to(cuda), kv.to(cuda), None, tbl.to(cuda), kv_lens.to(cuda), mtp=sq - 1,
                           new_kv_included=True, kscale=ks, vscale=vs, cache_layout="FUSED")
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"decode fused {kind}")


def assert_partials_close(got, want, name):
    """Task partials: finite rows within 1e-3, rows that saw no key exact."""
    (go, gm, gl), (wo, wm, wl) = [[t.float().cpu() for t in x] for x in (got, want)]
    seen = torch.isfinite(wm)
    assert torch.equal(torch.isfinite(gm), seen), f"{name}: rows that saw a key differ"
    assert torch.all(gl[~seen] == 0) and torch.all(go[~seen] == 0), f"{name}: unseen rows not neutral"
    assert_allclose(gm[seen], wm[seen], atol=1e-3, rtol=1e-3, name=f"{name} m")
    assert_allclose(gl[seen], wl[seen], atol=1e-3, rtol=1e-3, name=f"{name} l")
    assert_allclose(go[seen], wo[seen], atol=1e-3, rtol=1e-3, name=f"{name} o")


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("kind", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("layout", ["HND", "NHD", "FUSED", "NHD_FUSED"])
def test_decode_tasks_kernel_matches_plain(cuda, layout, kind, sq):
    """The task kernel over every layout in place, with sentinel tasks
    (capacity above the count), a long request split into several tasks,
    and draft rows whose last task holds no key they may see."""
    gen = torch.Generator().manual_seed(42)
    lens = [max(n, sq) for n in (1, 16, 17, 300, 1025, 4097, 3, 64)]
    q, k, v, tbl, kv_lens, ks, vs = fused_caches(gen, lens, kind, sq=sq)
    kc, vc = layout_caches(k, v, layout)
    tm = assign_attention_decode_task(kv_lens, 8, tile=256, min_process_len=512, capacity=200,
                                      impl="np")
    assert int(tm.num_tasks) < 200 and int((tm.batch == 5).sum()) > 8
    kd, vd = _hnd_views(kc.to(cuda), None if vc is None else vc.to(cuda), layout, 128)
    kh, vh = _hnd_views(kc, vc, layout, 128)
    want = _decode_tasks_ref(q, kh, vh, tbl, kv_lens, tm, sq, 128**-0.5, ks)
    tmd = tm._replace(**{f: getattr(tm, f).to(cuda) for f in ("batch", "head", "tile_start",
                                                              "num_tiles", "seg", "num_tasks")})
    n0 = paged_decode_tasks.launches
    got = paged_decode_tasks(q.to(cuda), kd, vd, tbl.to(cuda), kv_lens.to(cuda), tmd, sq,
                             128**-0.5, ks)
    torch.cuda.synchronize()
    assert paged_decode_tasks.launches == n0 + 1
    assert_partials_close(got, want, f"tasks {layout} {kind} sq={sq}")


def combine_map(gen, counts, sentinels, hkv):
    """A shuffled TaskMap of ``counts[s]`` real tasks of segment s and
    ``sentinels`` sentinel tasks (t_batch -1) in the segments listed."""
    seg = torch.cat([torch.full((c,), s, dtype=torch.int32) for s, c in enumerate(counts)]
                    + [torch.tensor(sentinels, dtype=torch.int32)])
    real = sum(counts)
    batch = torch.cat([seg[:real] // hkv, torch.full((len(sentinels),), -1, dtype=torch.int32)])
    perm = torch.randperm(seg.shape[0], generator=gen)
    zeros = torch.zeros(seg.shape[0], dtype=torch.int32)
    return TaskMap(batch[perm].contiguous(), zeros, zeros, zeros, seg[perm].contiguous(),
                   torch.tensor(real, dtype=torch.int32), len(counts), 16)


def combine_partials(gen, tm, rows, dv):
    """Seeded partials with a fifth of the rows, and every sentinel task, at
    m = -inf (l = 0, o = 0 there, as the task kernel writes them)."""
    cap = tm.capacity
    o = torch.randn((cap, rows, dv), generator=gen)
    m = torch.randn((cap, rows), generator=gen) * 4
    m[(torch.rand((cap, rows), generator=gen) < 0.2) | (tm.batch < 0)[:, None]] = float("-inf")
    l = torch.rand((cap, rows), generator=gen) * 50 + 1
    o[torch.isinf(m)] = 0
    l[torch.isinf(m)] = 0
    return o, m, l


# (case, hq, hkv, sq, dv): counts of real tasks by segment and sentinel
# tasks' segments come from the case
COMBINE_CARD_CASES = [
    ("long_segment", 32, 8, 3, 128),  # a segment of 64 tasks beside segments of 0-3
    ("sentinel_segment", 32, 8, 1, 128),  # segment 5 holds only sentinel tasks: output 0
    ("gqa128", 128, 1, 1, 128),  # G * sq 128 rows: 16 blocks of 8 rows a segment
    ("many_chunks", 16, 2, 2, 128),  # 1100 entries: three compaction passes, merged online
    ("narrow_columns", 8, 2, 1, 66),  # dv not a multiple of 4: one float a column group
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shuffled"] + [c[0] for c in COMBINE_CARD_CASES])
def test_decode_combine_kernel_matches_plain(cuda, case):
    """Partials with rows at m = -inf, sentinel tasks and a map whose
    segments are not contiguous (tasks shuffled); a 64-task segment, a
    segment of sentinels only, G * sq 128 (Hq 128 over Hkv 1), sq 3, a map
    longer than one compaction pass and dv 66. The kernel's forms come from
    combine_form (one block a segment at many segments, a block a row and
    chunk at few)."""
    gen = torch.Generator().manual_seed(43)
    if case == "shuffled":
        lens = [1, 300, 1025, 4097, 64]
        tm = assign_attention_decode_task(torch.tensor(lens), 8, tile=256, min_process_len=256,
                                          capacity=240, impl="np")
        perm = torch.randperm(240, generator=gen)
        tm = tm._replace(**{f: getattr(tm, f)[perm].contiguous() for f in ("batch", "head", "tile_start",
                                                                           "num_tiles", "seg")})
        hq, hkv, sq, dv = 32, 8, 3, 128
    else:
        hq, hkv, sq, dv = next(c[1:] for c in COMBINE_CARD_CASES if c[0] == case)
        segs = 2 * hkv
        counts = {"long_segment": [64, 3, 0, 1] + [2] * (segs - 4),
                  "sentinel_segment": [2] * 5 + [0] + [1] * (segs - 6),
                  "gqa128": [7, 1],
                  "many_chunks": [600, 150, 1, 300],
                  "narrow_columns": [5, 1, 0, 9]}[case]
        sentinels = [5, 5, 0, 2] if case == "sentinel_segment" else [1, 0, segs - 1]
        if case == "many_chunks":
            sentinels = sentinels * 15
        tm = combine_map(gen, counts, sentinels, hkv)
    rows = hq // hkv * sq
    o, m, l = combine_partials(gen, tm, rows, dv)
    want = _decode_combine_ref(o, m, l, tm, sq, hq, VS)
    if case == "sentinel_segment":
        assert torch.all(want.view(2, sq, hkv, -1)[0, :, 5] == 0)
    tmd = tm._replace(batch=tm.batch.to(cuda), seg=tm.seg.to(cuda))
    n0 = decode_combine.launches
    got = decode_combine(o.to(cuda), m.to(cuda), l.to(cuda), tmd, sq, hq, VS)
    torch.cuda.synchronize()
    assert decode_combine.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"combine {case}")


@pytest.mark.cuda
def test_decode_combine_kernel_takes_misaligned_partials(cuda):
    """o as a contiguous view 4 bytes off a 16-byte boundary: the kernel
    takes one float a column group and matches the plain version."""
    gen = torch.Generator().manual_seed(44)
    tm = combine_map(gen, [9, 1, 0, 33, 2, 2, 4, 1], [2, 3], 4)
    o, m, l = combine_partials(gen, tm, 4, 128)
    buf = torch.zeros(o.numel() + 1, device=cuda)
    od = buf[1:].view(o.shape)
    od.copy_(o)
    assert od.is_contiguous() and od.data_ptr() % 16 == 4
    tmd = tm._replace(batch=tm.batch.to(cuda), seg=tm.seg.to(cuda))
    got = decode_combine(od, m.to(cuda), l.to(cuda), tmd, 1, 16)
    want = _decode_combine_ref(o, m, l, tm, 1, 16)
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="combine misaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,kind,mtp", [("HND", "bf16", 0), ("NHD", "e4m3", 2),
                                             ("FUSED", "int8", 0), ("NHD_FUSED", "int8", 2)])
def test_task_map_decode_on_the_card_syncs_nothing_and_matches_ref(cuda, layout, kind, mtp):
    """attention_decode(task_map=...) on the card: the task kernel and the
    combine, one launch each, no device-to-host copy, and the reference's
    output within 1e-2; the torch scheduler builds the map on the card."""
    gen = torch.Generator().manual_seed(44)
    sq = mtp + 1
    lens = [max(n, sq) for n in (1, 300, 4097, 64, 2000)]
    q, k, v, tbl, kv_lens, ks, vs = fused_caches(gen, lens, kind, sq=sq)
    kc, vc = layout_caches(k, v, layout)
    dev = [t.to(cuda) for t in (q, tbl, kv_lens)]
    kcd, vcd = kc.to(cuda), None if vc is None else vc.to(cuda)
    kw = dict(mtp=mtp, new_kv_included=True, cache_layout=layout)
    want = attention_decode(q, kc, vc, tbl, kv_lens, impl="ref", kscale=ks, vscale=vs, **kw)
    kw.update(kscale=None if ks is None else ks.to(cuda), vscale=None if vs is None else vs.to(cuda))
    torch.cuda.synchronize()
    n0 = {f: f.launches for f in (paged_decode_tasks, decode_combine, paged_decode_attention,
                                  paged_decode_nhd_fused)}
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm = assign_attention_decode_task(dev[2], 8, mtp, True, tile=512, min_process_len=1024,
                                          impl="torch")
        got = attention_decode(dev[0], kcd, vcd, dev[1], dev[2], task_map=tm, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launched = {f.__name__: f.launches - c for f, c in n0.items()}
    assert launched == {"paged_decode_tasks": 1, "decode_combine": 1, "paged_decode_attention": 0,
                        "paged_decode_nhd_fused": 0}
    assert tm.capacity > int(tm.num_tasks)
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"task map {layout}")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["HND", "NHD_FUSED"])
def test_qt0_with_a_task_map_launches_the_qt0_kernel(cuda, layout):
    """QuantType 0 ignores a task map (the JAX package's reference does too)
    and launches its grid kernel once: no task kernel, no float32 gather."""
    gen = torch.Generator().manual_seed(46)
    lens = [1, 300, 4097, 64]
    q, k, v, tbl, kv_lens = fp8_paged(gen, lens, 32, 8, 128)
    ktok, vhead = token_scales(gen, k, "HND")
    want = _decode_qt0_ref(q, k, v, ktok, vhead, tbl, kv_lens, 1, 128**-0.5, "HND")
    kc, vc = layout_caches(k, v, layout)
    tm = assign_attention_decode_task(kv_lens.to(cuda), 8, tile=512, min_process_len=1024,
                                      impl="torch")
    fns = (paged_decode_qt0, paged_decode_tasks, decode_combine, paged_decode_attention)
    n0 = [f.launches for f in fns]
    got = attention_decode(q.to(cuda), kc.to(cuda), None if vc is None else vc.to(cuda),
                           tbl.to(cuda), kv_lens.to(cuda), new_kv_included=True,
                           kscale=ktok.to(cuda), vscale=vhead.to(cuda), cache_layout=layout,
                           quant_type=QT0, task_map=tm)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, n0)] == [1, 0, 0, 0]
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"qt0 task map {layout}")


@pytest.mark.cuda
def test_fused_and_task_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator().manual_seed(45)
    q, k, v, tbl, kv_lens, _, _ = fused_caches(gen, [20, 40], "bf16", hq=8, hkv=2)
    d = dict(device=cuda)
    dq, dk, dv, dtbl, dlens = (t.to(**d) for t in (q, k, v, tbl, kv_lens))
    kv = pack_kv_fused(dk, dv)
    bad = torch.zeros(kv.numel() + 8, dtype=torch.bfloat16, **d)[1:kv.numel() + 1].view(kv.shape)
    fused = dict(new_kv_included=True, cache_layout="FUSED")
    with pytest.raises(ValueError, match="aligned"):
        attention_decode(dq, bad, None, dtbl, dlens, **fused)
    with pytest.raises(ValueError, match="one device"):
        attention_decode(dq, kv, None, tbl, dlens, **fused)
    tm = assign_attention_decode_task(kv_lens, 2, tile=16, min_process_len=16, capacity=16, impl="np")
    with pytest.raises(ValueError, match="task map must be"):
        paged_decode_tasks(dq, dk, dv, dtbl, dlens, tm, 1, 0.1)
    tmd = tm._replace(**{f: getattr(tm, f).to(cuda) for f in ("batch", "head", "tile_start",
                                                              "num_tiles", "seg")})
    o, m, l = paged_decode_tasks(dq, dk, dv, dtbl, dlens, tmd, 1, 0.1)
    with pytest.raises(ValueError, match="task map must be"):
        decode_combine(o, m, l, tm, 1, 8)
    with pytest.raises(ValueError, match="partials must be"):
        decode_combine(o[:8], m[:8], l[:8], tmd, 1, 8)


# -------------------- block-sparse prefill, RMSNorm + fp8, route GEMM
# The sparse kernel against its plain version within the attention 1e-2;
# rows with no kept key exactly 0. RMSNorm + fp8: every e4m3 code and every
# float32 norm equal to the plain version on the card (both sum the squares
# in float64, every later step one correctly rounded float32 operation; the
# CPU's float64 sum, in another order, can round a row's mean an ulp apart
# when its squares span more than 53 bits). Route GEMM:
# float32 output within 1e-5 of the largest |output| (float32 sums of exact
# bf16 products in another order), bf16 output within one bf16 step more.
from hpc_ops_tpu_torch.ops.attention import attention_with_kvcache_prefill  # noqa: E402
from hpc_ops_tpu_torch.ops.attention.paging import nhd_fused_views  # noqa: E402
from hpc_ops_tpu_torch.ops.attention.prefill import (  # noqa: E402
    _prefill_sparse_ref,
    paged_prefill_sparse,
)
from hpc_ops_tpu_torch.ops import gemm as gemm_ops  # noqa: E402
from hpc_ops_tpu_torch.ops.gemm import _route_gemm_ref, route_gemm, split_fp32_weight  # noqa: E402
from hpc_ops_tpu_torch.ops.normalization import _rmsnorm_quant_ref, norm_form, rmsnorm_quant  # noqa: E402
from hpc_ops_tpu_torch.ops.rope_kernel import _align  # noqa: E402


def sparse_mask(gen, q_lens, kv_lens, hq, mtq, mtkv, keep=0.4):
    """A random [B, Hq, n_tm, n_tkv] tile mask keeping each q tile's causal
    diagonal tile; head 1's first q tile of request 0 keeps nothing."""
    n_tm, n_tkv = -(-max(q_lens) // mtq), -(-max(kv_lens) // mtkv)
    mask = (torch.rand((len(q_lens), hq, n_tm, n_tkv), generator=gen) < keep).to(torch.uint8)
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        for t in range(-(-ql // mtq)):
            mask[b, :, t, (kl - ql + t * mtq) // mtkv] = 1
    mask[0, 1, 0] = 0
    return mask


def sparse_case(gen, kind, layout, q_lens, kv_lens, pad=0, hq=32, hkv=8, mtq=128, mtkv=64):
    """q, caches of ``kind`` in ``layout`` (NHD_FUSED: NHD views of the
    slab), cu, table, lengths, the mask and per-tensor scales."""
    if kind == "bf16":
        q, k, v, tbl, kv = paged(gen, kv_lens, hq, hkv, 128, q_rows=sum(q_lens) + pad)
        scales = (None, None)
    elif kind == "e4m3":
        q, k, v, tbl, kv = fp8_paged(gen, kv_lens, hq, hkv, 128, q_rows=sum(q_lens) + pad)
        scales = (KS, VS)
    else:
        q, k, v, tbl, kv = paged(gen, kv_lens, hq, hkv, 128, q_rows=sum(q_lens) + pad)
        k = torch.randint(-127, 128, k.shape, generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, v.shape, generator=gen, dtype=torch.int8)
        scales = (torch.tensor([0.01]), torch.tensor([0.02]))
    if layout == "NHD":
        k, v = hnd_to_nhd(k).contiguous(), hnd_to_nhd(v).contiguous()
    elif layout == "NHD_FUSED":
        raw = pack_kv_fused_nhd(*(x.view(torch.uint8) if x.element_size() == 1 else x for x in (k, v)))
        k, v = nhd_fused_views(raw.view(k.dtype), hkv)
        layout = "NHD"
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    mask = sparse_mask(gen, q_lens, kv_lens, hq, mtq, mtkv)
    return (q, k, v, cu, tbl, kv, max(q_lens)), layout, mask, scales


def test_sparse_norm_gemm_wrappers_take_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(50)
    fns = (paged_prefill_sparse, rmsnorm_quant, route_gemm, paged_prefill_attention)
    n0 = [f.launches for f in fns]
    args, layout, mask, _ = sparse_case(gen, "bf16", "HND", [13, 40], [13, 100], hq=4, hkv=2)
    assert torch.equal(paged_prefill_sparse(*args, 0.1, layout, mask, 128, 64),
                       _prefill_sparse_ref(*args, 0.1, layout, mask, 128, 64))
    x = randn(gen, 5, 64)
    w, sc = torch.rand(64, generator=gen), torch.tensor([0.5, 2.0])
    for is_moe in (False, True):
        a, b = rmsnorm_quant(x, w, sc, 1e-6, is_moe), _rmsnorm_quant_ref(x, w, sc, 1e-6, is_moe)
        assert all(torch.equal(s.view(torch.uint8) if s.element_size() == 1 else s,
                               t.view(torch.uint8) if t.element_size() == 1 else t)
                   for s, t in zip(a if is_moe else (a,), b if is_moe else (b,)))
    wh, wl, ws = split_fp32_weight(torch.randn((24, 64), generator=gen))
    assert torch.equal(route_gemm(x, wh, wl, ws, True), _route_gemm_ref(x, wh, wl, ws, True))
    assert [f.launches for f in fns] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["HND", "NHD", "NHD_FUSED"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "e4m3"])
def test_prefill_sparse_kernel_matches_plain(cuda, kind, layout):
    """Three requests (unaligned cu, kv prefixes longer than q, padded rows),
    128 x 64 mask tiles, a q tile with no kept key (its rows come back 0)."""
    gen = torch.Generator().manual_seed(51)
    args, lay, mask, (ks, vs) = sparse_case(gen, kind, layout, [13, 7, 250], [13, 100, 300], pad=11)
    want = _prefill_sparse_ref(*args, 128**-0.5, lay, mask, 128, 64, ks, vs)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    got = paged_prefill_sparse(*dev, 128**-0.5, lay, mask.to(cuda), 128, 64,
                               None if ks is None else ks.to(cuda), None if vs is None else vs.to(cuda))
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"sparse {kind} {layout}")
    assert not got[:13, 1].float().any()  # q head 1 keeps nothing in request 0's first q tile
    assert not got[sum([13, 7, 250]):].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (32, 48), (16, 16)])
def test_prefill_sparse_pertoken_kernel_matches_plain(cuda, tiles):
    """e4m3 with one K scale per (token, kv head) and a V scale per head,
    over mask tiles that are and are not multiples of the kernel's tiles."""
    gen = torch.Generator().manual_seed(52)
    args, lay, mask, _ = sparse_case(gen, "e4m3", "HND", [100, 64, 31], [300, 64, 500], pad=3,
                                     mtq=tiles[0], mtkv=tiles[1])
    ktok, vhead = token_scales(gen, args[1], "HND")
    want = _prefill_sparse_ref(*args, 128**-0.5, lay, mask, *tiles, None, vhead, ktok)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    got = paged_prefill_sparse(*dev, 128**-0.5, lay, mask.to(cuda), *tiles, None, vhead.to(cuda),
                               ktok.to(cuda))
    torch.cuda.synchronize()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"sparse pertoken {tiles}")


@pytest.mark.cuda
def test_sparse_entry_point_launches_the_sparse_kernel_only(cuda):
    gen = torch.Generator().manual_seed(53)
    args, lay, mask, (ks, vs) = sparse_case(gen, "e4m3", "HND", [200, 77], [400, 77])
    want = attention_with_kvcache_prefill(*args, kscale=ks, vscale=vs, block_mask=mask,
                                          mask_tile_q=128, mask_tile_kv=64, cache_layout=lay)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    fns = (paged_prefill_sparse, paged_prefill_attention, paged_prefill_nhd_fused)
    n0 = [f.launches for f in fns]
    got = attention_with_kvcache_prefill(*dev, kscale=ks.to(cuda), vscale=vs.to(cuda),
                                         block_mask=mask.to(cuda), mask_tile_q=128, mask_tile_kv=64,
                                         cache_layout=lay)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, n0)] == [1, 0, 0]
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="sparse entry point")


@pytest.mark.cuda
def test_sparse_entry_point_refuses_k_scales_grouped_along_d(cuda):
    """K scales grouped along D (4 groups of 32 columns) with a block mask:
    the sparse kernel takes them (it refused them before it had a grouped
    form), launched once, no dense kernel, within ``close_scaled`` of the
    plain sparse version."""
    gen = torch.Generator().manual_seed(58)
    args, lay, mask, _ = sparse_case(gen, "e4m3", "HND", [40, 9], [100, 9])
    _, vhead = token_scales(gen, args[1], lay)
    grouped = group_scales(gen, args[1], lay, 4)
    kw = dict(kscale=grouped, vscale=vhead, quant_type=QT0, block_mask=mask, mask_tile_q=128,
              mask_tile_kv=64, cache_layout=lay)
    want = attention_with_kvcache_prefill(*args, **kw)  # CPU: the plain sparse version
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    kw.update(kscale=grouped.to(cuda), vscale=vhead.to(cuda), block_mask=mask.to(cuda))
    fns = (paged_prefill_sparse, paged_prefill_attention)
    n0 = [f.launches for f in fns]
    got = attention_with_kvcache_prefill(*dev, **kw)
    assert [f.launches - n for f, n in zip(fns, n0)] == [1, 0]
    close_scaled(got, want, "sparse entry point, grouped K scales")


def group_scales(gen, k, layout, groups):
    """[nb, bs, Hkv, groups] float32 K scales for a cache in ``layout``."""
    hkv, nb = (k.shape[0], k.shape[1]) if layout == "HND" else (k.shape[2], k.shape[0])
    return torch.rand((nb, BS, hkv, groups), generator=gen) * 30 + 5


def close_scaled(got, want, what):
    """|got - want| <= 1e-2 |want| + min(1e-2, 1e-2 max|want|), all finite
    (``chip_smoke.py``'s bar for attention outputs)."""
    torch.cuda.synchronize()
    g, w = got.float().cpu(), want.float().cpu()
    atol = min(1e-2, 1e-2 * float(w.abs().max()))
    assert bool(torch.isfinite(g).all()) and torch.allclose(g, w, atol=atol, rtol=1e-2), (
        f"{what}: max err {float((g - w).abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [2, 4, 8])
@pytest.mark.parametrize("op,layout", [("decode", "HND"), ("decode", "NHD"), ("prefill", "HND"),
                                       ("prefill", "NHD"), ("prefill_sparse", "HND")])
def test_grouped_k_scale_kernels_match_plain(cuda, op, layout, groups):
    """The grouped forms of the QuantType-0 decode kernel and of the prefill
    kernel's per-token form (dense and sparse): G K scales per (token, kv
    head), each over D/G columns, against their plain versions."""
    gen = torch.Generator().manual_seed(59 + groups)
    if op == "decode":
        q, k, v, tbl, kv = fp8_paged(gen, [max(n, 2) for n in FP8_LENS], 32, 8, 128, sq=2,
                                     layout=layout)
        _, vhead = token_scales(gen, k, layout)
        ktok = group_scales(gen, k, layout, groups)
        want = _decode_qt0_ref(q, k, v, ktok, vhead, tbl, kv, 2, 128**-0.5, layout)
        n0 = paged_decode_qt0.launches
        got = paged_decode_qt0(*(t.to(cuda) for t in (q, k, v, ktok, vhead, tbl, kv)), 2, 128**-0.5,
                               layout)
        assert paged_decode_qt0.launches == n0 + 1
    elif op == "prefill":
        q_lens, kv_lens = [13, 7, 250], [13, 100, 300]
        q, k, v, tbl, kv = fp8_paged(gen, kv_lens, 32, 8, 128, layout=layout, q_rows=sum(q_lens) + 5)
        cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
        _, vhead = token_scales(gen, k, layout)
        ktok = group_scales(gen, k, layout, groups)
        args = (q, k, v, cu, tbl, kv)
        want = _prefill_ref(*args, max(q_lens), 128**-0.5, layout, None, vhead, ktok)
        got = paged_prefill_attention(*(t.to(cuda) for t in args), max(q_lens), 128**-0.5, layout,
                                      None, vhead.to(cuda), ktok.to(cuda))
    else:
        args, lay, mask, _ = sparse_case(gen, "e4m3", layout, [100, 64, 31], [300, 64, 500], pad=3)
        _, vhead = token_scales(gen, args[1], lay)
        ktok = group_scales(gen, args[1], lay, groups)
        want = _prefill_sparse_ref(*args, 128**-0.5, lay, mask, 128, 64, None, vhead, ktok)
        dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
        got = paged_prefill_sparse(*dev, 128**-0.5, lay, mask.to(cuda), 128, 64, None, vhead.to(cuda),
                                   ktok.to(cuda))
    close_scaled(got, want, f"{op} {layout} G={groups}")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["decode", "prefill"])
def test_grouped_k_scale_entry_points_launch_the_kernel(cuda, op):
    """``attention_decode`` and ``attention_with_kvcache_prefill`` with K
    scales in 4 groups along D launch the QuantType-0 decode kernel or the
    prefill kernel once, under sync debug mode "error" (no reference, which
    reads lengths back to the host), and agree with the CPU run."""
    gen = torch.Generator().manual_seed(63)
    q, k, v, tbl, kv = fp8_paged(gen, FP8_LENS if op == "decode" else [40, 300], 32, 8, 128,
                                 q_rows=None if op == "decode" else 60)
    _, vhead = token_scales(gen, k, "HND")
    ktok = group_scales(gen, k, "HND", 4)
    kw = dict(kscale=ktok, vscale=vhead, quant_type=QT0, cache_layout="HND")
    if op == "decode":
        fn, counted = attention_decode, paged_decode_qt0
        args = (q, k, v, tbl, kv)
        kw["new_kv_included"] = True
    else:
        fn, counted = attention_with_kvcache_prefill, paged_prefill_attention
        args = (q, k, v, torch.tensor([0, 20, 60], dtype=torch.int32), tbl, kv, 40)
    want = fn(*args, **kw)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    kw.update(kscale=ktok.to(cuda), vscale=vhead.to(cuda))
    n0 = counted.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*dev, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counted.launches == n0 + 1
    close_scaled(got, want, f"{op} entry point, grouped K scales")


@pytest.mark.cuda
def test_prefill_sparse_skips_masked_tiles(cuda):
    """A mask keeping only each q tile's diagonal tile (1/64 of the causal
    tiles at 8192 tokens) runs in a small part of the all-ones mask's time:
    the skipped tiles cost no K/V loads and no math. Each call is timed as
    the replay of a CUDA graph that captured it: with the kernel at about
    0.15 ms for the diagonal mask, a call timed from the host also holds the
    wrapper's host time, which on a cold CPU exceeds it. Each time is the
    median of several replays, so one slow replay cannot decide it."""
    gen = torch.Generator().manual_seed(54)
    n = 8192
    q, k, v, tbl, kv = paged(gen, [n], 32, 8, 128, q_rows=n)
    args = [t.to(cuda) for t in (q, k, v)] + [torch.tensor([0, n], dtype=torch.int32, device=cuda),
                                             tbl.to(cuda), kv.to(cuda), n]
    ones = torch.ones((1, 32, n // 64, n // 64), dtype=torch.uint8, device=cuda)
    diag = torch.eye(n // 64, dtype=torch.uint8, device=cuda).expand(1, 32, -1, -1).contiguous()

    def ms(mask):
        """The median of 9 replays, each timed alone."""
        paged_prefill_sparse(*args, 0.1, "HND", mask, 64, 64)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            paged_prefill_sparse(*args, 0.1, "HND", mask, 64, 64)
        graph.replay()
        times = []
        for _ in range(9):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    t_diag, t_ones = ms(diag), ms(ones)
    print(f"diagonal mask {t_diag} ms, all-ones mask {t_ones} ms, ratio {t_diag / t_ones}")
    assert t_diag < 0.1 * t_ones


def assert_norm_outputs_equal(got, want, is_moe):
    for g, t in zip(got if is_moe else (got,), want if is_moe else (want,)):
        if g.dtype == torch.float32:
            assert torch.equal(g, t)
        else:
            assert torch.equal(g.view(torch.uint8), t.view(torch.uint8))


# rows 1-4097 x widths 8 to 65544 (any multiple of 8 runs the kernel)
NORM_CARD_SHAPES = [(8, 4096), (2048, 5120), (5, 320), (1, 8), (3, 7168), (4097, 8192), (1, 16384),
                    (3, 16384), (2048, 4096), (2, 65544)]


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("is_moe", [False, True])
@pytest.mark.parametrize("n,h", NORM_CARD_SHAPES)
def test_rmsnorm_quant_kernel_matches_plain(cuda, n, h, is_moe, w_dtype):
    gen = torch.Generator().manual_seed(55)
    x = randn(gen, n, h) * 3
    w = torch.rand(h, generator=gen).to(torch.bfloat16).to(w_dtype)
    if w_dtype == torch.float32:
        w = w + torch.rand(h, generator=gen) * 2**-10  # bits a bf16 weight cannot hold
    sc = torch.tensor([2.5, 5.0] if is_moe else [0.01])  # 0.01: many codes saturate at 448
    args = (x.to(cuda), w.to(cuda), sc.to(cuda), 1e-6, is_moe)
    want = _rmsnorm_quant_ref(*args)  # on the card: the CPU's float64 sum may round a mean apart
    got = rmsnorm_quant(*args)
    torch.cuda.synchronize()
    assert_norm_outputs_equal(got, want, is_moe)


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("a_off,w_off", [(1, 0), (2, 0), (4, 0), (0, 1), (0, 2), (1, 1), (4, 2)])
@pytest.mark.parametrize("h", [4096, 5120])
def test_rmsnorm_quant_kernel_takes_misaligned_views(cuda, h, a_off, w_off, w_dtype):
    """``a`` and the weight as contiguous views at offsets of 1, 2 or 4
    elements (2-16 bytes off a 16-byte boundary): the kernel takes narrower
    words (norm_form) and stays bit-equal to the plain version."""
    gen = torch.Generator().manual_seed(58)
    n = 37
    a_buf = (randn(gen, n * h + 8) * 3).to(cuda)
    w_buf = torch.rand(h + 8, generator=gen).to(w_dtype).to(cuda)
    x = a_buf[a_off: a_off + n * h].view(n, h)
    w = w_buf[w_off: w_off + h]
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (a_off > 0)
    f = norm_form(n, h, _align(x.data_ptr()), _align(w.data_ptr()), w.element_size())
    assert f.vec < 8
    for is_moe in (False, True):
        sc = torch.tensor([2.5, 5.0] if is_moe else [0.01], device=cuda)
        got = rmsnorm_quant(x, w, sc, 1e-6, is_moe)
        assert_norm_outputs_equal(got, _rmsnorm_quant_ref(x, w, sc, 1e-6, is_moe), is_moe)


@pytest.mark.cuda
@pytest.mark.parametrize("is_moe", [False, True])
def test_rmsnorm_quant_launches_one_kernel_a_call(cuda, is_moe):
    """At a bf16 weight a call is one launch: no conversion of the weight or
    the scales runs on the card (torch.profiler's kernel count)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(59)
    x = randn(gen, 64, 4096).to(cuda)
    w = torch.rand(4096, generator=gen).to(torch.bfloat16).to(cuda)
    sc = torch.tensor([2.5, 5.0] if is_moe else [0.5], device=cuda)
    rmsnorm_quant(x, w, sc, 1e-6, is_moe)
    torch.cuda.synchronize()
    n0 = rmsnorm_quant.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            rmsnorm_quant(x, w, sc, 1e-6, is_moe)
        torch.cuda.synchronize()
    kinds = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    assert rmsnorm_quant.launches == n0 + 10
    assert [e.count for e in kinds] == [10] and "rmsnorm_quant_kernel" in kinds[0].key


# (16, 256, 7168) and the router's (256, 256, 7168) take the small body with
# split K, (4096, 256, 7168) the large one with split K, 7176 makes 113
# stages that the splits share unevenly (ops/gemm.py:route_form)
ROUTE_CARD_SHAPES = [(256, 256, 7168), (16, 256, 7168), (4096, 256, 7168), (256, 256, 7176),
                     (100, 192, 512), (33, 72, 520), (1, 8, 8)]


def route_case(gen, m, n, k, dev):
    x = randn(gen, m, k)
    wh, wl, ws = split_fp32_weight(torch.randn((n, k), generator=gen))
    return x.to(dev), wh.to(dev), wl.to(dev), ws.to(dev)


def assert_route_close(got, x, wh, wl, ws, fp32, name):
    """The file's tolerance against the plain version (on the CPU), and the
    float32 output inside the float32 summation bound of the float64 product
    of the split weights: (k / 16 + 1) ulps of |x| @ |w|^T, element by
    element (chip_smoke.py's check_route_gemm)."""
    xc, whc, wlc, wsc = (t.cpu() for t in (x, wh, wl, ws))
    want = _route_gemm_ref(xc, whc, wlc, wsc, fp32).float()
    got = got.cpu()
    assert got.dtype == (torch.float32 if fp32 else torch.bfloat16)
    big = float(want.abs().max())
    assert_allclose(got.float(), want, atol=1e-5 * big, rtol=0 if fp32 else 2.0**-7, name=name)
    if fp32:
        k = x.shape[1]
        xd, whd, wld, s = xc.double(), whc.double(), wlc.double(), float(wsc)
        exact = xd @ (whd + s * wld).T
        sum_tol = (k / 16 + 1) * 2.0**-23 * (xd.abs() @ (whd.abs() + s * wld.abs()).T)
        assert bool(((got.double() - exact).abs() <= sum_tol).all()), f"{name}: outside the float32 sum bound"


@pytest.mark.cuda
@pytest.mark.parametrize("fp32", [False, True])
@pytest.mark.parametrize("m,n,k", ROUTE_CARD_SHAPES)
def test_route_gemm_kernel_matches_plain(cuda, m, n, k, fp32):
    gen = torch.Generator().manual_seed(56)
    x, wh, wl, ws = route_case(gen, m, n, k, cuda)
    got = route_gemm(x, wh, wl, ws, fp32)
    torch.cuda.synchronize()
    assert_route_close(got, x, wh, wl, ws, fp32, "route gemm")


# Every body and tile, split and not, with uneven runs (33 stages)
ROUTE_FORCED = [("small", 16, 1), ("small", 16, 4), ("small", 32, 7), ("small", 64, 1), ("small", 64, 16),
                ("large", 128, 1), ("large", 128, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("body,tile,splits", ROUTE_FORCED)
def test_route_gemm_every_form_matches_plain(cuda, monkeypatch, body, tile, splits):
    """Each body, token tile and split count forced through route_form (the
    wrapper has no knob), at a shape with ragged rows, columns and K."""
    m, n, k = 150, 200, 2104
    tm, tn = (tile, 64) if body == "small" else (128, 128)
    form = gemm_ops.make_form(body, tm, tn, m, n, splits)
    monkeypatch.setattr(gemm_ops, "route_form", lambda *_: form)
    gen = torch.Generator().manual_seed(58)
    x, wh, wl, ws = route_case(gen, m, n, k, cuda)
    for fp32 in (False, True):
        got = route_gemm(x, wh, wl, ws, fp32)
        torch.cuda.synchronize()
        assert_route_close(got, x, wh, wl, ws, fp32, f"route gemm {body} {tile} x {splits}")


@pytest.mark.cuda
def test_route_gemm_split_form_repeats_bit_for_bit(cuda):
    """Two calls of a split form give the same bits (the last block of a
    tile resets its ticket, and the merge adds the splits in order), and a
    call at another shape in between, which reuses the workspace and the
    tickets, does not disturb the next one."""
    gen = torch.Generator().manual_seed(59)
    a = route_case(gen, 256, 256, 7168, cuda)
    b = route_case(gen, 16, 256, 7176, cuda)
    assert gemm_ops.route_form(256, 256, 7168).splits > 1 and gemm_ops.route_form(16, 256, 7176).splits > 1
    first = route_gemm(*a, True)
    second = route_gemm(*a, True)
    other = route_gemm(*b, True)
    third = route_gemm(*a, True)
    again = route_gemm(*b, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third) and torch.equal(other, again)
    assert_route_close(other, *b, True, "route gemm between calls")


@pytest.mark.cuda
def test_sparse_norm_gemm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator().manual_seed(57)
    with pytest.raises(ValueError, match="multiple of 8"):
        rmsnorm_quant(randn(gen, 2, 12).to(cuda), torch.ones(12, device=cuda),
                      torch.ones(1, device=cuda), 1e-6, False)
    x = randn(gen, 4, 24).to(cuda)
    w = randn(gen, 8, 24).to(cuda)
    odd = torch.zeros(8 * 24 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(8, 24)  # 2-byte offset
    with pytest.raises(ValueError, match="aligned"):
        route_gemm(x, odd, w, torch.ones(1, device=cuda), False)
    with pytest.raises(ValueError, match="one device"):
        route_gemm(x, w, w, torch.ones(1), False)


# ------------------------------------------- fused all-reduce + RMSNorm
from hpc_ops_tpu_torch.parallel import make_mesh  # noqa: E402
from hpc_ops_tpu_torch.parallel.collective_kernels import (  # noqa: E402
    _allreduce_rmsnorm_ref,
    allreduce_rmsnorm,
    collective_rmsnorm,
)
from hpc_ops_tpu_torch.parallel.mesh import run_ranks  # noqa: E402


def allreduce_case(gen, ws, n, h, dev="cpu"):
    xs = [(torch.randn((n, h), generator=gen) * 0.5).to(torch.bfloat16).to(dev) for _ in range(ws)]
    res = torch.randn((n, h), generator=gen).to(torch.bfloat16).to(dev)
    w = (torch.rand(h, generator=gen) + 0.5).to(dev)
    return xs, [res.clone() for _ in range(ws)], w


def test_allreduce_wrapper_takes_the_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(70)
    xs, res, w = allreduce_case(gen, 4, 64, 264)
    outs = [torch.empty_like(xs[0]) for _ in range(4)]
    oress = [torch.empty_like(xs[0]) for _ in range(4)]
    n0 = allreduce_rmsnorm.launches
    allreduce_rmsnorm(xs, res, [w] * 4, outs, oress, 1e-5, "two_shot", True)
    want = _allreduce_rmsnorm_ref(xs, res[0], w, 1e-5, "two_shot", True)
    assert all(torch.equal(o, want[0]) and torch.equal(r, want[1]) for o, r in zip(outs, oress))
    assert allreduce_rmsnorm.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0, 2000])
@pytest.mark.parametrize("bf16_norm", [False, True])
@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
@pytest.mark.parametrize("ws", [2, 4, 8])
def test_allreduce_rmsnorm_kernel_is_bit_equal_to_plain(cuda, ws, mode, bf16_norm, skew):
    """Rows 20 and 21 on ``ws`` virtual ranks of the card: one launch for
    all ranks; each rank's outputs bit-equal to the plain version's (the
    same summation order and rounding) and to every other rank's. H = 1032
    leaves the kernel's second chunk sweep ragged."""
    gen = torch.Generator().manual_seed(71 + ws)
    xs, res, w = allreduce_case(gen, ws, 16 * ws, 1032, cuda)
    want = _allreduce_rmsnorm_ref(xs, res[0], w, 1e-5, mode, bf16_norm)
    n0 = allreduce_rmsnorm.launches
    outs = run_ranks(make_mesh(tp=ws, devices=[cuda] * ws), lambda g, _: collective_rmsnorm(
        g, xs[g.rank], res[g.rank], w, 1e-5, mode, bf16_norm, skew))[0]
    torch.cuda.synchronize()
    assert allreduce_rmsnorm.launches == n0 + 1
    for r, (o, o_res) in enumerate(outs):
        assert torch.equal(o, want[0]) and torch.equal(o_res, want[1]), f"rank {r}"


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0, 2000])
@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
@pytest.mark.parametrize("ws,n,h", [(4, 8, 4096), (8, 2048, 4096)])
def test_allreduce_rmsnorm_kernel_at_serving_widths(cuda, ws, n, h, mode, skew):
    """slice_full_tp's decode collective (4 ranks x 8 tokens x 4096) and the
    JAX benchmark's world 8 x 2048 x 4096: every rank's outputs bit-equal to
    the plain version, one launch a call, with and without skew. one_shot
    shares the rows among the whole group's blocks, so at 8 rows most ranks'
    blocks reduce no row of their own rank and write every rank's outputs."""
    gen = torch.Generator().manual_seed(90 + ws)
    xs, res, w = allreduce_case(gen, ws, n, h, cuda)
    want = _allreduce_rmsnorm_ref(xs, res[0], w, 1e-5, mode, False)
    n0 = allreduce_rmsnorm.launches
    outs = run_ranks(make_mesh(tp=ws, devices=[cuda] * ws), lambda g, _: collective_rmsnorm(
        g, xs[g.rank], res[g.rank], w, 1e-5, mode, False, skew))[0]
    torch.cuda.synchronize()
    assert allreduce_rmsnorm.launches == n0 + 1
    for r, (o, o_res) in enumerate(outs):
        assert torch.equal(o, want[0]) and torch.equal(o_res, want[1]), f"rank {r}"


@pytest.mark.cuda
@pytest.mark.parametrize("h", [4096, 5120])
def test_allreduce_plain_version_on_the_card_equals_the_cpu(cuda, h):
    """The plain version gives the same bits on the card and on the CPU, so
    CPU ranks and card ranks compute one function (5120: the mean's division
    is not a product with an exact reciprocal)."""
    gen = torch.Generator().manual_seed(80)
    xs, res, w = allreduce_case(gen, 4, 2048, h)
    for mode in ("one_shot", "two_shot"):
        for bf16_norm in (False, True):
            cpu = _allreduce_rmsnorm_ref(xs, res[0], w, 1e-5, mode, bf16_norm)
            card = _allreduce_rmsnorm_ref([x.to(cuda) for x in xs], res[0].to(cuda), w.to(cuda), 1e-5, mode,
                                          bf16_norm)
            assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))


@pytest.mark.cuda
def test_allreduce_kernel_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator().manual_seed(81)
    xs, res, w = allreduce_case(gen, 2, 16, 256, cuda)
    outs = [torch.empty_like(xs[0]) for _ in range(2)]
    n0 = allreduce_rmsnorm.launches
    with pytest.raises(ValueError, match="bf16"):
        allreduce_rmsnorm([x.float() for x in xs], res, [w] * 2, outs, outs, 1e-5, "one_shot", False)
    with pytest.raises(ValueError, match="float32"):
        allreduce_rmsnorm(xs, res, [w.to(torch.bfloat16)] * 2, outs, outs, 1e-5, "one_shot", False)
    with pytest.raises(ValueError, match="ranks"):
        allreduce_rmsnorm(xs * 5, res * 5, [w] * 10, outs * 5, outs * 5, 1e-5, "one_shot", False)
    big = torch.zeros((16, 8200), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        allreduce_rmsnorm([big] * 2, [big] * 2, [torch.ones(8200, device=cuda)] * 2, [big] * 2, [big] * 2,
                          1e-5, "one_shot", False)
    assert allreduce_rmsnorm.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [False, True])
def test_tp_forward_step_on_the_card_syncs_nothing_and_matches_cpu(cuda, moe):
    """make_sharded_step on a tp-2 mesh of virtual ranks on the card: a
    prefill, then a decode step under sync debug mode "error" (no host
    sync in any rank); two collective launches a layer and call; logits
    within 0.15 abs / 0.1 rel of the same step on CPU ranks."""
    from hpc_ops_tpu_torch.models import llama as T

    cfg = T.tiny_config(moe=moe)
    w = T.init_weights(cfg, torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(tp=2, devices=[dev] * 2)
        t = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        weights = T.shard_weights(w, cfg, mesh)
        caches = [[T.init_cache(cfg, 8, BS, tp=2, device=dev) for _ in range(2)]]
        tbl = t([[0, 1, -1], [2, 3, -1]])
        n0 = allreduce_rmsnorm.launches
        lp, caches = T.make_sharded_step(mesh, cfg, True, max_seqlens_q=7)(
            weights, caches, t(list(range(12))), t([7, 5]), t([0, 7, 12]), tbl)
        decode = T.make_sharded_step(mesh, cfg, False, max_seqlens_q=1)
        step = (t([3, 5]), t([8, 6]), t([0, 1, 2]), tbl)
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ld, _ = decode(weights, caches, *step)
        finally:
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode("default")
        if dev != "cpu":
            torch.cuda.synchronize()
            assert allreduce_rmsnorm.launches == n0 + 2 * 2 * cfg.layers
        outs[str(dev)] = (lp.float().cpu(), ld.float().cpu())
    for name, c, g in zip(("prefill", "decode"), outs["cpu"], outs[str(cuda)]):
        assert_allclose(g, c, atol=0.15, rtol=0.1, name=f"tp {name} logits")


# ------------------------------------ the tensor-core prefill: tiling edges
# A block holds 128 q rows (128 / G tokens) and walks 64-column KV tiles
# through a ring of stages: q lengths that are no multiple of a block's
# tokens, KV prefixes longer than q with kv_len % 64 != 0, padded rows.
TILE_Q_LENS, TILE_KV_LENS = [45, 130, 33], [45, 300, 161]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "e4m3"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (32, 8), (64, 8)])
def test_prefill_kernel_tiles_match_plain(cuda, hq, hkv, d, kind):
    """GQA groups of 1, 4 and 8 at D 64 and 128, bf16 and e4m3 caches, one
    launch each."""
    gen = torch.Generator().manual_seed(70)
    make = paged if kind == "bf16" else fp8_paged
    q, k, v, tbl, kv = make(gen, TILE_KV_LENS, hq, hkv, d, q_rows=sum(TILE_Q_LENS) + 7)
    cu = torch.tensor([0] + torch.tensor(TILE_Q_LENS).cumsum(0).tolist(), dtype=torch.int32)
    scales = (None, None) if kind == "bf16" else (KS, VS)
    want = _prefill_ref(q, k, v, cu, tbl, kv, max(TILE_Q_LENS), d**-0.5, "HND", *scales)
    n0 = paged_prefill_attention.launches
    got = paged_prefill_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), cu.to(cuda), tbl.to(cuda), kv.to(cuda),
        max(TILE_Q_LENS), d**-0.5, "HND", *(None if t is None else t.to(cuda) for t in scales))
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2,
                    name=f"prefill {kind} G={hq // hkv} D={d}")


@pytest.mark.cuda
def test_prefill_kernel_one_4096_row_request(cuda):
    """One request of 4096 rows (64 KV tiles through the ring for the last
    q tiles), against the plain version run on the card."""
    gen = torch.Generator().manual_seed(71)
    q, k, v, tbl, kv = (t.to(cuda) for t in paged(gen, [4096], 32, 8, 128, q_rows=4096))
    cu = torch.tensor([0, 4096], dtype=torch.int32, device=cuda)
    want = _prefill_ref(q, k, v, cu, tbl, kv, 4096, 128**-0.5, "HND")
    n0 = paged_prefill_attention.launches
    got = paged_prefill_attention(q, k, v, cu, tbl, kv, 4096, 128**-0.5, "HND")
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="prefill 4096 rows")


@pytest.mark.cuda
def test_prefill_kernel_ignores_nan_past_kv_len(cuda):
    """Split HND caches with NaN at and past kv_len in each request's last
    page (chunked prefill): those rows are zero-filled, never read, so a
    masked column multiplies no NaN."""
    gen = torch.Generator().manual_seed(72)
    q_lens, kv_lens = [3, 20, 70], [3, 45, 100]
    q, k, v, tbl, kv = paged(gen, kv_lens, 32, 8, 128, q_rows=sum(q_lens))
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    want = _prefill_ref(q, k, v, cu, tbl, kv, max(q_lens), 128**-0.5, "HND")
    for i, n in enumerate(kv_lens):
        page = int(tbl[i, n // BS])
        assert page >= 0
        k[:, page, n % BS :] = float("nan")
        v[:, page, n % BS :] = float("nan")
    n0 = paged_prefill_attention.launches
    got = paged_prefill_attention(q.to(cuda), k.to(cuda), v.to(cuda), cu.to(cuda), tbl.to(cuda),
                                  kv.to(cuda), max(q_lens), 128**-0.5, "HND")
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="prefill nan tail")


@pytest.mark.cuda
def test_prefill_grouped_k_scales_at_d64_in_eight_groups(cuda):
    """K scales in 8 groups of 8 columns at D 64 (G 8): a k-step of 16
    spans two groups, so each group's product zeroes the other's half of
    q; within ``close_scaled`` of the plain version, one launch."""
    gen = torch.Generator().manual_seed(73)
    q_lens, kv_lens = [45, 130], [100, 300]
    q, k, v, tbl, kv = fp8_paged(gen, kv_lens, 64, 8, 64, q_rows=sum(q_lens) + 3)
    cu = torch.tensor([0] + torch.tensor(q_lens).cumsum(0).tolist(), dtype=torch.int32)
    _, vhead = token_scales(gen, k, "HND")
    ktok = group_scales(gen, k, "HND", 8)
    args = (q, k, v, cu, tbl, kv)
    want = _prefill_ref(*args, max(q_lens), 64**-0.5, "HND", None, vhead, ktok)
    n0 = paged_prefill_attention.launches
    got = paged_prefill_attention(*(t.to(cuda) for t in args), max(q_lens), 64**-0.5, "HND", None,
                                  vhead.to(cuda), ktok.to(cuda))
    assert paged_prefill_attention.launches == n0 + 1
    close_scaled(got, want, "prefill D=64 G=8 groups")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "e4m3"])
def test_prefill_sparse_ring_skips_stages(cuda, kind):
    """A mask keeping every third 64-column tile and each q tile's diagonal
    one, so consecutive stages of the ring hold tiles far apart; q head 1
    keeps nothing in request 0's first q tile (its rows come back 0)."""
    gen = torch.Generator().manual_seed(74)
    q_lens, kv_lens = [200, 77], [900, 77]
    args, lay, _, (ks, vs) = sparse_case(gen, kind, "HND", q_lens, kv_lens, pad=5, mtq=64, mtkv=64)
    mask = torch.zeros((2, 32, -(-max(q_lens) // 64), -(-max(kv_lens) // 64)), dtype=torch.uint8)
    mask[:, :, :, ::3] = 1
    for b, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        for t in range(-(-ql // 64)):
            mask[b, :, t, (kl - ql + t * 64) // 64] = 1
    mask[0, 1, 0] = 0
    want = _prefill_sparse_ref(*args, 128**-0.5, lay, mask, 64, 64, ks, vs)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    n0 = paged_prefill_sparse.launches
    got = paged_prefill_sparse(*dev, 128**-0.5, lay, mask.to(cuda), 64, 64,
                               None if ks is None else ks.to(cuda), None if vs is None else vs.to(cuda))
    torch.cuda.synchronize()
    assert paged_prefill_sparse.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"sparse ring {kind}")
    assert not got[:64, 1].float().any()


@pytest.mark.cuda
def test_prefill_sparse_empty_walk_writes_zeros(cuda):
    """Blocks whose every row keeps no tile (all G heads of a kv head masked
    over whole q tiles) walk nothing: their rows come back exactly 0, never
    q's values staged in the shared memory the epilogue reuses; the other
    rows match the plain version."""
    gen = torch.Generator().manual_seed(75)
    q_lens, kv_lens = [200, 77], [900, 77]
    args, lay, mask, _ = sparse_case(gen, "bf16", "HND", q_lens, kv_lens, pad=5, mtq=64, mtkv=64)
    mask[0, 0:4, 0:2] = 0  # kv head 0's group, request 0's first 128 tokens: 4 blocks of 32
    mask[1, 4:8] = 0  # kv head 1's group, all of request 1
    want = _prefill_sparse_ref(*args, 128**-0.5, lay, mask, 64, 64)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    n0 = paged_prefill_sparse.launches
    got = paged_prefill_sparse(*dev, 128**-0.5, lay, mask.to(cuda), 64, 64)
    torch.cuda.synchronize()
    assert paged_prefill_sparse.launches == n0 + 1
    assert not got[:128, 0:4].float().any()
    assert not got[200:277, 4:8].float().any()
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="sparse empty walk")


# ------------------------------- fault F5's head shapes; the split-KV decode grid
# Every kernel against its plain version at the file's 1e-2 (grouped K
# scales: close_scaled). F5: prefill (dense, sparse, NHD_FUSED slab) at
# head_dim 96 and 256 and at Hq 128 over Hkv 1, decode at G * sq = 160 and
# G 128; each raised ValueError on the card before the kernels took them.
# Split-KV: splitk=True and False agree, repeated calls are bit-equal (the
# tickets go back to 0), two streams at once, mostly empty chunks, a 64K
# request, NaN past kv_len.
from hpc_ops_tpu_torch.ops.attention.decode import decode_splits  # noqa: E402

F5_SHAPES = {"d96": (96, 32, 8), "d256": (256, 8, 2), "g128": (128, 128, 1)}
F5_Q, F5_KV = [13, 7, 150], [13, 100, 300]


def f5_prefill_case(gen, kind, d, hq, hkv, pad=5):
    """q, HND caches of ``kind``, cu, table, lengths and the kind's scales."""
    q, k, v, tbl, kv = paged(gen, F5_KV, hq, hkv, d, q_rows=sum(F5_Q) + pad)
    if kind == "int8":
        k, v = (torch.randint(-127, 128, tuple(t.shape), generator=gen, dtype=torch.int8) for t in (k, v))
        ks, vs = SC, SC
    elif kind == "e4m3":
        k, v = (k.float() * 0.05).to(FP8), (v.float() * 0.05).to(FP8)
        ks, vs = KS, VS
    else:
        ks = vs = None
    cu = torch.tensor([0] + torch.tensor(F5_Q).cumsum(0).tolist(), dtype=torch.int32)
    return (q, k, v, cu, tbl, kv), ks, vs


def on(dev, *ts):
    return [None if t is None else t.to(dev) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("shape", list(F5_SHAPES))
def test_f5_prefill_head_shapes_match_plain(cuda, shape, kind):
    gen = torch.Generator().manual_seed(80)
    d, hq, hkv = F5_SHAPES[shape]
    args, ks, vs = f5_prefill_case(gen, kind, d, hq, hkv)
    want = _prefill_ref(*args, max(F5_Q), d**-0.5, "HND", ks, vs)
    n0 = paged_prefill_attention.launches
    got = paged_prefill_attention(*on(cuda, *args), max(F5_Q), d**-0.5, "HND", *on(cuda, ks, vs))
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"f5 prefill {shape} {kind}")
    assert not got[sum(F5_Q):].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [("d96", 3), ("d256", 4), ("g128", 1)])
def test_f5_prefill_per_token_k_scales_match_plain(cuda, shape, groups):
    """e4m3 with K scales per token and kv head in groups along D (D 96: 3
    groups of 32 columns, D 256: 4 of 64) and a V scale per head."""
    gen = torch.Generator().manual_seed(81)
    d, hq, hkv = F5_SHAPES[shape]
    args, _, _ = f5_prefill_case(gen, "e4m3", d, hq, hkv)
    ktok, vhead = group_scales(gen, args[1], "HND", groups), torch.rand(hkv, generator=gen) * 20 + 10
    want = _prefill_ref(*args, max(F5_Q), d**-0.5, "HND", None, vhead, ktok)
    got = paged_prefill_attention(*on(cuda, *args), max(F5_Q), d**-0.5, "HND", None,
                                  *on(cuda, vhead, ktok))
    close_scaled(got, want, f"f5 prefill {shape} {groups} K-scale groups")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "e4m3"])
@pytest.mark.parametrize("shape", list(F5_SHAPES))
def test_f5_prefill_sparse_head_shapes_match_plain(cuda, shape, kind):
    gen = torch.Generator().manual_seed(82)
    d, hq, hkv = F5_SHAPES[shape]
    args, ks, vs = f5_prefill_case(gen, kind, d, hq, hkv)
    mask = sparse_mask(gen, F5_Q, F5_KV, hq, 128, 64)
    want = _prefill_sparse_ref(*args, max(F5_Q), d**-0.5, "HND", mask, 128, 64, ks, vs)
    n0 = paged_prefill_sparse.launches
    got = paged_prefill_sparse(*on(cuda, *args), max(F5_Q), d**-0.5, "HND", mask.to(cuda), 128, 64,
                               *on(cuda, ks, vs))
    torch.cuda.synchronize()
    assert paged_prefill_sparse.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"f5 sparse {shape} {kind}")
    assert not got[:13, 1].float().any()  # q head 1 keeps nothing in request 0's first q tile


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("shape", list(F5_SHAPES))
def test_f5_prefill_nhd_fused_head_shapes_match_plain(cuda, shape, kind):
    gen = torch.Generator().manual_seed(83)
    d, hq, hkv = F5_SHAPES[shape]
    (q, k, v, cu, tbl, kv), _, _ = f5_prefill_case(gen, "bf16", d, hq, hkv)
    slab = pack_kv_fused_nhd(k, v)
    scs = (None, None)
    if kind == "int8":
        slab = torch.randint(-127, 128, tuple(slab.shape), generator=gen, dtype=torch.int8)
        scs = (SC, SC)
    want = _prefill_nhd_fused_ref(q, slab, cu, tbl, kv, max(F5_Q), d**-0.5, *scs)
    n0 = paged_prefill_nhd_fused.launches
    got = paged_prefill_nhd_fused(*on(cuda, q, slab, cu, tbl, kv), max(F5_Q), d**-0.5, *on(cuda, *scs))
    torch.cuda.synchronize()
    assert paged_prefill_nhd_fused.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"f5 slab {shape} {kind}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("hq,sq", [(32, 5), (128, 1)])
def test_f5_decode_large_groups_match_plain(cuda, hq, sq, kind):
    """G * sq = 160 (G 32, mtp 4) and G 128 over one kv head: every layout
    through attention_decode, split and not, and the task map."""
    gen = torch.Generator().manual_seed(84)
    lens = [max(n, sq) for n in (1, 300, 4097, 64)]
    q, k, v, tbl, kv_lens, ks, vs = fused_caches(gen, lens, kind, sq=sq, hq=hq, hkv=1)
    want = _decode_ref(q, k, v, tbl, kv_lens, sq, 128**-0.5, "HND", ks, vs)
    kw = dict(mtp=sq - 1, new_kv_included=True, kscale=None if ks is None else ks.to(cuda),
              vscale=None if vs is None else vs.to(cuda))
    dq, dtbl, dlens = on(cuda, q, tbl, kv_lens)
    for layout in ("HND", "NHD", "FUSED", "NHD_FUSED"):
        kc, vc = on(cuda, *layout_caches(k, v, layout))
        for splitk in (True, False):
            got = attention_decode(dq, kc, vc, dtbl, dlens, splitk=splitk, cache_layout=layout, **kw)
            assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2,
                            name=f"f5 decode G*sq={hq * sq} {kind} {layout} splitk={splitk}")
    tm = assign_attention_decode_task(dlens, 1, sq - 1, True, tile=256, min_process_len=512,
                                      impl="torch")
    kc, vc = on(cuda, k, v)
    got = attention_decode(dq, kc, vc, dtbl, dlens, task_map=tm, cache_layout="HND", **kw)
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"f5 task map {kind}")


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4])
def test_f5_decode_qt0_large_group_matches_plain(cuda, groups):
    gen = torch.Generator().manual_seed(85)
    q, k, v, tbl, kv_lens = fp8_paged(gen, [5, 300, 4097, 64], 32, 1, 128, sq=5)
    ktok, vhead = group_scales(gen, k, "HND", groups), torch.rand(1, generator=gen) * 20 + 10
    want = _decode_qt0_ref(q, k, v, ktok, vhead, tbl, kv_lens, 5, 128**-0.5, "HND")
    for splitk in (True, False):
        got = paged_decode_qt0(*on(cuda, q, k, v, ktok, vhead, tbl, kv_lens), 5, 128**-0.5, "HND",
                               splitk=splitk)
        close_scaled(got, want, f"f5 qt0 G 32 sq 5, {groups} groups, splitk={splitk}")


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(64, 64), (72, 72), (96, 96), (256, 256), (128, 64)])
def test_decode_head_dims_match_plain(cuda, d, dv):
    """Every head_dim of 16-byte bf16 rows up to 256 (72 pads its last
    k-step with zero columns), and Dv below D."""
    gen = torch.Generator().manual_seed(86)
    q, k, v, tbl, kv_lens = paged(gen, [1, 17, 300, 2000], 16, 4, d, sq=2)
    v = v[..., :dv].contiguous()
    want = _decode_ref(q, k, v, tbl, kv_lens, 2, d**-0.5, "HND")
    for splitk in (True, False):
        got = paged_decode_attention(*on(cuda, q, k, v, tbl, kv_lens), 2, d**-0.5, "HND", splitk=splitk)
        assert got.shape == (8, 16, dv)
        assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2,
                        name=f"decode d={d} dv={dv} splitk={splitk}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8", "e4m3"])
@pytest.mark.parametrize("layout", ["HND", "NHD", "FUSED", "NHD_FUSED"])
def test_splitk_true_and_false_agree(cuda, layout, kind):
    gen = torch.Generator().manual_seed(87)
    lens = [max(n, 2) for n in (1, 16, 17, 300, 1024, 4095, 3, 64)]
    q, k, v, tbl, kv_lens, ks, vs = fused_caches(gen, lens, kind, sq=2)
    assert decode_splits(8, tbl.shape[1] * BS) == 16
    want = _decode_ref(q, k, v, tbl, kv_lens, 2, 128**-0.5, "HND", ks, vs)
    kc, vc = on(cuda, *layout_caches(k, v, layout))
    kw = dict(mtp=1, new_kv_included=True, cache_layout=layout, kscale=None if ks is None else ks.to(cuda),
              vscale=None if vs is None else vs.to(cuda))
    outs = {}
    for splitk in (True, False):
        outs[splitk] = attention_decode(*on(cuda, q), kc, vc, *on(cuda, tbl, kv_lens), splitk=splitk, **kw)
        assert_allclose(outs[splitk].float(), want.float(), atol=1e-2, rtol=1e-2,
                        name=f"{layout} {kind} splitk={splitk}")
    assert_allclose(outs[True].float(), outs[False].float(), atol=1e-2, rtol=1e-2, name="split vs not")


@pytest.mark.cuda
def test_splitk_ten_calls_in_a_row_are_bit_equal(cuda):
    """The last block of each (request, kv head) resets its ticket: every
    call merges the same chunks in the same order."""
    gen = torch.Generator().manual_seed(88)
    q, k, v, tbl, kv_lens = on(cuda, *paged(gen, [1, 16, 17, 300, 1024, 4095, 3, 64], 32, 8, 128))
    first = paged_decode_attention(q, k, v, tbl, kv_lens, 1, 128**-0.5, "HND")
    for _ in range(9):
        assert torch.equal(paged_decode_attention(q, k, v, tbl, kv_lens, 1, 128**-0.5, "HND"), first)
    want = _decode_ref(*on("cpu", q, k, v, tbl, kv_lens), 1, 128**-0.5, "HND")
    assert_allclose(first.float(), want.float(), atol=1e-2, rtol=1e-2, name="ten calls")


@pytest.mark.cuda
def test_splitk_two_streams_at_once(cuda):
    """Two streams decode different batches at once, as the tensor-parallel
    ranks do: each stream's tickets are its own."""
    gen = torch.Generator().manual_seed(89)
    cases = [paged(gen, lens, 32, 8, 128) for lens in ([4095, 1, 300, 2000], [17, 4000, 3, 1024])]
    wants = [_decode_ref(*c, 1, 128**-0.5, "HND") for c in cases]
    dev = [on(cuda, *c) for c in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(paged_decode_attention(*dev[i], 1, 128**-0.5, "HND"))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            assert_allclose(got.float(), wants[i].float(), atol=1e-2, rtol=1e-2, name=f"stream {i}")


@pytest.mark.cuda
def test_splitk_short_requests_among_a_long_one(cuda):
    """kv_len 1 beside a 4096-token request: most chunks start past their
    request's length and write the neutral partial."""
    gen = torch.Generator().manual_seed(90)
    lens = [1, 1, 4096, 1, 2, 1, 1, 1]
    q, k, v, tbl, kv_lens = paged(gen, lens, 32, 8, 128)
    want = _decode_ref(q, k, v, tbl, kv_lens, 1, 128**-0.5, "HND")
    got = paged_decode_attention(*on(cuda, q, k, v, tbl, kv_lens), 1, 128**-0.5, "HND")
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="short among long")


@pytest.mark.cuda
def test_splitk_one_64k_request(cuda):
    gen = torch.Generator().manual_seed(91)
    q, k, v, tbl, kv_lens = paged(gen, [65536], 32, 8, 128)
    want = _decode_ref(q, k, v, tbl, kv_lens, 1, 128**-0.5, "HND")
    for splitk in (True, False):
        got = paged_decode_attention(*on(cuda, q, k, v, tbl, kv_lens), 1, 128**-0.5, "HND",
                                     splitk=splitk)
        assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"64K splitk={splitk}")


@pytest.mark.cuda
@pytest.mark.parametrize("splitk", [True, False])
def test_splitk_keeps_nan_past_kv_len_out(cuda, splitk):
    gen = torch.Generator().manual_seed(92)
    q, k, v, tbl, kv_lens = paged(gen, [3, 20, 1000, 4001], 8, 2, 128)
    want = _decode_ref(q, k, v, tbl, kv_lens, 1, 128**-0.5, "HND")
    for i, n in enumerate(kv_lens.tolist()):
        page = int(tbl[i, n // BS])
        k[:, page, n % BS :] = float("nan")
        v[:, page, n % BS :] = float("nan")
    got = paged_decode_attention(*on(cuda, q, k, v, tbl, kv_lens), 1, 128**-0.5, "HND", splitk=splitk)
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"nan tail splitk={splitk}")


@pytest.mark.cuda
def test_decode_wrappers_refuse_a_misaligned_q(cuda):
    """The decode kernel copies q's rows 16 bytes at a time."""
    gen = torch.Generator().manual_seed(93)
    q, k, v, tbl, kv_lens = on(cuda, *paged(gen, [20, 40], 8, 2, 128))
    bad = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_attention(bad, k, v, tbl, kv_lens, 1, 0.1, "HND")
    with pytest.raises(ValueError, match="16-byte aligned"):
        paged_decode_nhd_fused(bad, pack_kv_fused_nhd(k, v), tbl, kv_lens, 1, 0.1)


# ------------------------------------------ captured multi-step decode
# decode_multi captured as one CUDA graph (runtime/decode_graph.py) against
# the eager loop on a copy of the same caches: tokens equal, logprobs within
# 1e-5 (the same kernels on the same inputs; the log-softmax is the only
# float32 step outside them), the caches bit-equal afterwards.
from hpc_ops_tpu_torch.parallel.collective_kernels import MODES, _SignalPad  # noqa: E402
from hpc_ops_tpu_torch.runtime.decode_graph import DecodeMultiGraph  # noqa: E402

MULTI_MODES = {
    "bf16": {}, "int8_kv": dict(int8_kv=True, kv_scale=0.02), "fp8_kv": dict(fp8_kv=True),
    "dense_int8": dict(dense_int8=True), "moe_fp8": dict(moe="pertensor_fp8"),
    "moe_int8": dict(moe="pertensor_int8"), "moe_bw": dict(moe="blockwise_int8"),
}
MULTI_PROMPTS = [5, 9, 3, 17]  # prompt lengths of the batch, 4 pages of 16 slots each
MULTI_STEPS = 4


def multi_model(mode, dev, seed=0):
    """tiny_config in a serving mode, seeded weights on ``dev``."""
    from hpc_ops_tpu_torch.models import llama as T

    kw = dict(MULTI_MODES[mode])
    scheme = kw.pop("moe", None)
    cfg = T.tiny_config(moe=scheme is not None, **kw)
    if scheme is not None:
        cfg = cfg._replace(moe=cfg.moe._replace(scheme=scheme))
    w = T.init_weights(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return cfg, {**{k: v.to(dev) for k, v in w.items() if k != "layers"},
                 "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in w["layers"]]}


def multi_prefill(step, dev, vocab):
    """Prefill MULTI_PROMPTS through ``step(tokens, seq_lens, q_index, table,
    max_q)`` (a prefill forward call); returns the decode inputs: last tokens,
    seq_lens (prompt + 1) and the page table."""
    b = len(MULTI_PROMPTS)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, vocab, (sum(MULTI_PROMPTS),), generator=gen, dtype=torch.int32)
    cu = torch.tensor([0] + torch.tensor(MULTI_PROMPTS).cumsum(0).tolist(), dtype=torch.int32)
    tbl = torch.arange(4 * b, dtype=torch.int32).view(b, 4)
    logits = step(toks.to(dev), torch.tensor(MULTI_PROMPTS, dtype=torch.int32, device=dev), cu.to(dev),
                  tbl.to(dev), max(MULTI_PROMPTS))
    last = torch.argmax(logits, dim=-1).to(torch.int32)
    return last, torch.tensor(MULTI_PROMPTS, dtype=torch.int32, device=dev) + 1, tbl.to(dev)


def clone_caches(caches):
    return [{k: v.clone() for k, v in layer.items()} for layer in caches]


def equal_caches(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("mode", list(MULTI_MODES))
def test_decode_multi_graph_equals_the_eager_loop(cuda, mode, temperature):
    """Each serving mode: three dispatches with new inputs each (the tokens
    fed back, the lengths grown), the graph against decode_multi's loop with
    the same seed; then, at temperature 0.7, a replay of the last inputs with
    the same seed gives the same tokens and with another seed others."""
    from hpc_ops_tpu_torch import kernels
    from hpc_ops_tpu_torch.models import llama as T

    cfg, w = multi_model(mode, cuda)
    caches = T.init_cache(cfg, num_blocks=32, block_size=BS, device=cuda)
    last, lens, tbl = multi_prefill(lambda *a: T.forward_step(
        w, caches, cfg, *a[:4], is_prefill=True, max_seqlens_q=a[4])[0], cuda, cfg.vocab)
    graph_caches = clone_caches(caches)

    def body(toks, seq_lens, table, gens):
        return T.decode_multi(w, graph_caches, cfg, toks, seq_lens, table, MULTI_STEPS,
                              temperature=temperature, return_logprobs=True,
                              generator=None if gens is None else gens[0])[0]

    graph = DecodeMultiGraph(body, len(MULTI_PROMPTS), 4, MULTI_STEPS, cuda, temperature=temperature,
                             return_logprobs=True)
    for dispatch in range(3):
        seed = 11 + dispatch
        (want, want_lp), _ = T.decode_multi(w, caches, cfg, last, lens, tbl, MULTI_STEPS,
                                            temperature=temperature, sample_seed=seed, return_logprobs=True)
        n0 = kernels.launch_counts()
        got, got_lp = graph(last.cpu().numpy(), lens.cpu().numpy(), tbl.cpu().numpy(), seed)
        if dispatch:  # a replay adds the launches of its capture
            assert {k: v - n0[k] for k, v in kernels.launch_counts().items() if v != n0[k]} == graph.launches
        assert (got == want.cpu().numpy()).all(), f"{mode} dispatch {dispatch}: {got} != {want}"
        assert_allclose(got_lp, want_lp, atol=1e-5, rtol=0, name=f"{mode} logprobs {dispatch}")
        if dispatch < 2:
            last, lens = want[-1], lens + MULTI_STEPS
    assert equal_caches(caches, graph_caches), f"{mode}: the caches differ"
    assert graph.stats["host_memcpy_nodes"] == 0 and graph.launches
    if temperature > 0:
        inputs = (last.cpu().numpy(), lens.cpu().numpy(), tbl.cpu().numpy())
        again, _ = graph(*inputs, 13)
        other, _ = graph(*inputs, 14)
        assert (again == got).all() and (other != got).any()


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_multi_step_graph_equals_the_eager_loop(cuda, tp, temperature):
    """make_sharded_multi_step on tp virtual ranks: one graph for the mesh,
    three dispatches against the eager ranks on a copy of the caches, the
    collective counted through the replays at 2 x layers x steps."""
    from hpc_ops_tpu_torch.models import llama as T

    cfg, w = multi_model("bf16", cuda)
    mesh = make_mesh(tp=tp, devices=[cuda] * tp)
    weights = T.shard_weights(w, cfg, mesh)
    caches = [[T.init_cache(cfg, 32, BS, tp=tp, device=cuda) for _ in range(tp)]]
    prefill = T.make_sharded_step(mesh, cfg, True, max_seqlens_q=max(MULTI_PROMPTS))
    last, lens, tbl = multi_prefill(lambda *a: prefill(weights, caches, *a[:4])[0], cuda, cfg.vocab)
    graph_caches = [[clone_caches(c) for c in row] for row in caches]
    eager = T._sharded_multi_body(mesh, cfg, MULTI_STEPS, True, temperature, weights, caches)
    step = T.make_sharded_multi_step(mesh, cfg, MULTI_STEPS, return_logprobs=True, temperature=temperature)
    for dispatch in range(3):
        seed = 21 + dispatch
        gens = ([torch.Generator(device=cuda).manual_seed(seed) for _ in range(tp)]
                if temperature > 0 else None)
        want, want_lp = eager(last, lens, tbl, gens)
        n0 = allreduce_rmsnorm.launches
        (got, got_lp), _ = step(weights, graph_caches, last, lens, tbl, seed)
        torch.cuda.synchronize()
        if dispatch:
            assert allreduce_rmsnorm.launches == n0 + 2 * cfg.layers * MULTI_STEPS
        assert torch.equal(got, want), f"tp {tp} dispatch {dispatch}"
        assert_allclose(got_lp, want_lp, atol=1e-5, rtol=0, name=f"tp {tp} logprobs {dispatch}")
        last, lens = want[-1].clone(), lens + MULTI_STEPS
    for a, b in zip(caches[0], graph_caches[0]):
        assert equal_caches(a, b)


def profile_dispatch(fn):
    """torch.profiler over ``fn``: (graph launches, device-to-host copies,
    kernels run on the device)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    launches = sum(e.count for e in events if "cudaGraphLaunch" in e.key and e.device_type != cuda_t)
    dtoh = sum(e.count for e in events if e.device_type == cuda_t and "Memcpy DtoH" in e.key)
    kernels_run = sum(e.count for e in events if e.device_type == cuda_t and "Memcpy" not in e.key
                      and "Memset" not in e.key)
    return launches, dtoh, kernels_run


@pytest.mark.cuda
@pytest.mark.parametrize("logprobs", [False, True])
@pytest.mark.parametrize("sharded", [False, True])
def test_engine_multi_step_dispatch_is_one_replay(cuda, sharded, logprobs):
    """Engine(multi_step=4) and ShardedEngine(multi_step=4) on tp 2 virtual
    ranks: tokens (and logprobs within 1e-5) equal to multi_step=1's; a
    decode dispatch after the first is one graph launch and one
    device-to-host copy (torch.profiler); the tp graph's collective nodes
    are cooperative launches."""
    from hpc_ops_tpu_torch.runtime.engine import Engine
    from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine

    cfg, w = multi_model("bf16", cuda)
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61))]

    def make(ms):
        if sharded:
            return ShardedEngine(cfg, w, make_mesh(tp=2, devices=[cuda] * 2), num_blocks=64, block_size=BS,
                                 max_batch=4, multi_step=ms, logprobs=logprobs)
        return Engine(cfg, w, num_blocks=64, block_size=BS, max_batch=4, multi_step=ms, logprobs=logprobs,
                      device=cuda)

    base = make(1)
    want = base.run(prompts, max_new=12)
    eng = make(4)
    rids = [eng.add_request(p, max_new=12) for p in prompts]
    seen = []
    while True:
        st = eng.stats
        decode_next = st["pending"] == 0 and st["active"] > 0
        if decode_next and st["decode_dispatches"] >= 1:
            seen.append(profile_dispatch(eng.step))
        elif not eng.step():
            break
    assert [eng.requests[r].out for r in rids] == want
    if logprobs:
        for r in rids:
            assert_allclose(eng.requests[r].logprobs, base.requests[r].logprobs, atol=1e-5, rtol=0,
                            name=f"logprobs {r}")
    assert seen and all(s[:2] == (1, 1) for s in seen), seen
    stats = (eng._multi.graph if sharded else eng._multi).stats
    if sharded:
        assert stats["collective_nodes"] == 2 * cfg.layers * 4
        assert stats["collective_nodes_cooperative"] == stats["collective_nodes"], stats


@pytest.mark.cuda
def test_collective_epoch_is_kept_on_the_device(cuda):
    """Row 20-21's epoch, held in the signal pad: 20 calls on one pad that mix
    eager launches with replays of a captured one_shot and two_shot launch,
    at skew, each on new partials: every rank's outputs bit-equal to the
    plain version's, and the pad's epoch one higher after every call."""
    gen = torch.Generator().manual_seed(96)
    ws, n, h, skew = 4, 64, 1032, 2000
    xs, res, w = allreduce_case(gen, ws, n, h, cuda)
    pad = _SignalPad(cuda)
    outs = {m: ([torch.empty_like(xs[0]) for _ in range(ws)], [torch.empty_like(xs[0]) for _ in range(ws)])
            for m in MODES}

    def call(mode):
        allreduce_rmsnorm(xs, res, [w] * ws, *outs[mode], 1e-5, mode, False, skew, pad)

    for mode in MODES:  # eager first: the launcher's attributes and occupancy
        call(mode)
    graphs, side = {}, torch.cuda.Stream()
    for mode in MODES:
        graphs[mode] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[mode], stream=side):
            call(mode)
    e0 = pad.epoch()
    for i in range(20):
        mode = MODES[i % 2]
        kind = ("eager", "replay", "replay", "eager")[(i // 2) % 4]
        for x in xs:
            x.copy_((torch.randn((n, h), generator=gen) * 0.5).to(torch.bfloat16))
        graphs[mode].replay() if kind == "replay" else call(mode)
        torch.cuda.synchronize()
        want = _allreduce_rmsnorm_ref(xs, res[0], w, 1e-5, mode, False)
        for r in range(ws):
            assert torch.equal(outs[mode][0][r], want[0]) and torch.equal(outs[mode][1][r], want[1]), \
                f"call {i} ({kind} {mode}) rank {r}"
        assert pad.epoch() == e0 + i + 1, f"call {i} ({kind} {mode})"


# ------------------------------------------- the rest of the serving engine
# Speculative verification runs the decode kernel at sq = k + 1; rejected
# drafts leave rows past a request's committed length, which the kernel must
# never read (NaN there leaves the output equal to the plain version's).
from hpc_ops_tpu_torch.parallel.ring_attention import ring_attention, zigzag_layout, zigzag_unlayout  # noqa: E402
from hpc_ops_tpu_torch.utils.replay import TraceHook, replay_record  # noqa: E402
from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("splitk", [True, False])
@pytest.mark.parametrize("sq", [4, 8])
def test_decode_at_draft_widths_keeps_nan_past_kv_len_out(cuda, sq, splitk):
    """llama3_8b's heads (G 4) at mtp 3 and 7: G * sq of 16 and 32 rows (one
    and two row blocks), rows past each request's kv_len NaN."""
    gen = torch.Generator().manual_seed(97)
    q, k, v, tbl, kv_lens = paged(gen, [sq, 20, 1000, 4001, 17, 64], 32, 8, 128, sq=sq)
    want = _decode_ref(q, k, v, tbl, kv_lens, sq, 128**-0.5, "HND")
    for i, n in enumerate(kv_lens.tolist()):
        page = int(tbl[i, n // BS])
        k[:, page, n % BS :] = float("nan")
        v[:, page, n % BS :] = float("nan")
    got = attention_decode(*on(cuda, q, k, v, tbl, kv_lens), mtp=sq - 1, new_kv_included=True,
                           cache_layout="HND", splitk=splitk)
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name=f"sq {sq} splitk={splitk}")


def _engine_pair(cuda, **cfg_kw):
    """tiny_config at llama3_8b's GQA group of 4 (kv_heads 2), seeded weights
    on the CPU and on the card."""
    from hpc_ops_tpu_torch.models import llama as T

    cfg = T.tiny_config(**cfg_kw)._replace(kv_heads=2)
    w = T.init_weights(cfg, torch.Generator().manual_seed(3), device="cpu")
    return cfg, w, {**{k: v.to(cuda) for k, v in w.items() if k != "layers"},
                    "layers": [{k: v.to(cuda) for k, v in layer.items()} for layer in w["layers"]]}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 7])
def test_engine_speculative_on_the_card_matches_cpu(cuda, k):
    """Engine(speculative_k=k) on the card (the decode kernel at sq = k + 1)
    against the CPU engine: an oracle drafter fed by the CPU's plain greedy
    tokens, then the default n-gram drafter; tokens equal but for a first
    flip at a CPU top-2 margin below 0.15 (the logits tolerance), and the
    card's verification steps each one device-to-host copy."""
    from hpc_ops_tpu_torch.models import llama as T
    from hpc_ops_tpu_torch.runtime.engine import Engine

    cfg, w_cpu, w = _engine_pair(cuda)
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5], list(range(30, 70)), [9] * 20]
    kw = dict(num_blocks=64, block_size=BS, max_batch=4)
    want = Engine(cfg, w_cpu, device="cpu", **kw).run(prompts, max_new=12)
    fulls = [p + o for p, o in zip(prompts, want)]

    def oracle(tokens, kk):
        for f in fulls:
            if f[: len(tokens)] == list(tokens):
                return f[len(tokens) : len(tokens) + kk]
        return []

    def margin(tokens):
        n = len(tokens)
        t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
        caches = T.init_cache(cfg, 8, BS, device="cpu")
        logits, _ = T.forward_step(w_cpu, caches, cfg, t(tokens), t([n]), t([0, n]), t([list(range(8))]),
                                   is_prefill=True, max_seqlens_q=n)
        return top2_margin(logits.float().reshape(-1))

    for drafter in (oracle, None):
        eng = Engine(cfg, w, device=cuda, speculative_k=k, draft_fn=drafter, **kw)
        rids = [eng.add_request(p, max_new=12) for p in prompts]
        eng.step(), eng.step(), eng.step(), eng.step()  # the prefills
        copies = profile_dispatch(eng.step)[1]
        while eng.step():
            pass
        got = [eng.requests[r].out for r in rids]
        for p, a, b in zip(prompts, want, got):
            assert_greedy_match(a, b, lambda j, p=p, a=a: margin(p + a[:j]), 0.15)
        assert copies == 1 and eng.spec_proposed > 0
        if drafter is oracle:
            assert eng.speculative_stats["acceptance"] > 0.8
        assert eng.alloc.num_free == eng.alloc.num_blocks - 1


@pytest.mark.cuda
def test_engine_n_best_copies_pages_in_place_under_the_graph(cuda):
    """Engine(multi_step=4, temperature): a first request captures the graph;
    then an n = 3 request forks the parent's pages and copies its partial tail
    page in place (the graph holds the caches' addresses). The copied pages
    equal the parent's in every layer, the children decode through replays of
    the same graph, tokens in the vocab, every page returned."""
    from hpc_ops_tpu_torch.runtime.engine import Engine

    cfg, _, w = _engine_pair(cuda)
    eng = Engine(cfg, w, device=cuda, num_blocks=64, block_size=BS, max_batch=4, multi_step=4,
                 temperature=0.8, seed=5)
    free0 = eng.alloc.num_free
    eng.run([[1, 2, 3]], max_new=9)
    graph, addrs = eng._multi.graph, [t.data_ptr() for layer in eng.caches for t in layer.values()]
    assert graph is not None
    rids = eng.add_request(list(range(40, 61)), max_new=9, n=3)  # 21 tokens: a partial tail page
    eng.step()  # the prefill, the forks and the copies
    pt = eng.alloc.table(rids[0])
    for crid in rids[1:]:
        ct = eng.alloc.table(crid)
        assert ct[0] == pt[0] and ct[1] != pt[1]
        for layer in eng.caches:
            for c in layer.values():
                assert torch.equal(c[:, int(ct[1])], c[:, int(pt[1])])
    while eng.step():
        pass
    assert eng._multi.graph is graph
    assert [t.data_ptr() for layer in eng.caches for t in layer.values()] == addrs
    for r in rids:
        out = eng.requests[r].out
        assert len(out) == 9 and all(0 <= t < cfg.vocab for t in out)
    assert eng.alloc.num_free == free0


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,causal", [("ring", True), ("ring", False), ("zigzag", True)])
def test_ring_attention_on_virtual_ranks_matches_sdpa(cuda, schedule, causal):
    """4 virtual ranks of the card, GQA 4, float32 with TF32 off: within 2e-4
    of SDPA over the gathered sequence (tests/test_ring_attention.py's bar)."""
    gen = torch.Generator().manual_seed(98)
    ws, b, s, hkv, g, d = 4, 2, 4 * 256, 2, 4, 128
    q = torch.randn((b, s, hkv * g, d), generator=gen).to(cuda)
    k, v = (torch.randn((b, s, hkv, d), generator=gen).to(cuda) for _ in range(2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xs = [zigzag_layout(x, ws) if schedule == "zigzag" else x for x in (q, k, v)]
        shards = [torch.chunk(x, ws, dim=1) for x in xs]
        mesh = make_mesh(tp=ws, devices=[cuda] * ws)
        outs = run_ranks(mesh, lambda grp, _: ring_attention(*(sh[grp.rank] for sh in shards), grp,
                                                             causal=causal, schedule=schedule))[0]
        got = torch.cat(outs, dim=1)
        if schedule == "zigzag":
            got = zigzag_unlayout(got, ws)
        want = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
            v.repeat_interleave(g, dim=2).transpose(1, 2), is_causal=causal).transpose(1, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert (got - want).abs().max().item() < 2e-4


@pytest.mark.cuda
def test_replay_of_a_kernel_record_is_bit_identical(cuda, tmp_path):
    """TraceHook around act_mul_and_quant on the card (row 17's kernel): the
    record replays on the card from memory and from disk, bit-identical."""
    import hpc_ops_tpu_torch.ops.activation as act_mod

    gen = torch.Generator().manual_seed(99)
    x = randn(gen, 200, 2 * 1408).to(cuda)
    before = act_quant.launches
    with TraceHook([act_mod.act_mul_and_quant], out_dir=str(tmp_path)) as hook:
        act_mod.act_mul_and_quant(x, torch.tensor([1.7], device=cuda))
    rec = hook.records[0]
    assert rec.outputs.device.startswith("cuda") and rec.args[0].device.startswith("cuda")
    replay_record(rec)
    replay_record(rec.path)
    assert act_quant.launches - before == 5  # the record and two runs of each replay


# ------------------- meshes past one device's virtual ranks, approx top-k
from hpc_ops_tpu_torch.parallel.collective_kernels import allreduce_rmsnorm_rank  # noqa: E402
from hpc_ops_tpu_torch.parallel.mesh import make_hybrid_mesh  # noqa: E402


def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA devices, this machine has {torch.cuda.device_count()}")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def collective_run(mesh, xs, res, w, mode):
    """Every rank's (out, out_res) of the fused collective over ``mesh``'s
    one tp group, each rank's inputs on its device."""
    return run_ranks(mesh, lambda g, _: collective_rmsnorm(
        g, xs[g.rank].to(g.device), res[g.rank].to(g.device), w.to(g.device), 1e-5, mode, False))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True])
@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
@pytest.mark.parametrize("ws", [1, 2, 4, 8])
def test_allreduce_per_device_form_is_bit_equal(cuda, ws, mode, captured):
    """The per-device form (a launch a rank, forced over virtual ranks by
    the mesh's private switch) against the plain version and the one-launch
    form, eager and replayed from a captured CUDA graph (its cross-stream
    waits graph edges, one non-cooperative node a rank); 8 x ws + 5 rows
    leave one_shot's shares ragged."""
    from hpc_ops_tpu_torch import kernels

    gen = torch.Generator().manual_seed(110 + ws)
    n = 8 * ws + (5 if mode == "one_shot" else 0)
    xs, res, w = allreduce_case(gen, ws, n, 4096, cuda)
    want = _allreduce_rmsnorm_ref(xs, res[0], w, 1e-5, mode, False)
    one = collective_run(make_mesh(tp=ws, devices=[cuda] * ws), xs, res, w, mode)
    mesh = make_mesh(tp=ws, devices=[cuda] * ws)
    mesh._per_device = True
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    n0, r0 = allreduce_rmsnorm.launches, allreduce_rmsnorm_rank.launches
    with torch.cuda.stream(side):
        outs = collective_run(mesh, xs, res, w, mode)
    torch.cuda.synchronize()
    assert allreduce_rmsnorm.launches == n0 and allreduce_rmsnorm_rank.launches == r0 + ws
    if captured:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="global"):
            outs = collective_run(mesh, xs, res, w, mode)
        counts = (ctypes.c_int * 7)()
        kernels.check(kernels.lib().hpc_graph_node_counts(graph.raw_cuda_graph(), counts), "node counts")
        assert counts[6] == ws and counts[1] == 0, list(counts)
        graph.instantiate()
        for o, o_res in outs:
            o.zero_()
            o_res.zero_()
        graph.replay()
        torch.cuda.synchronize()
    for r, ((o, o_res), (a, a_res)) in enumerate(zip(outs, one)):
        assert torch.equal(o, want[0]) and torch.equal(o_res, want[1]), f"rank {r}"
        assert torch.equal(o, a) and torch.equal(o_res, a_res), f"rank {r}"


@pytest.mark.cuda
def test_allreduce_per_device_wrapper_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator().manual_seed(120)
    xs, res, w = allreduce_case(gen, 2, 16, 256, cuda)
    outs = [torch.empty_like(xs[0]) for _ in range(2)]
    r0 = allreduce_rmsnorm_rank.launches
    with pytest.raises(ValueError, match="rank"):
        allreduce_rmsnorm_rank(xs, res, [w] * 2, outs, outs, 1e-5, "one_shot", False, 2)
    with pytest.raises(ValueError, match="float32"):
        allreduce_rmsnorm_rank(xs, res, [w.to(torch.bfloat16)] * 2, outs, outs, 1e-5, "one_shot", False, 0)
    with pytest.raises(ValueError, match="bf16"):
        allreduce_rmsnorm_rank([x.float() for x in xs], res, [w] * 2, outs, outs, 1e-5, "two_shot", False, 1)
    assert allreduce_rmsnorm_rank.launches == r0


def hybrid_engines(cuda, cfg, w, prompts, ms, mesh, **kw):
    from hpc_ops_tpu_torch.runtime.sharded_engine import ShardedEngine

    eng = ShardedEngine(cfg, w, mesh, num_blocks=64, block_size=BS, max_batch=4, multi_step=ms, **kw)
    return eng, eng.run(prompts, max_new=12)


def hold_to_engine(cuda, cfg, w, prompts, got):
    """``got`` against the single-device Engine's greedy tokens on the card:
    a flip only where the Engine's top-2 margin is below 0.15."""
    from hpc_ops_tpu_torch.models import llama as T
    from hpc_ops_tpu_torch.runtime.engine import Engine
    from hpc_ops_tpu_torch.utils.testing import assert_greedy_match, top2_margin

    want = Engine(cfg, w, num_blocks=64, block_size=BS, max_batch=8, device=cuda).run(prompts, max_new=12)

    def margin(tokens):
        n = len(tokens)
        t = lambda x: torch.tensor(x, dtype=torch.int32, device=cuda)  # noqa: E731
        logits, _ = T.forward_step(w, T.init_cache(cfg, 8, BS, device=cuda), cfg, t(tokens), t([n]),
                                   t([0, n]), t([list(range(8))]), is_prefill=True, max_seqlens_q=n)
        return top2_margin(logits.float().cpu())

    for p, a, b in zip(prompts, want, got):
        assert_greedy_match(a, b, lambda j, p=p, a=a: margin(p + a[:j]), 0.15)


@pytest.mark.cuda
@pytest.mark.parametrize("ms", [1, 8])
def test_hybrid_sharded_engine_equals_engine(cuda, ms):
    """ShardedEngine over make_hybrid_mesh(2, 4) of virtual ranks, eager and
    with multi_step=8 (one captured graph for both tp groups): the same
    tokens as a (dp 2, tp 4) mesh of the same row shards, and the
    single-device Engine's by the greedy rule (a flip only where its top-2
    margin is below 0.15); a dispatch after the first is one graph launch
    and one device-to-host copy."""
    cfg, w = multi_model("bf16", cuda)
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61)), [31], [40, 41, 42]]
    eng, got = hybrid_engines(cuda, cfg, w, prompts, ms, make_hybrid_mesh(2, 4, devices=[cuda] * 8))
    _, flat = hybrid_engines(cuda, cfg, w, prompts, ms, make_mesh(tp=4, dp=2, devices=[cuda] * 8))
    assert got == flat
    hold_to_engine(cuda, cfg, w, prompts, got)
    if ms > 1:
        rid = eng.add_request([5, 6, 7], max_new=12)
        eng.step()  # its prefill
        assert profile_dispatch(eng.step)[:2] == (1, 1)
        while eng.step():
            pass
        assert len(eng.requests[rid].out) == 12
        assert eng._multi.graph.stats["collective_nodes"] == 2 * 2 * cfg.layers * ms


@pytest.mark.cuda
def test_binned_approx_top_k_on_the_card(cuda):
    """fused_sampler(topk_impl="approx")'s top-k on the card (PartialReduce's
    bins) at [8, 128256], k 64: the same values and indices as the same
    algorithm on the CPU, every value the logit at its index, sorted
    descending, recall of the exact top-64 at least 0.95; the sampler's
    token is one of the candidates."""
    from hpc_ops_tpu_torch.ops import sampler as S

    gen = torch.Generator().manual_seed(130)
    logits = torch.randn((8, 128256), generator=gen) * 3
    vals, idx = S._approx_max_k(logits.to(cuda), 64)
    cvals, cidx = S._approx_max_k(logits, 64)
    assert torch.equal(vals.cpu(), cvals) and torch.equal(idx.cpu(), cidx)
    assert torch.equal(vals, torch.gather(logits.to(cuda), 1, idx))
    assert bool((vals[:, :-1] >= vals[:, 1:]).all())
    exact = torch.topk(logits, 64).indices
    found = sum(len(set(idx[b].tolist()) & set(exact[b].tolist())) for b in range(8))
    assert found / exact.numel() >= 0.95
    tok, _ = S.fused_sampler(logits.to(cuda), temperature=0.8, topk=50, max_topk=64, topk_impl="approx",
                             generator=torch.Generator(device=cuda).manual_seed(1))
    assert all(int(tok[b, 0]) in idx[b].tolist() for b in range(8))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["one_shot", "two_shot"])
def test_distinct_devices_collective_is_bit_equal(cuda, mode):
    """make_mesh(tp=2) over two cards: the per-device form, each rank's
    launch reading its peer's partial over peer memory, bit-equal to the
    plain version on every rank."""
    devs = two_cards()
    mesh = make_mesh(tp=2, devices=devs)
    gen = torch.Generator().manual_seed(140)
    xs, res, w = allreduce_case(gen, 2, 64, 4096)
    want = _allreduce_rmsnorm_ref(xs, res[0], w, 1e-5, mode, False)
    r0 = allreduce_rmsnorm_rank.launches
    outs = collective_run(mesh, xs, res, w, mode)
    torch.cuda.synchronize(devs[0])
    torch.cuda.synchronize(devs[1])
    assert allreduce_rmsnorm_rank.launches == r0 + 2
    for r, (o, o_res) in enumerate(outs):
        assert o.device == devs[r]
        assert torch.equal(o.cpu(), want[0]) and torch.equal(o_res.cpu(), want[1]), f"rank {r}"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rank_a_device", "group_a_device"])
@pytest.mark.parametrize("ms", [1, 4])
def test_distinct_devices_sharded_engine_equals_virtual_ranks(cuda, layout, ms):
    """ShardedEngine over two cards, a tp rank a card (make_mesh(tp=2)) or a
    tp group a card (make_hybrid_mesh(2, 2) with each group's two ranks on
    one card), eager and multi_step=4: the tokens of the same mesh of
    virtual ranks on one card (the per-device collective is bit-equal to the
    one-launch form), and the single-device Engine's by the greedy rule."""
    devs = two_cards()
    cfg, w = multi_model("bf16", cuda)
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11], list(range(20, 61))]
    if layout == "rank_a_device":
        mesh, virtual = make_mesh(tp=2, devices=devs), make_mesh(tp=2, devices=[cuda] * 2)
    else:
        mesh = make_hybrid_mesh(2, 2, devices=[devs[0], devs[0], devs[1], devs[1]])
        virtual = make_hybrid_mesh(2, 2, devices=[cuda] * 4)
    _, got = hybrid_engines(cuda, cfg, w, prompts, ms, mesh)
    _, want = hybrid_engines(cuda, cfg, w, prompts, ms, virtual)
    assert got == want
    hold_to_engine(cuda, cfg, w, prompts, got)
