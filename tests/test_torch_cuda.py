"""Each CUDA kernel of the port against its plain PyTorch version.

The tests marked ``cuda`` need a card and skip without one; run them there
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(tests/conftest.py imports JAX; this file does not). The unmarked tests check
on the CPU that each wrapper takes its plain version for CPU tensors and
counts no launch.

Tolerances: attention within 1e-2 abs/rel in bf16 output (int8 slabs too:
kernel and plain version read the same codes); RoPE within one bf16 ulp;
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
from hpc_ops_tpu_torch.ops.attention.scheduler import assign_attention_decode_task
from hpc_ops_tpu_torch.ops.attention.prefill import (
    _prefill_nhd_fused_ref,
    _prefill_ref,
    paged_prefill_attention,
    paged_prefill_nhd_fused,
)
from hpc_ops_tpu_torch.ops.group_gemm import (
    gg_bw_aligned,
    gg_bw_aligned_ref,
    gg_bw_scatter,
    gg_bw_scatter_ref,
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
     (32, [9, 32], 208, 200)],  # K and N that end inside a stage and a block
)
def test_gg_scatter_kernel_matches_plain(cuda, tm, fill, k, n):
    gen = torch.Generator().manual_seed(21)
    x, w, y_scale, row_idx, grp = gg_case(gen, tm, fill, k, n)
    want = gg_scatter_ref(x, w, y_scale, row_idx, grp, tm)
    n0 = gg_scatter.launches
    got = gg_scatter(*(t.to(cuda) for t in (x, w, y_scale, row_idx, grp)), tm)
    torch.cuda.synchronize()
    assert gg_scatter.launches == n0 + 1
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


def moe_inputs(gen, s, k, h, interm, e_local, e_total):
    return dict(
        x=fp8(gen, s, h, scale=0.2), gw=fp8(gen, e_local, 2 * interm, h), dw=fp8(gen, e_local, h, interm),
        gs=torch.rand(e_local, generator=gen) * 0.4 + 0.2,
        ds=(torch.rand(e_local, generator=gen) * 0.1 + 0.05) / 16, act=torch.tensor([16.0]),
        ids=torch.randint(0, e_total, (s, k), generator=gen, dtype=torch.int32),
        ts=torch.rand((s, k), generator=gen) / k,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("rank_ep,size_ep", [(0, 1), (1, 4)])
def test_fuse_moe_on_the_card_syncs_nothing_and_matches_cpu(cuda, rank_ep, size_ep):
    """The whole pipeline on the card under sync debug mode "error": any copy
    of a count to the host would raise. Against the CPU run (plain versions)
    within 2e-2 abs + 2e-2 rel on outputs up to 4: summation order, one bf16
    rounding per GEMM and rare activation code steps."""
    gen = torch.Generator().manual_seed(25)
    e_total = 16
    t = moe_inputs(gen, 32, 4, 256, 256, e_total // size_ep, e_total)
    args = [t[n] for n in ("x", "gw", "dw", "gs", "ds", "act", "ids", "ts")]
    want = fuse_moe_pertensor_fp8(*args, rank_ep, e_total)
    dargs = [a.to(cuda) for a in args]
    fuse_moe_pertensor_fp8(*dargs, rank_ep, e_total)  # builds the library, warms the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fuse_moe_pertensor_fp8(*dargs, rank_ep, e_total)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
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
                                    (512, 1024, 256), (32, 208, 200)])
@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_gg_pertensor_kernel_matches_plain(cuda, dtype, tm, k, n):
    """Tiles write row blocks in another order than theirs, the last valid
    one the trash block; tiles past num_valid_tiles point at a block they
    must not write."""
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
    n0 = gg_pertensor.launches
    got = gg_pertensor(*(t.to(cuda) for t in (x, w, y_scale, grp, blk)), tm, nv.to(cuda))
    torch.cuda.synchronize()
    assert gg_pertensor.launches == n0 + 1
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


@pytest.mark.cuda
def test_decode_combine_kernel_matches_plain(cuda):
    """Partials with rows at m = -inf, sentinel tasks and a map whose
    segments are not contiguous (tasks shuffled)."""
    gen = torch.Generator().manual_seed(43)
    lens = [1, 300, 1025, 4097, 64]
    tm = assign_attention_decode_task(torch.tensor(lens), 8, tile=256, min_process_len=256,
                                      capacity=240, impl="np")
    perm = torch.randperm(240, generator=gen)
    tm = tm._replace(**{f: getattr(tm, f)[perm].contiguous() for f in ("batch", "head", "tile_start",
                                                                       "num_tiles", "seg")})
    rows = 4 * 3
    o = torch.randn((240, rows, 128), generator=gen)
    m = torch.randn((240, rows), generator=gen) * 4
    m[torch.rand((240, rows), generator=gen) < 0.2] = float("-inf")
    l = torch.rand((240, rows), generator=gen) * 50 + 1
    o[torch.isinf(m)] = 0
    l[torch.isinf(m)] = 0
    want = _decode_combine_ref(o, m, l, tm, 3, 32, VS)
    tmd = tm._replace(batch=tm.batch.to(cuda), seg=tm.seg.to(cuda))
    n0 = decode_combine.launches
    got = decode_combine(o.to(cuda), m.to(cuda), l.to(cuda), tmd, 3, 32, VS)
    torch.cuda.synchronize()
    assert decode_combine.launches == n0 + 1
    assert_allclose(got.float(), want.float(), atol=1e-2, rtol=1e-2, name="combine")


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
from hpc_ops_tpu_torch.ops.gemm import _route_gemm_ref, route_gemm, split_fp32_weight  # noqa: E402
from hpc_ops_tpu_torch.ops.normalization import _rmsnorm_quant_ref, rmsnorm_quant  # noqa: E402


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


@pytest.mark.cuda
@pytest.mark.parametrize("is_moe", [False, True])
@pytest.mark.parametrize("n,h", [(8, 4096), (2048, 5120), (5, 320)])
def test_rmsnorm_quant_kernel_matches_plain(cuda, n, h, is_moe):
    gen = torch.Generator().manual_seed(55)
    x = randn(gen, n, h) * 3
    w = torch.rand(h, generator=gen).to(torch.bfloat16)
    sc = torch.tensor([2.5, 5.0] if is_moe else [0.01])  # 0.01: many codes saturate at 448
    args = (x.to(cuda), w.to(cuda), sc.to(cuda), 1e-6, is_moe)
    want = _rmsnorm_quant_ref(*args)  # on the card: the CPU's float64 sum may round a mean apart
    got = rmsnorm_quant(*args)
    torch.cuda.synchronize()
    for g, t in zip(got if is_moe else (got,), want if is_moe else (want,)):
        if g.dtype == torch.float32:
            assert torch.equal(g, t)
        else:
            assert torch.equal(g.view(torch.uint8), t.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("fp32", [False, True])
@pytest.mark.parametrize("m,n,k", [(256, 256, 7168), (100, 192, 512), (33, 72, 520), (1, 8, 8)])
def test_route_gemm_kernel_matches_plain(cuda, m, n, k, fp32):
    gen = torch.Generator().manual_seed(56)
    x = randn(gen, m, k)
    wh, wl, ws = split_fp32_weight(torch.randn((n, k), generator=gen))
    want = _route_gemm_ref(x, wh, wl, ws, fp32).float()
    got = route_gemm(x.to(cuda), wh.to(cuda), wl.to(cuda), ws.to(cuda), fp32)
    torch.cuda.synchronize()
    assert got.dtype == (torch.float32 if fp32 else torch.bfloat16)
    big = float(want.abs().max())
    assert_allclose(got.float(), want, atol=1e-5 * big, rtol=0 if fp32 else 2.0**-7, name="route gemm")


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
