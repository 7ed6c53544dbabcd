"""Parity of the port's task-map (split-KV) decode, its scheduler and the
head-major FUSED decode against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The JAX
decode runs its Pallas kernels in interpret mode on the CPU, at the shapes
of its own tests; the port runs its kernels' plain versions.

Tolerances: task maps equal element for element; the task-map decode within
3e-2 atol/rtol, tests/test_decode_scheduler.py's tolerance (the JAX kernel
rounds the scaled q and the probabilities to bf16, the port stays in
float32; JAX merges the partials in segment order, the port's plain combine
in task order); e4m3 caches with their subnormal codes zeroed, because the
JAX kernel's e4m3 decode flushes them on the CPU (tests/
test_torch_fp8_attention.py); the FUSED decode within 2e-2 in bf16 and 8e-2
over int8 codes, tests/test_attention_decode.py's tolerances for it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.config import QuantType as JQuantType
from hpc_ops_tpu.ops.attention import attention_decode as jax_decode
from hpc_ops_tpu.ops.attention import scheduler as J
from hpc_ops_tpu.ops.attention.paging import nhd_to_hnd as jax_nhd_to_hnd
from hpc_ops_tpu.ops.attention.paging import pack_kv_fused as jax_pack_kv_fused
from hpc_ops_tpu.ops.quant import quantize_kv_fused_int8 as jax_quantize_kv_fused_int8
from hpc_ops_tpu_torch.ops.attention import decode as D
from hpc_ops_tpu_torch.ops.attention import scheduler as S
from hpc_ops_tpu_torch.ops.attention.paging import (
    hnd_to_nhd,
    nhd_to_hnd,
    pack_kv_fused,
    pack_kv_fused_nhd,
)
from hpc_ops_tpu_torch.ops.quant import quantize_kv_fused_int8
from hpc_ops_tpu_torch.utils.testing import assert_allclose
from tests.test_attention_decode import make_decode_case
from tests.test_torch_fp8_attention import QT0, e4m3, flush_subnormals, j8, jq, qt0_case, t8, to_layout

torch.set_num_threads(1)

FIELDS = ("batch", "head", "tile_start", "num_tiles", "seg")


def torch_of(x, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def ints(x):
    """An integer array of either package as a (writable) torch tensor."""
    return torch.from_numpy(np.array(x))


def jax_map_arrays(tm):
    return [np.asarray(getattr(tm, f)) for f in FIELDS], int(tm.num_tasks)


def assert_same_map(port, jax_arrays, jax_n):
    """A port TaskMap (or host tuple) equal to JAX's, sentinels included."""
    if isinstance(port, S.TaskMap):
        arrays, n = [getattr(port, f).cpu().numpy() for f in FIELDS], int(port.num_tasks)
        assert all(a.dtype == np.int32 for a in arrays) and port.num_tasks.dim() == 0
    else:
        arrays, n = list(port[:5]), port[5]
    assert n == jax_n
    for f, a, b in zip(FIELDS, arrays, jax_arrays):
        np.testing.assert_array_equal(a, b, err_msg=f)


# ------------------------------------------------------------------ scheduler
@pytest.mark.parametrize("kv_lens", [[512] * 8, [65536, 4096, 4096, 128], [1], [0, 33]])
def test_schedulers_equal_jax(kv_lens):
    """np, native and torch maps equal JAX's np, native and jnp maps, on
    tests/test_decode_scheduler.py's lengths and capacity."""
    h = 4
    kv = np.asarray(kv_lens, np.int32)
    cap = S.task_capacity(len(kv_lens), max(max(kv_lens), 1), h, 512, 8)
    assert cap == J.task_capacity(len(kv_lens), max(max(kv_lens), 1), h, 512, 8)
    want = J.assign_decode_tasks_np(kv, h, cap)
    assert_same_map(J.assign_decode_tasks_native(kv, h, cap), list(want[:5]), want[5])
    jnp_map = J.assign_decode_tasks_jnp(jnp.asarray(kv), h, cap)
    assert_same_map(want, *jax_map_arrays(jnp_map))
    assert_same_map(S.assign_decode_tasks_np(kv, h, cap), list(want[:5]), want[5])
    assert_same_map(S.assign_decode_tasks_native(kv, h, cap), list(want[:5]), want[5])
    assert_same_map(S.assign_decode_tasks_torch(torch.from_numpy(kv), h, cap), list(want[:5]), want[5])


@pytest.mark.parametrize("impl", ["np", "native", "torch", "jnp"])
@pytest.mark.parametrize("kv_lens,mtp,new_kv,kw", [
    ([1000, 64, 8192], 0, True, dict(tile=512, min_process_len=512)),
    ([131072] + [4096] * 31, 0, True, dict(tile=2048, capacity="tight")),  # one_128k_31x4k
    ([16384] + [64] * 15, 1, False, dict(tile=2048, capacity="tight")),  # skewed_extreme
    ([300, 17], 2, True, dict(tile=128, min_process_len=128, num_tasks_target=8, capacity=40)),
])
def test_assign_attention_decode_task_equals_jax(kv_lens, mtp, new_kv, kw, impl):
    """The public entry, capacity None, an int and "tight" included: the same
    capacity, arrays and count as JAX's (host schedulers only take "tight",
    in both packages); the map lies on the lengths' device."""
    if kw.get("capacity") == "tight" and impl in ("torch", "jnp"):
        with pytest.raises(ValueError, match="host scheduler"):
            S.assign_attention_decode_task(torch.tensor(kv_lens), 8, mtp, new_kv, impl=impl, **kw)
        return
    args = (8, mtp, new_kv)
    jimpl = "np" if impl == "torch" else impl
    want = J.assign_attention_decode_task(np.asarray(kv_lens, np.int32), *args, impl=jimpl, **kw)
    got = S.assign_attention_decode_task(torch.tensor(kv_lens, dtype=torch.int32), *args,
                                         impl=impl, **kw)
    assert got.capacity == want.capacity and got.num_segs == want.num_segs and got.tile == want.tile
    assert got.batch.device.type == "cpu"
    assert_same_map(got, *jax_map_arrays(want))


def test_task_map_covers_every_tile_once():
    kv = torch.tensor([1000, 64, 8192], dtype=torch.int32)
    cap = S.task_capacity(3, 8192, 2, 512, 1)
    tm = S.assign_decode_tasks_torch(kv, 2, cap, tile=512, min_process_len=512)
    covered = {}
    for t in range(int(tm.num_tasks)):
        key = (int(tm.batch[t]), int(tm.head[t]))
        covered.setdefault(key, []).append((int(tm.tile_start[t]), int(tm.num_tiles[t])))
    for b, n in enumerate(kv.tolist()):
        for h in range(2):
            runs = sorted(covered[(b, h)])
            assert sum(c for _, c in runs) == max(-(-n // 512), 1)
            assert all(s0 + c0 == s1 for (s0, c0), (s1, _) in zip(runs, runs[1:]))
    assert torch.all(tm.batch[int(tm.num_tasks):] == -1)


@pytest.mark.parametrize("args", [(8, 131072, 8, 2048, 2), (4, 4096, 2, 512, 1, 16), (64, 512, 8, 512, 8)])
def test_capacity_and_workspace_equal_jax(args):
    assert S.task_capacity(*args) == J.task_capacity(*args)
    assert S.get_attention_decode_task_workspace(*args) == J.get_attention_decode_task_workspace(*args)


SCENARIOS = {  # benchmark/attention_decode/bench_attention_decode.py
    "uniform_512": [512] * 64,
    "skewed_mix": [128] * 32 + [4096] * 32,
    "skewed_extreme": [16384] + [64] * 15,
    "one_64k_7x4k": [65536] + [4096] * 7,
    "one_128k_31x4k": [131072] + [4096] * 31,
}


@pytest.mark.parametrize("num_cores", [1, 2, 132])
def test_select_decode_mode_equals_jax(num_cores):
    for lens in [*SCENARIOS.values(), [], [5, 5, 5000]]:
        want = J.select_decode_mode(np.asarray(lens), 8, num_cores=num_cores)
        assert S.select_decode_mode(torch.tensor(lens, dtype=torch.int64), 8, num_cores=num_cores) == want
        assert S.select_decode_mode(lens, 8, num_cores=num_cores, skew_threshold=64.0) == \
            J.select_decode_mode(np.asarray(lens), 8, num_cores=num_cores, skew_threshold=64.0)


def test_select_decode_mode_reads_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        S.select_decode_mode([64, 16384], 8)


def test_print_equals_jax(capsys):
    kw = dict(mtp=1, new_kv_included=False, min_process_len=128, tile=128, num_tasks_target=8,
              capacity=20, impl="np")
    J.print_attention_decode_task(J.assign_attention_decode_task(np.array([300, 17], np.int32), 2, **kw))
    want = capsys.readouterr().out
    S.print_attention_decode_task(S.assign_attention_decode_task(torch.tensor([300, 17]), 2, **kw))
    assert capsys.readouterr().out == want and "num_tasks=8 capacity=20" in want


# ----------------------------------------------------------- task-map decode
def maps(kv_lens, mtp, tile, cap):
    """JAX's and the port's map of the same lengths (asserted equal)."""
    kw = dict(mtp=mtp, new_kv_included=True, min_process_len=tile, capacity=cap, tile=tile,
              num_tasks_target=8, impl="np")
    jtm = J.assign_attention_decode_task(np.asarray(kv_lens, np.int32), 2, **kw)
    tm = S.assign_attention_decode_task(torch.tensor(kv_lens, dtype=torch.int32), 2, **kw)
    assert_same_map(tm, *jax_map_arrays(jtm))
    return jtm, tm


def port_layouts(k_nhd, v_nhd):
    """The port's four cache layouts of the same NHD K and V."""
    k, v = nhd_to_hnd(k_nhd), nhd_to_hnd(v_nhd)
    return {"HND": (k.contiguous(), v.contiguous()), "NHD": (k_nhd, v_nhd),
            "FUSED": (pack_kv_fused(k, v), None), "NHD_FUSED": (pack_kv_fused_nhd(k, v), None)}


@pytest.mark.parametrize("kv_lens,mtp,cap", [
    ([300, 17], 0, "tight"),  # 8 tasks in a capacity of 32: sentinel tasks
    ([1500, 40, 256], 1, None),  # a segment split into 3 tasks, draft rows
])
def test_task_map_decode_bf16_matches_jax(kv_lens, mtp, cap):
    """tests/test_decode_scheduler.py's cases: the JAX task-map decode over
    its NHD caches against the port's over HND, NHD and both fused slabs."""
    sq, tile = mtp + 1, 128
    q, kc, vc, block_ids, lens = make_decode_case(13, kv_lens, sq=sq, bs=16)
    cap = cap or J.task_capacity(len(kv_lens), max(kv_lens), 2, tile, 1)
    jtm, tm = maps(lens, mtp, tile, cap)
    if cap == "tight":
        assert tm.capacity > int(tm.num_tasks)
    else:
        assert int((tm.seg[: int(tm.num_tasks)] == 0).sum()) == 3
    want = np.asarray(jax_decode(q, kc, vc, block_ids, jnp.asarray(lens), mtp=mtp,
                                 new_kv_included=True, task_map=jtm, task_tile=tile), np.float32)
    qt, tbl, tl = torch_of(q), ints(block_ids), ints(lens)
    for layout, (k, v) in port_layouts(torch_of(kc), torch_of(vc)).items():
        got = D.attention_decode(qt, k, v, tbl, tl, mtp=mtp, new_kv_included=True,
                                 cache_layout=layout, task_map=tm)
        assert got.dtype == torch.bfloat16 and got.shape == qt.shape
        assert_allclose(got.float(), want, atol=3e-2, rtol=3e-2, name=f"task map {layout}")


def test_task_map_decode_e4m3_matches_jax():
    """e4m3 HND caches with per-tensor scales and a per-token q scale."""
    kv_lens, tile = [1500, 40, 256], 128
    _, kc, vc, block_ids, lens = make_decode_case(14, kv_lens, sq=1, bs=16)
    rng = np.random.RandomState(5)
    k8 = flush_subnormals(e4m3(np.asarray(jax_nhd_to_hnd(kc), np.float32) * 16))
    v8 = flush_subnormals(e4m3(np.asarray(jax_nhd_to_hnd(vc), np.float32) * 16))
    qf = rng.randn(3, 8, 128).astype(np.float32)
    qscale = np.abs(qf).max(-1) / 448.0
    q8 = flush_subnormals(e4m3(qf / qscale[..., None]))
    ks = vs = np.float32(1 / 16)
    jtm, tm = maps(lens, 0, tile, "tight")
    want = np.asarray(jax_decode(j8(q8), j8(k8), j8(v8), block_ids, jnp.asarray(lens),
                                 new_kv_included=True, qscale=jnp.asarray(qscale), kscale=jnp.float32(ks),
                                 vscale=jnp.float32(vs), cache_layout="HND", task_map=jtm), np.float32)
    got = D.attention_decode_fp8(t8(q8), t8(k8), t8(v8), ints(block_ids),
                                 ints(lens), torch.from_numpy(qscale), torch.tensor([ks]),
                                 torch.tensor([vs]), new_kv_included=True, cache_layout="HND",
                                 task_map=tm)
    assert_allclose(got.float(), want, atol=3e-2, rtol=3e-2, name="task map e4m3")


def test_task_map_decode_int8_fused_matches_jax():
    """int8 codes of quantize_kv_fused_int8, FUSED and NHD_FUSED, under the
    JAX task-map decode over the FUSED slab."""
    kv_lens, tile = [300, 17, 140], 128
    q, kc, vc, block_ids, lens = make_decode_case(15, kv_lens, sq=1, bs=16)
    jkv, jks, jvs = jax_quantize_kv_fused_int8(jax_nhd_to_hnd(kc), jax_nhd_to_hnd(vc))
    jtm, tm = maps(lens, 0, tile, "tight")
    want = np.asarray(jax_decode(q, jkv, None, block_ids, jnp.asarray(lens), new_kv_included=True,
                                 kscale=jks, vscale=jvs, cache_layout="FUSED", task_map=jtm), np.float32)
    kv, ks, vs = quantize_kv_fused_int8(nhd_to_hnd(torch_of(kc)), nhd_to_hnd(torch_of(vc)))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))
    bs = kv.shape[2] // 2
    slabs = {"FUSED": kv, "NHD_FUSED": pack_kv_fused_nhd(kv[:, :, :bs], kv[:, :, bs:])}
    for layout, slab in slabs.items():
        got = D.attention_decode(torch_of(q), slab, None, ints(block_ids),
                                 ints(lens), new_kv_included=True, kscale=ks, vscale=vs,
                                 cache_layout=layout, task_map=tm)
        assert_allclose(got.float(), want, atol=3e-2, rtol=3e-2, name=f"task map int8 {layout}")


@pytest.mark.parametrize("layout", ["NHD", "HND"])
def test_task_map_qt0_ignores_the_map_matches_jax(layout):
    """QuantType 0 (one K scale per token and kv head) with a task map: JAX
    takes its reference, the port its QuantType-0 grid path, as the map
    changes only the schedule. The port's output equals its own without a
    map and JAX's within 1e-2 (tests/test_torch_fp8_attention.py's
    tolerance against JAX's reference)."""
    c = qt0_case(18, [40, 16, 300], 1)
    k, v = to_layout(c["k8"], c["v8"], layout)
    jtm, tm = maps(c["lens"], 0, 32, "tight")
    want = np.asarray(jax_decode(
        jq(c["q"]), j8(k), j8(v), jnp.asarray(c["tbl"]), jnp.asarray(c["lens"]), new_kv_included=True,
        kscale=jnp.asarray(c["kscale"]), vscale=jnp.asarray(c["vscale"]), cache_layout=layout,
        quant_type=JQuantType.QPERTOKEN_PERHEAD_KPERTOKEN_PERHEAD_VPERHEAD, task_map=jtm), np.float32)
    args = (c["q"], t8(k), t8(v), ints(c["tbl"]), ints(c["lens"]))
    kw = dict(new_kv_included=True, kscale=torch.from_numpy(c["kscale"]),
              vscale=torch.from_numpy(c["vscale"]), quant_type=QT0, cache_layout=layout)
    got = D.attention_decode(*args, task_map=tm, **kw)
    assert torch.equal(got, D.attention_decode(*args, **kw))
    assert_allclose(got.float(), want, atol=1e-2, rtol=1e-2, name=f"qt0 task map {layout}")


def test_task_map_partials_and_combine():
    """The task stage's partials: a sentinel task writes o = 0, m = -inf,
    l = 0, and so does a draft row in a task that holds no key it may see
    (it keeps m = -inf, where JAX's finite mask value gives such a row
    weight that only the combine's max removes); the combine of the
    partials equals the grid decode."""
    kv_lens, mtp, tile = [257, 4], 2, 128
    sq = mtp + 1
    q, kc, vc, block_ids, lens = make_decode_case(16, kv_lens, sq=sq, bs=16)
    _, tm = maps(lens, mtp, tile, 16)
    n = int(tm.num_tasks)
    qt, kt, vt = torch_of(q), nhd_to_hnd(torch_of(kc)), nhd_to_hnd(torch_of(vc))
    tbl, tl = ints(block_ids), ints(lens)
    o, m, l = D.paged_decode_tasks(qt, kt, vt, tbl, tl, tm, sq, 0.1)
    assert n == 8 and o.shape == (16, 4 * sq, 128) and m.shape == l.shape == (16, 4 * sq)
    assert torch.all(o[n:] == 0) and torch.all(m[n:] == float("-inf")) and torch.all(l[n:] == 0)
    # request 0's third tile holds position 256 only; draft rows s = 0, 1 see
    # keys up to 254 + s
    last = ((tm.batch == 0) & (tm.tile_start == 2)).nonzero().flatten()
    blind = torch.arange(4 * sq) % sq < 2
    assert len(last) == 2
    for t in last.tolist():
        assert torch.all(m[t, blind] == float("-inf")) and torch.all(l[t, blind] == 0)
        assert torch.all(o[t, blind] == 0) and torch.isfinite(m[t, ~blind]).all()
    got = D.decode_combine(o, m, l, tm, sq, 8)
    want = D.paged_decode_attention(qt, kt, vt, tbl, tl, sq, 0.1, "HND")
    assert_allclose(got.float(), want.float().numpy(), atol=1e-2, rtol=1e-2, name="combine")


def test_task_tile_must_be_a_multiple_of_the_page_size():
    q, kc, vc, block_ids, lens = make_decode_case(17, [40], sq=1, bs=16)
    tm = S.assign_attention_decode_task(ints(lens), 2, tile=24, impl="np", capacity=8)
    with pytest.raises(ValueError, match="multiple of the page size"):
        D.attention_decode(torch_of(q), torch_of(kc), torch_of(vc),
                           ints(block_ids), ints(lens),
                           new_kv_included=True, task_map=tm)


# --------------------------------------------------------- FUSED grid decode
@pytest.mark.parametrize("kv_lens,mtp", [
    ([33], 0),  # JAX: the packed kernel (row 7), r_pack 2
    ([128, 17, 255, 64], 0),  # row 7, r_pack 8
    ([40, 300], 2),  # row 7 with draft rows
    ([1100, 40], 0),  # long KV: row 6
])
def test_fused_decode_bf16_matches_jax(kv_lens, mtp):
    """tests/test_attention_decode.py's FUSED cases, against JAX's FUSED
    decode; one port kernel serves both JAX kernels."""
    sq = mtp + 1
    q, kc, vc, block_ids, lens = make_decode_case(17, kv_lens, sq=sq)
    jkv = jax_pack_kv_fused(jax_nhd_to_hnd(kc), jax_nhd_to_hnd(vc))
    want = np.asarray(jax_decode(q, jkv, None, block_ids, jnp.asarray(lens), mtp=mtp,
                                 new_kv_included=True, cache_layout="FUSED"), np.float32)
    kv = pack_kv_fused(nhd_to_hnd(torch_of(kc)), nhd_to_hnd(torch_of(vc)))
    tbl, tl = ints(block_ids), ints(lens)
    for impl in ("auto", "ref"):
        got = D.attention_decode(torch_of(q), kv, None, tbl, tl, mtp=mtp, new_kv_included=True,
                                 cache_layout="FUSED", impl=impl)
        assert got.dtype == torch.bfloat16 and got.shape == (len(kv_lens) * sq, 8, 128)
        assert_allclose(got.float(), want, atol=2e-2, rtol=2e-2, name=f"fused {impl}")


def test_fused_decode_int8_matches_jax():
    """tests/test_attention_decode.py's int8 FUSED case: quantize_kv_fused_int8
    codes and scales, the same in both packages."""
    q, kc, vc, block_ids, lens = make_decode_case(7, [100, 37, 260], sq=1)
    jkv, jks, jvs = jax_quantize_kv_fused_int8(jax_nhd_to_hnd(kc), jax_nhd_to_hnd(vc))
    want = np.asarray(jax_decode(q, jkv, None, block_ids, jnp.asarray(lens), new_kv_included=True,
                                 cache_layout="FUSED", kscale=jks, vscale=jvs), np.float32)
    kv, ks, vs = quantize_kv_fused_int8(nhd_to_hnd(torch_of(kc)), nhd_to_hnd(torch_of(vc)))
    assert torch.equal(ks, torch.from_numpy(np.array(jks)).reshape(ks.shape))
    got = D.attention_decode(torch_of(q), kv, None, ints(block_ids),
                             ints(lens), new_kv_included=True, cache_layout="FUSED",
                             kscale=ks, vscale=vs)
    assert_allclose(got.float(), want, atol=8e-2, rtol=8e-2, name="fused int8")
    # the head-major slab is read as HND views: the same as the HND decode of its halves
    bs = kv.shape[2] // 2
    hnd = D.attention_decode(torch_of(q), kv[:, :, :bs], kv[:, :, bs:],
                             ints(block_ids), ints(lens),
                             new_kv_included=True, cache_layout="HND", kscale=ks, vscale=vs)
    assert torch.equal(got, hnd)


def test_rope_int8_store_feeds_fused_decode_matches_jax():
    """tests/test_rope.py's chain: the int8 FUSED store, then the FUSED
    decode over the written cache, in both packages on the same inputs."""
    from hpc_ops_tpu.ops.rope import rope_norm_store_kv_int8 as jax_store
    from hpc_ops_tpu_torch.ops.rope import rope_norm_store_kv_int8
    from tests.test_rope import make_case

    c = make_case(29, [34, 8, 17, 21, 40, 12, 9, 30], [1] * 8, hq=8, hkv=2, blk=16)
    rng = np.random.RandomState(11)
    kv0 = np.clip(rng.randn(c["hkv"], c["total_blocks"], 2 * c["blk"], c["dqk"]) * 25, -127, 127)
    kv0 = kv0.astype(np.int8)
    sc = np.array([0.02], np.float32)
    jq, jkv = jax_store(jnp.asarray(kv0), c["qkv"], c["cos_sin"], c["num_seqlen"], c["q_index"],
                        c["kv_idx"], False, jnp.asarray(sc), jnp.asarray(sc), impl="pallas")
    want = np.asarray(jax_decode(jq, jkv, None, c["kv_idx"], c["num_seqlen"], new_kv_included=True,
                              cache_layout="FUSED", kscale=jnp.asarray(sc), vscale=jnp.asarray(sc)),
                      np.float32)
    t = ints
    q, kv = rope_norm_store_kv_int8(torch.from_numpy(kv0.copy()), torch_of(c["qkv"]),
                                    t(c["cos_sin"]).float(), t(c["num_seqlen"]), t(c["q_index"]),
                                    t(c["kv_idx"]), False, t(sc), t(sc))
    assert np.mean(kv.numpy() != np.asarray(jkv)) < 1e-3  # a rounding tie may differ by one code
    got = D.attention_decode(q, kv, None, t(c["kv_idx"]), t(c["num_seqlen"]), new_kv_included=True,
                             cache_layout="FUSED", kscale=t(sc), vscale=t(sc))
    assert_allclose(got.float(), want, atol=8e-2, rtol=8e-2, name="store -> fused decode")


def test_fused_views_are_read_in_place():
    """The FUSED and task-map paths hand the kernels views of the caches:
    unpacking the head-major slab and the NHD views copy nothing."""
    kv = torch.zeros((2, 5, 32, 128), dtype=torch.int8)
    k, v = D._hnd_views(kv, None, "FUSED", 128)
    assert k.data_ptr() == kv.data_ptr() and v.data_ptr() == kv.data_ptr() + 16 * 128
    assert k.stride() == (5 * 32 * 128, 32 * 128, 128, 1)
    nhd = torch.zeros((5, 16, 2, 128))
    k, _ = D._hnd_views(nhd, nhd, "NHD", 128)
    assert k.data_ptr() == nhd.data_ptr() and torch.equal(hnd_to_nhd(k), nhd)
