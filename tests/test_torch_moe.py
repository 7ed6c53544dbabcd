"""Parity of the port's fused fp8 MoE against the JAX package on numpy-made
inputs: routing (every integer output equal), reduce, and the whole pipeline.

The JAX grouped GEMM and activation run as Pallas kernels in interpret mode;
JAX's ``reduce`` takes its jnp path off the TPU. Both packages get the same
``topk_ids``, so no routing tie can move a result. Inputs hold no subnormal
e4m3 code (tests/test_torch_group_gemm.py shows what those do to the JAX
kernel on the CPU).

Tolerances of the pipeline, on outputs up to 4 (tests/test_moe.py takes 0.1
abs + 0.08 rel against a naive model):
- against the JAX plain path (``impl="ref"``), 2e-3 abs + 1e-2 rel: the two
  differ by float32 summation order and at most one bf16 rounding of a GEMM
  output (measured: bit-equal);
- against the JAX kernels in interpret mode, 0.05 abs + 0.03 rel: XLA compiles
  the activation kernel's body with excess precision, which moves one
  activation code in sixty by one step (a step of 2 at magnitude 16, times a
  down weight near 1 and a down scale near 0.006 is 0.012 on the output, a
  few times per row), and the JAX down GEMM flushes the subnormal codes. The
  JAX kernels differ from the JAX plain path by as much (0.039 measured).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import moe as J
from hpc_ops_tpu_torch.models.llama import weights_from_numpy
from hpc_ops_tpu_torch.ops import moe as T
from hpc_ops_tpu_torch.utils.testing import assert_allclose
from test_torch_group_gemm import e4m3

torch.set_num_threads(1)

ATOL, RTOL = 5e-2, 3e-2
ATOL_PLAIN, RTOL_PLAIN = 2e-3, 1e-2
EP_CASES = [(0, 1), (1, 4)]


def to_t(a):
    return weights_from_numpy(np.asarray(a), device="cpu")


def routing_ids(seed, s, k, e_total):
    rng = np.random.RandomState(seed)
    return np.sort(rng.randint(0, e_total, (s, k)).astype(np.int32), axis=1)


def assert_ints_equal(got, want, names):
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=name)


ROUTE_NAMES = ("row_idx", "topk_pos", "seqlens", "cu_seqlens", "tiles", "cu_tiles", "grp")


@pytest.mark.parametrize("rank_ep,size_ep", EP_CASES)
def test_routing_matches_jax(rank_ep, size_ep):
    s, k, e_total = 37, 4, 16
    e_local = e_total // size_ep
    ids = routing_ids(3, s, k, e_total)
    for tm in (32, 64):
        want = J._route_aligned(jnp.asarray(ids), e_local, rank_ep, tm)
        got = T._route_aligned(torch.from_numpy(ids), e_local, rank_ep, tm)
        assert_ints_equal(got, want, ROUTE_NAMES)
    want = J.count_and_build_indices(jnp.asarray(ids), e_local, rank_ep)
    got = T.count_and_build_indices(torch.from_numpy(ids), e_local, rank_ep)
    assert_ints_equal(got, want, ROUTE_NAMES)
    assert all(t.dtype == torch.int32 for t in got)


@pytest.mark.parametrize("rank_ep,size_ep", EP_CASES)
def test_count_and_gather_matches_jax(rank_ep, size_ep):
    s, k, h, e_total = 16, 2, 64, 8
    e_local = e_total // size_ep
    ids = routing_ids(41, s, k, e_total)
    x = e4m3(np.random.RandomState(1).randn(s, h) / 4, "keep")
    want = J.count_and_gather(x, jnp.asarray(ids), e_local, rank_ep)
    got = T.count_and_gather(to_t(x), torch.from_numpy(ids), e_local, rank_ep)
    np.testing.assert_array_equal(got[0].view(torch.uint8).numpy(),
                                  np.asarray(want[0]).view(np.uint8))
    assert_ints_equal(got[1:], want[1:], ("topk_pos", "seqlens", "cu_seqlens", "tiles", "cu_tiles"))
    g_want = J._gather_aligned(x, jnp.asarray(ids), e_local, rank_ep, 32)
    g_got = T._gather_aligned(to_t(x), torch.from_numpy(ids), e_local, rank_ep, 32)
    np.testing.assert_array_equal(g_got.x_gathered.view(torch.uint8).numpy(),
                                  np.asarray(g_want.x_gathered).view(np.uint8))
    assert_ints_equal(g_got[1:], g_want[1:], GATHER_NAMES)


GATHER_NAMES = ("topk_pos", "seqlens", "cu_seqlens", "tiles", "cu_tiles", "grp", "row_blk",
                "new_row_valid")


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("has_shared", [False, True])
def test_reduce_matches_jax_and_drops_nan_rows(has_shared, impl):
    """The case of tests/test_moe.py::test_reduce_pallas_vs_ref_nan_rows, cut
    down: rows that only dropped slots point at hold NaN. Tolerance: both sum
    float32 products in slot order and round once to bf16, so 1e-6 + one bf16
    step (2^-7 relative)."""
    rng = np.random.RandomState(17)
    rows, s, k, h = 128, 40, 4, 256
    x = rng.randn(rows, h).astype(np.float32)
    pos = rng.randint(1, rows, size=(s, k)).astype(np.int32)
    pos[pos == 37] = 11
    pos[rng.rand(s, k) < 0.3] = -1
    pos[0, 0] = -1
    x[37] = x[0] = np.nan  # row 0 is what a dropped slot's clamped index reads
    sc = rng.rand(s, k).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    shared = jnp.asarray(rng.randn(s, h), jnp.bfloat16) if has_shared else None
    want = np.asarray(J.reduce(xj, jnp.asarray(pos), jnp.asarray(sc), shared, impl=impl),
                      np.float32)
    got = T.reduce(to_t(xj), torch.from_numpy(pos), torch.from_numpy(sc),
                   None if shared is None else to_t(shared), impl=impl)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (s, h)
    assert torch.isfinite(got.float()).all()
    assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=2**-7, name="reduce")


def moe_case(rank_ep, size_ep, has_shared, seed=41):
    """The shapes of tests/test_moe.py::test_fuse_moe_pertensor_fp8 with
    magnitudes that keep the e4m3 codes normal: x is randn / 6 (that test's
    randn / 100 is subnormal on nine codes in ten), the gate-up scales put
    gate and up near 1, and the activation scale of 16 (undone in the down
    scales) lifts all but about one activation in a hundred above 2^-6. With
    that test's scales of 0.02 every activation code is subnormal and the
    JAX pipeline returns zeros on the CPU."""
    rng = np.random.RandomState(seed)
    s, k, h, interm, e_total = 32, 4, 256, 256, 16
    e_local = e_total // size_ep
    ids = np.sort(rng.randint(0, e_total, (s, k)).astype(np.int32), axis=1)
    arrays = dict(
        x=e4m3(rng.randn(s, h) / 6, "normal"),
        gw=e4m3(rng.randn(e_local, 2 * interm, h), "normal"),
        dw=e4m3(rng.randn(e_local, h, interm), "normal"),
        gs=jnp.asarray(rng.rand(e_local).astype(np.float32) * 0.4 + 0.2),
        ds=jnp.asarray((rng.rand(e_local).astype(np.float32) * 0.1 + 0.05) / 16),
        act=jnp.asarray(np.array([16.0], np.float32)),
        ids=jnp.asarray(ids),
        ts=jnp.asarray((rng.rand(s, k) / k).astype(np.float32)),
    )
    shared = jnp.asarray(rng.randn(s, h), jnp.bfloat16) if has_shared else None
    return arrays, shared, e_total


def torch_args(arrays, shared):
    t = {name: to_t(v) for name, v in arrays.items()}
    return ((t["x"], t["gw"], t["dw"], t["gs"], t["ds"], t["act"], t["ids"], t["ts"]),
            None if shared is None else to_t(shared))


@functools.lru_cache(maxsize=None)
def jax_outputs(rank_ep, size_ep, has_shared):
    """The JAX pipeline's result on moe_case, by its kernels and by its plain path."""
    a, shared, e_total = moe_case(rank_ep, size_ep, has_shared)
    return {
        impl: np.asarray(J.fuse_moe_pertensor_fp8(
            a["x"], a["gw"], a["dw"], a["gs"], a["ds"], a["act"], a["ids"], a["ts"], rank_ep,
            e_total, shared_output=shared, impl=impl), np.float32)
        for impl in ("scatter", "ref")
    }


@pytest.mark.parametrize("impl", ["scatter", "ref"])
@pytest.mark.parametrize("rank_ep,size_ep", EP_CASES)
@pytest.mark.parametrize("has_shared", [False, True])
def test_fuse_moe_pertensor_fp8_matches_jax(rank_ep, size_ep, has_shared, impl):
    arrays, shared, e_total = moe_case(rank_ep, size_ep, has_shared)
    args, t_shared = torch_args(arrays, shared)
    got = T.fuse_moe_pertensor_fp8(*args, rank_ep, e_total, shared_output=t_shared, impl=impl)
    want = jax_outputs(rank_ep, size_ep, has_shared)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want["ref"].shape
    assert np.abs(want["ref"]).max() > 1.0  # the case carries signal
    got = got.float().numpy()
    # the JAX plain path rounds where the port does (measured: bit-equal outputs)
    assert_allclose(got, want["ref"], atol=ATOL_PLAIN, rtol=RTOL_PLAIN, name=f"{impl} vs JAX ref")
    assert_allclose(got, want["scatter"], atol=ATOL, rtol=RTOL, name=f"{impl} vs JAX kernels")


def test_fuse_moe_alias_and_auto():
    arrays, shared, e_total = moe_case(0, 1, False, seed=5)
    args = (*torch_args(arrays, shared)[0], 0, e_total)
    assert torch.equal(T.fuse_moe(*args), T.fuse_moe_pertensor_fp8(*args, impl="scatter"))


def test_counts_reach_the_kernels_as_device_tensors(monkeypatch):
    """The pipeline hands the tile and row counts to the kernel wrappers as
    tensors (on the card: device scalars read through a pointer), never as
    Python numbers, so a step copies no count to the host."""
    seen = {}
    real_gg, real_act = T.gg_scatter, T.act_mul_and_quant

    def gg(x, w, sc, row_idx, grp, tm, num_valid_tiles=None):
        seen.setdefault("nvt", []).append(num_valid_tiles)
        return real_gg(x, w, sc, row_idx, grp, tm, num_valid_tiles)

    def act(gate_up, scale, use_bf16_mul=True, **kw):
        seen["num_valid"] = kw.get("num_valid")
        return real_act(gate_up, scale, use_bf16_mul, **kw)

    monkeypatch.setattr(T, "gg_scatter", gg)
    monkeypatch.setattr(T, "act_mul_and_quant", act)
    arrays, _, e_total = moe_case(1, 4, False)
    T.fuse_moe_pertensor_fp8(*torch_args(arrays, None)[0], 1, e_total)
    assert len(seen["nvt"]) == 2
    for v in (*seen["nvt"], seen["num_valid"]):
        assert isinstance(v, torch.Tensor) and tuple(v.shape) == (1,)
    tm = T._pick_tm(max(32 * 4 // e_total, 1), 256)
    assert int(seen["num_valid"]) == int(seen["nvt"][0]) * tm
