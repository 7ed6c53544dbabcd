"""Parity of the port's int8 grouped GEMMs, the act_fuse epilogue, the aligned
grouped GEMM and the packed-rows entry points against the JAX package (its
Pallas kernels in interpret mode) on numpy-made inputs.

Tolerances, each with its reason:
- int8 GEMMs, bit-equal: both packages sum int8 products exactly as integers
  (K of 256 is one k-step in the JAX kernel), convert to float32 once, scale
  in float32 and round once to bf16.
- act_fuse codes: equal to the JAX plain path (its GEMM, then
  ``act_mul_and_quant(impl="ref")``), which rounds where the port does;
  within one code step of JAX's fused kernel on at most 5% of the codes (the
  bound of tests/test_activation.py): XLA compiles that kernel's body
  without the bf16 rounding of ``silu(gate)`` on the CPU.
- e4m3 aligned GEMM: 2e-2 abs + 1e-2 rel, as tests/test_torch_group_gemm.py
  (float32 sums in another order, one bf16 rounding); inputs keep no
  subnormal code, which the JAX kernel flushes to 0 on the CPU.
- packed entry points: 5e-2 abs + 5e-2 rel, the tolerance of
  tests/test_group_gemm.py::test_group_gemm_int8_native, against the JAX
  kernel path and the float32 oracle alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import group_gemm as J
from hpc_ops_tpu.ops import moe as JM
from hpc_ops_tpu.ops.activation import act_mul_and_quant as jax_act_mul_and_quant
from hpc_ops_tpu.ops.quant import scaled_int8_quant
from hpc_ops_tpu_torch.models.llama import weights_from_numpy
from hpc_ops_tpu_torch.ops import group_gemm as T
from hpc_ops_tpu_torch.ops import moe as TM
from hpc_ops_tpu_torch.utils.testing import assert_allclose
from test_torch_group_gemm import e4m3, scatter_case

torch.set_num_threads(1)


def to_t(a):
    return weights_from_numpy(np.asarray(a), device="cpu")


def int8_case(seed=11, total_tokens=50, k_dim=256, n=512, g=3):
    """scatter_case's routing (four m-tiles, ragged fill, empty slots) over
    int8 operands quantised per tensor and per group, with y_scale folding
    both scales so that outputs are near 1."""
    _, _, _, row_idx, grp, tm = scatter_case(seed, total_tokens, k_dim, n, g)
    rng = np.random.RandomState(seed + 1)
    x8, xs = scaled_int8_quant(jnp.asarray(rng.randn(total_tokens, k_dim), jnp.float32))
    w8, ws = zip(*(scaled_int8_quant(jnp.asarray(rng.randn(n, k_dim), jnp.float32) / 16)
                   for _ in range(g)))
    y_scale = xs.reshape(()) * jnp.concatenate(ws)
    return x8, jnp.stack(w8), y_scale, row_idx, grp, tm


def torch_idx(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def test_gg_scatter_int8_matches_jax_bit_for_bit():
    x8, w8, y_scale, row_idx, grp, tm = int8_case()
    want = np.asarray(J._gg_scatter_pallas(x8, w8, y_scale, jnp.asarray(row_idx), jnp.asarray(grp),
                                           tm, 256, interpret=True), np.float32)
    got = T.gg_scatter(to_t(x8), to_t(w8), to_t(y_scale), *torch_idx(row_idx, grp), tm)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4 * tm, 512)
    valid = row_idx >= 0
    assert np.abs(want[valid]).max() > 0.5  # the case carries signal
    np.testing.assert_array_equal(got.float().numpy()[valid], want[valid])
    assert T.gg_scatter_i8.launches == 0  # CPU tensors never count a launch


@pytest.mark.parametrize("use_bf16_mul", [True, False])
def test_act_fuse_codes_match_jax(use_bf16_mul):
    # 1024 weight rows: two interleave blocks of 256 gate and 256 up rows
    x8, w8, y_scale, row_idx, grp, tm = int8_case(seed=5, n=1024)
    am = jnp.asarray([127.0 / 6.0], jnp.float32)  # gate and up near 1: few codes saturate
    w_il = JM.interleave_gate_up(w8)
    idx = (jnp.asarray(row_idx), jnp.asarray(grp))
    fused = np.asarray(J._gg_scatter_pallas(
        x8, w_il, y_scale, *idx, tm, 512, interpret=True, act_fuse=True, act_scale=am,
        use_bf16_mul=use_bf16_mul, out_dtype=jnp.int8))
    plain_gu = J._gg_scatter_pallas(x8, w8, y_scale, *idx, tm, 256, interpret=True)
    plain = np.asarray(jax_act_mul_and_quant(plain_gu, am, use_bf16_mul, out_dtype=jnp.int8,
                                             impl="ref"))
    got = T.gg_scatter(to_t(x8), to_t(w_il), to_t(y_scale), *torch_idx(row_idx, grp), tm,
                       act_fuse=True, act_scale=to_t(am), use_bf16_mul=use_bf16_mul)
    assert got.dtype == torch.int8 and tuple(got.shape) == fused.shape == (5 * tm, 512)
    assert not np.array_equal(np.asarray(w_il), np.asarray(w8))  # the interleave moves rows
    got = got.numpy().astype(np.int32)
    valid = row_idx >= 0
    codes = got[: 4 * tm][valid]
    assert np.abs(codes).max() > 60 and (np.abs(codes) == 127).mean() < 0.01
    np.testing.assert_array_equal(codes, plain[valid])
    step = np.abs(codes - fused[: 4 * tm][valid].astype(np.int32))
    assert step.max() <= 1 and (step > 0).mean() <= 0.05


def test_act_fuse_checks_its_layout():
    x8, w8, y_scale, row_idx, grp, tm = int8_case()
    args = (to_t(x8), to_t(w8), to_t(y_scale), *torch_idx(row_idx, grp), tm)
    with pytest.raises(ValueError, match="act_scale"):
        T.gg_scatter(*args, act_fuse=True)
    with pytest.raises(ValueError, match="whole blocks"):
        T.gg_scatter(*args, act_fuse=True, act_scale=torch.ones(1), pair=96)
    x, w, ys, _, _, _ = scatter_case()
    with pytest.raises(ValueError, match="int8 operands"):
        T.gg_scatter(to_t(x), to_t(w), to_t(ys), *torch_idx(row_idx, grp), tm, act_fuse=True,
                     act_scale=torch.ones(1))


@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_gg_pertensor_matches_jax(dtype):
    """The aligned GEMM over _gather_aligned's layout with the trash tile
    and skipped tiles: every row of a valid tile is compared."""
    rng = np.random.RandomState(9)
    s, k_dim, n, g, tm = 40, 256, 256, 4, 32
    ids = jnp.asarray(rng.randint(0, g, (s, 2)).astype(np.int32))
    if dtype == "int8":
        x, _ = scaled_int8_quant(jnp.asarray(rng.randn(s, k_dim), jnp.float32))
        w = jnp.stack([scaled_int8_quant(jnp.asarray(rng.randn(n, k_dim), jnp.float32))[0]
                       for _ in range(g)])
        y_scale = jnp.asarray(rng.rand(g).astype(np.float32) * 1e-4 + 1e-4)
    else:
        x = e4m3(rng.randn(s, k_dim) / 4, "normal")
        w = e4m3(rng.randn(g, n, k_dim) / 4, "normal")
        y_scale = jnp.asarray(rng.rand(g).astype(np.float32) + 0.5)
    ga = JM._gather_aligned(x, ids, g, 0, tm)
    nvt = ga.cu_tiles[-1]
    want = np.asarray(J._gg_pertensor_pallas(ga.x_gathered, w, y_scale, ga.grp, ga.row_blk, tm,
                                             256, 256, interpret=True, num_valid_tiles=nvt),
                      np.float32)
    got = T.gg_pertensor(to_t(ga.x_gathered), to_t(w), to_t(y_scale), to_t(ga.grp),
                         to_t(ga.row_blk), tm, to_t(nvt).reshape(1))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    rows = int(nvt) * tm
    assert 0 < rows < want.shape[0] - tm  # tiles past the valid count exist
    got = got.float().numpy()[:rows]
    assert np.abs(want[:rows]).max() > 0.5
    if dtype == "int8":
        np.testing.assert_array_equal(got, want[:rows])
    else:
        assert_allclose(got, want[:rows], atol=2e-2, rtol=1e-2, name="gg_pertensor e4m3")
    assert T.gg_pertensor.launches == 0


def packed_case(name, seqlens):
    """tests/test_group_gemm.py's inputs: test_group_gemm_int8_native for the
    int8 entry point, test_group_gemm_pertensor_fp8 for the e4m3 ones, whose
    few subnormal codes are raised to the smallest normal (the JAX kernel
    would flush them on the CPU)."""
    rng = np.random.RandomState(11 if name.endswith("int8") else 41)
    g, n, k = len(seqlens), 256, 512
    cu = np.concatenate([[0], np.cumsum(seqlens)]).astype(np.int32)
    x = rng.randn(int(cu[-1]), k).astype(np.float32)
    w = rng.randn(g, n, k).astype(np.float32)
    if name.endswith("int8"):
        x8, xs = scaled_int8_quant(jnp.asarray(x))
        w8s = [scaled_int8_quant(jnp.asarray(w[i])) for i in range(g)]
        w8 = jnp.stack([a for a, _ in w8s])
        y_scale = xs.reshape(()) * jnp.concatenate([b for _, b in w8s])
        return x8, w8, y_scale, cu
    xs, ws = np.abs(x).max() / 448.0, np.abs(w).max() / 448.0
    x8 = e4m3(x / xs, "normal")
    w8 = e4m3(w / ws, "normal")
    return x8, w8, jnp.full((g,), xs * ws, jnp.float32), cu


@pytest.mark.parametrize("name,seqlens", [("group_gemm_pertensor_int8", [40, 0, 100, 17]),
                                          ("group_gemm_pertensor_fp8", [1, 1, 1, 1, 60]),
                                          ("group_gemm_fp8", [5, 0, 33, 7])])
def test_packed_group_gemm_matches_jax(name, seqlens):
    x8, w8, y_scale, cu = packed_case(name, seqlens)
    sl = np.asarray(seqlens, np.int32)
    want = np.asarray(getattr(J, name)(x8, w8, jnp.asarray(sl), jnp.asarray(cu), y_scale),
                      np.float32)
    got = getattr(T, name)(to_t(x8), to_t(w8), torch.from_numpy(sl), torch.from_numpy(cu),
                           to_t(y_scale), tn=128, tk=256)  # TPU tile hints: ignored
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (int(cu[-1]), 256)
    assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=5e-2, name=f"{name} vs JAX")
    oracle = np.asarray(J.group_gemm_ref(x8, w8, sl, cu, np.asarray(y_scale)), np.float32)
    assert_allclose(got.float().numpy(), oracle, atol=5e-2, rtol=5e-2, name=f"{name} vs oracle")
    ref = T.group_gemm_pertensor_fp8(to_t(x8), to_t(w8), torch.from_numpy(sl),
                                     torch.from_numpy(cu), to_t(y_scale), impl="ref")
    assert_allclose(ref.float().numpy(), oracle, atol=5e-2, rtol=5e-2, name=f"{name} ref")


def test_group_gemm_pertensor_int8_takes_int8_only():
    x8, w8, y_scale, cu = packed_case("group_gemm_pertensor_fp8", [5, 7])
    with pytest.raises(ValueError, match="int8"):
        T.group_gemm_pertensor_int8(to_t(x8), to_t(w8), torch.tensor([5, 7]),
                                    torch.from_numpy(cu), to_t(y_scale))


@pytest.mark.parametrize("dtype,shape,tn", [("int8", (3, 512, 64), 512),
                                            ("int8", (2, 256, 32), 512),
                                            ("e4m3", (2, 1024, 32), 512),
                                            ("int8", (2, 1024, 32), 256)])
def test_interleave_gate_up_is_bit_equal(dtype, shape, tn):
    rng = np.random.RandomState(3)
    if dtype == "int8":
        w = jnp.asarray(rng.randint(-127, 128, shape).astype(np.int8))
    else:
        w = e4m3(rng.randn(*shape), "keep")
    want = np.asarray(JM.interleave_gate_up(w, tn))
    got = TM.interleave_gate_up(to_t(w), tn)
    assert got.dtype == to_t(w).dtype
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want.view(np.uint8))
    back = TM._deinterleave_gate_up(got) if tn == 512 else None
    if back is not None:
        np.testing.assert_array_equal(back.view(torch.uint8).numpy(), np.asarray(w).view(np.uint8))
    # and the columns of a product with it come back by deinterleave_columns
    cols = torch.arange(shape[1], dtype=torch.float32)[None].expand(2, -1)
    il = TM.interleave_gate_up(cols.T.reshape(1, shape[1], 2), tn)[0].T
    gate, up = T.deinterleave_columns(il, T.act_pair(shape[1], min(tn, shape[1]) // 2))
    assert torch.equal(torch.cat([gate, up], 1), cols)
