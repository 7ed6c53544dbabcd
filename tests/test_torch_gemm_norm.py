"""Parity of the port's route GEMM (ops/gemm.py) and fused RMSNorm + fp8
(ops/normalization.py) against the JAX package, on the grids of
tests/test_gemm.py and tests/test_normalization.py.

Route GEMM: the split weights are bit-equal to JAX's; the float32 output
within 1e-5 of the largest |output| (two float32 sums of exact bf16
products, in another order), the bf16 output within one bf16 step (2^-7
relative) plus that; both against the float64 product at the JAX test's
tolerance, and more accurate than one bf16 product.

RMSNorm + fp8: every e4m3 code equal to JAX's Pallas kernel (interpret mode)
and to JAX's reference (the port's plain version sums the squares in
float64, exact for these rows, then rounds each step once in float32, as
the kernel on the card does); the float32 norm within 2e-6 (the JAX side's
sum of squares is a float32 sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops.gemm import gemm_bf16xfp32 as jax_gemm
from hpc_ops_tpu.ops.gemm import split_fp32_weight as jax_split
from hpc_ops_tpu.ops.normalization import fused_rmsnorm_with_scale as jax_norm
from hpc_ops_tpu.ops.normalization import fused_rmsnorm_with_scale_ref as jax_norm_ref
from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.ops.gemm import (
    gemm_bf16xfp32,
    get_gemm_bf16xfp32_workspace,
    route_gemm,
    split_fp32_weight,
)
from hpc_ops_tpu_torch.ops.normalization import (
    _F32_EPS,
    fused_rmsnorm_with_scale,
    rmsnorm_quant,
)
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)


def f32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("use_fp32_output", [False, True])
@pytest.mark.parametrize("n,k", [(192, 512), (256, 1024)])
@pytest.mark.parametrize("m", [2, 16, 100, 512])
def test_route_gemm_matches_jax(m, n, k, use_fp32_output):
    rng = np.random.RandomState(41)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(n, k).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jh, jl, js = jax_split(jnp.asarray(w))
    wh, wl, ws = split_fp32_weight(torch.from_numpy(w))
    assert np.array_equal(wh.float().numpy(), f32(jh)) and np.array_equal(wl.float().numpy(), f32(jl))
    assert ws.dtype == torch.float32 and float(ws) == float(js[0])
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = gemm_bf16xfp32(xt, wh, wl, ws, use_fp32_output)
    assert got.dtype == (torch.float32 if use_fp32_output else torch.bfloat16)
    want = f32(jax_gemm(jx, jh, jl, js, use_fp32_output))
    big = float(np.abs(want).max())
    tol = dict(atol=1e-5 * big, rtol=0 if use_fp32_output else 2.0**-7)
    assert_allclose(got.float(), want, **tol, name="route gemm vs jax kernel")
    exact = xt.double().numpy() @ w.astype(np.float64).T
    jtol = 2e-2 if use_fp32_output else 0.25  # tests/test_gemm.py
    assert_allclose(got.float(), exact, atol=jtol * np.sqrt(k) / 16, rtol=2e-2, name="vs float64")
    bf16_only = xt.double().numpy() @ wh.double().numpy().T
    assert np.abs(got.double().numpy() - exact).mean() < np.abs(bf16_only - exact).mean()


def test_route_gemm_ref_and_arguments():
    """impl="ref" is JAX's reference; a plain number as the scale; the
    accepted-and-unused split-K arguments; the workspace's shape."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(33, 256).astype(np.float32)).to(torch.bfloat16)
    w = rng.randn(64, 256).astype(np.float32)
    wh, wl, ws = split_fp32_weight(torch.from_numpy(w))
    jh, jl, js = jax_split(jnp.asarray(w))
    want = f32(jax_gemm(jnp.asarray(x.float().numpy(), jnp.bfloat16), jh, jl, js, True, impl="ref"))
    got = gemm_bf16xfp32(x, wh, wl, 1.0 / 256, True, use_splitk=False, split_flag=torch.zeros(1),
                         tm=64, tn=64, tk=128, impl="ref")
    assert_allclose(got, want, atol=1e-4, rtol=1e-5, name="impl=ref")
    before = route_gemm.launches
    plain = gemm_bf16xfp32(x, wh, wl, 1.0 / 256, True)
    assert route_gemm.launches == before  # CPU tensors: the plain version
    assert_allclose(plain, want, atol=1e-3, rtol=1e-5, name="plain vs ref")
    ws_ = get_gemm_bf16xfp32_workspace(7168, 4096, device="cpu")
    assert tuple(ws_.shape) == (256, 112) and ws_.dtype == torch.int32 and not ws_.any()


@pytest.mark.parametrize("is_moe", [False, True])
@pytest.mark.parametrize("hidden", [320, 4096, 5120])
@pytest.mark.parametrize("batch", [1, 5, 17, 64])
def test_fused_rmsnorm_with_scale_matches_jax(batch, hidden, is_moe):
    k1, k2 = jax.random.split(jax.random.PRNGKey(batch * 131 + hidden))
    jx = jax.random.normal(k1, (batch, hidden), jnp.bfloat16)
    jw = jax.random.uniform(k2, (hidden,), jnp.bfloat16)
    jsc = jnp.array([2.5, 5.0], jnp.float32)[: 2 if is_moe else 1]
    x = torch.from_numpy(f32(jx)).to(torch.bfloat16)
    w = torch.from_numpy(f32(jw)).to(torch.bfloat16)
    sc = torch.tensor([2.5, 5.0])[: 2 if is_moe else 1]
    got = fused_rmsnorm_with_scale(x, w, eps=1e-6, scale=sc, is_moe=is_moe)
    want = jax_norm(jx, jw, eps=1e-6, scale=jsc, is_moe=is_moe)
    want_ref = jax_norm_ref(jx, jw, eps=1e-6, scale=jsc, is_moe=is_moe)
    if not is_moe:
        got, want, want_ref = (got,), (want,), (want_ref,)
    else:
        assert got[0].dtype == torch.float32
        assert_allclose(got[0], f32(want[0]), atol=2e-6, rtol=2e-6, name="norm vs jax kernel")
        assert_allclose(got[0], f32(want_ref[0]), atol=2e-6, rtol=2e-6, name="norm vs jax ref")
        got, want, want_ref = got[1:], want[1:], want_ref[1:]
    for g, wk, wr in zip(got, want, want_ref):
        assert g.dtype == torch.float8_e4m3fn
        codes = g.view(torch.uint8).numpy()
        assert np.array_equal(codes, np.asarray(wk).view(np.uint8)), "codes differ from the JAX kernel"
        assert np.array_equal(codes, np.asarray(wr).view(np.uint8)), "codes differ from the JAX ref"


def test_rmsnorm_defaults_and_ref():
    """The default eps is float32's machine epsilon, the default scale 1;
    impl="ref" divides (JAX's reference) and agrees on these inputs; the
    saturating cast clips at +-448; CPU tensors take the plain version."""
    assert _F32_EPS == float(np.finfo(np.float32).eps)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(9, 256).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.rand(1, 256).astype(np.float32) * 300).to(torch.bfloat16)
    jx, jw = jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.float().numpy(), jnp.bfloat16)
    before = rmsnorm_quant.launches
    for is_moe in (False, True):
        got = fused_rmsnorm_with_scale(x, w, is_moe=is_moe)
        ref = fused_rmsnorm_with_scale(x, w, is_moe=is_moe, impl="ref")
        want = jax_norm(jx, jw, is_moe=is_moe)
        got, ref, want = ((got,), (ref,), (want,)) if not is_moe else (got[1:], ref[1:], want[1:])
        for g, r, wk in zip(got, ref, want):
            assert np.array_equal(g.view(torch.uint8).numpy(), np.asarray(wk).view(np.uint8))
            assert torch.equal(g.view(torch.uint8), r.view(torch.uint8))
            assert float(g.float().abs().max()) == 448.0
    assert rmsnorm_quant.launches == before
    assert kernels.wrappers()["rmsnorm_quant"] is rmsnorm_quant
