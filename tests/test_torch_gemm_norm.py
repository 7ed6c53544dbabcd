"""Parity of the port's route GEMM (ops/gemm.py) and fused RMSNorm + fp8
(ops/normalization.py) against the JAX package, on the grids of
tests/test_gemm.py and tests/test_normalization.py.

Route GEMM: the split weights are bit-equal to JAX's; the float32 output
within 1e-5 of the largest |output| (two float32 sums of exact bf16
products, in another order), the bf16 output within one bf16 step (2^-7
relative) plus that; both against the float64 product at the JAX test's
tolerance, and more accurate than one bf16 product. The host's choice of
the kernel's form on a card (body, tile, split of K) is checked here too.

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
    SMS,
    STAGE_K,
    gemm_bf16xfp32,
    get_gemm_bf16xfp32_workspace,
    route_form,
    route_gemm,
    split_fp32_weight,
)
from hpc_ops_tpu_torch.ops.normalization import (
    _F32_EPS,
    fused_rmsnorm_with_scale,
    rmsnorm_quant,
)
from hpc_ops_tpu_torch.utils.common import cdiv
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


def split_stages(stages, splits):
    """The K stages of each split as csrc/gemm.cu cuts them: the first
    stages % splits splits take one stage more."""
    q, r = divmod(stages, splits)
    return [q + (s < r) for s in range(splits)]


ROUTE_FORM_SHAPES = [(256, 256, 7168), (16, 256, 7168), (4096, 256, 7168), (16384, 256, 7168),
                     (4096, 4096, 4096), (8192, 8192, 8192), (33, 72, 520), (1, 8, 8), (256, 256, 7176),
                     (257, 100, 64)]


@pytest.mark.parametrize("m,n,k", ROUTE_FORM_SHAPES)
def test_route_form_splits_whole_stages_and_sizes_its_workspace(m, n, k):
    """No split is empty, each is a whole number of 64-element stages, the
    first stages % splits one stage longer; the tiles cover the output; the
    workspace holds each split's hi and lo sums of each tile."""
    f = route_form(m, n, k)
    stages = cdiv(k, STAGE_K)
    runs = split_stages(stages, f.splits)
    assert len(runs) == f.splits and sum(runs) == stages and min(runs) >= 1
    assert runs == sorted(runs, reverse=True) and runs[0] - runs[-1] <= 1
    assert f.body == ("small" if m <= 256 else "large")
    assert (f.tile_m, f.tile_n) in ({(16, 64), (32, 64), (64, 64)} if f.body == "small" else {(128, 128)})
    assert f.tiles == cdiv(m, f.tile_m) * cdiv(n, f.tile_n) and f.blocks == f.tiles * f.splits
    assert f.workspace == (0 if f.splits == 1 else f.blocks * 2 * f.tile_m * f.tile_n)
    assert route_form(m, n, k) == f  # host integers only


def test_route_form_fills_the_card_where_the_tiles_do_not():
    """The router's decode shape splits K until the grid fills the 132 SMs
    in one wave: one split more would pass 132 blocks (which ran slower on
    an H100: two blocks sharing an SM, or a second wave); 4096^3 has tiles
    enough and does not split; (1, 8, 8) is one block; no split of the
    large body makes a second, partial wave."""
    router = route_form(256, 256, 7168)
    assert router.body == "small" and router.splits > 1
    assert router.blocks <= SMS < router.blocks + router.tiles
    assert route_form(4096, 4096, 4096).splits == 1
    one = route_form(1, 8, 8)
    assert one.blocks == 1 and one.splits == 1 and one.workspace == 0
    prefill = route_form(4096, 256, 7168)
    assert prefill.body == "large" and prefill.splits == 2 and prefill.blocks <= SMS
    assert route_form(256, 256, 7176).splits == router.splits  # 113 stages: uneven runs
    assert len(set(split_stages(113, router.splits))) == 2


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
