"""Parity of the port's scatter grouped GEMM and its tile bookkeeping against
the JAX package (its Pallas kernel in interpret mode) on numpy-made inputs.

Tolerance of the GEMM: 2e-2 abs + 1e-2 rel on the valid slots (the JAX test,
tests/test_group_gemm.py, takes 0.15 abs + 0.08 rel against a float32
oracle). Both packages multiply decoded e4m3 values into float32 and round
once to bf16 (2^-9 relative), so they differ by the order of the sum and, at
most, by one bf16 rounding. One difference is kept out of the main case and
shown in a test of its own: the JAX kernel's fast e4m3 decode flushes
subnormal codes (|x| < 2^-6) to 0 on the CPU, the port decodes them exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import group_gemm as J
from hpc_ops_tpu_torch.models.llama import weights_from_numpy
from hpc_ops_tpu_torch.ops import group_gemm as T
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

ATOL, RTOL = 2e-2, 1e-2


def to_t(a):
    return weights_from_numpy(np.asarray(a), device="cpu")


def subnormal(a) -> np.ndarray:
    """Mask of the e4m3 codes with a zero exponent and a nonzero mantissa."""
    bits = np.asarray(a).view(np.uint8)
    return ((bits & 0x78) == 0) & ((bits & 0x07) != 0)


def e4m3(a, subnormals: str):
    """numpy floats -> a JAX e4m3 array; subnormal codes are kept ("keep"),
    set to 0 ("zero") or raised to the smallest normal, 2^-6 ("normal")."""
    a = np.asarray(jnp.asarray(a, jnp.float8_e4m3fn))
    if subnormals != "keep":
        bits = a.view(np.uint8).copy()
        sub = subnormal(a)
        bits[sub] = (bits[sub] & 0x80) | (0x08 if subnormals == "normal" else 0)
        a = bits.view(a.dtype)
    return jnp.asarray(a)


def scatter_case(seed=11, total_tokens=50, k_dim=256, n=384, g=3, subnormals="normal"):
    """The case of tests/test_group_gemm.py::test_group_gemm_fp8_scatter:
    four m-tiles with a ragged fill, empty slots marked -1."""
    rng = np.random.RandomState(seed)
    tm = J._pick_tm(32)
    x = e4m3(rng.randn(total_tokens, k_dim) / 8, subnormals)
    w = e4m3(rng.randn(g, n, k_dim) / 8, subnormals)
    y_scale = jnp.asarray(rng.rand(g).astype(np.float32))
    grp = np.array([0, 1, 1, 2], np.int32)
    fill = [5, tm, 7, 1]
    row_idx = np.full((4 * tm,), -1, np.int32)
    for t in range(4):
        row_idx[t * tm : t * tm + fill[t]] = rng.randint(0, total_tokens, fill[t])
    return x, w, y_scale, row_idx, grp, tm


def test_pick_tm_and_flat_tiles_match_jax():
    for navg, k in [(1, None), (2, 4096), (28, 256), (32, None), (132, 4096), (500, 4096),
                    (500, 14336), (4000, 16384)]:
        assert T._pick_tm(navg, k) == J._pick_tm(navg, k)
    seqlens = np.array([5, 0, 64, 33, 1], np.int32)
    for tm, total in [(32, 9), (64, 12)]:
        want = J._flat_tiles(jnp.asarray(seqlens), tm, total)
        got = T._flat_tiles(torch.from_numpy(seqlens), tm, total)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(T.cdiv_dyn(torch.from_numpy(seqlens), 32).numpy(),
                                  np.asarray(J.cdiv_dyn(jnp.asarray(seqlens), 32)))


@pytest.mark.parametrize("tm,kind,want", [
    (32, "e4m3", 0), (32, "int8", 1), (32, "blockwise", 1), (64, "e4m3", 3), (64, "int8", 1),
    (128, "e4m3", 3), (128, "int8", 2), (160, "int8", 2), (256, "blockwise", 1), (512, "e4m3", 3),
    (512, "int8", 2), (512, "blockwise", 1), (96, "e4m3", 3), (160, "e4m3", 3), (256, "e4m3", 3),
    (288, "e4m3", 3), (96, "int8", 1), (288, "int8", 2), (64, "blockwise", 1),
])
def test_gg_form_picks_body_and_block_from_host_integers(tm, kind, want):
    """e4m3 per-tensor: the mma.sync body (0) at decode m-tiles, the
    register-operand body (3) from 64 slots up; int8 per-tensor: blocks of
    two warpgroups (2: 128 rows) from m-tiles of 128 up, else one (1: 64
    rows); blockwise: one warpgroup."""
    assert T.gg_form(tm, kind) == want


def test_gg_form_covers_every_m_tile_the_moe_picks():
    for navg in range(1, 700, 7):
        for k in (None, 4096, 14336):
            tm = T._pick_tm(navg, k)
            for kind in T.GG_KINDS:
                wg = T.gg_form(tm, kind)
                assert (wg == T.GG_MMA_SYNC) == (kind == "e4m3" and tm <= 32)
                assert (wg == T.GG_RS) == (kind == "e4m3" and tm > 32)
                assert (wg == 2) == (kind == "int8" and tm >= 128)
                assert wg in T.E4M3_BODIES if kind == "e4m3" else wg in (1, 2)
    with pytest.raises(ValueError, match="kind"):
        T.gg_form(64, "fp8")


def test_e4m3_bodies_count_beside_the_wrappers():
    """Each body of the e4m3 per-tensor forms keeps a launch count that
    ``kernels.launch_counts()`` lists beside the wrappers', that a captured
    graph's replays add to (``add_launches``) and that a reset zeroes; the
    plain version on the CPU counts none."""
    from hpc_ops_tpu_torch import kernels

    names = {body.__name__ for body in T.E4M3_BODIES.values()}
    assert names == {"gg_e4m3_mma_sync", "gg_e4m3_rs"} and names <= set(kernels.launch_counts())
    kernels.reset_launch_counts()
    x, w, y_scale, row_idx, grp, tm = scatter_case()
    T.gg_scatter(to_t(x), to_t(w), to_t(y_scale), torch.from_numpy(row_idx), torch.from_numpy(grp), tm)
    assert all(n == 0 for n in kernels.launch_counts().values())
    kernels.add_launches({"gg_e4m3_rs": 3, "gg_scatter": 3})
    counts = kernels.launch_counts()
    assert counts["gg_e4m3_rs"] == 3 == T.E4M3_BODIES[T.GG_RS].launches and counts["gg_e4m3_mma_sync"] == 0
    kernels.reset_launch_counts()
    assert T.E4M3_BODIES[T.GG_RS].launches == 0


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_group_gemm_fp8_scatter_matches_jax(impl):
    x, w, y_scale, row_idx, grp, tm = scatter_case()
    want = np.asarray(J.group_gemm_fp8_scatter(x, w, y_scale, jnp.asarray(row_idx),
                                               jnp.asarray(grp), impl=impl), np.float32)
    got = T.group_gemm_fp8_scatter(to_t(x), to_t(w), to_t(y_scale), torch.from_numpy(row_idx),
                                   torch.from_numpy(grp), impl=impl)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4 * tm, 384)
    valid = row_idx >= 0
    assert_allclose(got.float().numpy()[valid], want[valid], atol=ATOL, rtol=RTOL,
                    name=f"scatter {impl}")
    # and against the float32 oracle of the JAX test, at its tolerance
    xf, wf = np.asarray(x, np.float32), np.asarray(w, np.float32)
    oracle = np.einsum("sk,snk->sn", xf[row_idx[valid]], wf[np.repeat(grp, tm)[valid]])
    oracle = oracle * np.asarray(y_scale)[np.repeat(grp, tm)[valid]][:, None]
    assert_allclose(got.float().numpy()[valid], oracle, atol=0.15, rtol=0.08, name="oracle")


def test_gg_scatter_skips_nothing_it_should_compute():
    """num_valid_tiles below the grid: the tiles before it are computed as
    without it (the plain version computes every tile)."""
    x, w, y_scale, row_idx, grp, tm = scatter_case(seed=3)
    args = (to_t(x), to_t(w), to_t(y_scale), torch.from_numpy(row_idx), torch.from_numpy(grp), tm)
    full = T.gg_scatter(*args)
    part = T.gg_scatter(*args, num_valid_tiles=torch.tensor([2], dtype=torch.int32))
    assert torch.equal(full[: 2 * tm], part[: 2 * tm])
    assert T.gg_scatter.launches == 0  # CPU tensors never count a launch


def test_e4m3_subnormals_are_decoded_exactly():
    """The JAX kernel decodes e4m3 through a fast path that flushes subnormal
    codes (|x| < 2^-6) to 0 where float32 subnormals are flushed, as XLA does
    on the CPU; the port decodes every code exactly. With randn / 8 inputs
    (about a tenth of the codes subnormal) the port therefore agrees with the
    JAX package's plain path at the GEMM tolerance, and with its kernel only
    once the subnormal codes of the inputs are set to 0."""
    x, w, y_scale, row_idx, grp, tm = scatter_case(seed=5, subnormals="keep")
    assert 0.05 < subnormal(x).mean() < 0.2 and 0.05 < subnormal(w).mean() < 0.2
    idx = (jnp.asarray(row_idx), jnp.asarray(grp))
    jax_kernel = np.asarray(J.group_gemm_fp8_scatter(x, w, y_scale, *idx), np.float32)
    jax_plain = np.asarray(J.group_gemm_fp8_scatter(x, w, y_scale, *idx, impl="ref"), np.float32)
    t_idx = (torch.from_numpy(row_idx), torch.from_numpy(grp))
    got = T.group_gemm_fp8_scatter(to_t(x), to_t(w), to_t(y_scale), *t_idx).float().numpy()
    valid = row_idx >= 0
    assert_allclose(got[valid], jax_plain[valid], atol=ATOL, rtol=RTOL, name="exact decode")
    # 0.0146 on this input, on outputs up to 0.3: far above one bf16 rounding (6e-4)
    flush = np.abs(jax_kernel[valid] - jax_plain[valid]).max()
    assert flush > 5e-3, "the JAX kernel no longer flushes subnormals on the CPU"
    x0, w0, _, _, _, _ = scatter_case(seed=5, subnormals="zero")
    got0 = T.group_gemm_fp8_scatter(to_t(x0), to_t(w0), to_t(y_scale), *t_idx).float().numpy()
    assert_allclose(got0[valid], jax_kernel[valid], atol=ATOL, rtol=RTOL, name="flushed inputs")


def test_group_gemm_ref_matches_jax():
    rng = np.random.RandomState(7)
    g, n, k = 4, 64, 128
    seqlens = np.array([10, 0, 21, 3], np.int32)
    cu = np.concatenate([[0], np.cumsum(seqlens)]).astype(np.int32)
    x = jnp.asarray(rng.randn(int(cu[-1]), k) / 4, jnp.float8_e4m3fn)
    w = jnp.asarray(rng.randn(g, n, k) / 4, jnp.float8_e4m3fn)
    ys = rng.rand(g).astype(np.float32)
    want = np.asarray(J.group_gemm_ref(x, w, seqlens, cu, ys), np.float32)
    got = T.group_gemm_ref(to_t(x), to_t(w), torch.from_numpy(seqlens), torch.from_numpy(cu),
                           torch.from_numpy(ys))
    assert_allclose(got.float().numpy(), want, atol=ATOL, rtol=RTOL, name="group_gemm_ref")
