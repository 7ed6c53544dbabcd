"""Parity of the port's blockwise grouped GEMMs against the JAX package on
numpy-made inputs: ``group_gemm_blockwise_fp8`` / ``_int8`` in both x-scale
layouts and every scheme, their plain versions ``gg_bw_scatter_ref`` /
``gg_bw_aligned_ref`` (which the CUDA kernels equal bit for bit over int8 and
within summation order over e4m3), ``reformat_x_scale`` and the float32
oracle ``group_gemm_blockwise_ref``. The shapes are those of
tests/test_group_gemm.py (N 256, K 512), with a third, empty group beside a
ragged one.

Tolerances, each with its reason:
- against JAX's ``impl="ref"`` (``group_gemm_blockwise_ref``, every scheme and
  layout): one bf16 step (2^-7 relative) plus 1e-3 of the largest output.
  Both packages decode the operands exactly and promote each 128-group's
  partial sum by its two scales in float32; they differ in the order of the
  float32 sums and so, at most, in one bf16 rounding of the output;
- against JAX's kernels in interpret mode, the JAX tests' own tolerances
  against their float32 oracle (tests/test_group_gemm.py): "scatter" and
  "prescale" fold both scale sets into bf16 operands (about 2^-9 relative
  each): 0.5 abs + 1e-2 rel over int8, 0.3 + 3e-2 over e4m3; the exact
  "int8" scheme 0.05 + 1e-2; the "fp8" scheme 0.3 + 3e-2. JAX's kernels
  decode e4m3 through ``e4m3_bits_to_f32_fast``, which flushes subnormal
  codes on the CPU, so the e4m3 cases zero those codes in their inputs.

JAX's scatter kernel copies rows one DMA at a time in interpret mode (about
ten seconds a call here), so it runs once, over int8; the other JAX kernels
run once each.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import group_gemm as J
from hpc_ops_tpu.ops.quant import blockwise_int8_quant
from hpc_ops_tpu_torch.ops import group_gemm as T
from hpc_ops_tpu_torch.utils.testing import assert_allclose
from test_torch_group_gemm import e4m3

torch.set_num_threads(1)

N, K = 256, 512
KB = K // 128
SEQLENS = ((9, 0, 40), (70,))
BF16_STEP = 2.0**-7


def to_t(a) -> torch.Tensor:
    """A JAX or numpy array as a row-major CPU tensor; e4m3 and bf16 move as
    their bits."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def bw_case(dtype: str, seqlens: tuple, seed: int = 7):
    """Blockwise-quantised x (per row and 128-group) and w (per 128 x 128
    block), w scales padded to a multiple of 4 columns as in the JAX tests;
    returns JAX arrays."""
    rng = np.random.RandomState(seed)
    g, total = len(seqlens), sum(seqlens)
    x = rng.randn(total, K).astype(np.float32)
    w = rng.randn(g, N, K).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(seqlens)]).astype(np.int32)
    wg = w.reshape(g, N // 128, 128, KB, 128)
    if dtype == "int8":
        x8, sx = blockwise_int8_quant(jnp.asarray(x))
        sw = np.abs(wg).max(axis=(2, 4)) / 127.0 + 1e-8
        w8 = jnp.asarray(np.clip(np.round(wg / sw[:, :, None, :, None]), -127, 127).reshape(g, N, K),
                         jnp.int8)
    else:
        xg = x.reshape(total, KB, 128)
        sx = jnp.asarray(np.abs(xg).max(-1) / 448.0 + 1e-8)
        x8 = e4m3((xg / np.asarray(sx)[..., None]).reshape(total, K), "zero")
        sw = np.abs(wg).max(axis=(2, 4)) / 448.0 + 1e-8
        w8 = e4m3((wg / sw[:, :, None, :, None]).reshape(g, N, K), "zero")
    w_scale = np.zeros((g, N // 128, (KB + 3) // 4 * 4), np.float32)
    w_scale[:, :, :KB] = sw
    return dict(x=x8, w=w8, sx=sx, sw=jnp.asarray(w_scale), seqlens=jnp.asarray(seqlens, jnp.int32),
                cu=jnp.asarray(cu))


def x_scale(c, layout, pkg):
    if layout == "natural":
        return c["sx"]
    return pkg.reformat_x_scale(c["sx"], c["seqlens"], c["cu"], 32)


def entry(dtype):
    return "group_gemm_blockwise_int8" if dtype == "int8" else "group_gemm_blockwise_fp8"


def run_port(dtype, seqlens, layout, **kw):
    c = bw_case(dtype, seqlens)
    a = {k: to_t(v) for k, v in c.items()}
    sx = to_t(x_scale(c, layout, J))  # JAX's reference layout, carried over
    out = getattr(T, entry(dtype))(a["x"], a["w"], a["seqlens"], a["cu"], sx, a["sw"], 32,
                                   x_scale_layout=layout, **kw)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (sum(seqlens), N)
    return out.float().numpy()


@functools.lru_cache(maxsize=None)
def run_jax(dtype, seqlens, layout, **kw):
    c = bw_case(dtype, seqlens)
    out = getattr(J, entry(dtype))(c["x"], c["w"], c["seqlens"], c["cu"], x_scale(c, layout, J),
                                   c["sw"], 32, x_scale_layout=layout, **kw)
    return np.asarray(out, np.float32)


def tight(got, want, name):
    assert np.abs(want).max() > 10.0  # the case carries signal
    assert_allclose(got, want, atol=1e-3 * float(np.abs(want).max()), rtol=BF16_STEP, name=name)


SCHEMES = [(d, s) for d in ("int8", "e4m3") for s in T.BLOCKWISE_SCHEMES
           if not (d == "e4m3" and s == "int8")]


@pytest.mark.parametrize("seqlens", SEQLENS, ids=str)
@pytest.mark.parametrize("layout", ["natural", "transposed"])
@pytest.mark.parametrize("dtype,scheme", SCHEMES)
def test_group_gemm_blockwise_matches_jax_ref(dtype, scheme, layout, seqlens):
    """Every scheme in both layouts against JAX's float32 oracle (impl="ref")."""
    got = run_port(dtype, seqlens, layout, scheme=scheme)
    tight(got, run_jax(dtype, seqlens, "natural", impl="ref"), f"{dtype} {scheme} {layout}")


@pytest.mark.parametrize("layout", ["natural", "transposed"])
@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_group_gemm_blockwise_impl_ref_matches_jax(dtype, layout):
    """The port's impl="ref" is JAX's oracle: the same float32 function, the
    same transposed-layout row map."""
    seqlens = SEQLENS[0]
    got = run_port(dtype, seqlens, layout, impl="ref")
    tight(got, run_jax(dtype, seqlens, layout, impl="ref"), f"impl=ref {dtype} {layout}")


JAX_KERNELS = [  # (row of the kernel table, dtype, scheme, atol, rtol)
    ("row14", "int8", "scatter", 0.5, 1e-2),
    ("row13", "int8", "prescale", 0.5, 1e-2),
    ("row12", "int8", "int8", 0.05, 1e-2),
    ("row13", "e4m3", "prescale", 0.3, 3e-2),
    ("row12", "e4m3", "fp8", 0.3, 3e-2),
]


@pytest.mark.parametrize("row,dtype,scheme,atol,rtol", JAX_KERNELS,
                         ids=[f"{r}-{d}-{s}" for r, d, s, *_ in JAX_KERNELS])
def test_group_gemm_blockwise_matches_jax_kernels(row, dtype, scheme, atol, rtol):
    """The port (exact promotion) against JAX's kernel for the same scheme, at
    the JAX tests' tolerance for that kernel (module docstring)."""
    del row
    seqlens = SEQLENS[0]
    want = run_jax(dtype, seqlens, "transposed", scheme=scheme)
    got = run_port(dtype, seqlens, "transposed", scheme=scheme)
    assert_allclose(got, want, atol=atol, rtol=rtol, name=f"{dtype} {scheme} vs JAX kernel")


def aligned_layout(c, tm):
    """The scatter form's slots and the same rows copied tile-aligned."""
    seqlens, cu = to_t(c["seqlens"]), to_t(c["cu"])
    total = int(cu[-1])
    grp, row_idx, nvt, _ = T._packed_slots(seqlens, cu, total, tm, "cpu")
    return grp, row_idx, nvt


@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_gg_bw_forms_agree_and_leave_skipped_tiles(dtype):
    """gg_bw_scatter over rows fetched by index and gg_bw_aligned over the same
    rows copied into the aligned layout are one function, bit for bit (the
    kernels' order of sums); zero scales give zero rows (the engine's dummy
    slots), and the aligned form writes no tile past num_valid_tiles."""
    c = bw_case(dtype, SEQLENS[0])
    x, w, sx, sw = (to_t(c[k]) for k in ("x", "w", "sx", "sw"))
    sx[3] = 0.0  # a dummy row: scale 0 (blockwise_int8_quant's scale of a zero row)
    tm = 32
    grp, row_idx, nvt = aligned_layout(c, tm)
    scat = T.gg_bw_scatter(x, w, sx, sw, row_idx, grp, tm, nvt)
    x_al, sx_al = T._take_rows(x, row_idx), T._take_rows(sx, row_idx)
    row_blk = torch.arange(grp.shape[0], dtype=torch.int32)
    al = T.gg_bw_aligned(x_al, w, sx_al, sw, grp, row_blk, tm, nvt)
    real = row_idx >= 0
    assert int(nvt) < grp.shape[0]  # some tiles are skipped
    assert torch.equal(scat[real], al[real])
    assert not al[int(nvt) * tm :].any()  # the plain version leaves skipped tiles 0
    assert not scat[(row_idx == 3)].any()
    # each slot against JAX's oracle over its own row
    want = np.asarray(J.group_gemm_blockwise_ref(c["x"], c["w"], c["seqlens"], c["cu"],
                                                 jnp.asarray(sx.numpy()), c["sw"]), np.float32)
    got = scat[real].float().numpy()
    tight(got, want[row_idx[real].numpy()], f"gg_bw_scatter {dtype}")


@pytest.mark.parametrize("seqlens", SEQLENS, ids=str)
def test_reformat_x_scale_matches_jax(seqlens):
    c = bw_case("int8", seqlens)
    want = np.asarray(J.reformat_x_scale(c["sx"], c["seqlens"], c["cu"], 32))
    got = T.reformat_x_scale(to_t(c["sx"]), to_t(c["seqlens"]), to_t(c["cu"]), 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_blockwise_refuses_what_it_does_not_take():
    c = {k: to_t(v) for k, v in bw_case("int8", SEQLENS[1]).items()}
    f = bw_case("e4m3", SEQLENS[1])
    args = (c["seqlens"], c["cu"], c["sx"], c["sw"], 32)
    with pytest.raises(ValueError, match="int8"):
        T.group_gemm_blockwise_int8(to_t(f["x"]), to_t(f["w"]), *args, x_scale_layout="natural")
    with pytest.raises(ValueError, match="scheme 'int8'"):
        T.group_gemm_blockwise_fp8(to_t(f["x"]), to_t(f["w"]), *args, x_scale_layout="natural",
                                   scheme="int8")
    with pytest.raises(ValueError, match="unknown scheme"):
        T.group_gemm_blockwise_int8(c["x"], c["w"], *args, scheme="wide")
    with pytest.raises(ValueError, match="multiples of 128"):
        T.group_gemm_blockwise_int8(c["x"][:, :320], c["w"][:, :, :320], *args)
    with pytest.raises(ValueError, match="x_scale_layout"):
        T.group_gemm_blockwise_int8(c["x"], c["w"], *args, x_scale_layout="rows")


def test_transposed_layout_at_a_wide_n_keeps_its_m_tile():
    """A reference difference, shown rather than copied: at N = 14336 the
    JAX package's aligned path halves its m-tile (a VMEM cap, 128 -> 64 at
    ``num_seq_per_group_avg`` 100) and then reads ``reformat_x_scale``'s
    layout, laid out at the uncapped tile, with the capped one: its
    transposed-layout result (impl="ref" included) takes other rows' scales.
    The port reads the layout at the tile that wrote it, so both layouts
    give one result."""
    rng = np.random.RandomState(0)
    seqlens, n, k = (150, 60), 14336, 128
    cu = np.concatenate([[0], np.cumsum(seqlens)]).astype(np.int32)
    x8, sx = blockwise_int8_quant(jnp.asarray(rng.randn(sum(seqlens), k), jnp.float32))
    sx = sx * jnp.asarray(rng.rand(sum(seqlens), 1) + 0.5, jnp.float32)  # distinct row scales
    w8 = jnp.asarray(rng.randint(-127, 128, (2, n, k)), jnp.int8)
    sw = jnp.full((2, n // 128, 1), 4e-3, jnp.float32)
    sl, cuj = jnp.asarray(seqlens, jnp.int32), jnp.asarray(cu)
    sx_t = J.reformat_x_scale(sx, sl, cuj, 100)
    outs = {}
    for layout, scales in (("natural", sx), ("transposed", sx_t)):
        outs["jax", layout] = np.asarray(J.group_gemm_blockwise_int8(
            x8, w8, sl, cuj, scales, sw, 100, x_scale_layout=layout, impl="ref"), np.float32)
        outs["port", layout] = T.group_gemm_blockwise_int8(
            to_t(x8), to_t(w8), to_t(sl), to_t(cuj), to_t(scales), to_t(sw), 100, x_scale_layout=layout,
            scheme="prescale").float().numpy()
    big = np.abs(outs["jax", "natural"]).max()
    np.testing.assert_array_equal(outs["port", "natural"], outs["port", "transposed"])
    tight(outs["port", "natural"], outs["jax", "natural"], "port vs JAX natural")
    assert np.abs(outs["jax", "transposed"] - outs["jax", "natural"]).max() > 0.3 * big
