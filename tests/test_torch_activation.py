"""Parity of the port's activation + quantisation family against the JAX
package (its Pallas kernel in interpret mode) on numpy-made inputs.

Tolerance: quantised codes are compared as ordinals (adjacent e4m3 codes
differ by 1). Against the JAX package's plain path (``impl="ref"``) they must
be equal, or one code apart on at most 0.5% of the elements: XLA's and
PyTorch's float32 sigmoid may differ in the last place, which can move a
product across a rounding boundary. Against its Pallas kernel in interpret
mode the share may reach 5% with ``use_bf16_mul``, the bound of
tests/test_activation.py: XLA compiles the kernel body with excess precision
(the bf16 rounding of silu is elided), so the JAX kernel differs from the
JAX plain path on 1.6% of this input while the port equals the plain path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import activation as J
from hpc_ops_tpu_torch.models.llama import weights_from_numpy
from hpc_ops_tpu_torch.ops import activation as T

torch.set_num_threads(1)

MAX_SHARE = 5e-3
MAX_SHARE_INTERPRET_BF16_MUL = 5e-2


def ordinals(a) -> np.ndarray:
    """Signed code ordinals of an e4m3 or int8 array (torch or jax)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.int8:
            return a.numpy().astype(np.int32)
        b = a.view(torch.uint8).numpy()
    else:
        a = np.asarray(a)
        if a.dtype == np.int8:
            return a.astype(np.int32)
        b = a.view(np.uint8)
    mag = (b & 0x7F).astype(np.int32)
    return np.where(b & 0x80, -mag, mag)


def assert_codes_close(got, want, name, max_share=MAX_SHARE):
    d = np.abs(ordinals(got) - ordinals(want))
    assert d.max() <= 1, f"{name}: codes up to {d.max()} apart"
    assert (d != 0).mean() <= max_share, f"{name}: {(d != 0).mean():.2%} of codes differ"


def gate_up_case(n, c, seed=0):
    rng = np.random.RandomState(seed)
    gu = jnp.asarray(rng.randn(n, 2 * c) * 2, jnp.bfloat16)
    return gu, weights_from_numpy(np.asarray(gu), device="cpu")


@pytest.mark.parametrize("out", ["fp8", "int8"])
@pytest.mark.parametrize("use_bf16_mul", [True, False])
@pytest.mark.parametrize("num_valid", [None, 40])
def test_act_mul_and_quant_matches_jax(out, use_bf16_mul, num_valid):
    n, c = 70, 256
    gu_j, gu_t = gate_up_case(n, c)
    scale = 1.7 if out == "fp8" else 20.0
    jdt, tdt = (jnp.float8_e4m3fn, torch.float8_e4m3fn) if out == "fp8" else (jnp.int8, torch.int8)
    nv_j = None if num_valid is None else jnp.asarray([num_valid], jnp.int32)
    nv_t = None if num_valid is None else torch.tensor([num_valid], dtype=torch.int32)
    want = J.act_mul_and_quant(gu_j, jnp.asarray([scale], jnp.float32), use_bf16_mul,
                               out_dtype=jdt, num_valid=nv_j)
    got = T.act_mul_and_quant(gu_t, torch.tensor([scale]), use_bf16_mul, out_dtype=tdt,
                              num_valid=nv_t)
    assert got.dtype == tdt and tuple(got.shape) == (n, c)
    rows = slice(0, num_valid)  # rows past num_valid are unspecified
    assert_codes_close(got[rows], np.asarray(want)[rows], "kernel path",
                       MAX_SHARE_INTERPRET_BF16_MUL if use_bf16_mul else MAX_SHARE)
    ref = T.act_mul_and_quant(gu_t, torch.tensor([scale]), use_bf16_mul, out_dtype=tdt, impl="ref")
    want_ref = J.act_mul_and_quant(gu_j, jnp.asarray([scale], jnp.float32), use_bf16_mul,
                                   out_dtype=jdt, impl="ref")
    assert_codes_close(ref, want_ref, "impl=ref")
    assert_codes_close(got[rows], np.asarray(want_ref)[rows], "kernel path against JAX impl=ref")
    assert ordinals(got).max() > 20  # the case reaches well into the code range


def test_act_quant_saturates():
    gu_j, gu_t = gate_up_case(8, 64, seed=1)
    want = J.act_mul_and_quant(gu_j, jnp.asarray([1e4], jnp.float32))
    got = T.act_mul_and_quant(gu_t, torch.tensor([1e4]))
    assert_codes_close(got, want, "saturated")
    assert float(got.float().abs().max()) == 448.0 and torch.isfinite(got.float()).all()


def test_masked_variants_match_jax():
    e, rows, c = 4, 16, 256
    gu_j, gu_t = gate_up_case(e * rows, c, seed=2)
    npe = np.array([3, 16, 0, 7], np.int32)
    want = J.masked_act_mul_and_quant(gu_j, jnp.asarray([1.1], jnp.float32), jnp.asarray(npe))
    got = T.masked_act_mul_and_quant(gu_t, torch.tensor([1.1]), torch.from_numpy(npe))
    assert_codes_close(got, want, "masked")
    keep = np.zeros(e * rows, bool)
    for i, n in enumerate(npe):
        keep[i * rows : i * rows + n] = True
    assert (got.float().numpy()[~keep] == 0).all()

    want_y, want_s = J.masked_act_mul_and_blockwise_quant(gu_j, jnp.asarray(npe))
    got_y, got_s = T.masked_act_mul_and_blockwise_quant(gu_t, torch.from_numpy(npe))
    # the group scales are float32 maxima of float32 products: 1e-5 relative
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-9)
    assert_codes_close(got_y, want_y, "masked blockwise")
    assert (got_y.float().numpy()[~keep] == 0).all()
