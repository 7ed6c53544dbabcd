"""Parity of the port's W8A8 dense projections (``ModelConfig(dense_int8=True)``:
``quantize_w8``, ``_mm_w8a8``, ``_mm``) against the JAX package.

Inputs are made with numpy from a seed. Both packages divide and round half
to even in float32, so the int8 codes and scales of ``quantize_w8`` are
equal, the int32 sums of the int8 product are exact on both sides, and the
bf16 results of ``_mm_w8a8`` are equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as J
from hpc_ops_tpu_torch.models import llama as T

torch.set_num_threads(1)


def bf16_pair(a: np.ndarray):
    """The same bf16 values in both packages."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def test_quantize_w8_matches_jax():
    rng = np.random.RandomState(0)
    w = (rng.randn(96, 40) / 9.0).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero column keeps the 1e-9 floor of its scale
    jw, tw = bf16_pair(w)
    j8, js = J.quantize_w8(jw)
    t8, ts = T.quantize_w8(tw)
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32 and tuple(ts.shape) == (40,)
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(t8.abs().max()) == 127 and not t8[:, 3].any()
    assert t8.stride() == (1, 96)  # column-major: the int8 product's fast layout


@pytest.mark.parametrize("rows", [1, 8, 40])
def test_int8_product_sums_are_exact(rows):
    """Codes at the extremes, K = 512: sums reach 512 * 127 * 127, far past
    what bf16 or float16 sums could hold exactly."""
    rng = np.random.RandomState(rows)
    x8 = rng.randint(-127, 128, (rows, 512)).astype(np.int8)
    w8 = rng.randint(-127, 128, (512, 24)).astype(np.int8)
    x8[0], w8[:, 0] = 127, 127
    got = T._int8_matmul(torch.from_numpy(x8), torch.from_numpy(w8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x8.astype(np.int64) @ w8.astype(np.int64))


@pytest.mark.parametrize("rows", [1, 8, 33])
def test_mm_w8a8_matches_jax(rows):
    rng = np.random.RandomState(10 + rows)
    jx, tx = bf16_pair(rng.randn(rows, 256).astype(np.float32) * 3.0)
    jw, tw = bf16_pair((rng.randn(256, 72) / 16.0).astype(np.float32))
    j8, js = J.quantize_w8(jw)
    t8, ts = T.quantize_w8(tw)
    want = J._mm_w8a8(jx, j8, js)
    got = T._mm_w8a8(tx, t8, ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # _mm sends an int8 weight to the W8A8 product and a bf16 weight to a plain one
    layer = {"w": t8, "w_scale": ts, "b": tw}
    assert torch.equal(T._mm(tx, layer, "w"), got)
    assert torch.equal(T._mm(tx, layer, "b"), tx @ tw)
    # close to the unquantised product: two quantisation roundings of 1/254 each
    exact = tx.float() @ tw.float()
    assert float((got.float() - exact).abs().max()) < 0.03 * float(exact.abs().max())


def test_init_weights_dense_int8_layout_matches_jax():
    cfg, tcfg = J.tiny_config(dense_int8=True), T.tiny_config(dense_int8=True)
    jw = J.init_weights(jax.random.PRNGKey(0), cfg)
    tw = T.init_weights(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for lj, lt in zip(jw["layers"], tw["layers"]):
        assert set(lj) == set(lt)
        for k in lj:
            assert tuple(lt[k].shape) == lj[k].shape
            assert str(lt[k].dtype).split(".")[-1] == str(lj[k].dtype)
    layer = tw["layers"][0]
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        assert layer[name].dtype == torch.int8 and int(layer[name].abs().max()) == 127
    assert tw["lm_head"].dtype == torch.bfloat16  # the head stays bf16
    # carried-over JAX weights keep their codes and scales
    carried = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    np.testing.assert_array_equal(carried["layers"][1]["w_down"].numpy(),
                                  np.asarray(jw["layers"][1]["w_down"]))
    np.testing.assert_array_equal(carried["layers"][1]["w_down_scale"].numpy(),
                                  np.asarray(jw["layers"][1]["w_down_scale"]))
    assert carried["layers"][1]["w_down"].stride(0) == 1 and layer["w_down"].stride(0) == 1
