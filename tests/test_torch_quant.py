"""Parity of the port's quantization helpers and fused-page packing against
the JAX package.

Inputs are made with numpy from a seed and fed to both packages. Codes must
be bit-equal (int8 and float8_e4m3fn bytes); scales within one float32 ulp
(rtol 2**-23, for a max taken in another order); dequantised values within
the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.ops import quant as J
from hpc_ops_tpu.ops.attention import paging as JP
from hpc_ops_tpu.utils.common import fp8_saturate_cast as jax_fp8_cast
from hpc_ops_tpu_torch.ops import quant as T
from hpc_ops_tpu_torch.ops.attention import paging as TP
from hpc_ops_tpu_torch.utils.common import fp8_saturate_cast
from hpc_ops_tpu_torch.utils.testing import assert_allclose

torch.set_num_threads(1)

F32_ULP = 2.0**-23


def x_case(seed, *shape, scale=3.0):
    """float32 numpy data with ties at half a code and values past the fp8 range."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * scale).astype(np.float32)
    x.reshape(-1)[:8] = [0.5, -1.5, 2.5, 1000.0, -1000.0, 0.0, 448.0, -0.0]
    return x


def codes(a):
    """Bytes of an int8 / fp8 array or tensor, for bit-equality."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy() if a.dtype != torch.int8 else a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def test_fp8_saturate_cast_matches_jax():
    x = x_case(0, 64, 96, scale=200.0)
    np.testing.assert_array_equal(codes(fp8_saturate_cast(torch.from_numpy(x))),
                                  codes(jax_fp8_cast(jnp.asarray(x))))


@pytest.mark.parametrize("given_scale", [False, True])
@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_scaled_quant_matches_jax(kind, given_scale):
    x = x_case(1, 33, 128)
    scale = np.array([0.05], np.float32) if given_scale else None
    jf, tf = (J.scaled_fp8_quant, T.scaled_fp8_quant) if kind == "fp8" else (
        J.scaled_int8_quant, T.scaled_int8_quant)
    jy, js = jf(jnp.asarray(x), None if scale is None else jnp.asarray(scale))
    ty, ts = tf(torch.from_numpy(x), None if scale is None else torch.from_numpy(scale))
    assert ty.dtype == (torch.float8_e4m3fn if kind == "fp8" else torch.int8)
    assert_allclose(ts, np.asarray(js), atol=0, rtol=F32_ULP, name="scale")
    np.testing.assert_array_equal(codes(ty), codes(jy))
    jd = J.fp8_dequant(jy, js, jnp.float32)
    td = T.fp8_dequant(ty, ts, torch.float32)
    assert_allclose(td, np.asarray(jd), atol=0, rtol=F32_ULP, name="dequant")


@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_blockwise_quant_matches_jax(kind):
    x = x_case(2, 5, 3, 256)
    jf, tf = (J.blockwise_fp8_quant, T.blockwise_fp8_quant) if kind == "fp8" else (
        J.blockwise_int8_quant, T.blockwise_int8_quant)
    jy, js = jf(jnp.asarray(x))
    ty, ts = tf(torch.from_numpy(x))
    assert tuple(ts.shape) == js.shape == (5, 3, 2)
    assert_allclose(ts, np.asarray(js), atol=0, rtol=F32_ULP, name="scales")
    np.testing.assert_array_equal(codes(ty), codes(jy))
    if kind == "fp8":
        want = np.asarray(J.blockwise_fp8_dequant(jy, js))
        assert_allclose(T.blockwise_fp8_dequant(ty, ts), want, atol=0, rtol=F32_ULP, name="deq")


def test_per_token_per_head_fp8_quant_matches_jax():
    x = x_case(3, 6, 4, 128)
    x[1, 2] = 0.0  # an all-zero head takes the 1e-12 floor
    jy, js = J.per_token_per_head_fp8_quant(jnp.asarray(x))
    ty, ts = T.per_token_per_head_fp8_quant(torch.from_numpy(x))
    assert_allclose(ts, np.asarray(js), atol=0, rtol=F32_ULP, name="scales")
    np.testing.assert_array_equal(codes(ty), codes(jy))


def test_quantize_kv_fused_int8_matches_jax():
    rng = np.random.RandomState(4)
    k = rng.randn(2, 5, 16, 128).astype(np.float32)
    v = rng.randn(2, 5, 16, 128).astype(np.float32)
    kb, vb = torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16)
    jk, jv = jnp.asarray(kb.float().numpy(), jnp.bfloat16), jnp.asarray(vb.float().numpy(), jnp.bfloat16)
    for ks in (None, np.array([0.02], np.float32)):
        jkv, jks, jvs = J.quantize_kv_fused_int8(jk, jv, *(() if ks is None else (jnp.asarray(ks),) * 2))
        tkv, tks, tvs = T.quantize_kv_fused_int8(kb, vb, *(() if ks is None else (torch.from_numpy(ks),) * 2))
        assert tuple(tkv.shape) == jkv.shape == (2, 5, 32, 128)
        np.testing.assert_array_equal(codes(tkv), codes(jkv))
        assert_allclose(torch.cat([tks, tvs]), np.concatenate([jks, jvs]), atol=0, rtol=F32_ULP,
                        name="scales")


def test_fused_packing_matches_jax():
    rng = np.random.RandomState(5)
    k = rng.randint(-127, 128, (3, 4, 16, 64)).astype(np.int8)
    v = rng.randint(-127, 128, (3, 4, 16, 64)).astype(np.int8)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    fused = TP.pack_kv_fused(tk, tv)
    np.testing.assert_array_equal(fused.numpy(), np.asarray(JP.pack_kv_fused(k, v)))
    nhd = TP.pack_kv_fused_nhd(tk, tv)
    np.testing.assert_array_equal(nhd.numpy(), np.asarray(JP.pack_kv_fused_nhd(k, v)))
    for got, want in ((TP.unpack_kv_fused(fused), JP.unpack_kv_fused(np.asarray(fused))),
                      (TP.unpack_kv_fused_nhd(nhd, 3), JP.unpack_kv_fused_nhd(np.asarray(nhd), 3))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kn, vn = TP.nhd_fused_views(nhd, 3)
    np.testing.assert_array_equal(kn.numpy(), TP.hnd_to_nhd(tk).numpy())
    np.testing.assert_array_equal(vn.numpy(), TP.hnd_to_nhd(tv).numpy())
    assert kn.data_ptr() == nhd.data_ptr()  # a view, no copy
