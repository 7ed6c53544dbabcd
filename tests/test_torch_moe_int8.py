"""Parity of the port's int8 MoE against the JAX package on numpy-made inputs:
``fuse_moe_pertensor_int8`` fused (interleaved gate-up weight, activation in
the gate-up GEMM's epilogue, aligned down GEMM), unfused and ``impl="ref"``;
``impl="gather"`` over e4m3; and the ``MoEConfig(scheme="pertensor_int8")``
model and engine.

The JAX grouped GEMMs and activation run as Pallas kernels in interpret
mode. A difference of the reference is worked around, not copied: JAX's
``impl="ref"`` reads an interleaved gate-up weight as if it were [gate; up],
so JAX's plain pipeline is fed the plain weight here, while the port's
``impl="ref"`` undoes the interleave itself.

Tolerances, each with its reason (the case of
tests/test_moe.py::test_fuse_moe_int8_fused_act_epilogue, outputs up to
about 0.2):
- against the JAX plain path, 2e-3 abs + 1e-2 rel: both sum int8 products
  exactly (K of 256 and 128 are exact in JAX's float32 products too), round
  the GEMM outputs to bf16 at the same places and quantise the activation
  alike (measured: bit-equal);
- against the JAX kernels, the tolerance of that JAX test: one activation
  code step (1/act_scale) through the largest row sum of |down codes| times
  the largest down scale, times 2.5, plus 5%: XLA compiles the activation
  (fused or not) without the bf16 rounding of ``silu(gate)`` on the CPU and
  moves a few codes by one step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as JL
from hpc_ops_tpu.ops import moe as J
from hpc_ops_tpu.ops.quant import scaled_int8_quant
from hpc_ops_tpu.runtime.engine import Engine as JaxEngine
from hpc_ops_tpu_torch.models import llama as TL
from hpc_ops_tpu_torch.ops import moe as T
from hpc_ops_tpu_torch.runtime.engine import Engine
from hpc_ops_tpu_torch.utils.testing import assert_allclose, assert_greedy_match, top2_margin
from test_torch_moe import ATOL, ATOL_PLAIN, RTOL, RTOL_PLAIN, jax_outputs, moe_case, to_t, torch_args
from test_torch_model import run_prefill_then_decode

torch.set_num_threads(1)

RANK_EP, SIZE_EP = 1, 2  # expert parallelism: the second of two ranks


@functools.lru_cache(maxsize=None)
def int8_case():
    """tests/test_moe.py::test_fuse_moe_int8_fused_act_epilogue's inputs, cut
    to the local experts of rank 1 of 2: (arguments without the gate-up
    weight, the plain [gate; up] weight, the kernel-path tolerance)."""
    rng = np.random.RandomState(7)
    s, h, i, e, k = 96, 256, 128, 8, 2
    xf = jnp.asarray(rng.randn(s, h), jnp.float32) * 0.3
    gu = jnp.asarray(rng.randn(e, 2 * i, h), jnp.float32) * 0.05
    dw = jnp.asarray(rng.randn(e, h, i), jnp.float32) * 0.05
    topk_ids = jnp.asarray(rng.randint(0, e, (s, k)), jnp.int32)
    topk_scale = jnp.asarray(rng.rand(s, k), jnp.float32)
    x8, xs = scaled_int8_quant(xf)
    gu8, gus = zip(*(scaled_int8_quant(gu[j]) for j in range(e)))
    dw8, dws = zip(*(scaled_int8_quant(dw[j]) for j in range(e)))
    gu8, dw8 = jnp.stack(gu8), jnp.stack(dw8)
    gus, dws = jnp.concatenate(gus), jnp.concatenate(dws)
    act_scale = jnp.asarray([127.0 / 0.2], jnp.float32)
    local = slice(RANK_EP * e // SIZE_EP, (RANK_EP + 1) * e // SIZE_EP)
    args = dict(x=x8, dw=dw8[local], gs=xs.reshape(()) * gus[local],
                ds=dws[local] / act_scale.reshape(()), act=act_scale, ids=topk_ids, ts=topk_scale)
    tol = 2.5 * float(np.abs(np.asarray(dw8)).sum(axis=1).max()) / float(act_scale[0]) * float(dws.max())
    return args, gu8[local], e, tol


def call(fn, a, gate_up, e_total, to=lambda v: v, rank_ep=RANK_EP, **kw):
    return fn(to(a["x"]), to(gate_up), to(a["dw"]), to(a["gs"]), to(a["ds"]), to(a["act"]),
              to(a["ids"]), to(a["ts"]), rank_ep, e_total, **kw)


@functools.lru_cache(maxsize=None)
def jax_int8_outputs():
    """JAX's fused and unfused kernel paths and its plain path (fed the plain weight)."""
    a, gu8, e_total, _ = int8_case()
    run = functools.partial(call, J.fuse_moe_pertensor_int8, a, e_total=e_total)
    return {
        "fused": np.asarray(run(J.interleave_gate_up(gu8), gate_up_interleaved=True), np.float32),
        "unfused": np.asarray(run(gu8), np.float32),
        "ref": np.asarray(run(gu8, impl="ref"), np.float32),
    }


@pytest.mark.parametrize("path", ["fused", "unfused", "ref"])
def test_fuse_moe_pertensor_int8_matches_jax(path):
    a, gu8, e_total, tol = int8_case()
    gate_up = J.interleave_gate_up(gu8) if path in ("fused", "ref") else gu8
    kw = {"gate_up_interleaved": path != "unfused", "impl": "ref" if path == "ref" else "auto"}
    got = call(T.fuse_moe_pertensor_int8, a, gate_up, e_total, to_t, **kw)
    want = jax_int8_outputs()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want["ref"].shape
    assert np.abs(want["ref"]).max() > 0.05  # the case carries signal
    got = got.float().numpy()
    assert_allclose(got, want["ref"], atol=ATOL_PLAIN, rtol=RTOL_PLAIN, name=f"{path} vs JAX ref")
    if path != "ref":
        assert_allclose(got, want[path], atol=tol, rtol=0.05, name=f"{path} vs JAX kernels")


def test_interleaved_weights_and_the_reference_difference():
    """An intermediate of 512: two interleave blocks, so the shuffle moves
    rows (at tests/test_moe.py's intermediate of 128 it is the identity).
    JAX's impl="ref" reads the shuffled rows as [gate; up] and returns
    another function; the port's impl="ref" undoes the shuffle, and both
    port paths equal JAX's plain path fed the plain weight (tolerance as
    above)."""
    rng = np.random.RandomState(12)
    s, h, i, e, k = 32, 256, 512, 4, 2
    x8, xs = scaled_int8_quant(jnp.asarray(rng.randn(s, h), jnp.float32) * 0.3)
    gu8, gus = zip(*(scaled_int8_quant(jnp.asarray(rng.randn(2 * i, h), jnp.float32)) for _ in range(e)))
    dw8, dws = zip(*(scaled_int8_quant(jnp.asarray(rng.randn(h, i), jnp.float32)) for _ in range(e)))
    act = jnp.asarray([127.0 / 0.2], jnp.float32)
    a = dict(x=x8, dw=jnp.stack(dw8), gs=xs.reshape(()) * jnp.concatenate(gus) / 16,
             ds=jnp.concatenate(dws) / act.reshape(()) / 22.6, act=act,
             ids=jnp.asarray(rng.randint(0, e, (s, k)), jnp.int32),
             ts=jnp.asarray(rng.rand(s, k), jnp.float32))
    gu8 = jnp.stack(gu8)
    il = J.interleave_gate_up(gu8)
    assert not np.array_equal(np.asarray(il), np.asarray(gu8))
    run = functools.partial(call, e_total=e, rank_ep=0)
    want = np.asarray(run(J.fuse_moe_pertensor_int8, a, gu8, impl="ref"), np.float32)
    jax_il = np.asarray(run(J.fuse_moe_pertensor_int8, a, il, gate_up_interleaved=True, impl="ref"),
                        np.float32)
    got = {impl: run(T.fuse_moe_pertensor_int8, a, il, to=to_t, gate_up_interleaved=True,
                     impl=impl).float().numpy() for impl in ("auto", "ref")}
    assert np.abs(want).max() > 0.05
    for impl, g in got.items():
        assert_allclose(g, want, atol=ATOL_PLAIN, rtol=RTOL_PLAIN, name=f"port {impl} vs JAX ref")
    assert np.abs(jax_il - want).max() > 0.2 * np.abs(want).max()  # the reference difference


def test_fuse_moe_int8_refuses_what_it_does_not_take():
    a, gu8, e_total, _ = int8_case()
    il = J.interleave_gate_up(gu8)
    with pytest.raises(ValueError, match="interleaved"):
        call(T.fuse_moe_pertensor_int8, a, il, e_total, to_t, gate_up_interleaved=True, impl="gather")
    arrays, _, e8 = moe_case(0, 1, False)
    args = (*torch_args(arrays, None)[0], 0, e8)
    with pytest.raises(ValueError, match="int8"):
        T.fuse_moe_pertensor_int8(*args)
    with pytest.raises(ValueError, match="int8 weights"):
        T.fuse_moe_pertensor_fp8(*args, gate_up_interleaved=True)


def test_fuse_moe_pertensor_fp8_gather_matches_jax():
    """impl="gather" over e4m3: an expert-grouped copy of the tokens and the
    aligned grouped GEMM, against the JAX plain path and JAX's gather
    kernels at tests/test_torch_moe.py's tolerances (the same activation
    kernel's excess precision, no subnormal codes)."""
    arrays, _, e_total = moe_case(1, 4, False)
    got = T.fuse_moe_pertensor_fp8(*torch_args(arrays, None)[0], 1, e_total, impl="gather")
    a = arrays
    want = np.asarray(J.fuse_moe_pertensor_fp8(a["x"], a["gw"], a["dw"], a["gs"], a["ds"], a["act"],
                                               a["ids"], a["ts"], 1, e_total, impl="gather"),
                      np.float32)
    ref = jax_outputs(1, 4, False)["ref"]
    got = got.float().numpy()
    assert np.abs(ref).max() > 1.0
    assert_allclose(got, ref, atol=ATOL_PLAIN, rtol=RTOL_PLAIN, name="gather vs JAX ref")
    assert_allclose(got, want, atol=ATOL, rtol=RTOL, name="gather vs JAX gather kernels")


def int8_config(pkg):
    cfg = pkg.tiny_config(moe=True)
    return cfg._replace(moe=cfg.moe._replace(scheme="pertensor_int8"))


@pytest.fixture(scope="module")
def model_int8():
    """tiny_config(moe=True) with scheme="pertensor_int8", JAX's PRNGKey(0)
    weights carried over."""
    cfg = int8_config(JL)
    jw = JL.init_weights(jax.random.PRNGKey(0), cfg)
    tw = TL.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    return cfg, jw, int8_config(TL), tw


def test_int8_moe_weights_carry_over_and_init_layout(model_int8):
    """The int8 experts arrive bit for bit and row-major; the port's own
    init has the JAX layout, per-expert scales and interleaved codes drawn
    from the same float32 masters as the fp8 scheme's."""
    cfg, jw, tcfg, tw = model_int8
    lj, lt = jw["layers"][1], tw["layers"][1]
    for name in ("moe_gate_up", "moe_down"):
        assert lt[name].dtype == torch.int8 and lt[name].is_contiguous()
        np.testing.assert_array_equal(lt[name].numpy(), np.asarray(lj[name]))
    own = TL.init_weights(tcfg, torch.Generator().manual_seed(0), device="cpu")
    fp8 = TL.init_weights(TL.tiny_config(moe=True), torch.Generator().manual_seed(0), device="cpu")
    for lo, lj in zip(own["layers"], jw["layers"]):
        assert set(lo) == set(lj)
        for k in lj:
            assert tuple(lo[k].shape) == lj[k].shape
            assert str(lo[k].dtype).split(".")[-1] == str(lj[k].dtype)
    first, f8 = own["layers"][0], fp8["layers"][0]
    assert torch.equal(first["moe_act_scale"], torch.tensor([127.0 / cfg.moe.act_clip]))
    assert int(first["moe_down"].abs().amax(dim=(1, 2)).min()) == 127  # each expert's amax
    plain = T._deinterleave_gate_up(first["moe_gate_up"]).float()
    deq = plain * first["moe_gate_up_scale"][:, None, None]
    ref = f8["moe_gate_up"].float() * f8["moe_gate_up_scale"][:, None, None]
    assert float((deq - ref).abs().max()) < 0.1 * float(ref.abs().max())  # one master, two codes
    assert torch.equal(first["wqkv"], f8["wqkv"]) and torch.equal(first["router"], f8["router"])


def test_forward_step_moe_int8_matches_jax(model_int8):
    """Prefill then decode on JAX's weights: logits within 0.15 abs / 0.1
    rel, the tolerance of the fp8 MoE's model test (JAX's fused activation
    moves a few codes by one step; see the module docstring)."""
    cfg, jw, tcfg, tw = model_int8
    jp, jd = run_prefill_then_decode(JL, cfg, jw, jnp.asarray)
    tp, td = run_prefill_then_decode(TL, tcfg, tw, torch.from_numpy)
    assert torch.isfinite(tp.float()).all() and torch.isfinite(td.float()).all()
    assert_allclose(tp.float(), np.asarray(jp, np.float32), atol=0.15, rtol=0.1, name="prefill logits")
    assert_allclose(td.float(), np.asarray(jd, np.float32), atol=0.15, rtol=0.1, name="decode logits")


def test_forward_step_moe_int8_tracks_fp8():
    """The port of tests/test_model.py::test_moe_model_pertensor_int8: one
    seed gives the fp8 and the int8 model the same float32 masters, and the
    int8 model's prefill and decode logits stay within cosine 0.97 of the
    fp8 model's."""
    outs = {}
    for name, cfg in (("fp8", TL.tiny_config(moe=True)), ("int8", int8_config(TL))):
        w = TL.init_weights(cfg, torch.Generator().manual_seed(4), device="cpu")
        outs[name] = [t.float() for t in run_prefill_then_decode(TL, cfg, w, torch.from_numpy)]
    for a, ref in zip(outs["int8"], outs["fp8"]):
        assert torch.isfinite(a).all()
        cos = torch.nn.functional.cosine_similarity(a, ref, dim=-1)
        assert float(cos.min()) > 0.97, f"cosine {cos.tolist()}"


def test_engine_moe_int8_matches_jax_engine(model_int8):
    """int8 MoE serving: the engine's greedy tokens equal the JAX engine's on
    the same weights (a flip is accepted only at a bf16 near-tie of JAX's
    logits, below the 0.15 tolerance, and ends the comparison)."""
    cfg, jw, tcfg, tw = model_int8
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11]]
    want = JaxEngine(cfg, jw, num_blocks=64, block_size=16, max_batch=4).run(prompts, max_new=3)
    got = Engine(tcfg, tw, num_blocks=64, block_size=16, max_batch=4, device="cpu").run(
        prompts, max_new=3)

    def margin(tokens):
        n = len(tokens)
        caches = JL.init_cache(cfg, num_blocks=8, block_size=16)
        logits, _ = JL.forward_step(
            jw, caches, cfg, jnp.asarray(tokens, jnp.int32), jnp.asarray([n], jnp.int32),
            jnp.asarray([0, n], jnp.int32), jnp.asarray([list(range(8))], jnp.int32),
            is_prefill=True, max_seqlens_q=n)
        return top2_margin(np.asarray(logits, np.float32))

    for p, w, g in zip(prompts, want, got):
        assert_greedy_match(w, g, lambda j, p=p, w=w: margin(p + w[:j]), 0.15)
    assert all(len(g) == 3 for g in got)
