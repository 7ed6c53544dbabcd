"""Parity of the port's blockwise MoE against the JAX package on numpy-made
inputs: ``fuse_moe_blockwise_fp8`` / ``_int8`` (the scatter pipeline and the
aligned-row schemes, expert-parallel rank 1 of 2), the stage between the two
GEMMs, ``_gather_scale_aligned``, and the ``MoEConfig(scheme="blockwise_int8")``
model and engine.

Tolerances of a whole MoE output, each with its reason (the cases of
tests/test_moe.py::test_fuse_moe_blockwise_{fp8,int8}, outputs up to about
0.5): the JAX tests' own, 0.03 abs + 0.05 rel over int8 and 0.05 + 0.08 over
e4m3, against their float32 oracle over the dequantised operands and against
JAX's kernels. A whole output cannot be held tighter: the activation is
re-quantised per (row, 128-group) between the GEMMs, so a gate-up output one
bf16 step apart (the packages sum in other orders; JAX's scatter and
prescale kernels round pre-scaled operands to bf16) can move a group's
maximum and with it every code of the group. The stage between the GEMMs is
held on its own: over the same bf16 gate-up output, the codes are at most
one step apart.

The model and engine tests run JAX's model with its MoE computed by
``dense_blockwise_moe`` below: ``fuse_moe_blockwise_int8``'s function over
every (token, local expert), written with jnp and JAX's
``blockwise_int8_quant``, promoting each 128-group as JAX's
``group_gemm_blockwise_ref`` does. JAX's own path runs the row-gather kernel
in interpret mode, one DMA per row (about a minute for a prefill and a
decode of the tiny model here); the op tests below hold the port against
JAX's kernels instead.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as JL
from hpc_ops_tpu.ops import moe as J
from hpc_ops_tpu.ops.quant import blockwise_fp8_quant, blockwise_int8_quant
from hpc_ops_tpu.runtime.engine import Engine as JaxEngine
from hpc_ops_tpu_torch.models import llama as TL
from hpc_ops_tpu_torch.ops import moe as T
from hpc_ops_tpu_torch.ops.quant import blockwise_fp8_quant as t_fp8_quant
from hpc_ops_tpu_torch.ops.quant import blockwise_int8_quant as t_int8_quant
from hpc_ops_tpu_torch.runtime.engine import Engine
from hpc_ops_tpu_torch.utils.testing import assert_allclose, assert_greedy_match, top2_margin
from test_torch_group_gemm import e4m3
from test_torch_group_gemm_bw import to_t
from test_torch_model import run_prefill_then_decode

torch.set_num_threads(1)

RANK_EP, SIZE_EP = 1, 2  # expert parallelism: the second of two ranks
S, TOPK, H, I, E = 16, 2, 256, 256, 4  # tests/test_moe.py's blockwise cases
TOL = {"int8": (0.03, 0.05), "e4m3": (0.05, 0.08)}


def silu(a):
    return a / (1.0 + np.exp(-a))


@functools.lru_cache(maxsize=None)
def moe_case(dtype: str):
    """tests/test_moe.py's inputs (int8: seed 5, e4m3: seed 3, subnormal
    codes zeroed), a shared output, and the float32 oracle of rank 1 of 2
    over the dequantised operands."""
    rng = np.random.RandomState(5 if dtype == "int8" else 3)
    ids = rng.randint(0, E, (S, TOPK)).astype(np.int32)
    x = (rng.randn(S, H) / 10).astype(np.float32)
    top = 127.0 if dtype == "int8" else 448.0

    def quant_w(wm):
        e_, n_, k_ = wm.shape
        wg = wm.reshape(e_, n_ // 128, 128, k_ // 128, 128)
        sw = np.abs(wg).max(axis=(2, 4)) / top + 1e-8
        q = wg / sw[:, :, None, :, None]
        if dtype == "int8":
            return jnp.asarray(np.clip(np.round(q), -127, 127).reshape(wm.shape), jnp.int8), sw
        return e4m3(q.reshape(wm.shape), "zero"), sw

    if dtype == "int8":
        x8, sx = blockwise_int8_quant(jnp.asarray(x))
    else:
        xg = x.reshape(S, H // 128, 128)
        sx = jnp.asarray(np.abs(xg).max(-1) / 448.0 + 1e-8)
        x8 = e4m3((xg / np.asarray(sx)[..., None]).reshape(S, H), "zero")
    gw8, sgw = quant_w((rng.randn(E, 2 * I, H) / np.sqrt(H)).astype(np.float32))
    dw8, sdw = quant_w((rng.randn(E, H, I) / np.sqrt(I)).astype(np.float32))
    ts = (rng.rand(S, TOPK) / TOPK).astype(np.float32)
    shared = jnp.asarray(rng.randn(S, H) / 20, jnp.bfloat16)

    def deq(q, s):
        e_, n_, k_ = q.shape
        blocks = np.asarray(q, np.float32).reshape(e_, n_ // 128, 128, k_ // 128, 128)
        return (blocks * s[:, :, None, :, None]).reshape(q.shape)

    xd = (np.asarray(x8, np.float32).reshape(S, H // 128, 128) * np.asarray(sx)[..., None]).reshape(S, H)
    gwd, dwd = deq(gw8, sgw), deq(dw8, sdw)
    want = np.asarray(shared, np.float32).copy()
    local = slice(RANK_EP * E // SIZE_EP, (RANK_EP + 1) * E // SIZE_EP)
    for si in range(S):
        for ki in range(TOPK):
            el = int(ids[si, ki])
            if local.start <= el < local.stop:
                gu = xd[si] @ gwd[el].T
                want[si] += (silu(gu[:I]) * gu[I:]) @ dwd[el].T * ts[si, ki]
    args = (x8, sx, gw8[local], jnp.asarray(sgw[local]), dw8[local], jnp.asarray(sdw[local]),
            jnp.asarray(ids), jnp.asarray(ts), RANK_EP, E)
    return args, shared, want


@functools.lru_cache(maxsize=None)
def jax_moe(dtype, scheme):
    args, shared, _ = moe_case(dtype)
    fn = J.fuse_moe_blockwise_int8 if dtype == "int8" else J.fuse_moe_blockwise_fp8
    return np.asarray(fn(*args, shared, scheme=scheme), np.float32)


CASES = [("int8", "scatter", "int8"), ("int8", "prescale", "prescale"), ("int8", "int8", "int8"),
         ("e4m3", "scatter", "fp8"), ("e4m3", "prescale", "prescale"), ("e4m3", "fp8", "fp8")]


@pytest.mark.parametrize("dtype,scheme,jax_scheme", CASES, ids=[f"{d}-{s}" for d, s, _ in CASES])
def test_fuse_moe_blockwise_matches_jax(dtype, scheme, jax_scheme):
    """Each scheme on rank 1 of 2 with a shared output, against the float32
    oracle and against JAX's kernels (the exact-promotion scheme for the
    port's scatter pipeline: the port promotes exactly in every scheme), at
    the JAX tests' tolerance (module docstring)."""
    args, shared, want = moe_case(dtype)
    fn = T.fuse_moe_blockwise_int8 if dtype == "int8" else T.fuse_moe_blockwise_fp8
    got = fn(*(to_t(a) if not isinstance(a, int) else a for a in args), to_t(shared), scheme=scheme)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (S, H)
    got = got.float().numpy()
    assert np.abs(want).max() > 0.1  # the case carries signal beyond the shared output
    atol, rtol = TOL[dtype]
    assert_allclose(got, want, atol=atol, rtol=rtol, name=f"{dtype} {scheme} vs float32 oracle")
    assert_allclose(got, jax_moe(dtype, jax_scheme), atol=atol, rtol=rtol,
                    name=f"{dtype} {scheme} vs JAX {jax_scheme} kernels")


def test_fuse_moe_blockwise_alias_and_refusals():
    args, shared, _ = moe_case("e4m3")
    targs = [to_t(a) if not isinstance(a, int) else a for a in args]
    assert torch.equal(T.fuse_moe_blockwise(*targs), T.fuse_moe_blockwise_fp8(*targs))
    with pytest.raises(ValueError, match="int8"):
        T.fuse_moe_blockwise_int8(*targs)
    with pytest.raises(ValueError, match="unknown scheme"):
        T.fuse_moe_blockwise_fp8(*targs, scheme="wide")
    with pytest.raises(ValueError, match="scheme 'int8'"):
        T.fuse_moe_blockwise_fp8(*targs, scheme="int8")
    i8 = [to_t(a) if not isinstance(a, int) else a for a in moe_case("int8")[0]]
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        T.fuse_moe_blockwise_fp8(*i8)


@pytest.mark.parametrize("dtype", ["int8", "e4m3"])
def test_act_requant_matches_jax(dtype):
    """The stage between the GEMMs on the same bf16 gate-up output: JAX's
    silu(gate) * up in float32 then its blockwise quantisation, against the
    port's. Scales within one float32 rounding, codes at most one step apart
    (jax.nn.sigmoid and torch.sigmoid may round one ulp apart), on under 1%
    of them."""
    rng = np.random.RandomState(1)
    gu = jnp.asarray(rng.randn(96, 2 * I) * 3, jnp.bfloat16)
    gate, up = gu[:, :I].astype(jnp.float32), gu[:, I:].astype(jnp.float32)
    jq = blockwise_int8_quant if dtype == "int8" else blockwise_fp8_quant
    want_codes, want_scale = jq(gate * jax.nn.sigmoid(gate) * up)
    codes, scale = T._act_requant(to_t(gu), t_int8_quant if dtype == "int8" else t_fp8_quant)
    assert_allclose(scale.numpy(), np.asarray(want_scale) + 1e-8, atol=0, rtol=2**-23, name="scales")
    if dtype == "int8":
        a, b = codes.numpy().astype(np.int32), np.asarray(want_codes).astype(np.int32)
    else:  # e4m3 codes as signed ordinals: neighbours one apart
        def ordinal(c):
            bits = np.asarray(c).view(np.uint8).astype(np.int32)
            return np.where(bits >= 128, -(bits & 0x7F), bits & 0x7F)
        a, b = ordinal(codes.view(torch.uint8).numpy()), ordinal(want_codes)
    assert np.abs(a - b).max() <= 1 and np.mean(a != b) < 0.01


def test_gather_scale_aligned_matches_jax():
    """The aligned-row schemes' x scales land on the rows of their tokens
    (rank 1 of 2: off-rank pairs dropped)."""
    args, _, _ = moe_case("int8")
    sx, ids = args[1], args[6]
    e_local, tm = E // SIZE_EP, J._pick_tm(32)
    jg = J._gather_aligned(args[0], ids, e_local, RANK_EP, tm)
    want = J._gather_scale_aligned(sx, ids, e_local, RANK_EP, tm, jg)
    tg = T._gather_aligned(to_t(args[0]), to_t(ids), e_local, RANK_EP, tm)
    got = T._gather_scale_aligned(to_t(sx), tg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- the model


def _dense_gemm(xq, sxq, w, sw):
    """[E, S, K] codes with [E, S, K/128] scales against [E, N, K] codes with
    [E, N/128, >= K/128] block scales: each 128-group's partial sum times its
    two scales, summed over the groups (group_gemm_blockwise_ref's sum)."""
    e, n, k = w.shape
    kb = k // 128
    xf = xq.astype(jnp.float32).reshape(*xq.shape[:-1], kb, 128)
    wf = w.astype(jnp.float32).reshape(e, n, kb, 128)
    part = jnp.einsum("eskd,enkd->esnk", xf, wf, precision=jax.lax.Precision.HIGHEST)
    swe = jnp.repeat(sw[:, :, :kb].astype(jnp.float32), 128, axis=1)  # [E, N, kb]
    return jnp.sum(part * sxq[:, :, None, :] * swe[:, None], axis=-1).astype(jnp.bfloat16)


def dense_blockwise_moe(x, x_scale, gw, gsw, dw, dsw, topk_ids, topk_scale, rank_ep,
                        num_expert_total, shared_output=None, **kw):
    """fuse_moe_blockwise_int8's function over every (token, local expert),
    jnp only (it traces under the JAX engine's jit)."""
    del num_expert_total, kw
    e = gw.shape[0]
    s = x.shape[0]
    gu = _dense_gemm(jnp.broadcast_to(x, (e, *x.shape)), jnp.broadcast_to(x_scale, (e, *x_scale.shape)),
                     gw, gsw)
    interm = gu.shape[-1] // 2
    gate, up = gu[..., :interm].astype(jnp.float32), gu[..., interm:].astype(jnp.float32)
    d8, dsx = blockwise_int8_quant(gate * jax.nn.sigmoid(gate) * up)
    down = _dense_gemm(d8, dsx + 1e-8, dw, dsw)  # [E, S, H]
    local = topk_ids - rank_ep * e
    kept = (local >= 0) & (local < e)
    rows = down[jnp.clip(local, 0, e - 1), jnp.arange(s)[:, None]].astype(jnp.float32)  # [S, K, H]
    out = jnp.sum(jnp.where(kept[..., None], rows * topk_scale[..., None], 0.0), axis=1)
    if shared_output is not None:
        out = out + shared_output.astype(jnp.float32)
    return out.astype(jnp.bfloat16)


def bw_config(pkg):
    cfg = pkg.tiny_config(moe=True)
    return cfg._replace(moe=cfg.moe._replace(scheme="blockwise_int8"))


@pytest.fixture(scope="module")
def model_bw():
    """tiny_config(moe=True) with scheme="blockwise_int8", JAX's PRNGKey(0)
    weights carried over."""
    cfg = bw_config(JL)
    jw = JL.init_weights(jax.random.PRNGKey(0), cfg)
    tw = TL.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    return cfg, jw, bw_config(TL), tw


@pytest.fixture
def jax_dense_moe(monkeypatch):
    # JAX's _mlp_moe imports fuse_moe_blockwise_int8 from ops.moe at each call
    monkeypatch.setattr(J, "fuse_moe_blockwise_int8", dense_blockwise_moe)


def test_blockwise_weights_carry_over_and_init_layout(model_bw):
    """The int8 experts and their [E, N/128, K/128] block scales arrive bit for
    bit and row-major; the port's own init has the JAX layout, every block's
    largest code at 127, and draws the float32 masters of the fp8 scheme."""
    cfg, jw, tcfg, tw = model_bw
    lj, lt = jw["layers"][1], tw["layers"][1]
    for name in ("moe_gate_up", "moe_down", "moe_gate_up_scale", "moe_down_scale"):
        assert lt[name].is_contiguous()
        np.testing.assert_array_equal(lt[name].numpy(), np.asarray(lj[name]))
    own = TL.init_weights(tcfg, torch.Generator().manual_seed(0), device="cpu")
    fp8 = TL.init_weights(TL.tiny_config(moe=True), torch.Generator().manual_seed(0), device="cpu")
    for lo, lj in zip(own["layers"], jw["layers"]):
        assert set(lo) == set(lj)
        for k in lj:
            assert tuple(lo[k].shape) == lj[k].shape
            assert str(lo[k].dtype).split(".")[-1] == str(lj[k].dtype)
    first, f8 = own["layers"][0], fp8["layers"][0]
    codes, scale = first["moe_gate_up"], first["moe_gate_up_scale"]
    e, n, k = codes.shape
    blocks = codes.view(e, n // 128, 128, k // 128, 128).float()
    assert torch.equal(blocks.abs().amax(dim=(2, 4)), torch.full(scale.shape, 127.0))
    deq = (blocks * scale[:, :, None, :, None]).reshape(e, n, k)
    ref = f8["moe_gate_up"].float() * f8["moe_gate_up_scale"][:, None, None]
    assert float((deq - ref).abs().max()) < 0.1 * float(ref.abs().max())  # one master, two codes


def prefill_logits(pkg, cfg, weights, to, **kw):
    """Logits of a prefill of 7 and 5 tokens for two requests."""
    caches = pkg.init_cache(cfg, num_blocks=8, block_size=16, **kw)
    i32 = lambda a: to(np.asarray(a, np.int32))  # noqa: E731
    logits, _ = pkg.forward_step(weights, caches, cfg, i32(np.arange(12) % cfg.vocab), i32([7, 5]),
                                 i32([0, 7, 12]), i32([[0, 1, -1], [2, 3, -1]]), is_prefill=True,
                                 max_seqlens_q=8)
    return logits


def test_forward_step_blockwise_int8_matches_jax(model_bw, jax_dense_moe):
    """A prefill on JAX's weights: logits within 0.15 abs / 0.1 rel, the
    tolerance of the fp8 MoE's model test (the decode steps are held against
    JAX's engine below)."""
    cfg, jw, tcfg, tw = model_bw
    want = np.asarray(prefill_logits(JL, cfg, jw, jnp.asarray), np.float32)
    got = prefill_logits(TL, tcfg, tw, torch.from_numpy, device="cpu").float()
    assert torch.isfinite(got).all()
    assert_allclose(got, want, atol=0.15, rtol=0.1, name="prefill logits")


def test_forward_step_blockwise_int8_tracks_fp8():
    """The port of tests/test_model.py::test_moe_model_blockwise_int8: one seed
    gives the fp8 and the blockwise int8 model the same float32 masters, and
    the blockwise model's prefill and decode logits stay within cosine 0.97
    of the fp8 model's."""
    outs = {}
    for name, cfg in (("fp8", TL.tiny_config(moe=True)), ("bw", bw_config(TL))):
        w = TL.init_weights(cfg, torch.Generator().manual_seed(4), device="cpu")
        outs[name] = [t.float() for t in run_prefill_then_decode(TL, cfg, w, torch.from_numpy)]
    for a, ref in zip(outs["bw"], outs["fp8"]):
        assert torch.isfinite(a).all()
        cos = torch.nn.functional.cosine_similarity(a, ref, dim=-1)
        assert float(cos.min()) > 0.97, f"cosine {cos.tolist()}"


def test_engine_blockwise_int8_matches_jax_engine(model_bw, jax_dense_moe):
    """Blockwise int8 MoE serving: the engine's greedy tokens equal the JAX
    engine's on the same weights (a flip is accepted only at a bf16 near-tie
    of JAX's logits, below the 0.15 tolerance, and ends the comparison)."""
    cfg, jw, tcfg, tw = model_bw
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
