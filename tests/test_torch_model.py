"""Parity of the port's Llama model (dense and fp8 MoE; bf16, int8 and fp8 KV;
W8A8 projections) against the JAX package.

The JAX weights (``init_weights(PRNGKey(0), tiny_config())``) are carried
over bit-exactly with ``weights_from_numpy``, so both packages compute the
same function. Logits must agree within 0.15 abs / 0.1 rel, the tolerance of
tests/test_model.py; greedy tokens must be identical, except that a flip at
a bf16 near-tie (JAX's top-2 margin below that tolerance) ends the
comparison at that step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import llama as J
from hpc_ops_tpu.ops.normalization import rmsnorm_ref as jax_rmsnorm
from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.ops.attention.prefill import attention_with_kvcache_prefill
from hpc_ops_tpu_torch.ops.attention.reference import attention_with_kvcache_prefill_ref
from hpc_ops_tpu_torch.ops.normalization import rmsnorm_ref
from hpc_ops_tpu_torch.utils.testing import assert_allclose, assert_greedy_match, top2_margin

torch.set_num_threads(1)

ATOL, RTOL = 0.15, 0.1


@pytest.fixture(scope="module")
def model():
    cfg = J.tiny_config()
    jw = J.init_weights(jax.random.PRNGKey(0), cfg)
    tw = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    return cfg, jw, T.tiny_config(), tw


def i32(x):
    return np.asarray(x, np.int32)


def both(fn_j, fn_t, *arrays, **kw):
    """Call the JAX and the port function on the same int arrays."""
    return (fn_j(*(jnp.asarray(a) for a in arrays), **kw),
            fn_t(*(torch.from_numpy(a) for a in arrays), **kw))


def test_weights_from_numpy_is_bit_exact(model):
    _, jw, _, tw = model
    a = np.asarray(jw["layers"][1]["wqkv"]).view(np.uint16)
    b = tw["layers"][1]["wqkv"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(a, b)
    assert tw["cos_sin"].dtype == torch.float32


def test_init_weights_layout_matches_jax(model):
    cfg, jw, tcfg, _ = model
    tw = T.init_weights(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(jw)
    assert len(flat_j) == 3 + 1 + 6 * cfg.layers
    for name in ("embed", "lm_head", "cos_sin", "final_norm"):
        assert tuple(tw[name].shape) == jw[name].shape
    for lj, lt in zip(jw["layers"], tw["layers"]):
        assert set(lj) == set(lt)
        for k in lj:
            assert tuple(lt[k].shape) == lj[k].shape
            assert str(lt[k].dtype).split(".")[-1] == str(lj[k].dtype)
    std = tw["layers"][0]["wqkv"].float().std().item()
    assert abs(std * cfg.hidden**0.5 - 1.0) < 0.05
    again = T.init_weights(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["lm_head"], tw["lm_head"])


def test_rmsnorm_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 64).astype(np.float32)
    w = rng.rand(64).astype(np.float32)
    want = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    assert_allclose(rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(w), 1e-5), want,
                    atol=1e-5, rtol=1e-5, name="rmsnorm")


def run_prefill_then_decode(pkg, cfg, weights, to):
    """Prefill 7 and 5 tokens for 2 requests, then decode 1 token each."""
    caches = pkg.init_cache(cfg, num_blocks=8, block_size=16, **({} if pkg is J else {"device": "cpu"}))
    tbl = to(i32([[0, 1, -1], [2, 3, -1]]))
    lp, caches = pkg.forward_step(weights, caches, cfg, to(i32(np.arange(12) % cfg.vocab)),
                                  to(i32([7, 5])), to(i32([0, 7, 12])), tbl,
                                  is_prefill=True, max_seqlens_q=8)
    ld, caches = pkg.forward_step(weights, caches, cfg, to(i32([3, 5])), to(i32([8, 6])),
                                  to(i32([0, 1, 2])), tbl, is_prefill=False, max_seqlens_q=1)
    return lp, ld


def test_forward_step_matches_jax(model):
    cfg, jw, tcfg, tw = model
    jp, jd = run_prefill_then_decode(J, cfg, jw, jnp.asarray)
    tp, td = run_prefill_then_decode(T, tcfg, tw, torch.from_numpy)
    assert tp.shape == (2, cfg.vocab) and tp.dtype == torch.bfloat16
    assert_allclose(tp.float(), np.asarray(jp, np.float32), atol=ATOL, rtol=RTOL, name="prefill logits")
    assert_allclose(td.float(), np.asarray(jd, np.float32), atol=ATOL, rtol=RTOL, name="decode logits")


def test_forward_step_qkv_bias_matches_jax(model):
    """A Qwen2-style attention bias of 0.5 on every layer, carried over with
    the weights: the port adds it as the JAX model does, so prefill and
    decode logits agree within 0.15 abs / 0.1 rel, and the bias moves them
    well beyond that."""
    cfg, jw, tcfg, tw = model
    jb = {**jw, "layers": [{**layer, "qkv_bias": jnp.full((cfg.qkv_out,), 0.5, jnp.float32)}
                           for layer in jw["layers"]]}
    tb = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jb), device="cpu")
    jp, jd = run_prefill_then_decode(J, cfg, jb, jnp.asarray)
    tp, td = run_prefill_then_decode(T, tcfg._replace(qkv_bias=True), tb, torch.from_numpy)
    assert_allclose(tp.float(), np.asarray(jp, np.float32), atol=ATOL, rtol=RTOL, name="prefill logits")
    assert_allclose(td.float(), np.asarray(jd, np.float32), atol=ATOL, rtol=RTOL, name="decode logits")
    plain, _ = run_prefill_then_decode(T, tcfg, tw, torch.from_numpy)
    assert float((plain.float() - tp.float()).abs().max()) > 10 * ATOL


def jax_next_logits(cfg, jw, tokens):
    """JAX logits after one prefill of the whole sequence (fresh cache)."""
    n = len(tokens)
    caches = J.init_cache(cfg, num_blocks=8, block_size=16)
    logits, _ = J.forward_step(jw, caches, cfg, jnp.asarray(i32(tokens)), jnp.asarray(i32([n])),
                               jnp.asarray(i32([0, n])), jnp.asarray(i32([list(range(8))])),
                               is_prefill=True, max_seqlens_q=n)
    return np.asarray(logits, np.float32)[0]


def test_decode_multi_matches_jax(model):
    cfg, jw, tcfg, tw = model
    prompts = [[1, 2, 3], [5, 6, 7, 8]]
    tables = i32([[0, 1], [2, 3]])
    outs = {}
    for pkg, c, w, to, kw in ((J, cfg, jw, jnp.asarray, {}), (T, tcfg, tw, torch.from_numpy, {"device": "cpu"})):
        caches = pkg.init_cache(c, num_blocks=8, block_size=16, **kw)
        last = []
        for i, p in enumerate(prompts):
            logits, caches = pkg.forward_step(w, caches, c, to(i32(p)), to(i32([len(p)])),
                                              to(i32([0, len(p)])), to(tables[i : i + 1]),
                                              is_prefill=True, max_seqlens_q=len(p))
            last.append(int(np.argmax(np.asarray(logits.float() if pkg is T else logits, np.float32))))
        toks, _ = pkg.decode_multi(w, caches, c, to(i32(last)), to(i32([4, 5])), to(tables), 4)
        outs[pkg.__name__] = [[last[b]] + [int(t) for t in np.asarray(toks)[:, b]] for b in range(2)]
    want, got = outs[J.__name__], outs[T.__name__]
    for p, w, g in zip(prompts, want, got):
        assert_greedy_match(w, g, lambda j, p=p, w=w: top2_margin(jax_next_logits(cfg, jw, p + w[:j])), ATOL)


def test_decode_multi_sampling_and_logprobs(model):
    _, _, tcfg, tw = model
    caches = T.init_cache(tcfg, num_blocks=8, block_size=16, device="cpu")
    args = (torch.tensor([1, 2], dtype=torch.int32), torch.tensor([1, 1], dtype=torch.int32),
            torch.tensor([[0], [1]], dtype=torch.int32), 3)
    (toks, lps), _ = T.decode_multi(tw, caches, tcfg, *args, temperature=0.7, sample_seed=5,
                                    return_logprobs=True)
    assert toks.shape == (3, 2) and lps.shape == (3, 2)
    assert ((toks >= 0) & (toks < tcfg.vocab)).all() and (lps <= 0).all()


INT8 = dict(int8_kv=True, kv_scale=0.02)


def test_forward_step_int8_kv_matches_jax(model):
    """int8_kv: one int8 NHD_FUSED slab per layer, prefill then decode, with
    the same weights as the bf16 model (int8_kv changes no weight)."""
    _, jw, _, tw = model
    cfg, tcfg = J.tiny_config(**INT8), T.tiny_config(**INT8)
    jp, jd = run_prefill_then_decode(J, cfg, jw, jnp.asarray)
    tp, td = run_prefill_then_decode(T, tcfg, tw, torch.from_numpy)
    assert_allclose(tp.float(), np.asarray(jp, np.float32), atol=ATOL, rtol=RTOL, name="prefill logits")
    assert_allclose(td.float(), np.asarray(jd, np.float32), atol=ATOL, rtol=RTOL, name="decode logits")
    caches = T.init_cache(tcfg, num_blocks=5, block_size=16, device="cpu")
    assert [set(c) for c in caches] == [{"kv"}] * tcfg.layers
    assert caches[0]["kv"].dtype == torch.int8 and tuple(caches[0]["kv"].shape) == (5, 32, 4 * 128)


def test_forward_step_int8_kv_close_to_bf16():
    """The port of tests/test_model.py's int8_kv check: 8 requests, prefill
    then decode; each row of logits within cosine 0.98 of the bf16-cache
    model's with identical weights (JAX's PRNGKey(2) weights)."""
    cfg_bf, cfg_i8 = T.tiny_config(), T.tiny_config(**INT8)
    jw = J.init_weights(jax.random.PRNGKey(2), J.tiny_config())
    w = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    q_lens = [7, 5, 3, 8, 2, 6, 4, 1]
    b, rows = len(q_lens), sum(q_lens)
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32))  # noqa: E731
    seq = t(q_lens)
    q_index = t(np.concatenate([[0], np.cumsum(q_lens)]))
    tbl = t(np.arange(b * 2).reshape(b, 2))
    outs = {}
    for name, cfg in (("i8", cfg_i8), ("bf", cfg_bf)):
        caches = T.init_cache(cfg, num_blocks=b * 2 + 1, block_size=16, device="cpu")
        lp, caches = T.forward_step(w, caches, cfg, t(np.arange(rows) % cfg.vocab), seq, q_index,
                                    tbl, is_prefill=True, max_seqlens_q=8)
        ld, _ = T.forward_step(w, caches, cfg, t(np.arange(b) % cfg.vocab), seq + 1,
                               t(np.arange(b + 1)), tbl, is_prefill=False, max_seqlens_q=1)
        outs[name] = (lp.float(), ld.float())
    for phase, (a, ref) in enumerate(zip(outs["i8"], outs["bf"])):
        assert torch.isfinite(a).all()
        cos = torch.nn.functional.cosine_similarity(a, ref, dim=-1)
        assert cos.min() > 0.98, f"phase {phase}: min cosine {cos.min()}"


def test_forward_step_fp8_kv_matches_jax(model):
    """fp8_kv: e4m3 HND caches at a static scale of 1 and an e4m3 q with a
    scale per token and head, prefill then decode, on the bf16 model's
    weights. The port's attention (its kernels' plain versions here) decodes
    every e4m3 code exactly; the JAX kernels in interpret mode flush the
    subnormal ones, which the logits tolerance covers."""
    _, jw, _, tw = model
    cfg, tcfg = J.tiny_config(fp8_kv=True), T.tiny_config(fp8_kv=True)
    jp, jd = run_prefill_then_decode(J, cfg, jw, jnp.asarray)
    tp, td = run_prefill_then_decode(T, tcfg, tw, torch.from_numpy)
    assert_allclose(tp.float(), np.asarray(jp, np.float32), atol=ATOL, rtol=RTOL, name="prefill logits")
    assert_allclose(td.float(), np.asarray(jd, np.float32), atol=ATOL, rtol=RTOL, name="decode logits")
    caches = T.init_cache(tcfg, num_blocks=5, block_size=16, device="cpu")
    assert [set(c) for c in caches] == [{"k", "v"}] * tcfg.layers
    assert caches[0]["k"].dtype == torch.float8_e4m3fn and tuple(caches[0]["v"].shape) == (4, 5, 16, 128)


def test_forward_step_fp8_kv_close_to_bf16_and_decode_multi(model):
    """The fp8 cache keeps each row of logits within cosine 0.98 of the bf16
    cache's (the bar of tests/test_model.py), and decode_multi over fp8
    caches gives the tokens of single steps."""
    _, _, _, tw = model
    outs = {}
    for name, cfg in (("fp8", T.tiny_config(fp8_kv=True)), ("bf16", T.tiny_config())):
        outs[name] = run_prefill_then_decode(T, cfg, tw, torch.from_numpy)
    for a, ref in zip(outs["fp8"], outs["bf16"]):
        cos = torch.nn.functional.cosine_similarity(a.float(), ref.float(), dim=-1)
        assert cos.min() > 0.98, f"min cosine {cos.min()}"
    cfg = T.tiny_config(fp8_kv=True)
    t = lambda x: torch.as_tensor(np.asarray(x, np.int32))  # noqa: E731
    tbl = t([[0, 1], [2, 3]])
    runs = []
    for multi in (True, False):
        caches = T.init_cache(cfg, num_blocks=8, block_size=16, device="cpu")
        _, caches = T.forward_step(tw, caches, cfg, t([1, 2, 3, 5, 6]), t([3, 2]), t([0, 3, 5]), tbl,
                                   is_prefill=True, max_seqlens_q=3)
        if multi:
            toks, _ = T.decode_multi(tw, caches, cfg, t([9, 4]), t([4, 3]), tbl, 3)
            runs.append(toks.tolist())
        else:
            last, lens, steps = t([9, 4]), t([4, 3]), []
            for _ in range(3):
                logits, caches = T.forward_step(tw, caches, cfg, last, lens, t([0, 1, 2]), tbl,
                                                is_prefill=False)
                last, lens = logits.argmax(-1).to(torch.int32), lens + 1
                steps.append(last.tolist())
            runs.append(steps)
    assert runs[0] == runs[1]


def test_forward_step_dense_int8_matches_jax():
    """dense_int8: W8A8 projections on JAX's quantised weights carried over
    (codes and per-column scales), prefill then decode. The int8 products are
    exact in both packages, so the logits tolerance has the same causes as
    the bf16 model's."""
    cfg, tcfg = J.tiny_config(dense_int8=True), T.tiny_config(dense_int8=True)
    jw = J.init_weights(jax.random.PRNGKey(0), cfg)
    tw = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    assert tw["layers"][0]["wqkv"].dtype == torch.int8
    jp, jd = run_prefill_then_decode(J, cfg, jw, jnp.asarray)
    tp, td = run_prefill_then_decode(T, tcfg, tw, torch.from_numpy)
    assert_allclose(tp.float(), np.asarray(jp, np.float32), atol=ATOL, rtol=RTOL, name="prefill logits")
    assert_allclose(td.float(), np.asarray(jd, np.float32), atol=ATOL, rtol=RTOL, name="decode logits")


@pytest.fixture(scope="module")
def model_moe():
    """tiny_config(moe=True) with JAX's PRNGKey(0) weights carried over."""
    cfg = J.tiny_config(moe=True)
    jw = J.init_weights(jax.random.PRNGKey(0), cfg)
    tw = T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")
    return cfg, jw, T.tiny_config(moe=True), tw


def test_moe_weights_carry_over_and_init_layout(model_moe):
    cfg, jw, tcfg, tw = model_moe
    assert tcfg == T.ModelConfig(**{**cfg._asdict(), "moe": T.MoEConfig(**cfg.moe._asdict())})
    lj, lt = jw["layers"][1], tw["layers"][1]
    assert lt["moe_gate_up"].dtype == torch.float8_e4m3fn
    for name in ("moe_gate_up", "moe_down"):  # fp8 codes arrive bit for bit
        np.testing.assert_array_equal(lt[name].view(torch.uint8).numpy(),
                                      np.asarray(lj[name]).view(np.uint8))
    own = T.init_weights(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for lo, lj in zip(own["layers"], jw["layers"]):
        assert set(lo) == set(lj)
        for k in lj:
            assert tuple(lo[k].shape) == lj[k].shape
            assert str(lo[k].dtype).split(".")[-1] == str(lj[k].dtype)
    first = own["layers"][0]
    assert float(first["moe_gate_up"].float().abs().max()) == 448.0  # amax maps to the fp8 bound
    assert torch.equal(first["moe_down_scale"], first["moe_down_scale"][:1].expand(8))
    w = first["moe_gate_up"].float() * first["moe_gate_up_scale"][:, None, None]
    assert abs(w.std().item() * cfg.hidden**0.5 - 1.0) < 0.05


def test_forward_step_moe_matches_jax(model_moe, monkeypatch):
    """fp8 MoE, prefill then decode: the routing ids of every layer are equal
    (a near-tie in the router would flip an expert and move the logits by far
    more than any tolerance), then the logits agree within 0.15 abs / 0.1 rel
    like the dense model's."""
    cfg, jw, tcfg, tw = model_moe
    routed = {"J": [], "T": []}

    def recording(name, fn):
        def wrapped(x, gw, dw, gs, ds, act, topk_ids, *a, **kw):
            routed[name].append(np.asarray(topk_ids))
            return fn(x, gw, dw, gs, ds, act, topk_ids, *a, **kw)
        return wrapped

    monkeypatch.setattr(J, "fuse_moe_pertensor_fp8", recording("J", J.fuse_moe_pertensor_fp8))
    monkeypatch.setattr(T, "fuse_moe_pertensor_fp8", recording("T", T.fuse_moe_pertensor_fp8))
    jp, jd = run_prefill_then_decode(J, cfg, jw, jnp.asarray)
    tp, td = run_prefill_then_decode(T, tcfg, tw, torch.from_numpy)
    assert len(routed["J"]) == len(routed["T"]) == 2 * cfg.layers
    for a, b in zip(routed["T"], routed["J"]):
        np.testing.assert_array_equal(a, b)
    assert_allclose(tp.float(), np.asarray(jp, np.float32), atol=ATOL, rtol=RTOL, name="prefill logits")
    assert_allclose(td.float(), np.asarray(jd, np.float32), atol=ATOL, rtol=RTOL, name="decode logits")


def test_forward_step_moe_expert_parallel_ranks_sum(model_moe):
    """rank_ep: two ranks, each holding half of the experts, give partial MoE
    outputs (off-rank experts dropped) that add up to the single-rank output
    within two bf16 roundings."""
    _, _, tcfg, tw = model_moe
    layer = tw["layers"][0]
    h = torch.randn((6, tcfg.hidden), generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    whole = T._mlp_moe(h, layer, tcfg, 0).float()
    half = tcfg.moe.num_experts // 2
    parts = []
    for rank in (0, 1):
        sl = slice(rank * half, (rank + 1) * half)
        local = {**layer, **{k: layer[k][sl] for k in ("moe_gate_up", "moe_down", "moe_gate_up_scale",
                                                       "moe_down_scale")}}
        parts.append(T._mlp_moe(h, local, tcfg, rank).float())
    assert_allclose(parts[0] + parts[1], whole.numpy(), atol=2 * 2**-8 * float(whole.abs().max()),
                    rtol=0, name="ep partial sums")


@pytest.mark.parametrize("field", ["fp8_kv", "int8_kv", "dense_int8", "qkv_bias", "moe"])
def test_later_slices_raise(field):
    q = torch.zeros((1, 8, 128), dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32)
    if field == "fp8_kv":
        # fp8_kv serves now, but not beside int8_kv; the task-map decode and
        # the head-major FUSED layout decode over fp8 caches too
        with pytest.raises(ValueError, match="mutually exclusive"):
            T.init_cache(T.tiny_config(fp8_kv=True, int8_kv=True), 4, 16, device="cpu")
        return
    if field in ("int8_kv", "dense_int8"):
        # both serve now, and block-sparse prefill reads the int8 FUSED slab
        # and bf16 HND caches: a malformed mask raises, a mask keeping every
        # tile gives the dense result
        gen = torch.Generator().manual_seed(5)
        if field == "int8_kv":
            kv = torch.randint(-127, 128, (4, 32, 2 * 128), generator=gen, dtype=torch.int8)
            caches = dict(kcache=kv, vcache=None, cache_layout="NHD_FUSED")
        else:
            kv = torch.randn((2, 4, 16, 128), generator=gen).to(torch.bfloat16)
            caches = dict(kcache=kv, vcache=kv, cache_layout="HND")
        qr = torch.randn((5, 8, 128), generator=gen).to(torch.bfloat16)
        args = dict(q=qr, cu_seqlens_q=torch.tensor([0, 5]), block_ids=torch.tensor([[2, 0]]),
                    seqlens_kvcache=torch.tensor([20]), max_seqlens_q=5, **caches)
        with pytest.raises(ValueError, match="block_mask"):
            attention_with_kvcache_prefill(**args, block_mask=torch.ones(1))
        dense = attention_with_kvcache_prefill(**args)
        ones = torch.ones((1, 8, 1, 2), dtype=torch.uint8)
        sparse = attention_with_kvcache_prefill(**args, block_mask=ones, mask_tile_q=8,
                                                mask_tile_kv=16)
        assert_allclose(sparse.float(), dense.float(), atol=1e-2, rtol=1e-2,  # one bf16 step
                        name=f"{field} all-ones mask")
        return
    if field == "moe":
        # every MoE scheme serves now, blockwise_int8 included
        cfg = T.tiny_config(moe=True)
        T.init_cache(cfg._replace(moe=cfg.moe._replace(scheme="blockwise_int8")), 4, 16, device="cpu")
        # and the reference takes a block mask: one keeping every tile is the
        # dense reference
        kv = torch.randn((4, 16, 2, 128), generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
        args = (q, kv, kv, torch.tensor([0, 1]), torch.zeros((1, 1), dtype=torch.int32), one, 1)
        assert torch.equal(attention_with_kvcache_prefill_ref(*args),
                           attention_with_kvcache_prefill_ref(*args, block_mask=torch.ones((1, 8, 1, 1))))
        return
    # qkv_bias serves now (forward_step adds a layer's "qkv_bias"), and so
    # does tensor parallelism over axis_name, on virtual ranks of one device
    # and over distinct CUDA devices; a device this process does not see is
    # refused
    cfg = T.tiny_config(qkv_bias=True)
    T.init_cache(cfg, 4, 16, device="cpu")
    from hpc_ops_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="not visible"):
        make_mesh(tp=2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
