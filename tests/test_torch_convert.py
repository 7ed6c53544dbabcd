"""HF checkpoint conversion in the port (port of tests/test_convert.py).

Each converted model is held against transformers' own forward pass on a
random-init model built from a config in code (nothing is downloaded), at
the JAX tests' bars: per-position cosine of the logits > 0.99 and top-1
agreement >= 0.9 for the bf16 dense models (> 0.98 for W8A8), > 0.95 and
>= 0.75 for Mixtral's e4m3 experts. And each converted weight tree is held
against ``weights_from_numpy`` of the JAX converter's output on the same
model: every tensor bit-equal, in the port's layouts (dense_int8 codes
column-major); the cos|sin table to 2e-4 abs (test_torch_rope.py's bar for
the two packages' float32 cos and sin).
"""

import jax
import numpy as np
import pytest
import torch

from hpc_ops_tpu.models import convert as J
from hpc_ops_tpu_torch.models import llama as T
from hpc_ops_tpu_torch.models.convert import config_from_hf, from_hf_llama, from_hf_mixtral
from hpc_ops_tpu_torch.runtime.engine import Engine

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-30)


def llama(seed, **kw):
    cfg = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=128,
               rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False, **kw)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(**cfg)).eval()


def qwen2(seed):
    torch.manual_seed(seed)
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, tie_word_embeddings=False)).eval()


def mixtral(seed, hidden=256, inter=256):
    torch.manual_seed(seed)
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=512, hidden_size=hidden, intermediate_size=inter, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=False)).eval()


LLAMA3_SCALING = {"rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


def llama_scaled():
    torch.manual_seed(9)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=256,
        rope_theta=10000.0, rope_scaling=LLAMA3_SCALING, tie_word_embeddings=False)).eval()


def tied_bf16():
    """A bf16 checkpoint with tied embeddings: the master weights are bf16,
    so both converters only carry them over."""
    torch.manual_seed(2)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
        tie_word_embeddings=True)).to(torch.bfloat16).eval()


# name -> (model, port converter kwargs, ids seed, ids length, cosine bar, top-1 bar)
CASES = {
    "llama": (lambda: llama(0), {}, 1, 24, 0.99, 0.9),
    "qwen2_qkv_bias": (lambda: qwen2(5), {}, 4, 20, 0.99, 0.9),
    "llama3_rope_scaling": (llama_scaled, {"max_position": 256}, 6, 48, 0.99, 0.9),
    "dense_int8": (lambda: llama(0), {"dense_int8": True}, 1, 24, 0.98, 0.0),
    "mixtral": (lambda: mixtral(3), {}, 2, 16, 0.95, 0.75),
}


def port_logits(cfg, w, ids):
    n = len(ids)
    nb = -(-n // 16)
    t = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    caches = T.init_cache(cfg, num_blocks=nb, block_size=16, device="cpu")
    logits, _ = T.forward_step(w, caches, cfg, t(ids), t([n]), t([0, n]), t([list(range(nb))]),
                               is_prefill=True, max_seqlens_q=n, return_all_logits=True)
    return logits.float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_converted_model_matches_transformers(case):
    make, kw, seed, n, cos_bar, top1_bar = CASES[case]
    model = make()
    ids = np.random.RandomState(seed).randint(0, 512, (1, n))
    with torch.no_grad():
        hf_logits = model(torch.tensor(ids)).logits[0].float().numpy()
    conv = from_hf_mixtral if case == "mixtral" else from_hf_llama
    cfg, w = conv(model, device="cpu", **kw)
    ours = port_logits(cfg, w, [int(x) for x in ids[0]])
    c = _cos(ours, hf_logits)
    top1 = float((ours.argmax(-1) == hf_logits.argmax(-1)).mean())
    assert c.min() > cos_bar, f"cosine per position: min {c.min()}"
    assert top1 >= top1_bar, f"top-1 agreement {top1}"
    if case == "qwen2_qkv_bias":
        assert cfg.qkv_bias and w["layers"][0]["qkv_bias"].shape == (cfg.qkv_out,)
    if case == "dense_int8":
        wqkv = w["layers"][0]["wqkv"]
        assert cfg.dense_int8 and wqkv.dtype == torch.int8 and wqkv.stride() == (1, wqkv.shape[0])
    if case == "mixtral":
        assert cfg.moe.num_experts == 4 and w["layers"][0]["moe_gate_up"].shape == (4, 512, 256)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# name -> (model, JAX converter and kwargs, port converter and kwargs)
PARITY = {
    "llama": (lambda: llama(0), (J.from_hf_llama, {}), (from_hf_llama, {})),
    "llama_tied_bf16_master": (tied_bf16, (J.from_hf_llama, {}), (from_hf_llama, {})),
    "qwen2_qkv_bias": (lambda: qwen2(5), (J.from_hf_llama, {}), (from_hf_llama, {})),
    "llama3_rope_scaling": (llama_scaled, (J.from_hf_llama, {"max_position": 256}),
                            (from_hf_llama, {"max_position": 256})),
    "dense_int8": (lambda: llama(0), (J.from_hf_llama, {"dense_int8": True}),
                   (from_hf_llama, {"dense_int8": True})),
    "mixtral_fp8": (lambda: mixtral(3), (J.from_hf_mixtral, {}), (from_hf_mixtral, {})),
    "mixtral_blockwise": (lambda: mixtral(4, hidden=256, inter=256),
                          (J.from_hf_mixtral, {"scheme": "blockwise_int8"}),
                          (from_hf_mixtral, {"scheme": "blockwise_int8"})),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_converted_weights_equal_jax_converter(case):
    make, (jconv, jkw), (pconv, pkw) = PARITY[case]
    model = make()
    jcfg, jw = jconv(model, **jkw)
    cfg, w = pconv(model, device="cpu", **pkw)
    assert cfg._replace(moe=None) == T.ModelConfig(**jcfg._replace(moe=None)._asdict())
    if jcfg.moe is not None:
        assert tuple(cfg.moe) == tuple(jcfg.moe)
    want = dict(_leaves(T.weights_from_numpy(jax.tree_util.tree_map(np.asarray, jw), device="cpu")))
    got = dict(_leaves(w))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        e = want[name]
        assert g.dtype == e.dtype and g.shape == e.shape and g.stride() == e.stride(), name
        if name == "/cos_sin":
            np.testing.assert_allclose(g.numpy(), e.numpy(), atol=2e-4, rtol=0)
        else:
            assert torch.equal(g.view(torch.uint8) if g.element_size() == 1 else g,
                               e.view(torch.uint8) if e.element_size() == 1 else e), name


def test_config_from_hf_and_mixtral_int8_scheme_raises():
    model = mixtral(3)
    assert config_from_hf(model.config) == T.ModelConfig(
        **J.config_from_hf(model.config)._asdict())
    assert config_from_hf(model.config, max_position=64).max_position == 64
    with pytest.raises(ValueError, match="pertensor_int8"):
        from_hf_mixtral(model, scheme="pertensor_int8", device="cpu")


def test_converted_model_serves_hf_greedy():
    """Converted weights drive the port's Engine: its greedy continuation is
    transformers' own greedy argmax loop (tied embeddings)."""
    torch.manual_seed(1)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=64,
        tie_word_embeddings=True)).eval()
    cfg, w = from_hf_llama(model, device="cpu")
    outs = Engine(cfg, w, num_blocks=16, block_size=16, max_batch=2, device="cpu").run(
        [[1, 2, 3], [5, 6]], max_new=4)
    assert all(len(o) == 4 for o in outs)
    with torch.no_grad():
        seq = [1, 2, 3]
        for _ in range(4):
            seq.append(int(model(torch.tensor([seq])).logits[0, -1].argmax()))
    assert outs[0] == seq[3:]
