"""HuggingFace checkpoint conversion (port of ``models/convert.py``).

Converts a transformers Llama-family causal LM (Llama 2/3, Mistral,
Qwen2-style: GQA decoder, NeoX rotate-half RoPE, RMSNorm, SiLU-gated MLP) or
a Mixtral MoE into the port's weights, on an explicit ``device``:

  * ``wqkv [H, (Hq+2Hkv)*D]``: the q|k|v column blocks (q/k/v_proj
    transposed and concatenated);
  * ``w_gate_up [H, 2I]``: the gate|up halves;
  * ``w_down [I, H]``, ``wo [Hq*D, H]``, ``lm_head [H, V]``: transposed from
    HF's [out, in];
  * ``cos_sin``: rebuilt from ``rope_theta`` (and ``rope_scaling``).

The input is any object with transformers' attribute names
(``model.model.layers[i].self_attn.q_proj.weight``, ...); this module imports
no transformers. Each tensor is converted on its own, in torch, straight to
``dtype`` on ``device``: no float32 copy of the model is made (the JAX
package goes through float32 numpy). The values equal what
:func:`~hpc_ops_tpu_torch.models.llama.weights_from_numpy` makes of the JAX
converter's output, in the port's layouts (``dense_int8`` weights
column-major). Expert weights are quantised one expert at a time in float32.
"""

from __future__ import annotations

import torch

from hpc_ops_tpu_torch.config import FP8_DTYPE
from hpc_ops_tpu_torch.models.llama import ModelConfig, MoEConfig, check_supported, quantize_w8
from hpc_ops_tpu_torch.ops.rope import make_cos_sin_cache

__all__ = ["config_from_hf", "from_hf_llama", "from_hf_mixtral"]

_MOE_SCHEMES = ("pertensor_fp8", "blockwise_int8")


def config_from_hf(hf_config, max_position: int | None = None) -> ModelConfig:
    """Map a transformers LlamaConfig-compatible config to ModelConfig."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads
    )
    return ModelConfig(
        vocab=hf_config.vocab_size,
        hidden=hf_config.hidden_size,
        layers=hf_config.num_hidden_layers,
        q_heads=hf_config.num_attention_heads,
        kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        head_dim=head_dim,
        intermediate=hf_config.intermediate_size,
        rope_base=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=hf_config.rms_norm_eps,
        max_position=max_position or min(int(hf_config.max_position_embeddings), 8192),
    )


def _check_scheme(scheme: str) -> None:
    # the JAX converter turns any other scheme into e4m3 experts under an int8
    # config; the port converts only what the config says it holds
    if scheme not in _MOE_SCHEMES:
        raise ValueError(f"from_hf_mixtral: scheme {scheme!r} has no conversion "
                         f"(one of {_MOE_SCHEMES})")


def _quantize_expert(w: torch.Tensor, scheme: str, scale=None):
    """One expert's [N, K] float32 weight as the serving scheme stores it:
    int8 codes with a scale per 128 x 128 block, ``max|block| / 127 + 1e-8``
    (blockwise_int8), or e4m3 codes at the layer's per-tensor ``scale``."""
    if scheme == "blockwise_int8":
        n, k = w.shape
        blocks = w.reshape(n // 128, 128, k // 128, 128)
        sw = blocks.abs().amax(dim=(1, 3)) / 127.0 + 1e-8
        w8 = torch.clamp(torch.round(blocks / sw[:, None, :, None]), -127, 127)
        return w8.reshape(n, k).to(torch.int8), sw
    return (w / scale).to(FP8_DTYPE), None


def _quantize_moe(gw, dw, scheme: str):
    """Quantise a layer's experts, ``gw`` and ``dw`` sequences of [N, K]
    weights (any float dtype), one expert at a time in float32, the way
    ``init_weights`` quantises them: per-128x128-block int8 scales, or e4m3
    at one scale for each stacked tensor, ``max|w| / 448`` (its [E] copies).
    Returns (gate-up codes [E, 2F, H], scales, down codes [E, H, F],
    scales)."""
    _check_scheme(scheme)
    out = []
    for ws in (gw, dw):
        scale = None
        if scheme == "pertensor_fp8":
            scale = torch.stack([w.detach().float().abs().max() for w in ws]).max() / 448.0
        codes, scales = zip(*(_quantize_expert(w.detach().float(), scheme, scale) for w in ws))
        out += [torch.stack(codes),
                torch.stack(scales) if scheme == "blockwise_int8"
                else scale.to(torch.float32).expand(len(ws)).contiguous()]
    return tuple(out)


def _converter(dtype, device):
    def conv(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(device=device, dtype=dtype)

    return conv


def _attn_weights(attn, conv) -> dict:
    return {
        "wqkv": torch.cat([conv(attn.q_proj.weight).T, conv(attn.k_proj.weight).T,
                           conv(attn.v_proj.weight).T], dim=1),  # [H, (Hq+2Hkv)*D]
        "wo": conv(attn.o_proj.weight).T.contiguous(),  # [Hq*D, H]
    }


def _head(model, base, cfg, conv, device) -> dict:
    if getattr(model.config, "tie_word_embeddings", False):
        lm_head_w = base.embed_tokens.weight
    else:
        lm_head_w = model.lm_head.weight
    return {
        "embed": conv(base.embed_tokens.weight),  # [V, H]
        "final_norm": conv(base.norm.weight),
        "lm_head": conv(lm_head_w).T.contiguous(),  # [H, V]
        "cos_sin": make_cos_sin_cache(cfg.max_position, cfg.head_dim, cfg.rope_base,
                                      rope_scaling=getattr(model.config, "rope_scaling", None),
                                      device=device),
    }


def from_hf_mixtral(
    model,
    dtype=torch.bfloat16,
    max_position: int | None = None,
    scheme: str = "pertensor_fp8",
    device="cuda",
):
    """Convert a transformers ``MixtralForCausalLM`` into the MoE model.

    Router semantics are equal by construction: Mixtral's softmax, top-k,
    renormalise equals this model's top-k then softmax. Expert weights are
    stacked [E, N, K] (w1|w3 rows as the gate|up halves, w2 as it is) and
    quantised with the serving ``scheme``, ``pertensor_fp8`` or
    ``blockwise_int8``; ``pertensor_int8`` raises ValueError.
    """
    _check_scheme(scheme)
    cfg = config_from_hf(model.config, max_position=max_position)._replace(
        moe=MoEConfig(
            num_experts=model.config.num_local_experts,
            topk=model.config.num_experts_per_tok,
            expert_intermediate=model.config.intermediate_size,
            scheme=scheme,
        )
    )
    check_supported(cfg)
    conv = _converter(dtype, device)
    base = model.model if hasattr(model, "model") else model
    layers = []
    for hf_layer in base.layers:
        moe = hf_layer.block_sparse_moe
        gw = [torch.cat([ex.w1.weight.detach().to(device), ex.w3.weight.detach().to(device)], dim=0)
              for ex in moe.experts]  # [2F, H] gate|up
        dw = [ex.w2.weight.detach().to(device) for ex in moe.experts]  # [H, F]
        g8, gs, d8, ds = _quantize_moe(gw, dw, scheme)
        del gw, dw
        layers.append({
            "attn_norm": conv(hf_layer.input_layernorm.weight),
            **_attn_weights(hf_layer.self_attn, conv),
            "mlp_norm": conv(hf_layer.post_attention_layernorm.weight),
            "router": conv(moe.gate.weight).T.contiguous(),  # [H, E]
            "moe_gate_up": g8,
            "moe_gate_up_scale": gs,
            "moe_down": d8,
            "moe_down_scale": ds,
        })
    return cfg, {"layers": layers, **_head(model, base, cfg, conv, device)}


def from_hf_llama(
    model,
    dtype=torch.bfloat16,
    max_position: int | None = None,
    dense_int8: bool = False,
    device="cuda",
):
    """Convert a transformers ``LlamaForCausalLM``-style model.

    Returns ``(cfg, weights)`` for :func:`forward_step` and the engines, on
    ``device``, cast to ``dtype`` (bf16 by default) tensor by tensor.
    ``dense_int8=True`` also quantises the dense projections to the W8A8
    serving scheme (:func:`~hpc_ops_tpu_torch.models.llama.quantize_w8`:
    per-column int8 codes, column-major). Qwen2-style q/k/v biases become
    ``qkv_bias``.
    """
    conv = _converter(dtype, device)
    base = model.model if hasattr(model, "model") else model
    has_bias = base.layers[0].self_attn.q_proj.bias is not None
    cfg = config_from_hf(model.config, max_position=max_position)._replace(
        qkv_bias=has_bias, dense_int8=dense_int8)
    layers = []
    for hf_layer in base.layers:
        attn, mlp = hf_layer.self_attn, hf_layer.mlp
        layer = {
            "attn_norm": conv(hf_layer.input_layernorm.weight),
            **_attn_weights(attn, conv),
            "mlp_norm": conv(hf_layer.post_attention_layernorm.weight),
            "w_gate_up": torch.cat([conv(mlp.gate_proj.weight).T, conv(mlp.up_proj.weight).T],
                                   dim=1),  # [H, 2I]
            "w_down": conv(mlp.down_proj.weight).T.contiguous(),  # [I, H]
        }
        if has_bias:  # the q|k|v column order of wqkv
            layer["qkv_bias"] = torch.cat([conv(attn.q_proj.bias), conv(attn.k_proj.bias),
                                           conv(attn.v_proj.bias)])
        if dense_int8:
            for name in ("wqkv", "wo", "w_gate_up", "w_down"):
                layer[name], layer[name + "_scale"] = quantize_w8(layer[name])
        layers.append(layer)
    return cfg, {"layers": layers, **_head(model, base, cfg, conv, device)}
