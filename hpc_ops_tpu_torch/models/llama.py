"""Llama-class decoder on the port's operator stack (port of
``models/llama.py``; bf16, int8 or fp8 KV; dense bf16 or W8A8 projections;
dense, fp8-MoE, int8-MoE or blockwise-int8-MoE MLP; one device, or
tensor-parallel over a (dp, tp) mesh).

Weights are a plain dict of tensors with the JAX package's layout:
``{"embed", "final_norm", "lm_head", "cos_sin", "layers": [{"attn_norm",
"wqkv", "wo", "mlp_norm", "w_gate_up", "w_down"}, ...]}``; projections are
``x @ w`` with ``w`` of shape [in, out]. With ``cfg.moe`` a layer holds
``"router"`` [H, E] and the experts ``"moe_gate_up"`` [E, 2I, H] and
``"moe_down"`` [E, H, I] with one float32 scale per expert
(``"moe_gate_up_scale"``, ``"moe_down_scale"``) in place of the dense MLP:
float8_e4m3fn codes, or with ``MoEConfig(scheme="pertensor_int8")`` int8
codes, the gate-up rows interleaved (``interleave_gate_up``) and the
activation's int8 scale ``"moe_act_scale"`` [1] folded out of the down
scales; or with ``MoEConfig(scheme="blockwise_int8")`` int8 codes with one
float32 scale per 128 x 128 block (``[E, N/128, K/128]``).
A layer may carry ``"qkv_bias"`` [qkv_out], added to the QKV projection.
With ``dense_int8`` the dense projections (``wqkv``, ``wo``, ``w_gate_up``,
``w_down``) are int8 codes with one float32 scale per output column
(``<name>_scale``) and run as W8A8 products (:func:`_mm_w8a8`).
Caches are a list of per-layer ``{"k", "v"}`` HND
``[Hkv, num_blocks, block_size, D]`` tensors, bf16 or with ``fp8_kv``
float8_e4m3fn at a static scale of 1, or, with ``int8_kv``, ``{"kv"}`` int8
NHD_FUSED slabs ``[num_blocks, 2*block_size, Hkv*D]`` holding
``round(x / kv_scale)`` codes; :func:`forward_step` updates them IN PLACE
(the JAX version returns new caches; this one returns the same list).

Each layer: RMSNorm, the QKV projection, RoPE fused with the paged KV store
(the CUDA kernel on decode steps; quantising into the slab with
``int8_kv``; with ``fp8_kv`` a plain-PyTorch store that also quantises q
per token and head), paged attention (prefill or decode kernel, reading the cache
in place), the o-projection with residual add, RMSNorm and the gated-SiLU
MLP: dense, or routed to the top-k experts through the fused MoE
(``ops/moe.py``): fp8, the scatter grouped GEMM, activation + quantisation
and top-k reduce kernels; int8, the gate-up GEMM with the activation in its
epilogue, the aligned down GEMM and the reduce kernel; blockwise int8, the
blockwise scatter gate-up GEMM, a plain-tensor activation and re-quantisation,
the blockwise aligned down GEMM and the reduce kernel.

Tensor parallelism, as in the JAX package: q/kv heads and the MLP
intermediate are split over ``tp`` (GQA groups stay whole, so attention needs
no communication), MoE experts are expert-parallel on the same axis
(``rank_ep`` = the tp rank), and each row-parallel projection (``wo``, the
down projection or the MoE) ends in the fused all-reduce + residual + RMSNorm
(``parallel/collectives.py``), the only communication of a layer.
:func:`shard_weights` places each rank's shard (after the column repacks of
:func:`shard_weights_for_tp`), :func:`init_cache` with ``tp`` makes one
rank's caches, and :func:`make_sharded_step` runs :func:`forward_step` on
every rank of the mesh with ``axis_name`` set to the rank's
:class:`~hpc_ops_tpu_torch.parallel.mesh.RankGroup`; ``dp`` shards the batch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from hpc_ops_tpu_torch.config import FP8_DTYPE, FP8_MAX, QuantPolicy
from hpc_ops_tpu_torch.ops.attention.decode import attention_decode
from hpc_ops_tpu_torch.ops.attention.prefill import attention_with_kvcache_prefill
from hpc_ops_tpu_torch.ops.moe import (
    fuse_moe_blockwise_int8,
    fuse_moe_pertensor_fp8,
    fuse_moe_pertensor_int8,
    interleave_gate_up,
)
from hpc_ops_tpu_torch.ops.normalization import rmsnorm_ref
from hpc_ops_tpu_torch.ops.quant import blockwise_int8_quant
from hpc_ops_tpu_torch.ops.rope import (
    make_cos_sin_cache,
    rope_norm_store_kv,
    rope_norm_store_kv_fp8,
    rope_norm_store_kv_int8,
)
from hpc_ops_tpu_torch.ops.sampler import (
    fused_sampler_temperature_sample,
    gumbel_from_uniform,
)
from hpc_ops_tpu_torch.parallel.collectives import fuse_allreduce_rmsnorm
from hpc_ops_tpu_torch.parallel.mesh import run_ranks


class MoEConfig(NamedTuple):
    """MoE geometry. ``scheme``: "pertensor_fp8" (one scale for all expert
    weights, fp8 codes), "pertensor_int8" (one scale per expert, int8 codes,
    the gate-up weight interleaved so that the gate-up GEMM applies the
    activation in its epilogue; ``act_clip`` is the |silu(gate) * up| range
    mapped onto the int8 codes) or "blockwise_int8" (int8 codes with one
    scale per 128 x 128 weight block, activations quantised per (token,
    128-group))."""

    num_experts: int = 8
    topk: int = 2
    expert_intermediate: int = 1024
    scheme: str = "pertensor_fp8"
    act_clip: float = 8.0  # pertensor_int8 only


class ModelConfig(NamedTuple):
    vocab: int = 32000
    hidden: int = 4096
    layers: int = 32
    q_heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 14336
    rope_base: float = 500000.0
    norm_eps: float = 1e-5
    fp8_kv: bool = False
    int8_kv: bool = False
    kv_scale: float = 0.05
    qkv_bias: bool = False
    dense_int8: bool = False
    moe: Optional[MoEConfig] = None
    max_position: int = 8192
    # residual-branch gain; 1/sqrt(2*layers) keeps the residual stream
    # dominant as in trained networks
    residual_alpha: float = 1.0

    @property
    def qkv_out(self) -> int:
        return (self.q_heads + 2 * self.kv_heads) * self.head_dim


def llama3_8b(**kw) -> ModelConfig:
    return ModelConfig(
        vocab=128256, hidden=4096, layers=32, q_heads=32, kv_heads=8,
        head_dim=128, intermediate=14336, **kw,
    )


def tiny_config(moe: bool = False, **kw) -> ModelConfig:
    """Small config for tests / dry runs."""
    return ModelConfig(
        vocab=512, hidden=256, layers=2, q_heads=8, kv_heads=4, head_dim=128,
        intermediate=512, max_position=512,
        moe=MoEConfig(num_experts=8, topk=2, expert_intermediate=256) if moe else None,
        **kw,
    )


MOE_SCHEMES = ("pertensor_fp8", "pertensor_int8", "blockwise_int8")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for ``fp8_kv`` with ``int8_kv`` (one cache, one type)
    or an unknown MoE scheme."""
    if cfg.fp8_kv and cfg.int8_kv:
        raise ValueError("fp8_kv and int8_kv are mutually exclusive")
    if cfg.moe is not None and cfg.moe.scheme not in MOE_SCHEMES:
        raise ValueError(f"unknown MoE scheme {cfg.moe.scheme!r}")


def init_weights(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype=torch.bfloat16,
    seed: int = 0,
) -> dict:
    """Random weights with the JAX package's layout and distributions
    (normal / sqrt(fan_in), norms at 1). Draws from ``generator`` (a
    ``torch.Generator`` on ``device``; seeded from ``seed`` when None). The
    numbers differ from JAX's; :func:`weights_from_numpy` carries JAX's over.
    """
    check_supported(cfg)
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    h, d = cfg.hidden, cfg.head_dim

    def lin(fan_in, shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w.div_(math.sqrt(fan_in)).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    def experts(fan_in, shape):
        """Expert weights [E, N, K] and their scales: fp8 codes at one scale
        for the tensor ([E] copies of it), (pertensor_int8) int8 codes at one
        scale per expert, ``max|w_e| / 127 + 1e-12``, or (blockwise_int8)
        int8 codes at one scale per 128 x 128 block, ``max|block| / 127 +
        1e-8``, [E, N/128, K/128]. Every scheme draws the same float32
        master, the only transient."""
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        w.div_(math.sqrt(fan_in))
        if cfg.moe.scheme == "blockwise_int8":
            e, n, k = shape
            blocks = w.view(e, n // 128, 128, k // 128, 128)
            scale = blocks.abs().amax(dim=(2, 4)) / 127.0 + 1e-8
            blocks.div_(scale[:, :, None, :, None]).round_().clamp_(-127, 127)
            return w.to(torch.int8), scale
        if cfg.moe.scheme == "pertensor_int8":
            scale = w.abs().amax(dim=(1, 2)) / 127.0 + 1e-12
            w8 = w.div_(scale[:, None, None]).round_().clamp_(-127, 127).to(torch.int8)
            return w8, scale
        scale = w.abs().max() / FP8_MAX
        w.div_(scale)
        return w.to(FP8_DTYPE), scale.expand(shape[0]).contiguous()

    layers = []
    for _ in range(cfg.layers):
        layer = {
            "attn_norm": ones(h),
            "wqkv": lin(h, (h, cfg.qkv_out)),
            "wo": lin(cfg.q_heads * d, (cfg.q_heads * d, h)),
            "mlp_norm": ones(h),
        }
        if cfg.moe is None:
            layer["w_gate_up"] = lin(h, (h, 2 * cfg.intermediate))
            layer["w_down"] = lin(cfg.intermediate, (cfg.intermediate, h))
        else:
            m = cfg.moe
            layer["router"] = lin(h, (h, m.num_experts))
            layer["moe_gate_up"], layer["moe_gate_up_scale"] = experts(
                h, (m.num_experts, 2 * m.expert_intermediate, h))
            layer["moe_down"], layer["moe_down_scale"] = experts(
                m.expert_intermediate, (m.num_experts, h, m.expert_intermediate))
            if m.scheme == "pertensor_int8":
                act_scale = torch.full((1,), 127.0 / m.act_clip, dtype=torch.float32,
                                       device=device)
                layer["moe_gate_up"] = interleave_gate_up(layer["moe_gate_up"])
                # the activation's int8 scale is undone in the down GEMM's
                layer["moe_down_scale"] = layer["moe_down_scale"] / act_scale[0]
                layer["moe_act_scale"] = act_scale
        if cfg.dense_int8:
            for name in ("wqkv", "wo") + (("w_gate_up", "w_down") if cfg.moe is None else ()):
                layer[name], layer[name + "_scale"] = quantize_w8(layer[name])
        layers.append(layer)
    return {
        "embed": lin(1, (cfg.vocab, h)),
        "final_norm": ones(h),
        "lm_head": lin(h, (h, cfg.vocab)),
        "layers": layers,
        "cos_sin": make_cos_sin_cache(cfg.max_position, d, cfg.rope_base, device=device),
    }


def quantize_w8(w: torch.Tensor):
    """Per-output-column symmetric int8 weight quantisation:
    ``w[:, c] ~= w8[:, c] * scale[c]``. Returns (int8 codes, f32 scales); the
    codes are laid out column-major (:func:`_column_major`)."""
    wf = w.float()
    scale = wf.abs().amax(dim=0) / 127.0 + 1e-9
    w8 = torch.round(wf / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return _column_major(w8), scale


def _column_major(w8: torch.Tensor) -> torch.Tensor:
    """The same [in, out] int8 matrix with strides (1, in): each output
    column's codes contiguous, the layout in which the library's int8 product
    streams a weight (on an H100 it is 4.6 times slower on a row-major
    4096 x 28672 weight: ``chip_smoke.py``, slice_full_w8a8)."""
    return w8.t().contiguous().t()


def _int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> exact int32 sums. On the card the
    library's int8 product, which takes more than 16 rows (a decode batch has
    fewer: its rows are padded here and the result cut) and K and N in
    multiples of 8; on the CPU an int32 product."""
    if x8.device.type != "cuda":
        return x8.to(torch.int32) @ w8.to(torch.int32)
    m = x8.shape[0]
    if m <= 16:
        x8 = torch.nn.functional.pad(x8, (0, 0, 0, 32 - m))
    return torch._int_mm(x8, w8)[:m]


def _mm_w8a8(x, w8, w_scale):
    """W8A8 product: per-token dynamic activation scales, an int8 product
    with int32 sums, float32 rescale -> bf16. The sums are exact, so the only
    error is the two quantisation roundings."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-9
    x8 = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    acc = _int8_matmul(x8, w8)
    return (acc.float() * xs * w_scale[None, :]).to(torch.bfloat16)


def _mm(x, layer, name):
    """Dense projection: bf16 product, or W8A8 when the weight is int8."""
    w = layer[name]
    if w.dtype == torch.int8:
        return _mm_w8a8(x, w, layer[name + "_scale"])
    return x @ w


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch may not share read-only memory
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: carry the bits over
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn":  # ml_dtypes fp8: the same, byte by byte
        return torch.from_numpy(a.view(np.uint8)).view(FP8_DTYPE).to(device)
    return torch.from_numpy(a).to(device)


def weights_from_numpy(tree, device="cuda"):
    """JAX weight pytree already converted to numpy -> the port's weights.

    bfloat16 and float8_e4m3fn arrays (numpy's ml_dtypes types) are carried
    over bit-exactly through integer views, so both packages compute the same
    function. int8 weight matrices (``dense_int8``) keep their values and
    shape and become column-major in memory; the 3-D int8 expert tensors of
    ``pertensor_int8`` and ``blockwise_int8`` stay row-major, as the grouped
    GEMMs read them, and so do their float32 scales.
    """
    if isinstance(tree, dict):
        return {k: weights_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [weights_from_numpy(v, device) for v in tree]
    t = _to_torch(np.asarray(tree), device)
    # int8 matrices are dense_int8 weights: the layout quantize_w8 gives them
    return _column_major(t) if t.dtype == torch.int8 and t.dim() == 2 else t


def init_cache(cfg: ModelConfig, num_blocks: int, block_size: int, tp: int = 1, device="cuda"):
    """Per-layer HND caches ``{"k", "v"}`` of [Hkv/tp, blocks, bs, D] zeros
    (bf16, or float8_e4m3fn with ``cfg.fp8_kv``), or with ``cfg.int8_kv`` one
    int8 NHD_FUSED slab ``{"kv"}`` of [blocks, 2*bs, (Hkv/tp)*D] zeros: with
    ``tp`` > 1 one rank's caches (its kv heads; its lanes of the slab, as
    JAX's ``P(rows, None, "tp")``) over its row shard's ``num_blocks``."""
    check_supported(cfg)
    hkv = cfg.kv_heads // tp
    if cfg.int8_kv:
        shape = (num_blocks, 2 * block_size, hkv * cfg.head_dim)
        return [{"kv": torch.zeros(shape, dtype=torch.int8, device=device)}
                for _ in range(cfg.layers)]
    shape = (hkv, num_blocks, block_size, cfg.head_dim)
    dt = FP8_DTYPE if cfg.fp8_kv else torch.bfloat16
    return [
        {
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
        }
        for _ in range(cfg.layers)
    ]


def _mlp_dense(h_normed, layer):
    gu = _mm(h_normed, layer, "w_gate_up")
    i = gu.shape[-1] // 2
    gate = gu[..., :i].float()
    act = (gate * torch.sigmoid(gate)).to(torch.bfloat16) * gu[..., i:]
    return _mm(act, layer, "w_down")


def _mlp_moe(h_normed, layer, cfg: ModelConfig, rank_ep: int, act_scale=None):
    """Top-k routed experts through the fused MoE: per-tensor fp8, where
    ``act_scale`` is the [1] float32 activation scale of 1 (a step builds it
    once for all its layers); per-tensor int8 (``pertensor_int8``: the
    layer's own ``moe_act_scale``, the fused-activation path); or blockwise
    int8 (``blockwise_int8``)."""
    m = cfg.moe
    xf = h_normed.float()
    router_logits = xf @ layer["router"].float()
    topk_scale, topk_ids = torch.topk(router_logits, m.topk, dim=-1)
    topk_scale = torch.softmax(topk_scale, dim=-1)
    if m.scheme == "blockwise_int8":
        # int8 activations with a scale per (token, 128-group), on the device
        x8, sx = blockwise_int8_quant(xf)
        return fuse_moe_blockwise_int8(
            x8,
            sx,
            layer["moe_gate_up"],
            layer["moe_gate_up_scale"],
            layer["moe_down"],
            layer["moe_down_scale"],
            topk_ids.to(torch.int32),
            topk_scale,
            rank_ep,
            m.num_experts,
        )
    if m.scheme == "pertensor_int8":
        # per-tensor int8 activations, the scale never leaves the device
        x_scale = xf.abs().max().clamp(min=1e-6) / 127.0
        x8 = torch.round(xf / x_scale).clamp(-127, 127).to(torch.int8)
        return fuse_moe_pertensor_int8(
            x8,
            layer["moe_gate_up"],
            layer["moe_down"],
            layer["moe_gate_up_scale"] * x_scale,
            layer["moe_down_scale"],
            layer["moe_act_scale"],
            topk_ids.to(torch.int32),
            topk_scale,
            rank_ep,
            m.num_experts,
            gate_up_interleaved=True,
        )
    if act_scale is None:
        act_scale = torch.ones((1,), dtype=torch.float32, device=h_normed.device)
    # quantize activations per-tensor for the fp8 MoE
    x_scale = xf.abs().max().clamp(min=1e-6) / FP8_MAX
    x8 = (xf / x_scale).to(FP8_DTYPE)
    return fuse_moe_pertensor_fp8(
        x8,
        layer["moe_gate_up"],
        layer["moe_down"],
        layer["moe_gate_up_scale"] * x_scale,  # fold activation scale
        layer["moe_down_scale"],
        act_scale,
        topk_ids.to(torch.int32),
        topk_scale,
        rank_ep,
        m.num_experts,
    )  # partial over ep ranks (off-rank experts dropped)


def forward_step(
    weights,
    caches,
    cfg: ModelConfig,
    token_ids: torch.Tensor,  # [rows] new tokens, packed
    seq_lens: torch.Tensor,  # [B] total tokens incl. new
    q_index: torch.Tensor,  # [B+1] prefix sums of new tokens per request
    block_ids: torch.Tensor,  # [B, max_blocks]
    is_prefill: bool,
    mtp: int = 0,
    axis_name: Optional[str] = None,
    rank_ep: int = 0,
    max_seqlens_q: int = 1,
    temperature: float = 0.0,
    sample_seed: int = 0,
    return_all_logits: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """One forward step (prefill or decode) over the paged caches.

    Returns ``(out, caches)``: sampled token ids [B, 1] when temperature > 0,
    else the bf16 logits of each request's last row [B, vocab] (of every row
    with ``return_all_logits``). The caches are written in place. With
    ``axis_name`` (a :class:`~hpc_ops_tpu_torch.parallel.mesh.RankGroup`,
    under :func:`~hpc_ops_tpu_torch.parallel.mesh.run_ranks`) the weights and
    caches are this rank's shards and both residual adds + RMSNorms of a layer
    are the fused all-reduce (``mode="one_shot"``), as in the JAX package.
    """
    check_supported(cfg)
    rows = token_ids.shape[0]
    x = weights["embed"][token_ids.long()]
    h_normed = rmsnorm_ref(x, weights["layers"][0]["attn_norm"], cfg.norm_eps).to(torch.bfloat16)
    x_res = x.to(torch.bfloat16)
    # decode rows are all real (or parked on the dummy page), the fused store
    # kernel's contract; prefill rows may be padded
    store_impl = "xla" if is_prefill else "pallas"
    if cfg.int8_kv:
        kv_sc = torch.full((1,), cfg.kv_scale, dtype=torch.float32, device=x.device)
        attn_kw = {"cache_layout": "NHD_FUSED", "kscale": kv_sc, "vscale": kv_sc}
    elif cfg.fp8_kv:
        kv_sc = torch.ones((1,), dtype=torch.float32, device=x.device)  # static scale 1
        attn_kw = {"cache_layout": "HND", "kscale": kv_sc, "vscale": kv_sc}
    else:
        attn_kw = {"cache_layout": "HND"}
    q_scale = None
    if cfg.moe is not None:
        moe_act_scale = torch.ones((1,), dtype=torch.float32, device=x.device)
    for li, layer in enumerate(weights["layers"]):
        qkv = _mm(h_normed, layer, "wqkv")
        if "qkv_bias" in layer:  # Qwen2-style attention bias
            qkv = qkv + layer["qkv_bias"].to(qkv.dtype)
        if cfg.int8_kv:
            # one int8 NHD_FUSED slab per layer, read in place by attention
            k_cache, v_cache = caches[li]["kv"], None
            q, _ = rope_norm_store_kv_int8(
                k_cache, qkv, weights["cos_sin"], seq_lens, q_index, block_ids, is_prefill,
                kv_sc, kv_sc, impl=store_impl, cache_layout="NHD_FUSED",
                num_kv_heads=k_cache.shape[2] // cfg.head_dim,
            )
        elif cfg.fp8_kv:
            # e4m3 q with a scale per token and head, e4m3 K/V into HND caches
            q, q_scale, _, k_cache, v_cache = rope_norm_store_kv_fp8(
                caches[li]["k"], caches[li]["v"], qkv, weights["cos_sin"], seq_lens, q_index,
                block_ids, is_prefill, kv_sc, kv_sc, int(QuantPolicy.DYNAMIC_Q_STATIC_KV),
                max_seqlens=max_seqlens_q, cache_layout="HND", zero_tails=False,
            )
        else:
            q, k_cache, v_cache = rope_norm_store_kv(
                caches[li]["k"], caches[li]["v"], qkv, weights["cos_sin"], seq_lens,
                q_index, block_ids, is_prefill, cache_layout="HND", zero_tails=False,
                impl=store_impl,
            )
        if is_prefill:
            attn = attention_with_kvcache_prefill(
                q, k_cache, v_cache, q_index, block_ids, seq_lens, max_seqlens_q,
                qscale=q_scale, **attn_kw,
            )
        else:
            attn = attention_decode(
                q, k_cache, v_cache, block_ids, seq_lens, mtp=mtp, new_kv_included=True,
                qscale=q_scale, **attn_kw,
            )
        attn_out = _mm(attn.reshape(rows, -1), layer, "wo")  # a partial over tp
        if cfg.residual_alpha != 1.0:
            attn_out = attn_out * cfg.residual_alpha
        if axis_name is not None:  # fused all-reduce + residual + mlp norm
            h_normed, x_res = fuse_allreduce_rmsnorm(attn_out.contiguous(), x_res, layer["mlp_norm"],
                                                     cfg.norm_eps, axis_name, mode="one_shot")
        else:
            x_res = (x_res.float() + attn_out.float()).to(torch.bfloat16)
            h_normed = rmsnorm_ref(x_res, layer["mlp_norm"], cfg.norm_eps).to(torch.bfloat16)
        if cfg.moe is None:
            mlp_out = _mlp_dense(h_normed, layer)
        else:
            mlp_out = _mlp_moe(h_normed, layer, cfg, rank_ep, moe_act_scale)
        if cfg.residual_alpha != 1.0:
            mlp_out = mlp_out * cfg.residual_alpha
        next_norm = (
            weights["layers"][li + 1]["attn_norm"] if li + 1 < cfg.layers else weights["final_norm"]
        )
        if axis_name is not None:
            h_normed, x_res = fuse_allreduce_rmsnorm(mlp_out.to(torch.bfloat16).contiguous(), x_res,
                                                     next_norm, cfg.norm_eps, axis_name, mode="one_shot")
        else:
            x_res = (x_res.float() + mlp_out.float()).to(torch.bfloat16)
            h_normed = rmsnorm_ref(x_res, next_norm, cfg.norm_eps).to(torch.bfloat16)

    if return_all_logits:
        return h_normed @ weights["lm_head"], caches
    last_rows = (q_index[1:] - 1).long()
    logits = h_normed[last_rows] @ weights["lm_head"]
    if temperature > 0:
        tokens = fused_sampler_temperature_sample(
            logits.float(), temperature, seed=sample_seed, generator=generator
        )
        return tokens, caches
    return logits, caches


def decode_multi(
    weights,
    caches,
    cfg: ModelConfig,
    last_tokens: torch.Tensor,  # [B] last sampled token per slot
    seq_lens: torch.Tensor,  # [B] total tokens incl. the input token
    block_ids: torch.Tensor,  # [B, max_blocks] (pre-extended for num_steps)
    num_steps: int,
    temperature: float = 0.0,
    sample_seed: int = 0,
    axis_name: Optional[str] = None,
    rank_ep: int = 0,
    return_logprobs: bool = False,
):
    """``num_steps`` decode steps in a loop: forward, sample, append to the
    cache, feed the token back (the JAX version is one ``lax.scan``).

    The caller pre-extends each page table to cover ``seq_lens + num_steps -
    1`` slots. Greedy matches single-step decode token for token;
    temperature > 0 draws each step's Gumbel noise from a ``torch.Generator``
    seeded with ``sample_seed`` (other numbers than JAX's).

    Returns ``(tokens [num_steps, B] int32, caches)``, or with
    ``return_logprobs`` ``((tokens, logprobs [num_steps, B] f32), caches)``.
    """
    b = seq_lens.shape[0]
    dev = last_tokens.device
    q_index = torch.arange(b + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(sample_seed)) if temperature > 0 else None
    toks = last_tokens.to(torch.int32)
    lens = seq_lens.to(torch.int32)
    out, lps = [], []
    for _ in range(num_steps):
        logits, caches = forward_step(
            weights, caches, cfg, toks, lens, q_index, block_ids, is_prefill=False,
            axis_name=axis_name, rank_ep=rank_ep, max_seqlens_q=1,
        )
        if temperature > 0:
            u = torch.rand(logits.shape, generator=gen, device=dev).clamp_(min=1e-20)
            nxt = fused_sampler_temperature_sample(
                logits.float(), temperature, gumbel_noise=gumbel_from_uniform(u)
            ).reshape(-1)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if return_logprobs:
            lsm = torch.log_softmax(logits.float(), dim=-1)
            lps.append(lsm.gather(1, nxt.long()[:, None])[:, 0])
        out.append(nxt)
        toks, lens = nxt, lens + 1
    tokens = torch.stack(out)
    if return_logprobs:
        return (tokens, torch.stack(lps)), caches
    return tokens, caches


def shard_weights_specs(cfg: ModelConfig) -> dict:
    """The weight tree with, for each leaf, the dim split over ``tp`` (None:
    replicated): JAX's PartitionSpecs for a (dp, tp) mesh. Column-parallel
    projections (``wqkv``, ``w_gate_up``) split their output dim and their
    per-column scales, row-parallel ones (``wo``, ``w_down``) their input dim
    (their scales replicate); MoE experts split along the expert dim with
    their scales (per expert, or per 128 x 128 block)."""
    layer = {"attn_norm": None, "wqkv": 1, "wo": 0, "mlp_norm": None}
    if cfg.qkv_bias:
        layer["qkv_bias"] = 0
    if cfg.dense_int8:
        layer.update(wqkv_scale=0, wo_scale=None)
        if cfg.moe is None:
            layer.update(w_gate_up_scale=0, w_down_scale=None)
    if cfg.moe is None:
        layer.update(w_gate_up=1, w_down=0)
    else:
        layer.update(router=None, moe_gate_up=0, moe_down=0, moe_gate_up_scale=0, moe_down_scale=0)
        if cfg.moe.scheme == "pertensor_int8":
            layer["moe_act_scale"] = None
    return {"embed": None, "final_norm": None, "lm_head": None, "cos_sin": None,
            "layers": [dict(layer) for _ in range(cfg.layers)]}


def repack_qkv_for_tp(wqkv: torch.Tensor, cfg: ModelConfig, tp: int) -> torch.Tensor:
    """Reorder packed [H, (Hq+2Hkv)*D] columns so a tp-split gives each rank
    its own contiguous [q_heads/tp | k_heads/tp | v_heads/tp] block. Rows pass
    through untouched (a [1, cols] bias view repacks the same way)."""
    h = wqkv.shape[0]
    d = cfg.head_dim
    q, kh = cfg.q_heads, cfg.kv_heads
    wq = wqkv[:, : q * d].reshape(h, tp, q // tp * d)
    wk = wqkv[:, q * d : (q + kh) * d].reshape(h, tp, kh // tp * d)
    wv = wqkv[:, (q + kh) * d :].reshape(h, tp, kh // tp * d)
    return torch.cat([wq, wk, wv], dim=-1).reshape(h, -1)


def repack_gate_up_for_tp(w_gate_up: torch.Tensor, tp: int) -> torch.Tensor:
    """Reorder packed [H, 2I] (gate|up halves) columns so a tp-split gives
    each rank its own contiguous [gate_r | up_r] block."""
    h, two_i = w_gate_up.shape
    i = two_i // 2
    g = w_gate_up[:, :i].reshape(h, tp, i // tp)
    u = w_gate_up[:, i:].reshape(h, tp, i // tp)
    return torch.cat([g, u], dim=-1).reshape(h, -1)


def _repack_layer(layer: dict, cfg: ModelConfig, tp: int) -> dict:
    nl = {**layer, "wqkv": repack_qkv_for_tp(layer["wqkv"], cfg, tp)}
    for name in ("qkv_bias", "wqkv_scale"):
        if name in layer:
            nl[name] = repack_qkv_for_tp(layer[name][None, :], cfg, tp).reshape(-1)
    if "w_gate_up" in layer:
        nl["w_gate_up"] = repack_gate_up_for_tp(layer["w_gate_up"], tp)
    if "w_gate_up_scale" in layer:
        nl["w_gate_up_scale"] = repack_gate_up_for_tp(layer["w_gate_up_scale"][None, :], tp).reshape(-1)
    return nl


def shard_weights_for_tp(weights: dict, cfg: ModelConfig, tp: int) -> dict:
    """Apply the column repacks needed before splitting weights over tp."""
    return {**weights, "layers": [_repack_layer(layer, cfg, tp) for layer in weights["layers"]]}


def shard_weights(weights: dict, cfg: ModelConfig, mesh) -> list:
    """Each tp rank's weights, placed once on its device: a list over the tp
    ranks of weight dicts (every dp shard's rank r uses entry r). Layer by
    layer: repack (:func:`shard_weights_for_tp`), then split each leaf along
    its :func:`shard_weights_specs` dim; replicated leaves are moved, not
    copied, where they already lie on the rank's device (virtual ranks on one
    card share them), and int8 matrices keep the column-major layout
    :func:`quantize_w8` gives them."""
    tp = mesh.shape["tp"]
    devs = list(mesh.devices[0])
    experts = cfg.moe.num_experts if cfg.moe is not None else tp
    if cfg.q_heads % tp or cfg.kv_heads % tp or cfg.intermediate % tp or experts % tp:
        raise ValueError(f"tp={tp} must divide the q and kv heads, the intermediate and the experts")
    specs = shard_weights_specs(cfg)

    def split(t, dim, r):
        if dim is None:
            return t.to(devs[r])
        n = t.shape[dim] // tp
        part = t.narrow(dim, r * n, n).to(devs[r])
        return _column_major(part) if t.dtype == torch.int8 and t.dim() == 2 else part.contiguous()

    ranks = [{k: split(weights[k], None, r) for k in ("embed", "final_norm", "lm_head", "cos_sin")}
             for r in range(tp)]
    for r in ranks:
        r["layers"] = []
    for layer, spec in zip(weights["layers"], specs["layers"]):
        repacked = _repack_layer(layer, cfg, tp)
        for r in range(tp):
            ranks[r]["layers"].append({k: split(v, spec[k], r) for k, v in repacked.items()})
    return ranks


def make_sharded_step(mesh, cfg: ModelConfig, is_prefill: bool = False, **fw_kw):
    """A forward step over a (dp, tp) mesh: ``step(weights, caches, token_ids,
    seq_lens, q_index, block_ids) -> (out, caches)`` with JAX's data
    conventions. ``weights`` is :func:`shard_weights`'s list, ``caches`` a
    ``[dp][tp]`` list of each rank's :func:`init_cache` (``tp=tp``, the row
    shard's own page pool). The data rows are split evenly over the dp
    shards: ``token_ids`` [rows], ``seq_lens`` [B] and ``block_ids`` [B,
    max_blocks] concatenated over the shards (block ids index the shard's
    pool), ``q_index`` each shard's prefix sums, concatenated ([0, 1, 2, 0, 1,
    2] for two shards of two decode rows). Every rank of a dp shard runs
    :func:`forward_step` on its shards of the weights and caches with
    ``axis_name`` its rank group and ``rank_ep`` its tp rank. Returns the out
    of each dp shard's tp rank 0 (every rank's is the same), concatenated,
    and the ranks' caches."""
    check_supported(cfg)
    dp = mesh.shape["dp"]

    def step(weights, caches, token_ids, seq_lens, q_index, block_ids):
        for t in (token_ids, seq_lens, q_index, block_ids):
            if t.shape[0] % dp:
                raise ValueError(f"a data array of {t.shape[0]} rows does not split over dp={dp}")
        tok, lens, qi = (t.reshape(dp, -1) for t in (token_ids, seq_lens, q_index))
        tbl = block_ids.reshape(dp, -1, block_ids.shape[-1])

        def rank(group, d):
            dev = group.device
            return forward_step(
                weights[group.rank], caches[d][group.rank], cfg, tok[d].to(dev), lens[d].to(dev),
                qi[d].to(dev), tbl[d].to(dev), is_prefill, axis_name=group, rank_ep=group.rank,
                **fw_kw)

        res = run_ranks(mesh, rank)
        out = torch.cat([row[0][0] for row in res])
        return out, [[r[1] for r in row] for row in res]

    return step


__all__ = [
    "ModelConfig",
    "MoEConfig",
    "llama3_8b",
    "tiny_config",
    "init_weights",
    "quantize_w8",
    "weights_from_numpy",
    "init_cache",
    "forward_step",
    "decode_multi",
    "make_sharded_step",
    "shard_weights",
    "shard_weights_specs",
    "repack_qkv_for_tp",
    "repack_gate_up_for_tp",
    "shard_weights_for_tp",
]
