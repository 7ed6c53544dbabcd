"""Fused sampler: rep-penalty -> temperature -> [softmax] -> top-k -> [softmax]
-> top-p -> Gumbel-max -> penalty-mask writeback (port of ``ops/sampler.py``).

Plain PyTorch, same semantics as the JAX package:
  * sampling is bounded to the top-``max_topk`` (32/64) candidates; a user
    ``topk`` of 0 means "do not tighten below max_topk";
  * the temperature-only fast path scores the full vocab;
  * ties in the Gumbel-max break toward the smaller token id;
  * with caller-supplied ``gumbel_noise`` the result is reproducible, and
    equal to the JAX package's bit for bit.

The top-k is a stable descending sort, so equal values keep the lower token
id first, as ``lax.top_k`` does. ``topk_impl="approx"`` (the TPU's
PartialReduce unit) has no counterpart and raises ``ValueError``. The
penalty mask is updated IN PLACE and also returned.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from hpc_ops_tpu_torch.config import SoftmaxPolicy

_NEG_INF = float("-inf")


def _per_batch(x, b, dtype, device) -> torch.Tensor:
    """Broadcast scalar-or-[B] to [B]."""
    if isinstance(x, torch.Tensor) and x.ndim > 0:
        return x.to(dtype=dtype, device=device)
    return torch.full((b,), float(x) if dtype.is_floating_point else int(x), dtype=dtype, device=device)


def _unpack_bits(mask_rows: torch.Tensor, v: int) -> torch.Tensor:
    """[B, ceil(V/8)] uint8 -> [B, V] bool; token i bit = row[i//8] >> (i%8)."""
    shifts = torch.arange(8, device=mask_rows.device, dtype=torch.uint8)
    bits = (mask_rows[..., None] >> shifts) & 1
    return bits.reshape(mask_rows.shape[0], -1)[:, :v].bool()


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel(0) noise from uniform(0,1]: -log(-log(u))."""
    return -torch.log(-torch.log(u.clamp(1e-20, 1.0)))


def _gumbel(b, v, seed, device, generator=None) -> torch.Tensor:
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((b, v), generator=generator, device=device, dtype=torch.float32)
    return gumbel_from_uniform(u)


def fused_sampler(
    logits: torch.Tensor,
    *,
    penalty_mask: Optional[torch.Tensor] = None,
    slot_id: Optional[torch.Tensor] = None,
    repetition_penalty: Union[torch.Tensor, float] = 0.0,
    temperature: Union[torch.Tensor, float] = 0.0,
    softmax_policy: SoftmaxPolicy = SoftmaxPolicy.NONE,
    topk: Union[torch.Tensor, int] = 0,
    topp: Union[torch.Tensor, float] = 0.0,
    max_topk: int = 32,
    gumbel_noise: Optional[torch.Tensor] = None,
    draft_token_ids: Optional[torch.Tensor] = None,
    seed: int = 0,
    topk_impl: str = "exact",
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused sampling step over ``logits`` [B, V].

    Without ``gumbel_noise`` the noise is drawn from ``generator`` (or a
    ``torch.Generator`` seeded with ``seed``); its numbers differ from JAX's.
    Returns ``(token_ids [B, 1] int32, penalty_mask or None)``.
    """
    if topk_impl != "exact":
        raise ValueError(
            f"topk_impl={topk_impl!r}: only 'exact' is supported (the approximate "
            "top-k is the TPU's PartialReduce unit)"
        )
    softmax_policy = SoftmaxPolicy(int(softmax_policy))
    if max_topk not in (32, 64):
        raise ValueError(f"max_topk must be 32 or 64, got {max_topk}")
    b, v = logits.shape
    dev = logits.device

    def _is_scalar_zero(x):
        return not isinstance(x, torch.Tensor) and float(x) == 0.0

    temp_is_tensor = isinstance(temperature, torch.Tensor) and temperature.ndim > 0
    fast = (
        penalty_mask is None
        and slot_id is None
        and _is_scalar_zero(repetition_penalty)
        and _is_scalar_zero(topp)
        and not isinstance(topk, torch.Tensor)
        and int(topk) == 0
        and softmax_policy == SoftmaxPolicy.NONE
        and (temp_is_tensor or float(temperature) > 0.0)
    )
    if fast:
        return (
            fused_sampler_temperature_sample(
                logits, temperature, gumbel_noise, draft_token_ids, seed, generator
            ),
            None,
        )
    if draft_token_ids is not None:
        raise ValueError("draft_token_ids currently requires the temperature-only fast path")
    if (penalty_mask is None) != (slot_id is None):
        raise ValueError("penalty_mask and slot_id must be provided together")
    topp_enabled = isinstance(topp, torch.Tensor) or float(topp) != 0.0
    if topp_enabled and softmax_policy == SoftmaxPolicy.NONE:
        raise ValueError("topp requires softmax_policy != NONE")

    work = logits.float()
    # 1. repetition penalty
    if penalty_mask is not None:
        rp = _per_batch(repetition_penalty, b, torch.float32, dev)
        rows = penalty_mask[slot_id.long()]
        apply = _unpack_bits(rows, v) & (rp > 0)[:, None]
        rp_safe = torch.where(rp > 0, rp, 1.0)[:, None]
        work = torch.where(
            apply & (work > 0), work / rp_safe, torch.where(apply, work * rp_safe, work)
        )
    # 2. temperature
    t = _per_batch(temperature, b, torch.float32, dev)
    work = torch.where((t > 0)[:, None], work / torch.where(t > 0, t, 1.0)[:, None], work)
    # 3. optional softmax over the full vocab
    if softmax_policy == SoftmaxPolicy.BEFORE_TOPK:
        work = torch.softmax(work, dim=-1)
    # 4. top-max_topk candidates, sorted descending, ties by lower index
    vals, idx = torch.sort(work, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :max_topk], idx[:, :max_topk]
    tk = _per_batch(topk, b, torch.int32, dev)
    k_eff = torch.where((tk <= 0) | (tk > max_topk), max_topk, tk)
    pos = torch.arange(max_topk, dtype=torch.int32, device=dev)[None, :]
    keep_k = pos < k_eff[:, None]
    if softmax_policy == SoftmaxPolicy.AFTER_TOPK:
        probs = torch.softmax(torch.where(keep_k, vals, _NEG_INF), dim=-1)
        vfg = torch.where(keep_k, torch.log(probs.clamp(min=1e-38)), _NEG_INF)
    elif softmax_policy == SoftmaxPolicy.BEFORE_TOPK:
        probs = torch.where(keep_k, vals, 0.0)
        vfg = torch.where(probs > 0, torch.log(probs.clamp(min=1e-38)), _NEG_INF)
    else:
        probs = None
        vfg = vals
    # 5. top-p truncation (first candidate always kept)
    keep = keep_k
    if topp_enabled:
        tp = _per_batch(topp, b, torch.float32, dev)
        csum_excl = torch.cumsum(probs, dim=-1) - probs
        keep_p = (pos == 0) | (csum_excl < tp[:, None])
        keep = keep & torch.where((tp > 0)[:, None], keep_p, True)
    # 6. Gumbel-max over surviving candidates
    if gumbel_noise is None:
        gumbel_noise = _gumbel(b, v, seed, dev, generator)
    noise = torch.gather(gumbel_noise.float(), 1, idx)
    score = torch.where(keep, vfg + noise, _NEG_INF)
    tie = score == score.max(dim=-1, keepdim=True).values
    token = torch.where(tie, idx, v).min(dim=-1).values.to(torch.int32)
    # 7. penalty writeback: set the bit of the sampled token, in place
    if penalty_mask is not None:
        rows_idx = slot_id.long()
        byte_idx = (token // 8).long()
        bit = torch.bitwise_left_shift(torch.ones_like(token), token % 8).to(penalty_mask.dtype)
        penalty_mask[rows_idx, byte_idx] = penalty_mask[rows_idx, byte_idx] | bit
    return token[:, None], penalty_mask


def fused_sampler_temperature_sample(
    logits: torch.Tensor,
    temperature: Union[torch.Tensor, float],
    gumbel_noise: Optional[torch.Tensor] = None,
    draft_token_ids: Optional[torch.Tensor] = None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Temperature-only path: full-vocab ``argmax(logit/temp + Gumbel(0))``
    with optional draft-token -inf masking. Ties break toward the smaller
    token id. Returns [B, 1] int32."""
    b, v = logits.shape
    dev = logits.device
    t = _per_batch(temperature, b, torch.float32, dev)
    score = logits.float() / t[:, None]
    col = torch.arange(v, dtype=torch.int64, device=dev)[None, :]
    if draft_token_ids is not None:
        draft = draft_token_ids.long()
        score = torch.where((draft[:, None] >= 0) & (col == draft[:, None]), _NEG_INF, score)
    if gumbel_noise is None:
        gumbel_noise = _gumbel(b, v, seed, dev, generator)
    score = score + gumbel_noise.float()
    tie = score == score.max(dim=-1, keepdim=True).values
    token = torch.where(tie, col, v).min(dim=-1).values.to(torch.int32)
    return token[:, None]


__all__ = ["fused_sampler", "fused_sampler_temperature_sample", "gumbel_from_uniform"]
