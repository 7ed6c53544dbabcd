"""Stem sparse-mask generator (port of ``ops/stem.py``): OAM scoring and
TPD top-k policy denoising, producing the block masks of the block-sparse
prefill (``attention_with_kvcache_prefill(block_mask=...)``).

Stages, as in the JAX package:
  1. :func:`stem_oam_prep_paged_kv`: per stem block (128 tokens) and group
     g of 16, the sum of K rows {g, g+16, ...} (8 samples), dequantised, in
     reversed group order, as bf16; V bias from each 16-row group's largest
     L2 norm, log-normalised per (request, kv head), relu, averaged per block.
  2. :func:`stem_oam_prep_varlen_q`: the same group sums of q times its
     per-token scale, in natural group order.
  3. :func:`stem_oam_gemm`: block logits ``Qflat @ Kflat^T / 64 + V bias``,
     -inf past the causal diagonal and the requests' block counts, as bf16.
  4. :func:`stem_tpd`: a per-row budget from the three-regime schedule with
     linear decay, then the blocks whose logit is at least the budget-th
     largest finite one (ties included), plus the forced sink, window and
     diagonal blocks.

Plain PyTorch: the JAX package writes no kernel here either (its products go
to XLA), and the products here are ``torch.einsum`` in float32, with TF32
off for their duration. Everything stays on the inputs' device with no read
back to the host, so on the card the mask and the sparse prefill run back to
back.
"""

from __future__ import annotations

import contextlib

import torch

from hpc_ops_tpu_torch.config import QuantType
from hpc_ops_tpu_torch.utils.common import cdiv

NEG_INF = float("-inf")


@contextlib.contextmanager
def _no_tf32():
    """Full float32 products on the card (TF32 would keep ~3 digits)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _gather_tokens(cache, kv_indices, max_len):
    """[nb, bs, H, X] pages + [B, max_blocks] table -> [B, max_len, H, X]."""
    bs = cache.shape[1]
    nblk = cdiv(max_len, bs)
    ids = kv_indices[:, :nblk].long().clamp(min=0)
    raw = cache.view(torch.uint8) if cache.element_size() == 1 else cache
    out = raw[ids]  # [B, nblk, bs, H, X]
    if cache.element_size() == 1:
        out = out.view(cache.dtype)
    b = kv_indices.shape[0]
    return out.reshape(b, nblk * bs, *cache.shape[2:])[:, :max_len]


def _gathered_dequant(cache, scale, quant_type, kind: str, kv_indices, max_len):
    """The requests' tokens of a paged cache, dequantised to float32. Pages
    are gathered before the conversion, so the cost follows the requests'
    lengths, not the pool's size."""
    c = _gather_tokens(cache, kv_indices, max_len).float()
    if cache.dtype == torch.bfloat16:
        return c
    qt = QuantType(quant_type)
    if qt == QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR:
        return c * scale.float().reshape(())
    if kind == "k":
        ks = _gather_tokens(scale.float(), kv_indices, max_len)
        return c * ks.repeat_interleave(c.shape[-1] // ks.shape[-1], dim=-1)
    return c * scale.float()[None, None, :, None]


def cdiv_dyn(x, d: int):
    return (x + d - 1) // d


def stem_oam_prep_paged_kv(
    kcache,
    vcache,
    kscale,
    vscale,
    kv_indices,
    kv_seq_lens,
    lambda_mag: float = 0.3,
    stem_block_size: int = 128,
    stem_stride: int = 16,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
    *,
    max_kv_len: int | None = None,
):
    """K_flat and V_bias from a paged NHD cache ``[nb, bs, Hkv, D]``.

    Returns kflat ``[B, Hkv, max_Kb, stem_stride*D]`` bf16 (reversed group
    order) and vbias ``[B, Hkv, max_Kb]`` float32; ``max_Kb`` covers the
    page table (or ``max_kv_len``).
    """
    b = kv_seq_lens.shape[0]
    hkv, dqk = kcache.shape[2], kcache.shape[3]
    dv = vcache.shape[3]
    bs = kcache.shape[1]
    if max_kv_len is None:
        max_kv_len = kv_indices.shape[1] * bs
    max_kv_pad = cdiv(max_kv_len, stem_block_size) * stem_block_size
    max_kb = max_kv_pad // stem_block_size
    spb = stem_block_size // stem_stride  # samples per group (8)
    dev = kcache.device
    lens = kv_seq_lens.to(dev).long()

    k_tok = _gathered_dequant(kcache, kscale, quant_type, "k", kv_indices, max_kv_pad)
    v_tok = _gathered_dequant(vcache, vscale, quant_type, "v", kv_indices, max_kv_pad)
    t = torch.arange(max_kv_pad, device=dev)
    valid = (t[None, :] < lens[:, None])[:, :, None, None]
    k_tok = k_tok.masked_fill(~valid, 0.0)
    v_tok = v_tok.masked_fill(~valid, 0.0)

    # K_flat: [B, Kb, spb (sample), stride (group), Hkv, D], summed over samples
    kg = k_tok.reshape(b, max_kb, spb, stem_stride, hkv, dqk).sum(dim=2)
    kg = torch.flip(kg, dims=(2,))  # reversed group order
    kflat = kg.permute(0, 3, 1, 2, 4).reshape(b, hkv, max_kb, stem_stride * dqk).to(torch.bfloat16)

    # V_bias: each 16-row group's largest L2 norm, log-normalised, relu, block mean
    vn = torch.linalg.vector_norm(v_tok.reshape(b, max_kv_pad // stem_stride, stem_stride, hkv, dv),
                                  dim=-1)
    vmax = vn.amax(dim=2).permute(0, 2, 1)  # [B, Hkv, groups]
    g_len = (cdiv_dyn(lens, stem_block_size) * stem_block_size) // stem_stride
    gi = torch.arange(vmax.shape[-1], device=dev)
    gvalid = gi[None, None, :] < g_len[:, None, None]

    logv = torch.log(vmax + 1e-6)
    n = g_len.clamp(min=1).float()[:, None]
    mean = torch.where(gvalid, logv, 0.0).sum(dim=-1) / n
    var = torch.where(gvalid, (logv - mean[..., None]) ** 2, 0.0).sum(dim=-1) / (n - 1).clamp(min=1.0)
    std = torch.where(g_len[:, None] > 1, torch.sqrt(var), 0.0)
    normalized = (logv - mean[..., None]) / (std[..., None] + 1e-6)
    contrib = torch.where(gvalid, lambda_mag * normalized.clamp(min=0.0), 0.0)
    vbias = contrib.reshape(b, hkv, max_kb, spb).sum(dim=-1) / float(spb)
    return kflat, vbias


def stem_oam_prep_varlen_q(
    q_fp8,
    qscale,
    q_seq_lens,
    cu_seqlens_q,
    stem_block_size: int = 128,
    stem_stride: int = 16,
):
    """Q_flat: per-token-scaled group sums in natural group order.

    q_fp8 ``[total, Hq, D]``; qscale ``[B, Hq, max_seq_q_pad]`` float32.
    Returns ``[B, Hq, max_Qb, stem_stride*D]`` bf16.
    """
    total, hq, dqk = q_fp8.shape
    b = q_seq_lens.shape[0]
    max_q_pad = cdiv(qscale.shape[-1], stem_block_size) * stem_block_size
    max_qb = max_q_pad // stem_block_size
    spb = stem_block_size // stem_stride
    dev = q_fp8.device
    cu = cu_seqlens_q.to(dev).long()

    # packed rows -> [B, max_q_pad, Hq, D], each scaled by its token's scale
    row = torch.arange(total, device=dev)
    req = torch.searchsorted(cu[1:].contiguous(), row, right=True).clamp(max=b - 1)
    pos = row - cu[req]
    ok = (row < cu[b]) & (pos < max_q_pad)
    qs = qscale.to(dev)[req, :, pos.clamp(max=qscale.shape[-1] - 1)]  # [total, Hq]
    qw = q_fp8.float() * qs.float()[..., None]
    # rows of no request land in one spare row past the end (no boolean
    # indexing: it would read a count back to the host)
    dense = torch.zeros((b * max_q_pad + 1, hq, dqk), dtype=torch.float32, device=dev)
    dense[torch.where(ok, req * max_q_pad + pos, b * max_q_pad)] = qw
    qg = dense[:-1].reshape(b, max_qb, spb, stem_stride, hq, dqk).sum(dim=2)
    return qg.permute(0, 3, 1, 2, 4).reshape(b, hq, max_qb, stem_stride * dqk).to(torch.bfloat16)


def stem_oam_gemm(
    qflat,
    kflat,
    vbias,
    q_seq_lens,
    kv_seq_lens,
    stem_block_size: int = 128,
    stem_stride: int = 16,
    causal: bool = True,
):
    """Block logits ``Qflat @ Kflat^T / spb^2 + V_bias``, ``[B, Hq, max_Qb,
    max_Kb]`` bf16 with -inf at invalid positions (float32 sums)."""
    b, hq, max_qb, _ = qflat.shape
    hkv, max_kb = kflat.shape[1], kflat.shape[2]
    g = hq // hkv
    spb = stem_block_size // stem_stride
    frob = 1.0 / float(spb * spb)
    dev = qflat.device

    kfe = kflat.repeat_interleave(g, dim=1)  # [B, Hq, Kb, F]
    vbe = vbias.repeat_interleave(g, dim=1)  # [B, Hq, Kb]
    with _no_tf32():
        logits = torch.einsum("bhqf,bhkf->bhqk", qflat.float(), kfe.float()) * frob
    logits = logits + vbe[:, :, None, :].float()

    q_lens, kv_lens = q_seq_lens.to(dev).long(), kv_seq_lens.to(dev).long()
    num_qb = cdiv_dyn(q_lens, stem_block_size)
    num_kb = cdiv_dyn(kv_lens, stem_block_size)
    qb = torch.arange(max_qb, device=dev)
    kb = torch.arange(max_kb, device=dev)
    invalid = (qb[None, :, None] >= num_qb[:, None, None]) | (kb[None, None, :] >= num_kb[:, None, None])
    if causal:
        off = cdiv_dyn(kv_lens - q_lens, stem_block_size)
        invalid = invalid | (qb[None, :, None] + off[:, None, None] < kb[None, None, :])
    return logits.masked_fill(invalid[:, None], NEG_INF).to(torch.bfloat16)


def _compute_budget(q_row, kb_offset, prompt_kv_blocks, alpha, rate_medium, bias_medium,
                    rate_large, bias_large):
    """Three-regime k schedule with linear decay, in JAX's int32/float32 steps."""
    k_small = prompt_kv_blocks
    k_medium = (prompt_kv_blocks.float() * rate_medium).to(torch.int32) + bias_medium
    k_large = (prompt_kv_blocks.float() * rate_large).to(torch.int32) + bias_large
    k_val = torch.where(prompt_kv_blocks < 56, k_small,
                        torch.where(prompt_kv_blocks < 160, k_medium, k_large))
    q_pos = q_row + kb_offset
    decay_len = prompt_kv_blocks - k_val
    k_end = k_val.float() * alpha
    t = (q_pos - k_val).float() / (decay_len - 1).clamp(min=1).float()
    decayed = torch.floor(k_val.float() + t * (k_end - k_val.float())).to(torch.int32)
    decayed = torch.minimum(decayed.clamp(min=1), k_val)
    return torch.where((q_pos < k_val) | (decay_len <= 1), k_val, decayed)


def stem_tpd(
    block_logits,
    q_seq_lens,
    kv_seq_lens,
    num_prompt_tokens,
    block_size: int = 128,
    alpha: float = 1.0,
    initial_blocks: int = 4,
    window_size: int = 4,
    k_block_num_rate_medium: float = 0.2,
    k_block_num_bias_medium: int = 30,
    k_block_num_rate_large: float = 0.1,
    k_block_num_bias_large: int = 30,
    gqa_groups: int = 1,
):
    """Top-k policy denoising: ``[B, Hq, max_Qb, max_Kb]`` logits (-inf =
    invalid) -> uint8 mask of the same shape (1 = selected). ``gqa_groups >
    1`` pools the logits over each group of q heads (the mean of the finite
    entries) before the top-k, so the group shares one mask."""
    b, hq, max_qb, max_kb = block_logits.shape
    dev = block_logits.device
    logits = block_logits.float()
    if gqa_groups > 1:
        if hq % gqa_groups:
            raise ValueError(f"stem_tpd: {hq} heads are not a multiple of gqa_groups={gqa_groups}")
        lg = logits.reshape(b, hq // gqa_groups, gqa_groups, max_qb, max_kb)
        fin = torch.isfinite(lg)
        cnt = fin.sum(dim=2, keepdim=True)
        mean = torch.where(fin, lg, 0.0).sum(dim=2, keepdim=True) / cnt.clamp(min=1)
        pooled = torch.where(cnt > 0, mean, NEG_INF)
        logits = pooled.expand(b, hq // gqa_groups, gqa_groups, max_qb, max_kb).reshape(
            b, hq, max_qb, max_kb)
    finite = torch.isfinite(logits)

    q_lens = q_seq_lens.to(dev).to(torch.int32)
    kv_lens = kv_seq_lens.to(dev).to(torch.int32)
    qi_blocks = cdiv_dyn(q_lens, block_size)
    ki_blocks = cdiv_dyn(kv_lens, block_size)
    prompt_kv_blocks = cdiv_dyn(num_prompt_tokens.to(dev).to(torch.int32), block_size)
    kb_offset = cdiv_dyn(kv_lens - q_lens, block_size)

    q_row = torch.arange(max_qb, dtype=torch.int32, device=dev)
    budget = _compute_budget(q_row[None, :], kb_offset[:, None], prompt_kv_blocks[:, None], alpha,
                             k_block_num_rate_medium, k_block_num_bias_medium,
                             k_block_num_rate_large, k_block_num_bias_large)  # [B, max_Qb]

    # threshold: the budget-th largest finite value (ties included)
    col = torch.arange(max_kb, dtype=torch.int32, device=dev)
    col_ok = col[None, None, None, :] < ki_blocks[:, None, None, None]
    work = torch.where(finite & col_ok, logits, NEG_INF)
    sorted_desc = torch.sort(work, dim=-1, descending=True).values
    total_finite = torch.isfinite(work).sum(dim=-1)  # [B, H, Qb]
    eff_budget = torch.minimum(budget[:, None, :].long(), total_finite.clamp(min=1))
    # a budget of 0 reads the last entry, as JAX's index -1 does
    kth = torch.gather(sorted_desc, -1, ((eff_budget - 1) % max_kb)[..., None])
    selected = torch.isfinite(work) & (work >= kth)
    # a budget at or above the finite count selects every finite entry
    selected = torch.where((budget[:, None, :] >= total_finite)[..., None], torch.isfinite(work),
                           selected)

    diag = torch.minimum(q_row[None, :] + kb_offset[:, None], ki_blocks[:, None] - 1)  # [B, Qb]
    d = diag[:, None, :, None]
    c = col[None, None, None, :]
    forced = (c < initial_blocks) | ((c <= d) & (c > d - window_size)) | (c == d)
    mask = (selected | forced) & col_ok
    row_ok = q_row[None, None, :, None] < qi_blocks[:, None, None, None]  # rows past the request
    return (mask & row_ok).to(torch.uint8)


def stem_paged_kv(
    q_fp8,
    kcache,
    vcache,
    qscale,
    kscale,
    vscale,
    kv_indices,
    cu_seqlens_q,
    kv_seq_lens,
    num_prompt_tokens,
    lambda_mag: float = 0.3,
    alpha: float = 1.0,
    stem_block_size: int = 128,
    stem_stride: int = 16,
    causal: bool = True,
    initial_blocks: int = 4,
    window_size: int = 4,
    k_block_num_rate_medium: float = 0.2,
    k_block_num_bias_medium: int = 30,
    k_block_num_rate_large: float = 0.1,
    k_block_num_bias_large: int = 30,
    quant_type: QuantType = QuantType.QPERTOKEN_PERHEAD_KPERTENSOR_VPERTENSOR,
    gqa_groups: int = 1,
):
    """End-to-end Stem mask generation: the uint8 mask ``[B, Hq, max_Qb,
    max_Kb]`` for ``attention_with_kvcache_prefill(block_mask=...,
    mask_tile_q=stem_block_size, mask_tile_kv=stem_block_size)``.
    ``gqa_groups`` pools importance over each GQA group before the top-k so
    the group shares one mask (see :func:`stem_tpd`)."""
    q_seq_lens = (cu_seqlens_q[1:] - cu_seqlens_q[:-1]).to(torch.int32)
    kflat, vbias = stem_oam_prep_paged_kv(
        kcache, vcache, kscale, vscale, kv_indices, kv_seq_lens, lambda_mag, stem_block_size,
        stem_stride, quant_type,
    )
    qflat = stem_oam_prep_varlen_q(q_fp8, qscale, q_seq_lens, cu_seqlens_q, stem_block_size,
                                   stem_stride)
    block_logits = stem_oam_gemm(qflat, kflat, vbias, q_seq_lens, kv_seq_lens, stem_block_size,
                                 stem_stride, causal)
    return stem_tpd(
        block_logits, q_seq_lens, kv_seq_lens, num_prompt_tokens, stem_block_size, alpha,
        initial_blocks, window_size, k_block_num_rate_medium, k_block_num_bias_medium,
        k_block_num_rate_large, k_block_num_bias_large, gqa_groups=gqa_groups,
    )


__all__ = [
    "stem_oam_prep_paged_kv",
    "stem_oam_prep_varlen_q",
    "stem_oam_gemm",
    "stem_tpd",
    "stem_paged_kv",
]
