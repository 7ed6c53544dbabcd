"""Route GEMM: a float32-accurate product through split bf16 weights (port
of ``ops/gemm.py``).

The float32 weight is split as ``w_high = bf16(w)``, ``w_low = bf16((w -
w_high) / scale)`` with scale 2^-8, and ``gemm_bf16xfp32`` computes ``x @
(w_high + scale * w_low)^T`` as two bf16 products with float32 sums, fed by
one load of each x tile (``csrc/gemm.cu``, :func:`route_gemm`): MoE router
projections, where a bf16 weight would misroute tokens. On a card the host
picks the kernel's body, tile and split of K (:func:`route_form`).

``use_splitk``, ``split_flag``, ``tm``, ``tn`` and ``tk`` are accepted for
the JAX package's signature and unused.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from hpc_ops_tpu_torch import kernels
from hpc_ops_tpu_torch.kernels import SMS
from hpc_ops_tpu_torch.utils.common import cdiv

STAGE_K = 64  # K elements of a stage of the kernel (csrc/gemm.cu BK)
SMALL_M = 256  # token counts up to this take the small body (the router's decode shapes)
SMALL_TN = (16, 32, 64)  # the small body's token tiles
MAX_SPLITS_LARGE = 8  # the large body's 128 x 128 partials cost 16 times a small tile's to merge


class RouteForm(NamedTuple):
    """A launch of the route GEMM: the body ("large": 128 rows of x by 128
    weight rows a block, two warpgroups; "small": 64 weight rows by
    ``tile_m`` tokens, one warpgroup, weights on wgmma's 64-row side), the
    output tile (rows of x by weight rows), the split of K, and what
    follows from them."""

    body: str
    tile_m: int
    tile_n: int
    splits: int
    tiles: int  # output tiles
    blocks: int  # tiles x splits
    workspace: int  # float32 elements of the split partials (0 for one split)


def make_form(body: str, tile_m: int, tile_n: int, m: int, n: int, splits: int) -> RouteForm:
    """The form of these choices for an [m, n] output."""
    tiles = cdiv(m, tile_m) * cdiv(n, tile_n)
    return RouteForm(body, tile_m, tile_n, splits, tiles, tiles * splits,
                     0 if splits == 1 else tiles * splits * 2 * tile_m * tile_n)


def _small_cost(f: RouteForm, stages: int) -> int:
    """Bytes the slowest block of a small-body form moves: its stages (2 x 64
    weight rows and the tile's tokens, 128 bytes a row) and, for the tile's
    last block, the merge of every split's hi and lo sums. On an H100 the
    small body's time followed these bytes at about 90 GB/s a block, plus a
    fixed 5-6 us (scripts/time_route_allreduce.py --forms)."""
    merge = f.splits * 2 * 64 * f.tile_m * 4 if f.splits > 1 else 0
    return cdiv(stages, f.splits) * (2 * 64 + f.tile_m) * 128 + merge


@functools.lru_cache(maxsize=1024)
def route_form(m: int, n: int, k: int) -> RouteForm:
    """The kernel's form for x [m, k] and weights [n, k]. No split makes the
    grid pass 132 blocks: on an H100 the router's shape ran 25-45% slower at
    144 blocks (16 tiles x 9 splits, two blocks sharing an SM, or a second
    wave) than at 128 (scripts/time_route_allreduce.py --forms).

    - m > 256: the large body, K split only where the tiles leave more than
      half of the SMs idle.
    - m <= 256: the small body, the token tile and split count whose slowest
      block moves the fewest bytes (:func:`_small_cost`).

    Host integers only: it never reads the device."""
    stages = cdiv(k, STAGE_K)
    if m > SMALL_M:
        tiles = cdiv(m, 128) * cdiv(n, 128)
        return make_form("large", 128, 128, m, n, max(1, min(SMS // tiles, stages, MAX_SPLITS_LARGE)))
    forms = []
    for tn in SMALL_TN:
        tiles = cdiv(m, tn) * cdiv(n, 64)
        most = max(1, min(SMS // tiles, stages))
        forms += [make_form("small", tn, 64, m, n, s) for s in range(1, most + 1)]
    return min(forms, key=lambda f: (_small_cost(f, stages), f.blocks))


def gemm_bf16xfp32_ref(x, w_high, w_low, scale, use_fp32_output=False):
    """The JAX package's reference: ``x @ (w_high + w_low * scale)^T`` in float32."""
    w = w_high.float() + w_low.float() * torch.as_tensor(scale, dtype=torch.float32,
                                                          device=w_low.device).reshape(())
    out = x.float() @ w.T
    return out if use_fp32_output else out.to(torch.bfloat16)


def _route_gemm_ref(x, w_high, w_low, scale, use_fp32_output):
    """Plain PyTorch version of :func:`route_gemm`: two float32 products
    (sums of exact bf16 products) and ``hi + scale * lo``, as the kernel."""
    xf = x.float()
    out = xf @ w_high.float().T + scale.float().reshape(()) * (xf @ w_low.float().T)
    return out if use_fp32_output else out.to(torch.bfloat16)


_BUFFERS: dict = {}  # (device index, stream) -> (float32 workspace, int32 tickets)


def _split_buffers(key, x, form):
    """Pointers to the split workspace and ticket buffer of ``key``, (device
    index, stream), each grown on demand and kept (the kernel leaves the
    tickets zero; launches on one stream run in order), or 0 and 0 for one
    split. Tensor-parallel ranks launch on their own streams at once, so
    each stream has its own."""
    if form.splits == 1:
        return 0, 0
    ws, tickets = _BUFFERS.get(key, (None, None))
    if ws is None or ws.numel() < form.workspace or tickets is None or tickets.numel() < form.tiles:
        kernels.refuse_under_capture("the route GEMM's split workspace")
    if ws is None or ws.numel() < form.workspace:
        ws = torch.empty(form.workspace, dtype=torch.float32, device=x.device)
    if tickets is None or tickets.numel() < form.tiles:
        tickets = torch.zeros(max(form.tiles, 4096), dtype=torch.int32, device=x.device)
    _BUFFERS[key] = ws, tickets
    return ws.data_ptr(), tickets.data_ptr()


def route_gemm(
    x: torch.Tensor,  # [m, k] bf16
    w_high: torch.Tensor,  # [n, k] bf16
    w_low: torch.Tensor,  # [n, k] bf16
    scale: torch.Tensor,  # [1] float32
    use_fp32_output: bool,
) -> torch.Tensor:
    """``x @ w_high^T + scale * (x @ w_low^T)`` with float32 sums; [m, n]
    bf16, or float32 with ``use_fp32_output``.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    name = "route_gemm"
    if x.device.type == "cpu":
        return _route_gemm_ref(x, w_high, w_low, scale, use_fp32_output)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    m, k = x.shape
    n = w_high.shape[0]
    for t in (x, w_high, w_low):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: x and the weights must be contiguous, 16-byte aligned bf16")
    if tuple(w_high.shape) != (n, k) or tuple(w_low.shape) != (n, k) or k % 8:
        raise ValueError(f"{name}: weights must be [n, {k}] with k a multiple of 8")
    dev = x.get_device()
    if w_high.get_device() != dev or w_low.get_device() != dev or scale.get_device() != dev:
        raise ValueError(f"{name}: all tensors must be on one device")
    # the kernel reads the first float32 of scale
    sc = scale if scale.dtype == torch.float32 and scale.is_contiguous() else scale.float().contiguous()
    out = torch.empty((m, n), dtype=torch.float32 if use_fp32_output else torch.bfloat16,
                      device=x.device)
    form = route_form(m, n, k)
    stream = kernels.stream_ptr(x)
    key = (dev, stream)
    ws, tickets = _split_buffers(key, x, form)
    small = form.body == "small"
    rc = kernels.lib().hpc_route_gemm(
        x.data_ptr(), w_high.data_ptr(), w_low.data_ptr(), sc.data_ptr(), out.data_ptr(), m, n, k,
        int(bool(use_fp32_output)), ws, tickets, int(small), form.tile_m if small else form.tile_n,
        form.splits, stream,
    )
    if rc != 0:
        _BUFFERS.pop(key, None)  # fresh tickets for the next call: this one may have taken some
    kernels.check(rc, "hpc_route_gemm")
    kernels.count(route_gemm)
    return out


route_gemm.launches = 0


def gemm_bf16xfp32(
    x,
    w_high,
    w_low,
    scale,
    use_fp32_output: bool = False,
    use_splitk: bool = True,
    split_flag=None,
    *,
    tm: int = 256,
    tn: int = 256,
    tk: int = 512,
    impl: str = "auto",
):
    """Float32-accurate GEMM through two fused bf16 GEMMs.

    Args:
      x: [m, k] bf16 activations.
      w_high: [n, k] bf16, the high bits of the float32 weight.
      w_low: [n, k] bf16, the residual divided by ``scale``.
      scale: a [1] float32 tensor or a number (typically 1/256).
      use_fp32_output: return float32 instead of bf16.
      use_splitk, split_flag, tm, tn, tk: accepted, unused.
      impl: "ref" runs the JAX package's reference.

    Returns: [m, n] bf16 or float32.
    """
    del use_splitk, split_flag, tm, tn, tk
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor([scale], dtype=torch.float32, device=x.device)
    if impl == "ref":
        return gemm_bf16xfp32_ref(x, w_high, w_low, scale, use_fp32_output)
    return route_gemm(x, w_high, w_low, scale, use_fp32_output)


def split_fp32_weight(w_fp32: torch.Tensor, scale: float = 1.0 / 256):
    """``(w_high, w_low, scale)`` from a float32 weight."""
    w_high = w_fp32.to(torch.bfloat16)
    w_low = ((w_fp32 - w_high.float()) / scale).to(torch.bfloat16)
    return w_high, w_low, torch.tensor([scale], dtype=torch.float32, device=w_fp32.device)


def get_gemm_bf16xfp32_workspace(max_weight_hidden_size: int, max_tokens: int = 131072,
                                 device="cuda"):
    """The reference's split-flag workspace, ``[cdiv(max_tokens, 16),
    cdiv(max_weight_hidden_size, 64)]`` int32 zeros on ``device`` (the card
    unless the caller asks for the CPU). The port's GEMM reads none of it: it
    keeps its own split workspace and tickets per stream (:func:`route_gemm`)."""
    return torch.zeros((cdiv(max_tokens, 16), cdiv(max_weight_hidden_size, 64)), dtype=torch.int32,
                       device=device)


__all__ = [
    "gemm_bf16xfp32",
    "gemm_bf16xfp32_ref",
    "split_fp32_weight",
    "get_gemm_bf16xfp32_workspace",
]
