"""Test comparison helpers: an ``allclose`` that prints a top-k error table.

Accepts numpy arrays and torch tensors (any device, any float dtype).
"""

from __future__ import annotations

import numpy as np
import torch


def to_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _topk_error_table(name, a, b, k=10):
    a64 = to_f64(a).reshape(-1)
    b64 = to_f64(b).reshape(-1)
    abs_err = np.abs(a64 - b64)
    denom = np.maximum(np.abs(b64), 1e-12)
    rel_err = abs_err / denom
    order = np.argsort(-abs_err)[:k]
    lines = [f"top-{k} {name} errors (flat_idx, got, want, abs_err, rel_err):"]
    for i in order:
        lines.append(
            f"  [{i:>10d}] got={a64[i]: .6e} want={b64[i]: .6e} "
            f"abs={abs_err[i]:.3e} rel={rel_err[i]:.3e}"
        )
    lines.append(
        f"summary: max_abs={abs_err.max():.3e} mean_abs={abs_err.mean():.3e} "
        f"max_rel={rel_err.max():.3e} mismatched="
        f"{int(np.sum(abs_err > 0))}/{a64.size}"
    )
    return "\n".join(lines)


def assert_allclose(
    got, want, atol=1e-5, rtol=1e-5, name="output", k=10, equal_nan=False
):
    """np.allclose with a top-k error table on failure; NaN fails by default."""
    got_np = to_f64(got)
    want_np = to_f64(want)
    assert got_np.shape == want_np.shape, (
        f"{name}: shape mismatch {got_np.shape} vs {want_np.shape}"
    )
    if not equal_nan and not np.isfinite(got_np).all():
        raise AssertionError(
            f"{name}: got contains {int(np.sum(~np.isfinite(got_np)))} "
            f"non-finite values"
        )
    if not np.allclose(got_np, want_np, atol=atol, rtol=rtol, equal_nan=equal_nan):
        raise AssertionError(
            f"{name}: allclose failed (atol={atol}, rtol={rtol})\n"
            + _topk_error_table(name, got_np, want_np, k=k)
        )


def max_abs_err(got, want) -> float:
    return float(np.max(np.abs(to_f64(got) - to_f64(want))))


def max_bf16_ulp_err(got, want) -> float:
    """Largest |got - want| in units of want's bf16 ulp, 2^(exponent - 7)."""
    g, w = to_f64(got), to_f64(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0**-126))) - 7)
    return float(np.max(np.abs(g - w) / ulp)) if w.size else 0.0


def top2_margin(logits) -> float:
    """Gap between the largest and second-largest logit of a 1-D row."""
    row = np.sort(to_f64(logits).reshape(-1))
    return float(row[-1] - row[-2])


def assert_greedy_match(want: list, got: list, margin_at, tol: float):
    """Greedy token streams must agree token for token.

    Two implementations that round bf16 products differently may flip a
    near-tie. A flip at step j is accepted only when ``margin_at(j)``, the
    reference's top-2 logit margin there, is below ``tol`` (the logits
    tolerance); the comparison stops at that step. Returns the step of an
    accepted flip, or None.
    """
    for j, (w, g) in enumerate(zip(want, got)):
        if w != g:
            m = margin_at(j)
            assert m < tol, f"token {j}: got {g}, want {w}, top-2 margin {m} >= {tol}"
            return j
    assert len(want) == len(got), f"lengths differ: {len(got)} vs {len(want)}"
    return None


__all__ = [
    "assert_allclose",
    "assert_greedy_match",
    "max_abs_err",
    "max_bf16_ulp_err",
    "to_f64",
    "top2_margin",
]
