"""Shared shape helpers."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


__all__ = ["cdiv", "round_up"]
