"""Shared helpers for the kernel wrappers (``sputnik_tpu/kernels/common.py``)."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_tile(dim: int, preferred: int, minimum: int = 128) -> int:
    """Largest tile <= preferred that divides dim, multiple of `minimum`."""
    t = min(preferred, dim)
    while t > minimum:
        if dim % t == 0 and t % minimum == 0:
            return t
        t -= minimum
    if dim % minimum != 0:
        raise ValueError(f"dimension {dim} not a multiple of {minimum}")
    return minimum
