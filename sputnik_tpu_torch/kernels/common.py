"""Shared helpers for the kernel wrappers (``sputnik_tpu/kernels/common.py``),
and the per-topology plan cache."""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

# Plans cached per metadata tensors: {(key, ids): (weak refs, plan)}.
_PLANS: Dict[tuple, Tuple[tuple, object]] = {}


def cached_plan(tensors: Sequence[torch.Tensor], key: tuple, build: Callable[[], object]):
    """``build()`` once per ``key`` and set of metadata ``tensors`` (by
    identity, through weak references: the entry goes when one of them
    does). Descriptors made by ``with_data`` / ``with_transpose_metadata``
    / ``astype`` share their metadata tensors, so they share the plan."""
    full = (key, tuple(id(t) for t in tensors))
    hit = _PLANS.get(full)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    value = build()
    refs = tuple(weakref.ref(t, lambda _, k=full: _PLANS.pop(k, None)) for t in tensors)
    _PLANS[full] = (refs, value)
    return value


def oriented(x: torch.Tensor, transposed: bool) -> torch.Tensor:
    """``x``, or with ``transposed`` its transpose over the last two axes."""
    return x.transpose(-1, -2) if transposed else x


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
