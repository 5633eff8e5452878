"""DLMC-shaped synthetic matrices (``sputnik_tpu/utils/dlmc.py``:
``synthetic_dlmc``). Loading ``.smtx`` files through the native parser is
not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from sputnik_tpu_torch.formats import CsrMatrix
from sputnik_tpu_torch.utils.device import resolve_device

__all__ = ["synthetic_dlmc"]


def synthetic_dlmc(
    rng: np.random.Generator,
    rows: int = 2048,
    cols: int = 512,
    sparsity: float = 0.9,
    *,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> CsrMatrix:
    """DLMC-shaped synthetic matrix: transformer weight aspect ratios with
    mildly non-uniform row lengths (magnitude-pruning-like skew), the same
    numpy draws as the JAX package's, on ``device`` (``None``: the card)."""
    nnz_total = int(rows * cols * (1 - sparsity))
    # Row lengths: lognormal skew normalized to nnz_total.
    w = rng.lognormal(0.0, 0.5, rows)
    lens = np.maximum((w / w.sum() * nnz_total).astype(np.int64), 0)
    lens = np.minimum(lens, cols)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices = np.concatenate(
        [np.sort(rng.choice(cols, size=int(n), replace=False)) for n in lens]
    ).astype(np.int32) if lens.sum() else np.zeros(0, np.int32)
    vals = torch.as_tensor(rng.standard_normal(len(indices)).astype(np.float32))
    return CsrMatrix.create(vals.to(device=resolve_device(device), dtype=dtype), indices, offsets, (rows, cols))
