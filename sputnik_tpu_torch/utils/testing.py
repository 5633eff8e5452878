"""Random sparse-matrix generators and the fp64 oracle.

Port of ``sputnik_tpu/utils/testing.py``. The generators draw from a numpy
``Generator`` in exactly the same order as the JAX package's, so the same
seed gives both packages identical topologies and values.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix, CsrMatrix
from sputnik_tpu_torch.utils.device import resolve_device

__all__ = [
    "random_csr_topology", "random_csr", "random_bsr", "random_bsr_topology",
    "bsr_from_blocks", "dense_oracle_matmul", "bf16_ulp_excess", "ATOL",
]

ATOL = 5e-2  # the reference's NanSensitiveFloatNear tolerance


def _random_topology(
    rng: np.random.Generator,
    rows: int,
    cols: int,
    nnz: int,
    *,
    pad_rows_to: int = 1,
    perfect_uniform: bool = False,
    unordered: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(offsets, indices, is_pad) of a random CSR pattern; padding entries
    duplicate a valid column id in their row and must hold zeros."""
    if perfect_uniform:
        if nnz % rows:
            raise ValueError("perfect uniform needs nnz % rows == 0")
        per_row = [nnz // rows] * rows
    else:
        flat = rng.choice(rows * cols, size=nnz, replace=False)
        per_row = np.bincount(flat // cols, minlength=rows).tolist()

    offsets, indices, pad_mask = [0], [], []
    for r in range(rows):
        k = per_row[r]
        cidx = np.sort(rng.choice(cols, size=k, replace=False))
        pad = (-k) % pad_rows_to if pad_rows_to > 1 else 0
        if k == 0 and pad:
            cidx = np.zeros(pad, np.int64)
            pm = np.ones(pad, bool)
        else:
            pm = np.zeros(k, bool)
            if pad:
                cidx = np.concatenate([cidx, np.full(pad, cidx[-1] if k else 0)])
                pm = np.concatenate([pm, np.ones(pad, bool)])
        if unordered and len(cidx) > 1:
            perm = rng.permutation(len(cidx))
            cidx, pm = cidx[perm], pm[perm]
        indices.append(cidx)
        pad_mask.append(pm)
        offsets.append(offsets[-1] + len(cidx))
    offsets = np.asarray(offsets, np.int32)
    indices = np.concatenate(indices).astype(np.int32) if indices else np.zeros(0, np.int32)
    pad_mask = np.concatenate(pad_mask) if pad_mask else np.zeros(0, bool)
    return offsets, indices, pad_mask


def bf16_ulp_excess(got: torch.Tensor, want: torch.Tensor, floor: float = 2.0 ** -8) -> float:
    """The largest ``|got - want| / ulp`` of two bf16 results, where ``ulp``
    is one bf16 ulp at ``max(|got|, |want|, floor * max|want|)``: at most 1
    when every element is within one ulp. The floor covers elements near
    zero formed by cancellation, where two fp32 sums taken in different
    orders may differ by more than a bf16 ulp of the element itself."""
    if not got.numel():
        return 0.0
    got, want = got.float(), want.float()
    mag = torch.maximum(torch.maximum(got.abs(), want.abs()), floor * want.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=torch.finfo(torch.float32).tiny))) - 7)
    return float(((got - want).abs() / ulp).max())


def random_csr_topology(rng, rows, cols, nnz, **kw):
    offsets, indices, _ = _random_topology(rng, rows, cols, nnz, **kw)
    return offsets, indices


def random_csr(
    rng: np.random.Generator,
    rows: int,
    cols: int,
    nnz: int,
    *,
    dtype: torch.dtype = torch.float32,
    device=None,
    pad_rows_to: int = 1,
    unordered: bool = False,
) -> CsrMatrix:
    """Random CSR with ``nnz`` uniformly placed nonzeros (padding entries
    hold zeros), on ``device`` (``None``: the card)."""
    offsets, indices, pad = _random_topology(rng, rows, cols, nnz, pad_rows_to=pad_rows_to, unordered=unordered)
    values = rng.standard_normal(len(indices)).astype(np.float32)
    values[pad] = 0.0
    values = torch.as_tensor(values).to(device=resolve_device(device), dtype=dtype)
    return CsrMatrix.create(values, indices, offsets, (rows, cols))


def random_bsr_topology(rng, rows, cols, nnz_blocks, block_size, *, pad_rows_to=1, unordered=False):
    return _random_topology(
        rng, rows // block_size, cols // block_size, nnz_blocks,
        pad_rows_to=pad_rows_to, unordered=unordered,
    )


def random_bsr(
    rng: np.random.Generator,
    rows: int,
    cols: int,
    nnz: int,
    block_size: int,
    *,
    dtype: torch.dtype = torch.float32,
    device=None,
    pad_rows_to: int = 1,
    unordered: bool = False,
    perfect_uniform: bool = False,
) -> BlockSparseMatrix:
    """Random BSR with ``nnz`` nonzero elements rounded up to whole blocks,
    on ``device`` (``None``: the card)."""
    if rows % block_size or cols % block_size:
        raise ValueError("shape must be divisible by block_size")
    bs = block_size
    nnz_blocks = min(max(-(-nnz // (bs * bs)), 0), (rows // bs) * (cols // bs))
    if perfect_uniform:
        br = rows // bs
        nnz_blocks = min(-(-nnz_blocks // br) * br, br * (cols // bs))
        offsets, indices, pad = _random_topology(
            rng, br, cols // bs, nnz_blocks, perfect_uniform=True, unordered=unordered
        )
    else:
        offsets, indices, pad = random_bsr_topology(
            rng, rows, cols, nnz_blocks, bs, pad_rows_to=pad_rows_to, unordered=unordered
        )
    data = rng.standard_normal((len(indices), bs, bs)).astype(np.float32)
    data[pad] = 0.0
    return BlockSparseMatrix.create(
        torch.as_tensor(data).to(device=resolve_device(device), dtype=dtype), offsets, indices, (rows, cols)
    )


def bsr_from_blocks(rows, cols, block_rows, block_cols, blocks, *, dtype=torch.float32, device=None):
    """Hand-built BSR from (block_row, block_col, block) triples; ``block_rows``
    must be non-decreasing (CSR block order). ``device=None``: the card."""
    blocks = np.asarray(blocks, np.float32)
    bs = blocks.shape[-1]
    counts = np.bincount(np.asarray(block_rows, np.int64), minlength=rows // bs)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BlockSparseMatrix.create(
        torch.as_tensor(blocks).to(device=resolve_device(device), dtype=dtype),
        offsets,
        np.asarray(block_cols, np.int32),
        (rows, cols),
    )


def dense_oracle_matmul(a, b, *, transpose_a: bool = False, transpose_b: bool = False) -> np.ndarray:
    """fp64-accumulated dense matmul, the golden model."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    if transpose_a:
        a64 = a64.T
    if transpose_b:
        b64 = b64.T
    return a64 @ b64
