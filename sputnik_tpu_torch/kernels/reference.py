"""Plain PyTorch versions of the seven BSR matmuls
(``sputnik_tpu/kernels/reference.py``).

They densify the sparse operands and run one fp32 ``torch.matmul``, then
cast to the output type (a sparse output's blocks are then gathered out):
the registry's ``torch_reference`` variants, the CPU path, and the densify
detour for near-dense operands. Operands keep their layouts; a leading
batch axis broadcasts. int8 operands give the exact int32 sum
(:func:`product`), as the int8 kernels accumulate it.
"""

from __future__ import annotations

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix, bsr_to_dense
from sputnik_tpu_torch.kernels.common import oriented as _op

__all__ = ["dsd", "dds", "sdd", "ssd", "sds", "dss", "sss", "extract_blocks", "product", "flush"]


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as a kernel accumulates it: fp32, or for int8 operands the
    exact int32 sum. CUDA has no integer matmul, so int8 goes through fp64
    on the card (exact: a row of 1024 products of up to 127^2 sums to about
    2^24, far below 2^53) and int64 on the CPU."""
    if a.dtype == torch.int8:
        wide = torch.float64 if a.is_cuda else torch.int64
        return torch.matmul(a.to(wide), b.to(wide)).to(torch.int32)
    return torch.matmul(a.float(), b.float())


def flush(acc: torch.Tensor, out_dtype, out_scale=None) -> torch.Tensor:
    """A kernel's flush: ``float(acc) * out_scale`` in fp32 (the scale
    rounded to fp32 first, as the JAX package's weak-typed multiply does),
    then the cast to ``out_dtype``."""
    if out_scale is not None:
        acc = acc.float() * torch.tensor(np.float32(out_scale), device=acc.device)
    return acc.to(out_dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    return flush(product(a, b), out_dtype)


def extract_blocks(dense: torch.Tensor, topology: BlockSparseMatrix) -> torch.Tensor:
    """Gather ``topology``'s blocks out of ``([batch,] M, N)`` -> ``([batch,] nnz, bs, bs)``."""
    bs, br, bc = topology.block_size, topology.block_rows, topology.block_cols
    blocks = dense.reshape(dense.shape[:-2] + (br, bs, bc, bs)).transpose(-3, -2)
    return blocks[..., topology.row_indices.long(), topology.indices.long(), :, :]


def dsd(a: BlockSparseMatrix, b, *, transpose_a=False, transpose_b=False, out_dtype=None):
    return _mm(_op(bsr_to_dense(a), transpose_a), _op(b, transpose_b), out_dtype or a.dtype)


def dds(a, b: BlockSparseMatrix, *, transpose_a=False, transpose_b=False, out_dtype=None):
    return _mm(_op(a, transpose_a), _op(bsr_to_dense(b), transpose_b), out_dtype or b.dtype)


def sdd(a, b, topology: BlockSparseMatrix, *, transpose_a=False, transpose_b=False, out_dtype=None):
    full = _mm(_op(a, transpose_a), _op(b, transpose_b), out_dtype or topology.dtype)
    return topology.with_data(extract_blocks(full, topology))


def ssd(a: BlockSparseMatrix, b, topology: BlockSparseMatrix, *, transpose_a=False, transpose_b=False,
        out_dtype=None):
    full = _mm(_op(bsr_to_dense(a), transpose_a), _op(b, transpose_b), out_dtype or topology.dtype)
    return topology.with_data(extract_blocks(full, topology))


def sds(a, b: BlockSparseMatrix, topology: BlockSparseMatrix, *, transpose_a=False, transpose_b=False,
        out_dtype=None):
    full = _mm(_op(a, transpose_a), _op(bsr_to_dense(b), transpose_b), out_dtype or topology.dtype)
    return topology.with_data(extract_blocks(full, topology))


def dss(a: BlockSparseMatrix, b: BlockSparseMatrix, *, transpose_a=False, transpose_b=False, out_dtype=None):
    return _mm(_op(bsr_to_dense(a), transpose_a), _op(bsr_to_dense(b), transpose_b), out_dtype or a.dtype)


def sss(a: BlockSparseMatrix, b: BlockSparseMatrix, topology: BlockSparseMatrix, *, transpose_a=False,
        transpose_b=False, out_dtype=None):
    out_dtype = out_dtype or topology.dtype
    full = dss(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype)
    return topology.with_data(extract_blocks(full, topology))
