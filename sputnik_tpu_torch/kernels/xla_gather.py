"""BSR DSD / DDS as one gather and one batched deep product
(``sputnik_tpu/kernels/xla_gather.py``, the registry's ``xla_gather_bmm``).

The JAX package hands this to XLA outside any Pallas kernel: when every
block-row holds the same number W of blocks, the gather of the dense
operand's strips is regular and the contraction collapses to one batched
dot of depth W * 128 (ragged rows are padded to the widest with a zero
block). Here the gather is a torch index and the dot one ``torch.matmul``
of the batched operands, with fp32 accumulation: in the operands' dtype
when the output has it (the tensor cores accumulate in fp32 and round once,
as JAX's fp32 dot followed by the cast), else in fp32. As in JAX, the
gather materializes ``block_rows * W * 128 * N`` elements of the dense
operand.

The slot maps are planned from the metadata's host copies (JAX: concrete
metadata) and cached per topology on the sparse operand's device, so that a
call with a warm cache, or a CUDA graph capture of one, copies nothing from
the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import reference
from sputnik_tpu_torch.kernels.common import cached_plan

__all__ = ["dsd_gather_bmm", "dds_gather_bmm", "uniform_row_width", "uniform_col_width"]


def _uniform(counts: np.ndarray) -> Optional[int]:
    if counts.size == 0:
        return None
    w = int(counts[0])
    return w if w > 0 and bool((counts == w).all()) else None


def uniform_row_width(a: BlockSparseMatrix) -> Optional[int]:
    """W if every block-row has exactly W blocks, else None; None for
    metadata built on the card (uniformity is a host-side dispatch
    decision, as JAX's needs concrete offsets)."""
    if not a.host_known:
        return None
    return _uniform(np.diff(a.host_offsets))


def uniform_col_width(b: BlockSparseMatrix) -> Optional[int]:
    """W if every block-column has exactly W blocks, else None."""
    if not b.host_known:
        return None
    return _uniform(np.diff(b.host_metadata(transposed=True)[0]))


def _product(lhs: torch.Tensor, rhs: torch.Tensor, out_dtype) -> torch.Tensor:
    if lhs.dtype == out_dtype:
        return torch.matmul(lhs, rhs)
    return reference.flush(reference.product(lhs, rhs), out_dtype)


def _dsd_slots(a: BlockSparseMatrix):
    """(positions, k ids) of each (block-row, slot), (mb, W) int64 on the
    data's device: a padding slot points at block ``nnz`` (a zero block the
    call appends) and k-block 0. None positions for uniform rows."""
    def build():
        offs, idxs = a.host_offsets, a.host_indices
        counts = np.diff(offs)
        if uniform_row_width(a) is not None:
            return None, torch.as_tensor(idxs.astype(np.int64).reshape(a.block_rows, -1)).to(a.device)
        w = max(int(counts.max()), 1)
        slot_pos = np.full((a.block_rows, w), a.nnz_blocks, np.int64)
        slot_idx = np.zeros((a.block_rows, w), np.int64)
        for r in range(a.block_rows):
            c = int(counts[r])
            slot_pos[r, :c] = np.arange(offs[r], offs[r + 1])
            slot_idx[r, :c] = idxs[offs[r]:offs[r + 1]]
        return torch.as_tensor(slot_pos).to(a.device), torch.as_tensor(slot_idx).to(a.device)

    return cached_plan((a.indices,), ("gather_dsd",), build)


def dsd_gather_bmm(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
) -> torch.Tensor:
    """C[M, N] = A_sparse @ op(B): gather B's strips, one batched product of
    depth W * 128 (JAX's ``dsd_gather_bmm``). ``transpose_a`` is not
    supported (the registry's predicate refuses it); the metadata must be
    known on the host."""
    if transpose_a:
        raise ValueError("dsd_gather_bmm supports transpose_a=False only")
    if not a.host_known:
        raise ValueError("dsd_gather_bmm plans slot maps on the host: the metadata must be known there")
    out_dtype = out_dtype or a.dtype
    bs, mb = a.block_size, a.block_rows
    n_dim = b.shape[0] if transpose_b else b.shape[1]
    bk = b.shape[1] if transpose_b else b.shape[0]
    if bk != a.cols:
        raise ValueError(f"contraction mismatch: A gives k={a.cols}, B gives {bk}")
    slot_pos, idx2 = _dsd_slots(a)
    w = idx2.shape[1]
    if slot_pos is None:
        a4 = a.data.reshape(mb, w, bs, bs)
    else:
        padded = torch.cat([a.data, a.data.new_zeros((1, bs, bs))])
        a4 = padded[slot_pos]
    lhs = a4.permute(0, 2, 1, 3).reshape(mb, bs, w * bs)  # (rows, i, (slot, k))
    if transpose_b:  # B stored (N, K): strip k is B[:, k*bs:(k+1)*bs]^T
        b3 = b.reshape(n_dim, a.cols // bs, bs)
        rhs = b3[:, idx2].permute(1, 2, 3, 0).reshape(mb, w * bs, n_dim)
    else:
        b3 = b.reshape(a.cols // bs, bs, n_dim)
        rhs = b3[idx2].reshape(mb, w * bs, n_dim)
    return _product(lhs, rhs, out_dtype).reshape(a.rows, n_dim)


def _dds_slots(b: BlockSparseMatrix):
    """(block-row ids, block positions) of each (block-column, slot), (nb, W)
    int64 on the data's device."""
    def build():
        _, rows, positions = b.host_metadata(transposed=True)
        shape = (b.block_cols, -1)
        return (torch.as_tensor(rows.astype(np.int64).reshape(shape)).to(b.device),
                torch.as_tensor(positions.astype(np.int64).reshape(shape)).to(b.device))

    return cached_plan((b.indices,), ("gather_dds",), build)


def dds_gather_bmm(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
) -> torch.Tensor:
    """C[M, N] = op(A) @ B_sparse for uniform block-columns of B (JAX's
    ``dds_gather_bmm``): A's strips follow each column's block-row ids.
    ``transpose_b`` is not supported."""
    if transpose_b:
        raise ValueError("dds_gather_bmm supports transpose_b=False only")
    if uniform_col_width(b) is None:
        raise ValueError("dds_gather_bmm needs a uniform-column pattern with concrete metadata")
    out_dtype = out_dtype or b.dtype
    bs, nb = b.block_size, b.block_cols
    m_dim = a.shape[1] if transpose_a else a.shape[0]
    ak = a.shape[0] if transpose_a else a.shape[1]
    if ak != b.rows:
        raise ValueError(f"contraction mismatch: B gives k={b.rows}, A gives {ak}")
    idx2, pos = _dds_slots(b)
    w = idx2.shape[1]
    rhs = b.data[pos].reshape(nb, w * bs, bs)  # (cols, (slot, k), n)
    if transpose_a:  # A stored (K, M): strip k is A[k*bs:(k+1)*bs, :]^T
        a3 = a.reshape(b.rows // bs, bs, m_dim)
        lhs = a3[idx2].permute(0, 3, 1, 2).reshape(nb, m_dim, w * bs)
    else:
        a3 = a.reshape(m_dim, b.rows // bs, bs)
        lhs = a3[:, idx2].permute(1, 0, 2, 3).reshape(nb, m_dim, w * bs)
    out = _product(lhs, rhs, out_dtype)  # (cols, M, bs)
    return out.permute(1, 0, 2).reshape(m_dim, nb * bs)
