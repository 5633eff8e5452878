"""Block-sparse (BSR) matrix format and its metadata transforms, in PyTorch.

The counterpart of ``sputnik_tpu/formats.py`` (``BlockSparseMatrix`` and the
metadata helpers). The contract is the same:

  * ``offsets[i]``  int32 prefix sum of nonzero blocks per block-row,
    ``offsets[0] == 0``, ``offsets[-1] == nnz_blocks``.
  * ``indices[j]``  int32 block-column id of nonzero block ``j``; indices
    within a row may be unordered.
  * ``data``        ``(nnz_blocks, bs, bs)`` blocks in block-row order,
    row-major within a block. The port also allows one leading batch axis,
    ``(batch, nnz_blocks, bs, bs)``: a batch of matrices that share one
    topology (the heads of an attention layer).
  * Padding blocks (zero values at a duplicate (row, col)) are legal.

Metadata is int32 everywhere, as in the JAX package. The nnz hints are
computed on the host from numpy when the matrix is built, before its
tensors go to a device, so that no later call has to read the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "BlockSparseMatrix",
    "bsr_from_dense",
    "bsr_to_dense",
    "build_transpose_metadata",
    "row_indices_from_offsets",
]


def _as_int32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def row_indices_from_offsets(offsets: torch.Tensor, nnz: int) -> torch.Tensor:
    """Expand CSR-style ``offsets`` into the block-row id of every nonzero."""
    if nnz == 0:
        return torch.zeros((0,), dtype=torch.int32, device=offsets.device)
    ids = torch.arange(nnz, dtype=offsets.dtype, device=offsets.device)
    return (torch.searchsorted(offsets, ids, right=True) - 1).to(torch.int32)


def build_transpose_metadata(
    offsets: torch.Tensor, indices: torch.Tensor, n_cols_b: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(offsets_t, indices_t, block_offsets) for column-major iteration.

    ``block_offsets[s]`` is the position in ``data`` of the s-th block in
    column-major order (a stable argsort by column id), ``indices_t[s]`` its
    block-row id, and ``offsets_t`` the prefix sum of blocks per block-column.
    Values never move.
    """
    nnz = indices.shape[0]
    row_ids = row_indices_from_offsets(offsets, nnz)
    order = torch.argsort(indices, stable=True)
    # offsets_t[c] = blocks in columns < c: a search in the sorted column ids
    # (no atomics, and no device read as torch.bincount would need).
    cols = torch.arange(n_cols_b + 1, dtype=indices.dtype, device=indices.device)
    offsets_t = torch.searchsorted(indices[order].contiguous(), cols).to(torch.int32)
    return offsets_t, row_ids[order], order.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BlockSparseMatrix:
    """BSR matrix descriptor; see the module docstring for the contract."""

    data: torch.Tensor  # ([batch,] nnz_blocks, bs, bs)
    offsets: torch.Tensor  # (block_rows + 1,) int32
    indices: torch.Tensor  # (nnz_blocks,) int32 block-column ids
    row_indices: torch.Tensor  # (nnz_blocks,) int32 block-row ids
    offsets_t: Optional[torch.Tensor]  # (block_cols + 1,) int32
    indices_t: Optional[torch.Tensor]  # (nnz_blocks,) int32, column-major order
    block_offsets: Optional[torch.Tensor]  # (nnz_blocks,) int32, column-major order
    shape: Tuple[int, int]  # (rows, cols) in elements
    block_size: int
    max_row_nnz: Optional[int] = None
    max_col_nnz: Optional[int] = None
    min_row_nnz: Optional[int] = None
    min_col_nnz: Optional[int] = None

    # -- geometry -------------------------------------------------------------
    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.block_size

    @property
    def block_cols(self) -> int:
        return self.shape[1] // self.block_size

    @property
    def nnz_blocks(self) -> int:
        return self.data.shape[-3]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[:-3])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def density(self) -> float:
        return self.nnz_blocks / max(self.block_rows * self.block_cols, 1)

    # -- constructors ------------------------------------------------------------
    @staticmethod
    def create(
        data: torch.Tensor,
        offsets,
        indices,
        shape: Tuple[int, int],
        *,
        row_indices=None,
        with_transpose: bool = False,
        max_row_nnz: Optional[int] = None,
        max_col_nnz: Optional[int] = None,
    ) -> "BlockSparseMatrix":
        """Build a descriptor. ``offsets``/``indices`` may be numpy arrays or
        tensors; they are moved to ``data``'s device. The nnz hints are read
        from host copies, so build from numpy to avoid a device read."""
        bs = int(data.shape[-1])
        if data.ndim not in (3, 4) or data.shape[-2] != bs:
            raise ValueError(f"data must be ([batch,] nnz_blocks, bs, bs), got {tuple(data.shape)}")
        if shape[0] % bs or shape[1] % bs:
            raise ValueError(f"shape {shape} not divisible by block_size {bs}")
        off_np = offsets.cpu().numpy() if isinstance(offsets, torch.Tensor) else np.asarray(offsets)
        idx_np = indices.cpu().numpy() if isinstance(indices, torch.Tensor) else np.asarray(indices)
        counts = off_np[1:] - off_np[:-1]
        col_counts = np.bincount(idx_np.astype(np.int64), minlength=shape[1] // bs)
        if max_row_nnz is None:
            max_row_nnz = int(counts.max()) if counts.size else 0
        if max_col_nnz is None:
            max_col_nnz = int(col_counts.max()) if idx_np.size else 0
        min_row_nnz = int(counts.min()) if counts.size else 0
        min_col_nnz = int(col_counts.min()) if idx_np.size else 0
        device = data.device
        offsets = _as_int32(offsets, device)
        indices = _as_int32(indices, device)
        if row_indices is None:
            row_indices = row_indices_from_offsets(offsets, int(data.shape[-3]))
        m = BlockSparseMatrix(
            data=data,
            offsets=offsets,
            indices=indices,
            row_indices=_as_int32(row_indices, device),
            offsets_t=None,
            indices_t=None,
            block_offsets=None,
            shape=(int(shape[0]), int(shape[1])),
            block_size=bs,
            max_row_nnz=max_row_nnz,
            max_col_nnz=max_col_nnz,
            min_row_nnz=min_row_nnz,
            min_col_nnz=min_col_nnz,
        )
        return m.with_transpose_metadata() if with_transpose else m

    # -- metadata ----------------------------------------------------------------
    def with_transpose_metadata(self) -> "BlockSparseMatrix":
        """Attach (offsets_t, indices_t, block_offsets); idempotent."""
        if self.offsets_t is not None:
            return self
        offsets_t, indices_t, block_offsets = build_transpose_metadata(
            self.offsets, self.indices, self.block_cols
        )
        return dataclasses.replace(
            self, offsets_t=offsets_t, indices_t=indices_t, block_offsets=block_offsets
        )

    def iteration_arrays(self, transposed: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(row_ids, col_ids, data_ids) in kernel iteration order: block-row
        order, or (``transposed``) block-column order through the transpose
        metadata, where "row" means the transposed matrix's row."""
        if not transposed:
            return self.row_indices, self.indices, torch.arange(
                self.nnz_blocks, dtype=torch.int32, device=self.indices.device
            )
        m = self.with_transpose_metadata()
        t_rows = m.indices[m.block_offsets.long()]
        return t_rows, m.indices_t, m.block_offsets

    def to(self, device) -> "BlockSparseMatrix":
        """The same matrix with every tensor on ``device``."""
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **moved)

    def to_dense(self) -> torch.Tensor:
        return bsr_to_dense(self)

    def with_data(self, data: torch.Tensor) -> "BlockSparseMatrix":
        """Same topology, new block values; the batch axis may change."""
        if tuple(data.shape[-3:]) != tuple(self.data.shape[-3:]) or data.ndim not in (3, 4):
            raise ValueError(f"data shape {tuple(data.shape)} does not fit {tuple(self.data.shape)}")
        return dataclasses.replace(self, data=data)


def bsr_from_dense(x, block_size: int, *, prune_zero_blocks: bool = True) -> BlockSparseMatrix:
    """Dense (numpy or tensor) -> BSR, on the host: the number of nonzero
    blocks depends on the data."""
    device = x.device if isinstance(x, torch.Tensor) else None
    xn = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    rows, cols = xn.shape
    bs = block_size
    if rows % bs or cols % bs:
        raise ValueError(f"shape {tuple(xn.shape)} not divisible by block_size {bs}")
    br, bc = rows // bs, cols // bs
    blocks = xn.reshape(br, bs, bc, bs).permute(0, 2, 1, 3)
    if prune_zero_blocks:
        mask = (blocks.abs().sum(dim=(2, 3)) != 0).numpy()
    else:
        mask = np.ones((br, bc), dtype=bool)
    r, c = np.nonzero(mask)
    data = blocks[torch.as_tensor(r), torch.as_tensor(c)].contiguous()
    offsets = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=br))]).astype(np.int32)
    m = BlockSparseMatrix.create(data, offsets, c.astype(np.int32), (rows, cols))
    return m if device is None else m.to(device)


def bsr_to_dense(m: BlockSparseMatrix) -> torch.Tensor:
    """Densify; padding blocks accumulate, matching the reference convention.
    A batched matrix gives ``(batch, rows, cols)``."""
    bs, br, bc = m.block_size, m.block_rows, m.block_cols
    data = m.data.movedim(-3, 0)  # (nnz, [batch,] bs, bs)
    dense = torch.zeros((br, bc) + tuple(data.shape[1:]), dtype=m.dtype, device=m.device)
    dense.index_put_((m.row_indices.long(), m.indices.long()), data, accumulate=True)
    # (br, bc, [batch,] bs, bs) -> ([batch,] br, bs, bc, bs)
    dense = dense.movedim((0, 1), (-4, -2))
    return dense.reshape(tuple(data.shape[1:-2]) + (m.rows, m.cols))
