"""Sparse matrix formats and their metadata transforms, in PyTorch.

The counterpart of ``sputnik_tpu/formats.py``: the block-sparse
``BlockSparseMatrix`` and its metadata helpers, and the element-granular
``CsrMatrix`` with its padded-row ``EllMatrix`` and sliced-ELL
``SellMatrix`` clothing (see each class). The BSR contract is the same:

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
computed on the host when the matrix is built from numpy or CPU metadata,
before its tensors go to a device, so that no later call has to read the
device. Metadata already on a CUDA device (built there every step, as the
dropless MoE's is) is never read back: its hints are the caller's or
``None``, as the JAX package leaves them for traced metadata.

The same split decides routing. The JAX package plans exact work lists on
the host when metadata is concrete (not traced); the port's counterpart is
metadata known on the host: ``create`` keeps numpy copies of ``offsets``
and ``indices`` (``host_offsets`` / ``host_indices``) when it receives
numpy or CPU metadata, and every derived descriptor carries them. Planners
read those copies and never the card; a matrix whose metadata was built on
the card has none and takes the routes for traced metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sputnik_tpu_torch.utils.device import resolve_device

__all__ = [
    "BlockSparseMatrix",
    "bsr_from_dense",
    "bsr_to_dense",
    "build_transpose_metadata",
    "row_indices_from_offsets",
    "block_position_map",
    "block_bitmask",
    "sorted_row_swizzle",
    "CsrMatrix",
    "csr_from_dense",
    "csr_to_dense",
    "EllMatrix",
    "SellMatrix",
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


def sorted_row_swizzle(offsets: torch.Tensor) -> torch.Tensor:
    """Rows ordered by descending nonzero count, stable (Sputnik's
    ``SortedRowSwizzle``, ``matrix_utils.cu:348-363``), as int32."""
    row_nnz = offsets[1:] - offsets[:-1]
    return torch.argsort(-row_nnz, stable=True).to(torch.int32)


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


def block_position_map(offsets: torch.Tensor, indices: torch.Tensor, n_rows_b: int, n_cols_b: int) -> torch.Tensor:
    """Dense ``(n_rows_b, n_cols_b)`` int32 map: ``pos[r, c]`` is the index
    into ``data`` of block (r, c), or -1 when absent. Built on the metadata's
    device with one scatter-amax, so padding blocks at a duplicate (row,
    col) keep a valid id, as JAX's ``.at[].max`` does."""
    nnz = indices.shape[0]
    pos = torch.full((n_rows_b * n_cols_b,), -1, dtype=torch.int32, device=indices.device)
    if nnz:
        rows = row_indices_from_offsets(offsets, nnz).long()
        ids = torch.arange(nnz, dtype=torch.int32, device=indices.device)
        pos.scatter_reduce_(0, rows * n_cols_b + indices.long(), ids, reduce="amax")
    return pos.reshape(n_rows_b, n_cols_b)


def block_bitmask(offsets: torch.Tensor, indices: torch.Tensor, n_rows_b: int, n_cols_b: int) -> torch.Tensor:
    """Packed presence bitmask ``(n_rows_b, words)`` uint32: bit ``c % 32`` of
    word ``c // 32`` is set iff block (r, c) exists (rows padded to whole
    words), the JAX package's layout."""
    words = -(-n_cols_b // 32)
    present = block_position_map(offsets, indices, n_rows_b, n_cols_b) >= 0
    present = torch.nn.functional.pad(present, (0, words * 32 - n_cols_b))
    bits = present.reshape(n_rows_b, words, 32).long()
    shifts = torch.arange(32, device=bits.device)
    return (bits << shifts).sum(dim=2).to(torch.uint32)


def _np_transpose_metadata(offsets: np.ndarray, indices: np.ndarray, n_cols_b: int):
    """:func:`build_transpose_metadata` on host copies, in numpy: the same
    stable argsort, so the same arrays."""
    row_ids = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32), np.diff(offsets))
    order = np.argsort(indices, kind="stable").astype(np.int32)
    offsets_t = np.concatenate([[0], np.cumsum(np.bincount(indices, minlength=n_cols_b))]).astype(np.int32)
    return offsets_t, row_ids[order], order


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
    # Numpy copies of offsets / indices when the metadata was built on the
    # host (see the module docstring); None for metadata built on a card.
    host_offsets: Optional[np.ndarray] = dataclasses.field(default=None, compare=False, repr=False)
    host_indices: Optional[np.ndarray] = dataclasses.field(default=None, compare=False, repr=False)

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
        tensors; they are moved to ``data``'s device. The nnz hints are
        computed from numpy or CPU metadata. Metadata on a CUDA device is
        not read back (it may be built on the card every step, as the
        dropless MoE's is): the hints are then the caller's ``max_row_nnz``
        / ``max_col_nnz`` or ``None``, as the JAX package leaves them for
        traced metadata."""
        bs = int(data.shape[-1])
        if data.ndim not in (3, 4) or data.shape[-2] != bs:
            raise ValueError(f"data must be ([batch,] nnz_blocks, bs, bs), got {tuple(data.shape)}")
        if shape[0] % bs or shape[1] % bs:
            raise ValueError(f"shape {shape} not divisible by block_size {bs}")
        min_row_nnz = min_col_nnz = None
        off_np = idx_np = None
        if not any(isinstance(x, torch.Tensor) and x.is_cuda for x in (offsets, indices)):
            off_np = np.array(offsets.numpy() if isinstance(offsets, torch.Tensor) else offsets, np.int32)
            idx_np = np.array(indices.numpy() if isinstance(indices, torch.Tensor) else indices, np.int32)
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
            host_offsets=off_np,
            host_indices=idx_np,
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

    @property
    def host_known(self) -> bool:
        """Whether the metadata is known on the host (the JAX package's
        "concrete"): planners may read :meth:`host_metadata`."""
        return self.host_offsets is not None and self.host_indices is not None

    def host_metadata(self, transposed: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(offsets, dep ids, data ids) in numpy, in block-row order or
        (``transposed``) through the transpose metadata: (offsets_t,
        indices_t, block_offsets). Raises for metadata built on a card."""
        if not self.host_known:
            raise ValueError(
                "the metadata was built on a card and has no host copy; planning on the host needs "
                "numpy or CPU metadata (the routes for traced metadata take the rest)"
            )
        if transposed:
            return _np_transpose_metadata(self.host_offsets, self.host_indices, self.block_cols)
        return self.host_offsets, self.host_indices, np.arange(self.nnz_blocks, dtype=np.int32)

    def host_row_indices(self) -> np.ndarray:
        """Block-row id of every block, in numpy, from the host copies."""
        offs, _, _ = self.host_metadata()
        return np.repeat(np.arange(self.block_rows, dtype=np.int32), np.diff(offs))

    def position_map(self) -> torch.Tensor:
        """Dense (block_rows, block_cols) int32 position-or-minus-one map."""
        return block_position_map(self.offsets, self.indices, self.block_rows, self.block_cols)

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

    def transpose(self) -> "BlockSparseMatrix":
        """The transposed matrix, materialized (blocks moved AND transposed):
        a standalone BSR of shape (cols, rows), unlike
        :meth:`with_transpose_metadata`'s index indirection."""
        m = self.with_transpose_metadata()
        bo = m.block_offsets.long()
        host_offsets = host_indices = None
        if self.host_known:
            host_offsets, host_indices, _ = self.host_metadata(transposed=True)
        return BlockSparseMatrix(
            data=m.data[..., bo, :, :].transpose(-1, -2),
            offsets=m.offsets_t,
            indices=m.indices_t,
            row_indices=m.indices[bo],
            offsets_t=None,
            indices_t=None,
            block_offsets=None,
            shape=(self.shape[1], self.shape[0]),
            block_size=self.block_size,
            max_row_nnz=self.max_col_nnz,
            max_col_nnz=self.max_row_nnz,
            min_row_nnz=self.min_col_nnz,
            min_col_nnz=self.min_row_nnz,
            host_offsets=host_offsets,
            host_indices=host_indices,
        )

    def to_dense(self) -> torch.Tensor:
        return bsr_to_dense(self)

    def astype(self, dtype: torch.dtype) -> "BlockSparseMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def with_data(self, data: torch.Tensor) -> "BlockSparseMatrix":
        """Same topology, new block values; the batch axis may change."""
        if tuple(data.shape[-3:]) != tuple(self.data.shape[-3:]) or data.ndim not in (3, 4):
            raise ValueError(f"data shape {tuple(data.shape)} does not fit {tuple(self.data.shape)}")
        return dataclasses.replace(self, data=data)


def bsr_from_dense(x, block_size: int, *, prune_zero_blocks: bool = True, device=None) -> BlockSparseMatrix:
    """Dense (numpy or tensor) -> BSR, planned on the host: the number of
    nonzero blocks depends on the data. A numpy array goes to ``device``
    (``None``: the card); a tensor keeps its device unless ``device`` is
    given. The metadata is known on the host either way."""
    if isinstance(x, torch.Tensor):
        device = x.device if device is None else torch.device(device)
    else:
        device = resolve_device(device)
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
    return BlockSparseMatrix.create(data.to(device), offsets, c.astype(np.int32), (rows, cols))


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


# ---------------------------------------------------------------------------
# CsrMatrix, EllMatrix, SellMatrix: the element-granular CSR engine's formats
# ---------------------------------------------------------------------------


def _host_numpy(x) -> np.ndarray:
    """A tensor (any device; bf16 through fp32) or array as numpy. Reading a
    CUDA tensor here is construction on the host, not a kernel's hot path."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _max_row_nnz(offsets) -> Optional[int]:
    """The largest row length from numpy or CPU offsets; ``None`` for offsets
    on a CUDA device, which are not read back."""
    if isinstance(offsets, torch.Tensor) and offsets.is_cuda:
        return None
    counts = np.diff(_host_numpy(offsets))
    return int(counts.max()) if counts.size else 0


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Element-granular CSR matrix, the upstream-Sputnik format.

    Padding entries are legal: zero values with a valid duplicate column id
    (reference ``matrix_utils.cu:272-282``). ``dense_mirror`` (opt-in,
    :meth:`with_dense_mirror`) keeps a dense copy beside the sparse arrays
    for static matrices, so that SpMM becomes one dense matmul; the sparse
    arrays stay the source of truth. ``max_row_nnz`` is a host hint from
    numpy or CPU offsets (``None`` when they were built on the card); no op
    of ``ops.csr`` needs it.
    """

    values: torch.Tensor  # (nnz,)
    indices: torch.Tensor  # (nnz,) int32 column ids
    offsets: torch.Tensor  # (rows + 1,) int32
    row_indices: Optional[torch.Tensor]  # (nnz,) int32 row ids
    shape: Tuple[int, int]
    dense_mirror: Optional[torch.Tensor] = None  # (rows, cols), same dtype
    max_row_nnz: Optional[int] = None

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @staticmethod
    def create(values: torch.Tensor, indices, offsets, shape: Tuple[int, int], *,
               row_indices=None, max_row_nnz: Optional[int] = None) -> "CsrMatrix":
        """Metadata (numpy or tensors) goes to int32 on ``values``' device."""
        if max_row_nnz is None:
            max_row_nnz = _max_row_nnz(offsets)
        device = values.device
        offsets = _as_int32(offsets, device)
        indices = _as_int32(indices, device)
        if row_indices is None:
            row_indices = row_indices_from_offsets(offsets, int(values.shape[0]))
        return CsrMatrix(
            values=values, indices=indices, offsets=offsets,
            row_indices=_as_int32(row_indices, device),
            shape=(int(shape[0]), int(shape[1])), max_row_nnz=max_row_nnz,
        )

    def with_values(self, values: torch.Tensor) -> "CsrMatrix":
        if tuple(values.shape) != tuple(self.values.shape):
            raise ValueError(f"values shape {tuple(values.shape)} != {tuple(self.values.shape)}")
        # New values invalidate a cached mirror.
        return dataclasses.replace(self, values=values, dense_mirror=None)

    def with_dense_mirror(self) -> "CsrMatrix":
        """Attach a dense copy for the dense-matmul fast path; idempotent."""
        if self.dense_mirror is not None:
            return self
        return dataclasses.replace(self, dense_mirror=csr_to_dense(self))

    def astype(self, dtype: torch.dtype) -> "CsrMatrix":
        mirror = None if self.dense_mirror is None else self.dense_mirror.to(dtype)
        return dataclasses.replace(self, values=self.values.to(dtype), dense_mirror=mirror)

    def to_dense(self) -> torch.Tensor:
        return csr_to_dense(self)

    def transpose(self) -> "CsrMatrix":
        offsets_t, indices_t, order = build_transpose_metadata(self.offsets, self.indices, self.cols)
        order = order.long()
        return CsrMatrix(
            values=self.values[order], indices=indices_t, offsets=offsets_t,
            row_indices=self.indices[order], shape=(self.shape[1], self.shape[0]),
            max_row_nnz=_max_row_nnz(offsets_t),
        )


def csr_from_dense(x, *, pad_rows_to: int = 1, device=None) -> CsrMatrix:
    """Dense -> CSR on the host, optionally padding each row's nnz to a
    multiple of ``pad_rows_to`` with zero-valued duplicate-column entries
    (reference ``matrix_utils.cu:267-287``). A tensor keeps its device and
    dtype; a numpy array goes to ``device`` (``None``: the card)."""
    if isinstance(x, torch.Tensor):
        device, dtype = x.device, x.dtype
    else:
        device, dtype = resolve_device(device), None
    x = _host_numpy(x)
    rows, cols = x.shape
    vals, idxs, counts = [], [], np.zeros(rows, np.int64)
    for r in range(rows):
        (cidx,) = np.nonzero(x[r])
        v = x[r][cidx]
        pad = (-len(cidx)) % pad_rows_to
        if pad:
            pad_col = cidx[-1] if len(cidx) else 0
            cidx = np.concatenate([cidx, np.full(pad, pad_col, cidx.dtype if len(cidx) else np.int64)])
            v = np.concatenate([v, np.zeros(pad, x.dtype)])
        vals.append(v)
        idxs.append(cidx)
        counts[r] = len(cidx)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    values = np.concatenate(vals) if vals else np.zeros((0,), x.dtype)
    indices = np.concatenate(idxs).astype(np.int32) if idxs else np.zeros((0,), np.int32)
    values = torch.as_tensor(values).to(device=device, dtype=dtype)
    return CsrMatrix.create(values, indices, offsets, (rows, cols))


def csr_to_dense(m: CsrMatrix) -> torch.Tensor:
    """Densify; duplicate (row, col) entries accumulate."""
    dense = torch.zeros(m.shape, dtype=m.dtype, device=m.device)
    return dense.index_put_((m.row_indices.long(), m.indices.long()), m.values, accumulate=True)


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELL (padded rows): ``values`` / ``indices`` are ``(rows, width)`` with
    per-row occupancy ``row_nnz``. Padding slots hold value 0 and column 0
    (inert in products, masked in the softmax)."""

    values: torch.Tensor  # (rows, width)
    indices: torch.Tensor  # (rows, width) int32
    row_nnz: torch.Tensor  # (rows,) int32
    shape: Tuple[int, int]

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def nnz(self) -> int:  # padded
        return self.values.shape[0] * self.values.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def valid_mask(self) -> torch.Tensor:
        w = torch.arange(self.width, dtype=torch.int32, device=self.row_nnz.device)
        return w[None, :] < self.row_nnz[:, None]

    def with_values(self, values: torch.Tensor) -> "EllMatrix":
        if tuple(values.shape) != tuple(self.values.shape):
            raise ValueError(f"values shape {tuple(values.shape)} != {tuple(self.values.shape)}")
        return dataclasses.replace(self, values=values)

    def astype(self, dtype: torch.dtype) -> "EllMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))

    @staticmethod
    def from_csr(m: CsrMatrix, width: Optional[int] = None) -> "EllMatrix":
        """CSR -> ELL on the host (numpy), on the CSR's device; ``width``
        defaults to the longest row. A CSR on the card is read back for
        this: construction, not the hot path."""
        o = _host_numpy(m.offsets).astype(np.int64)
        counts = o[1:] - o[:-1]
        w = int(counts.max()) if width is None else int(width)
        slots = np.minimum(o[:-1, None] + np.arange(w)[None, :], max(int(o[-1]) - 1, 0))
        valid = np.arange(w)[None, :] < counts[:, None]
        vals = np.where(valid, _host_numpy(m.values)[slots], 0).astype(np.float32)
        idx = np.where(valid, _host_numpy(m.indices)[slots], 0).astype(np.int32)
        return EllMatrix(
            values=torch.as_tensor(vals).to(device=m.device, dtype=m.dtype),
            indices=torch.as_tensor(idx).to(m.device),
            row_nnz=torch.as_tensor(counts.astype(np.int32)).to(m.device),
            shape=m.shape,
        )

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        r = torch.arange(self.rows, device=self.device)[:, None].expand(self.values.shape)
        vals = torch.where(self.valid_mask(), self.values, torch.zeros((), dtype=self.dtype, device=self.device))
        return dense.index_put_((r.reshape(-1), self.indices.reshape(-1).long()), vals.reshape(-1),
                                accumulate=True)


# chunk="auto" crossover (the JAX package's, measured there on a TPU): below
# this many nonzeros per (row, 128-column chunk) the 64-wide chunk is taken.
_AUTO_CHUNK_CROSSOVER = 9.0


@dataclasses.dataclass(frozen=True)
class SellMatrix:
    """Sliced-ELL: nonzeros grouped by ``chunk``-column chunk of the
    contraction dimension, stored slot-major.

    ``values`` / ``indices`` are ``(n_chunks, width, rows_padded)``: for a
    fixed slot the rows are contiguous, so a kernel that gives neighbouring
    threads neighbouring rows reads them coalesced. ``indices`` hold the
    column id within the chunk (0..chunk-1); padding slots carry the
    sentinel ``chunk``. Rows are padded to a multiple of 128 (``pad_rows``
    extra, all sentinel). ``tile_widths`` is the largest slot count of each
    (chunk, 128-row tile), ``slot_counts`` each (chunk, storage row)'s count:
    slots ``0 .. count - 1`` are the valid ones (construction keeps CSR
    order, so valid slots are a prefix of the width axis). With
    ``sort_rows`` (Sputnik's SortedRowSwizzle) storage row ``r`` holds
    logical row ``row_perm[r]``; the ops take inputs and give outputs in
    logical row order.
    """

    values: torch.Tensor  # (n_chunks, width, rows_padded)
    indices: torch.Tensor  # (n_chunks, width, rows_padded) int32; `chunk` = padding
    shape: Tuple[int, int]  # logical (rows, cols)
    chunk: int  # column-chunk width
    pad_rows: int  # rows_padded - rows
    tile_widths: Optional[torch.Tensor] = None  # (n_chunks, rows_padded // 128) int32
    row_perm: Optional[torch.Tensor] = None  # (rows_padded,) int32
    slot_counts: Optional[torch.Tensor] = None  # (n_chunks, rows_padded) int32

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def rows_padded(self) -> int:
        return self.values.shape[2]

    @property
    def n_chunks(self) -> int:
        return self.values.shape[0]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def nnz(self) -> int:  # padded slot count
        return int(np.prod(tuple(self.values.shape)))

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def valid_mask(self) -> torch.Tensor:
        return self.indices < self.chunk

    def with_values(self, values: torch.Tensor) -> "SellMatrix":
        if tuple(values.shape) != tuple(self.values.shape):
            raise ValueError(f"values shape {tuple(values.shape)} != {tuple(self.values.shape)}")
        return dataclasses.replace(self, values=values)

    def astype(self, dtype: torch.dtype) -> "SellMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))

    @staticmethod
    def from_csr(m: CsrMatrix, *, chunk=128, sort_rows: bool = False) -> "SellMatrix":
        """CSR -> sliced-ELL on the host (numpy), the JAX package's algorithm
        step for step, on the CSR's device. Stable: the slots of a (row,
        chunk) group keep CSR order. ``chunk="auto"`` takes 64 below
        ``_AUTO_CHUNK_CROSSOVER`` nonzeros per (row, 128 columns), else 128.
        A CSR on the card is read back for this: construction, not the hot
        path."""
        rows, cols = m.shape
        if chunk == "auto":
            nnz_per_row_chunk128 = m.nnz / max(rows, 1) * 128.0 / max(cols, 1)
            chunk = 64 if nnz_per_row_chunk128 < _AUTO_CHUNK_CROSSOVER else 128
        rows_p = max(-(-rows // 128) * 128, 128)
        n_chunks = max(-(-cols // chunk), 1)
        vals = _host_numpy(m.values).astype(np.float32)
        cidx = _host_numpy(m.indices)
        ridx = _host_numpy(m.row_indices).astype(np.int64)

        row_perm = None
        if sort_rows:
            offs = _host_numpy(m.offsets)
            lens = offs[1:] - offs[:-1]
            order_rows = np.argsort(-lens, kind="stable").astype(np.int32)
            row_perm = np.concatenate([order_rows, np.arange(rows, rows_p, dtype=np.int32)])
            inv = np.empty(rows, np.int64)
            inv[order_rows] = np.arange(rows)
            ridx = inv[ridx]  # storage row of each nonzero

        chunk_of = cidx // chunk
        order = np.lexsort((np.arange(len(cidx)), chunk_of, ridx))
        r_s, ch_s = ridx[order], chunk_of[order]
        c_s, v_s = (cidx[order] % chunk).astype(np.int32), vals[order]
        key = r_s * n_chunks + ch_s
        if len(key):
            newgrp = np.concatenate([[True], key[1:] != key[:-1]])
            grp_start = np.maximum.accumulate(np.where(newgrp, np.arange(len(key)), 0))
            slot = np.arange(len(key)) - grp_start
            width = int(slot.max()) + 1
        else:
            slot = np.zeros((0,), np.int64)
            width = 1
        sv = np.zeros((n_chunks, width, rows_p), np.float32)
        sc = np.full((n_chunks, width, rows_p), chunk, np.int32)
        sv[ch_s, slot, r_s] = v_s
        sc[ch_s, slot, r_s] = c_s
        counts = np.zeros((n_chunks, rows_p), np.int32)
        np.add.at(counts, (ch_s, r_s), 1)
        tw = counts.reshape(n_chunks, rows_p // 128, 128).max(axis=2)
        device = m.device
        return SellMatrix(
            values=torch.as_tensor(sv).to(device=device, dtype=m.dtype),
            indices=torch.as_tensor(sc).to(device),
            shape=(rows, cols),
            chunk=int(chunk),
            pad_rows=rows_p - rows,
            tile_widths=torch.as_tensor(tw).to(device),
            row_perm=None if row_perm is None else torch.as_tensor(row_perm).to(device),
            slot_counts=torch.as_tensor(counts).to(device),
        )

    def to_dense(self) -> torch.Tensor:
        nc, w, rp = self.values.shape
        dense = torch.zeros((nc, self.chunk + 1, rp), dtype=self.dtype, device=self.device)
        ch = torch.arange(nc, device=self.device)[:, None, None].expand(nc, w, rp)
        rr = torch.arange(rp, device=self.device)[None, None, :].expand(nc, w, rp)
        dense.index_put_((ch.reshape(-1), self.indices.reshape(-1).long(), rr.reshape(-1)),
                         self.values.reshape(-1), accumulate=True)
        full = dense[:, : self.chunk, :].permute(2, 0, 1).reshape(rp, nc * self.chunk)
        if self.row_perm is not None:  # storage row r holds logical row perm[r]
            full = torch.zeros_like(full).index_copy_(0, self.row_perm.long(), full)
        return full[: self.rows, : self.cols]
