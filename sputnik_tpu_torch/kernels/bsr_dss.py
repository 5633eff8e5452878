"""DSS (dense = sparse @ sparse) for metadata that is not planned on the
host, on the ``bsr_dss_masked`` and ``bsr_dss_worklist`` CUDA kernels
(``csrc/bsr_dss.cu``).

Port of ``sputnik_tpu/kernels/bsr_dss.py``:

* :func:`dss` streams op(A)'s row m against op(B)'s dense position map
  (``pos[k, n]``: B's block or -1), one CTA per (m, n) tile; absent blocks
  are skipped. The step count per tile is op(A)'s row extent, not the
  intersection size.
* :func:`dss_worklist` enumerates the exact intersection on the card with
  torch ops (:func:`build_dss_worklist`: cumsum / searchsorted decode of
  the per-k outer products, one stable argsort by output tile) into a list
  of static length W from the nnz hints (:func:`worklist_budget`), with
  no device read, and runs it through the kernel. The list is trimmed to
  the exact total only when the metadata is known on the host, as JAX
  trims only a concrete total. A :class:`DssWorklist` carries a signature
  that rejects its replay against another problem.

On CPU tensors both compute their kernel's plain PyTorch version from the
same position map or work list; on CUDA tensors they launch the kernel, or
raise for a problem it does not take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.bsr_flat import (
    KIND_BLOCKS, block_products, check_metadata, check_operands, product_shape, tiles_to_dense,
)

__all__ = [
    "dss", "dss_worklist", "worklist_budget", "build_dss_worklist", "DssWorklist",
    "masked_reference", "worklist_reference", "LAUNCHES",
]

# Kernel launches in this process, per kernel.
LAUNCHES = {"bsr_dss_masked": 0, "bsr_dss_worklist": 0}


@dataclasses.dataclass(frozen=True)
class DssWorklist:
    """A prebuilt DSS work list, tied to the topology pair it was built for.

    The ``signature`` (block size, block-grid dims and transpose flags) lets
    :func:`dss_worklist` reject a list replayed against a different
    problem. Iterating yields the five tensors."""

    out_sorted: torch.Tensor  # (W,) int32 output tile per item, non-decreasing
    a_ids: torch.Tensor  # (W,) int32 A block per item
    b_ids: torch.Tensor  # (W,) int32 B block per item
    flags: torch.Tensor  # (W,) int32, 1 = real item
    visited: torch.Tensor  # (n_tiles,) bool
    signature: tuple = dataclasses.field(default=(), compare=False)

    def __iter__(self):
        return iter((self.out_sorted, self.a_ids, self.b_ids, self.flags, self.visited))


def _dss_signature(a, b, transpose_a, transpose_b):
    bs = a.block_size
    return (bs, a.rows // bs, a.cols // bs, b.rows // bs, b.cols // bs, bool(transpose_a), bool(transpose_b))


@functools.cache
def _lib():
    lib = _build.load("bsr_dss")
    lib.bsr_dss_masked.restype = ctypes.c_int
    lib.bsr_dss_masked.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    lib.bsr_dss_worklist.restype = ctypes.c_int
    lib.bsr_dss_worklist.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return lib


def _row_stream(a: BlockSparseMatrix, transpose_a: bool):
    """op(A)'s row stream on its device: (offsets, k ids, data ids or None)."""
    if transpose_a:
        m = a.with_transpose_metadata()
        return m.offsets_t, m.indices_t, m.block_offsets
    return a.offsets, a.indices, None


def _op_b_position_map(b: BlockSparseMatrix, transpose_b: bool, pos_map: Optional[torch.Tensor]):
    """(position map, stride of k, stride of n) of op(B)'s (k, n) blocks;
    the map is B's own, the strides read it transposed when op(B) = B^T."""
    pos = b.position_map() if pos_map is None else pos_map
    return pos, *((1, b.block_cols) if transpose_b else (b.block_cols, 1))


# ----------------------------------------------------------------- masked --
def masked_reference(a: BlockSparseMatrix, b: BlockSparseMatrix, pos: torch.Tensor, *, transpose_a: bool,
                     transpose_b: bool, max_steps: int, m_blocks: int, n_blocks: int) -> torch.Tensor:
    """The plain version of ``bsr_dss_masked``: fp32 ``(m_blocks * n_blocks,
    bs, bs)`` tile sums, from the same row stream and position map: every
    (op(A) block in its row's first ``max_steps``, n) with ``pos >= 0``.
    Reads the item count back from the device."""
    offs, dep, data = _row_stream(a, transpose_a)
    nnz = dep.numel()
    rows = torch.searchsorted(offs.long(), torch.arange(nnz, device=offs.device), right=True) - 1
    in_cap = torch.arange(nnz, device=offs.device) - offs.long()[rows] < max_steps
    pos_kn = pos.T if transpose_b else pos
    hits = (pos_kn[dep.long()] >= 0) & in_cap[:, None]  # (nnz_a, n_blocks)
    s, n = hits.nonzero(as_tuple=True)
    a_ids = s if data is None else data.long()[s]
    b_ids = pos_kn[dep.long()[s], n].long()
    return block_products(KIND_BLOCKS, a.data, b.data, a_ids, b_ids, n, rows[s] * n_blocks + n,
                          m_blocks * n_blocks, transpose_a=transpose_a, transpose_b=transpose_b)


def dss(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    max_steps: Optional[int] = None,
    pos_map: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C[M, N] = op(A_sparse) @ op(B_sparse) on the position map of B
    (``pos_map``: a prebuilt ``b.position_map()``, else built here on B's
    device with no device read)."""
    out_dtype = out_dtype or a.dtype
    bs = a.block_size
    if b.block_size != bs:
        raise ValueError(f"block size mismatch: {bs} vs {b.block_size}")
    m_dim, n_dim = product_shape(a, b, transpose_a, transpose_b)
    m_blocks, n_blocks = m_dim // bs, n_dim // bs
    if max_steps is None:
        hint = a.max_col_nnz if transpose_a else a.max_row_nnz
        max_steps = hint if hint is not None else (a.rows if transpose_a else a.cols) // bs
    max_steps = max(int(max_steps), 1)
    pos, pos_k, pos_n = _op_b_position_map(b, transpose_b, pos_map)
    if not a.data.is_cuda and not b.data.is_cuda:
        sums = masked_reference(a, b, pos, transpose_a=transpose_a, transpose_b=transpose_b,
                                max_steps=max_steps, m_blocks=m_blocks, n_blocks=n_blocks)
        return tiles_to_dense(sums, m_blocks, n_blocks).to(out_dtype)
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=a.device)
    check_operands("bsr_dss_masked", [("a", a.data), ("b", b.data)], out, sparse=(a, b))
    offs, dep, data = _row_stream(a, transpose_a)
    check_metadata("bsr_dss_masked", out.device, offs, dep, data, pos)
    if m_blocks > 65535:
        raise ValueError("bsr_dss_masked: more than 65535 output block-rows")
    err = _lib().bsr_dss_masked(
        a.data.data_ptr(), b.data.data_ptr(), out.data_ptr(),
        offs.data_ptr(), dep.data_ptr(), None if data is None else data.data_ptr(), pos.data_ptr(),
        m_blocks, n_blocks, max_steps, pos_k, pos_n, n_dim,
        int(a.dtype == torch.float32), int(out_dtype == torch.float32), int(transpose_a), int(transpose_b),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_dss_masked launch failed: cudaError {err}")
    LAUNCHES["bsr_dss_masked"] += 1
    return out


# --------------------------------------------------------------- worklist --
def _per_k_arrays(s: BlockSparseMatrix, k_is_row: bool):
    """(k offsets, other ids, data ids): the operand's blocks grouped by
    their contraction block id k, on its device. ``k_is_row``: k indexes
    the stored block rows; else the stored block columns (through the
    transpose metadata)."""
    if k_is_row:
        return s.offsets, s.indices, torch.arange(s.nnz_blocks, dtype=torch.int32, device=s.indices.device)
    m = s.with_transpose_metadata()
    return m.offsets_t, m.indices_t, m.block_offsets


def worklist_budget(a: BlockSparseMatrix, b: BlockSparseMatrix, *, transpose_a: bool = False,
                    transpose_b: bool = False) -> Optional[int]:
    """Static upper bound on the exact DSS item count from the descriptors'
    nnz hints (None when a hint is absent): work = sum_k (#op(A) blocks in
    column k) * (#op(B) blocks in row k), bounded by min(nnz_a * max_b_per_k,
    nnz_b * max_a_per_k, k_blocks * max_a_per_k * max_b_per_k)."""
    max_a = a.max_row_nnz if transpose_a else a.max_col_nnz
    max_b = b.max_col_nnz if transpose_b else b.max_row_nnz
    if max_a is None or max_b is None:
        return None
    k_blocks = (a.rows if transpose_a else a.cols) // a.block_size
    return max(1, min(a.nnz_blocks * max_b, b.nnz_blocks * max_a, k_blocks * max_a * max_b))


def _host_total(a, b, transpose_a, transpose_b) -> int:
    """The exact item count from the host copies of the metadata."""
    def per_k(s, k_is_row):
        offs, idx = s.host_offsets, s.host_indices
        if k_is_row:
            return np.diff(offs).astype(np.int64)
        return np.bincount(idx, minlength=s.block_cols).astype(np.int64)

    return int((per_k(a, transpose_a) * per_k(b, not transpose_b)).sum())


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as int64; zeros when ``x`` is empty (an operand with no
    blocks: every slot is dead)."""
    return x.long()[idx] if x.numel() else torch.zeros_like(idx)


def build_dss_worklist(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    work_budget: Optional[int] = None,
) -> DssWorklist:
    """The merged DSS work list, built on the operands' device by torch ops
    with no device read: everything :func:`dss_worklist`'s kernel consumes,
    reusable across calls on the same topology pair. Dead slots past the
    true total carry the last real item's blocks and tile with flag 0."""
    bs = a.block_size
    if b.block_size != bs:
        raise ValueError(f"block size mismatch: {bs} vs {b.block_size}")
    m_dim, n_dim = product_shape(a, b, transpose_a, transpose_b)
    n_blocks = n_dim // bs
    n_tiles = (m_dim // bs) * n_blocks
    if work_budget is None:
        work_budget = worklist_budget(a, b, transpose_a=transpose_a, transpose_b=transpose_b)
        if work_budget is None:
            raise ValueError(
                "dss_worklist needs static nnz hints (BlockSparseMatrix.create computes them from host "
                "metadata; pass max_row_nnz / max_col_nnz or work_budget= for metadata built on a card)"
            )
    w = max(int(work_budget), 1)
    dev = a.indices.device
    # op(A) blocks grouped by k (op(A)'s columns), op(B) blocks by k (rows).
    a_offs, a_m, a_pos = _per_k_arrays(a, k_is_row=transpose_a)
    b_offs, b_n, b_pos = _per_k_arrays(b, k_is_row=not transpose_b)
    ca = (a_offs[1:] - a_offs[:-1]).long()
    rb = (b_offs[1:] - b_offs[:-1]).long()
    cum0 = torch.cat([torch.zeros((1,), dtype=torch.long, device=dev), torch.cumsum(ca * rb, 0)])
    total = cum0[-1]
    t = torch.arange(w, dtype=torch.long, device=dev)
    k_t = torch.clamp(torch.searchsorted(cum0, t, right=True) - 1, 0, ca.numel() - 1)
    valid = t < total
    r = t - cum0[k_t]
    rbk = torch.clamp(rb[k_t], min=1)
    a_slot = torch.clamp(a_offs.long()[k_t] + torch.div(r, rbk, rounding_mode="floor"), 0, max(a.nnz_blocks - 1, 0))
    b_slot = torch.clamp(b_offs.long()[k_t] + r % rbk, 0, max(b.nnz_blocks - 1, 0))
    out_id = torch.where(valid, _take(a_m, a_slot) * n_blocks + _take(b_n, b_slot), n_tiles)
    order = torch.argsort(out_id, stable=True)  # real items stay k-grouped per tile
    a_ids = _take(a_pos, a_slot)[order]
    b_ids = _take(b_pos, b_slot)[order]
    flags = valid[order]
    # Dead slots repeat the last real item (a (1,) index: no device read).
    last_real = torch.clamp(total - 1, min=0).reshape(1)
    out_sorted = torch.clamp(out_id[order], max=n_tiles - 1)
    out_sorted, a_ids, b_ids = (torch.where(flags, x, x.index_select(0, last_real))
                                for x in (out_sorted, a_ids, b_ids))
    visited = torch.zeros((n_tiles,), dtype=torch.int32, device=dev).index_add_(
        0, torch.where(valid, out_id, 0), valid.int()) > 0
    if a.host_known and b.host_known:
        # Metadata known on the host: trim to the exact intersection size
        # (the stable argsort put every real item first), as JAX trims
        # when the total is concrete.
        w_exact = max(_host_total(a, b, transpose_a, transpose_b), 1)
        if w_exact < w:
            out_sorted, a_ids, b_ids, flags = (x[:w_exact] for x in (out_sorted, a_ids, b_ids, flags))
    return DssWorklist(
        out_sorted.int(), a_ids.int(), b_ids.int(), flags.int(), visited,
        signature=_dss_signature(a, b, transpose_a, transpose_b),
    )


def worklist_reference(a: BlockSparseMatrix, b: BlockSparseMatrix, worklist: DssWorklist, *, transpose_a: bool,
                       transpose_b: bool, n_tiles: int) -> torch.Tensor:
    """The plain version of ``bsr_dss_worklist``: fp32 ``(n_tiles, bs, bs)``
    sums of the list's flag-1 items. Reads the item count back from the
    device."""
    live = worklist.flags.bool()
    return block_products(KIND_BLOCKS, a.data, b.data, worklist.a_ids.long()[live], worklist.b_ids.long()[live],
                          None, worklist.out_sorted.long()[live], n_tiles, transpose_a=transpose_a,
                          transpose_b=transpose_b)


def dss_worklist(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    work_budget: Optional[int] = None,
    worklist: Optional[DssWorklist] = None,
) -> torch.Tensor:
    """Exact-intersection DSS for metadata built on the card: the merged
    work list (``worklist``: a prebuilt :func:`build_dss_worklist` result
    for this pair, else built here) through ``bsr_dss_worklist``."""
    out_dtype = out_dtype or a.dtype
    bs = a.block_size
    if b.block_size != bs:
        raise ValueError(f"block size mismatch: {bs} vs {b.block_size}")
    m_dim, n_dim = product_shape(a, b, transpose_a, transpose_b)
    m_blocks, n_blocks = m_dim // bs, n_dim // bs
    if a.nnz_blocks == 0 or b.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=a.device)
    if worklist is None:
        worklist = build_dss_worklist(a, b, transpose_a=transpose_a, transpose_b=transpose_b,
                                      work_budget=work_budget)
    want = _dss_signature(a, b, transpose_a, transpose_b)
    if worklist.signature and worklist.signature != want:
        raise ValueError(
            "dss_worklist: cached work list was built for a different problem "
            f"(signature {worklist.signature}, this call is {want}); rebuild it with build_dss_worklist "
            "for this (a, b, transpose) combination"
        )
    if not a.data.is_cuda and not b.data.is_cuda:
        sums = worklist_reference(a, b, worklist, transpose_a=transpose_a, transpose_b=transpose_b,
                                  n_tiles=m_blocks * n_blocks)
        return tiles_to_dense(sums, m_blocks, n_blocks).to(out_dtype)
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=a.device)
    check_operands("bsr_dss_worklist", [("a", a.data), ("b", b.data)], out, sparse=(a, b))
    out_sorted, a_ids, b_ids, flags, visited = worklist
    check_metadata("bsr_dss_worklist", out.device, out_sorted, a_ids, b_ids, flags)
    if visited.dtype != torch.bool or visited.numel() != m_blocks * n_blocks or visited.device != out.device:
        raise ValueError(f"bsr_dss_worklist: visited must be ({m_blocks * n_blocks},) bool on {out.device}")
    w = int(out_sorted.shape[0])
    if w + m_blocks * n_blocks >= 2 ** 31:
        raise ValueError("bsr_dss_worklist: more than 2^31 CTAs")
    err = _lib().bsr_dss_worklist(
        a.data.data_ptr(), b.data.data_ptr(), out.data_ptr(),
        out_sorted.data_ptr(), a_ids.data_ptr(), b_ids.data_ptr(), flags.data_ptr(), visited.data_ptr(),
        w, m_blocks, n_blocks, n_dim,
        int(a.dtype == torch.float32), int(out_dtype == torch.float32), int(transpose_a), int(transpose_b),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_dss_worklist launch failed: cudaError {err}")
    LAUNCHES["bsr_dss_worklist"] += 1
    return out
