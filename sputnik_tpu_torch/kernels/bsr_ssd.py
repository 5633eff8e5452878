"""SSD (sparse = sparse @ dense) and SDS (sparse = dense @ sparse),
output-stationary, on the ``bsr_sparse_out`` CUDA kernel
(``csrc/bsr_ssd.cu``).

Port of ``sputnik_tpu/kernels/bsr_ssd.py``: one CTA per output block loops
over the stream operand's blocks in that block's row (SSD) or column
(SDS), a trip count read from the metadata on the card, so this route
needs no host plan: it takes metadata built on the card. ``max_steps``
caps the trip count as the TPU grid's step axis does (default: the
stream's row / column hint, else the full block dimension).

On CPU tensors :func:`ssd` and :func:`sds` compute the plain PyTorch
version (:func:`sparse_out_reference`), from the same metadata; on CUDA
tensors they launch the kernel, or raise for a problem it does not take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.bsr_flat import (
    KIND_SDS, KIND_SSD, block_products, check_metadata, check_operands, sparse_out_shapes,
)

__all__ = ["ssd", "sds", "sparse_out_reference", "LAUNCHES"]

# Kernel launches in this process; each launch of bsr_sparse_out adds one.
LAUNCHES = 0


@functools.cache
def _kernel():
    fn = _build.load("bsr_ssd").bsr_sparse_out
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong]
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def _stream_arrays(stream: BlockSparseMatrix, transposed: bool):
    """(offsets, dep ids, data ids or None) of the stream on its device."""
    if transposed:
        m = stream.with_transpose_metadata()
        return m.offsets_t, m.indices_t, m.block_offsets
    return stream.offsets, stream.indices, None


def _max_steps(stream: BlockSparseMatrix, transposed: bool, max_steps: Optional[int]) -> int:
    if max_steps is None:
        hint = stream.max_col_nnz if transposed else stream.max_row_nnz
        max_steps = hint if hint is not None else (stream.block_rows if transposed else stream.block_cols)
    return max(int(max_steps), 1)


def sparse_out_reference(kind: int, stream: BlockSparseMatrix, dense: torch.Tensor, topology: BlockSparseMatrix,
                         *, stream_transposed: bool, max_steps: int, transpose_a: bool,
                         transpose_b: bool) -> torch.Tensor:
    """The plain version of ``bsr_sparse_out``: fp32 ``(nnz_out, bs, bs)``
    from the same metadata, each output block's first ``max_steps`` stream
    blocks of its group. Reads the item count back from the device."""
    offs, dep, data = _stream_arrays(stream, stream_transposed)
    if kind == KIND_SSD:
        group_of, other_of = topology.row_indices, topology.indices
    else:
        group_of, other_of = topology.indices, topology.row_indices
    g = group_of.long()
    counts = torch.clamp(offs[g + 1] - offs[g], max=max_steps).long()
    out_ids = torch.repeat_interleave(torch.arange(topology.nnz_blocks, device=offs.device), counts)
    starts = torch.cumsum(counts, 0) - counts
    pos = offs[g].long()[out_ids] + torch.arange(out_ids.numel(), device=offs.device) - starts[out_ids]
    data_ids = pos if data is None else data.long()[pos]
    return block_products(kind, stream.data, dense, data_ids, dep.long()[pos], other_of.long()[out_ids], out_ids,
                          topology.nnz_blocks, transpose_a=transpose_a, transpose_b=transpose_b)


def _sparse_out(kind: int, stream: BlockSparseMatrix, dense: torch.Tensor, topology: BlockSparseMatrix, *,
                stream_transposed: bool, transpose_a: bool, transpose_b: bool, out_dtype,
                max_steps: Optional[int]) -> BlockSparseMatrix:
    global LAUNCHES
    nnz_c, bs = topology.nnz_blocks, topology.block_size
    steps = _max_steps(stream, stream_transposed, max_steps)
    if not stream.data.is_cuda and not dense.is_cuda:
        sums = sparse_out_reference(kind, stream, dense, topology, stream_transposed=stream_transposed,
                                    max_steps=steps, transpose_a=transpose_a, transpose_b=transpose_b)
        return topology.with_data(sums.to(out_dtype))
    out = torch.empty((nnz_c, bs, bs), dtype=out_dtype, device=stream.device)
    check_operands("bsr_sparse_out", [("stream", stream.data), ("dense", dense)], out, sparse=(stream, topology))
    offs, dep, data = _stream_arrays(stream, stream_transposed)
    group_of, other_of = ((topology.row_indices, topology.indices) if kind == KIND_SSD
                          else (topology.indices, topology.row_indices))
    check_metadata("bsr_sparse_out", out.device, offs, dep, data, group_of, other_of)
    if nnz_c == 0:
        return topology.with_data(out)
    err = _kernel()(
        stream.data.data_ptr(), dense.data_ptr(), out.data_ptr(),
        group_of.data_ptr(), other_of.data_ptr(), offs.data_ptr(), dep.data_ptr(),
        None if data is None else data.data_ptr(),
        nnz_c, steps, kind, dense.shape[-1],
        int(stream.dtype == torch.float32), int(out_dtype == torch.float32),
        int(transpose_a), int(transpose_b),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_sparse_out launch failed: cudaError {err}")
    LAUNCHES += 1
    return topology.with_data(out)


def ssd(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    max_steps: Optional[int] = None,
) -> BlockSparseMatrix:
    """C_sparse = op(A_sparse) @ op(B_dense), masked to ``topology``."""
    sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    return _sparse_out(KIND_SSD, a, b, topology, stream_transposed=transpose_a, transpose_a=transpose_a,
                       transpose_b=transpose_b, out_dtype=out_dtype or topology.dtype, max_steps=max_steps)


def sds(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    max_steps: Optional[int] = None,
) -> BlockSparseMatrix:
    """C_sparse = op(A_dense) @ op(B_sparse), masked to ``topology``. B
    streams grouped by op(B)'s column: a non-transposed B iterates through
    its transpose metadata."""
    sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    return _sparse_out(KIND_SDS, b, a, topology, stream_transposed=not transpose_b, transpose_a=transpose_a,
                       transpose_b=transpose_b, out_dtype=out_dtype or topology.dtype, max_steps=max_steps)
