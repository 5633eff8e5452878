"""SDD (sparse = dense @ dense, masked to a topology) on the ``bsr_sdd``
CUDA kernel (``csrc/bsr_sdd.cu``).

Port of ``sputnik_tpu/kernels/bsr_sdd.py`` (``sdd`` and ``sdd_panel``): one
CTA per nonzero output block, full-K loop, output written in the topology's
packed data order. The dense operands may carry one leading batch axis
(attention heads); the output data then has it too.

On CPU tensors :func:`sdd` computes the plain PyTorch version
(:func:`sdd_reference`); on CUDA tensors it launches the kernel, or raises
for a problem the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build, reference

__all__ = ["sdd", "launch", "sdd_reference", "LAUNCHES"]

# Kernel launches in this process; each launch of bsr_sdd adds one.
LAUNCHES = 0

KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# The kernel's plain version: one fp32 dense matmul, then the topology's blocks.
sdd_reference = reference.sdd


@functools.cache
def _kernel():
    fn = _build.load("bsr_sdd").bsr_sdd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 5
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def _batch(x: torch.Tensor):
    if x.ndim == 2:
        return 1, 0
    if x.ndim == 3:
        return x.shape[0], x.stride(0)
    raise ValueError(f"bsr_sdd: expected 2 or 3 dims, got shape {tuple(x.shape)}")


def launch(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    out: torch.Tensor,
    *,
    transpose_a: bool,
    transpose_b: bool,
) -> None:
    """Launch ``bsr_sdd``: the blocks of ``op(a) @ op(b)`` at ``topology``
    into ``out`` (``([batch,] nnz, 128, 128)``). Raises ``ValueError`` for
    anything the kernel does not take: CPU tensors, other dtypes, block sizes
    other than 128, K not a multiple of 128, non-contiguous or misaligned data.
    """
    global LAUNCHES
    for name, t in (("a", a), ("b", b), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"bsr_sdd needs CUDA tensors; {name} is on {t.device}")
        if t.device != a.device:
            raise ValueError("bsr_sdd: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bsr_sdd: {name} must be contiguous and 16-byte aligned")
    if a.dtype not in KERNEL_DTYPES or b.dtype != a.dtype:
        raise ValueError(f"bsr_sdd takes bf16 or fp32 operands of one dtype, got {a.dtype} and {b.dtype}")
    if out.dtype not in KERNEL_DTYPES:
        raise ValueError(f"bsr_sdd: output dtype {out.dtype} not supported")
    bs = topology.block_size
    if bs != 128:
        raise ValueError(f"bsr_sdd: block size must be 128, got {bs}")
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    k_dim = a.shape[-2] if transpose_a else a.shape[-1]
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    kb = b.shape[-1] if transpose_b else b.shape[-2]
    if kb != k_dim:
        raise ValueError(f"bsr_sdd: contraction mismatch, A gives k={k_dim}, B gives {kb}")
    if (m_dim, n_dim) != topology.shape:
        raise ValueError(f"bsr_sdd: output shape {(m_dim, n_dim)} != topology {topology.shape}")
    if k_dim % 128:
        raise ValueError(f"bsr_sdd: K={k_dim} must be a multiple of 128")
    a_batch, a_bstride = _batch(a)
    b_batch, b_bstride = _batch(b)
    batch = max(a_batch, b_batch)
    if {a_batch, b_batch} - {1, batch}:
        raise ValueError(f"bsr_sdd: batch axes disagree ({a_batch} and {b_batch})")
    out_shape = ((batch,) if a.ndim == 3 or b.ndim == 3 else ()) + (topology.nnz_blocks, bs, bs)
    if tuple(out.shape) != out_shape:
        raise ValueError(f"bsr_sdd: out is {tuple(out.shape)}, expected {out_shape}")
    if batch > 65535:
        raise ValueError("bsr_sdd: more than 65535 batch entries")
    rows, cols = topology.row_indices, topology.indices
    for name, t in (("row_indices", rows), ("indices", cols)):
        if t.dtype != torch.int32 or t.device != a.device or not t.is_contiguous():
            raise ValueError(f"bsr_sdd: {name} must be contiguous int32 on {a.device}")
    err = _kernel()(
        a.data_ptr(), b.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
        topology.nnz_blocks, k_dim, batch,
        a.stride(-2), b.stride(-2),
        a_bstride if a_batch > 1 else 0, b_bstride if b_batch > 1 else 0,
        out.stride(0) if out.ndim == 4 else 0,
        int(a.dtype == torch.float32), int(out.dtype == torch.float32),
        int(transpose_a), int(transpose_b),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_sdd launch failed: cudaError {err}")
    LAUNCHES += 1


def sdd(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
) -> BlockSparseMatrix:
    """C_sparse = op(A) @ op(B) masked to ``topology``; a new matrix sharing
    ``topology``'s metadata with freshly computed blocks."""
    out_dtype = out_dtype or topology.dtype
    if not a.is_cuda and not b.is_cuda:
        return sdd_reference(a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype)
    batch = max(tuple(a.shape[:-2]), tuple(b.shape[:-2]), key=len)
    bs = topology.block_size
    out = torch.empty(batch + (topology.nnz_blocks, bs, bs), dtype=out_dtype, device=a.device)
    launch(a, b, topology, out, transpose_a=transpose_a, transpose_b=transpose_b)
    return topology.with_data(out)
