"""DSD (dense = sparse @ dense) and DDS (dense = dense @ sparse) on the
``bsr_dsd_stream`` CUDA kernel (``csrc/bsr_dsd.cu``).

Port of ``sputnik_tpu/kernels/bsr_dsd.py``. One kernel covers all four
transpose modes of both ops: DDS runs as ``C^T = op(B_bsr)^T @ op(A)^T``
through the same kernel with swapped operands and output strides. Sparse
data may carry one leading batch axis, as may the dense operand; a batch
of problems sharing one topology is one launch.

On CPU tensors :func:`dsd` and :func:`dds` compute the plain PyTorch version
(:func:`dsd_reference`, :func:`dds_reference`); on CUDA tensors they launch
the kernel, or raise for a problem the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build, reference

__all__ = ["dsd", "dds", "stream", "dsd_reference", "dds_reference", "LAUNCHES"]

# Kernel launches in this process; each launch of bsr_dsd_stream adds one.
LAUNCHES = 0

KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# The kernels' plain versions: densify, one fp32 matmul, cast.
dsd_reference = reference.dsd
dds_reference = reference.dds


@functools.cache
def _kernel():
    fn = _build.load("bsr_dsd").bsr_dsd_stream
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 6
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def _split_batch(x: torch.Tensor, ndim: int):
    """(batch, batch_stride) of a tensor with ``ndim`` core dims and at most
    one leading batch axis; an unbatched tensor has stride 0."""
    if x.ndim == ndim:
        return 1, 0
    if x.ndim == ndim + 1:
        return x.shape[0], x.stride(0)
    raise ValueError(f"expected {ndim} or {ndim + 1} dims, got shape {tuple(x.shape)}")


def _check_aligned(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"bsr_dsd_stream: {name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"bsr_dsd_stream: {name} must be 16-byte aligned")


def stream(
    sparse: BlockSparseMatrix,
    dense: torch.Tensor,
    out: torch.Tensor,
    *,
    transpose_sparse: bool,
    transpose_dense: bool,
    out_transposed: bool,
) -> None:
    """Launch ``bsr_dsd_stream``: ``op(sparse) @ op(dense)`` into ``out``.

    ``out`` is ``([batch,] M, N)``, or ``([batch,] N, M)`` with
    ``out_transposed`` (the DDS route). Raises ``ValueError`` for anything
    the kernel does not take: CPU tensors, other dtypes, block sizes other
    than 128, N not a multiple of 128, non-contiguous or misaligned data.
    """
    global LAUNCHES
    data = sparse.data
    for name, t in (("sparse data", data), ("dense", dense), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"bsr_dsd_stream needs CUDA tensors; {name} is on {t.device}")
    if dense.device != data.device or out.device != data.device:
        raise ValueError("bsr_dsd_stream: operands are on different devices")
    if data.dtype not in KERNEL_DTYPES or dense.dtype != data.dtype:
        raise ValueError(
            f"bsr_dsd_stream takes bf16 or fp32 operands of one dtype, got {data.dtype} and {dense.dtype}"
        )
    if out.dtype not in KERNEL_DTYPES:
        raise ValueError(f"bsr_dsd_stream: output dtype {out.dtype} not supported")
    bs = sparse.block_size
    if bs != 128:
        raise ValueError(f"bsr_dsd_stream: block size must be 128, got {bs}")
    m_dim = sparse.cols if transpose_sparse else sparse.rows
    k_dim = sparse.rows if transpose_sparse else sparse.cols
    n_dim = dense.shape[-2] if transpose_dense else dense.shape[-1]
    dk = dense.shape[-1] if transpose_dense else dense.shape[-2]
    if dk != k_dim:
        raise ValueError(f"bsr_dsd_stream: contraction mismatch, sparse gives k={k_dim}, dense {dk}")
    if n_dim % 128:
        raise ValueError(f"bsr_dsd_stream: N={n_dim} must be a multiple of 128")
    a_batch, a_bstride = _split_batch(data, 3)
    b_batch, b_bstride = _split_batch(dense, 2)
    c_batch, c_bstride = _split_batch(out, 2)
    batch = max(a_batch, b_batch)
    if {a_batch, b_batch} - {1, batch} or c_batch != batch:
        raise ValueError(
            f"bsr_dsd_stream: batch axes disagree (sparse {a_batch}, dense {b_batch}, out {c_batch})"
        )
    if a_batch == 1:
        a_bstride = 0
    if b_batch == 1:
        b_bstride = 0
    out_shape = (n_dim, m_dim) if out_transposed else (m_dim, n_dim)
    if tuple(out.shape[-2:]) != out_shape:
        raise ValueError(f"bsr_dsd_stream: out is {tuple(out.shape)}, expected {out_shape}")
    for name, t in (("sparse data", data), ("dense", dense), ("out", out)):
        _check_aligned(name, t)

    if transpose_sparse:
        m = sparse.with_transpose_metadata()
        groups, deps, positions = m.offsets_t, m.indices_t, m.block_offsets
    else:
        groups, deps, positions = sparse.offsets, sparse.indices, None
    for name, t in (("offsets", groups), ("indices", deps), ("block_offsets", positions)):
        if t is not None and (t.dtype != torch.int32 or t.device != data.device or not t.is_contiguous()):
            raise ValueError(f"bsr_dsd_stream: {name} must be contiguous int32 on {data.device}")
    n_groups = m_dim // bs
    if n_groups > 65535 or batch > 65535:
        raise ValueError("bsr_dsd_stream: more than 65535 block-rows or batch entries")
    # Element (i, j) of op(sparse) @ op(dense) goes to out[i * row + j * col].
    row_stride, col_stride = (1, m_dim) if out_transposed else (n_dim, 1)
    err = _kernel()(
        data.data_ptr(), groups.data_ptr(), deps.data_ptr(),
        None if positions is None else positions.data_ptr(),
        dense.data_ptr(), out.data_ptr(),
        n_groups, n_dim, batch,
        dense.stride(-2), row_stride, col_stride,
        a_bstride, b_bstride, c_bstride,
        int(data.dtype == torch.float32), int(out.dtype == torch.float32),
        int(transpose_sparse), int(transpose_dense),
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_dsd_stream launch failed: cudaError {err}")
    LAUNCHES += 1


def _batch_shape(*xs) -> tuple:
    return max((tuple(x) for x in xs), key=len)


def dsd(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
) -> torch.Tensor:
    """C[M, N] = op(A_sparse) @ op(B_dense)."""
    out_dtype = out_dtype or a.dtype
    if not a.data.is_cuda and not b.is_cuda:
        return dsd_reference(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype)
    m_dim = a.cols if transpose_a else a.rows
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    batch = _batch_shape(a.batch_shape, b.shape[:-2])
    out = torch.empty(batch + (m_dim, n_dim), dtype=out_dtype, device=a.device)
    stream(a, b, out, transpose_sparse=transpose_a, transpose_dense=transpose_b, out_transposed=False)
    return out


def dds(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
) -> torch.Tensor:
    """C[M, N] = op(A_dense) @ op(B_sparse), run as C^T = op(B)^T @ op(A)^T."""
    out_dtype = out_dtype or b.dtype
    if not a.is_cuda and not b.data.is_cuda:
        return dds_reference(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype)
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    n_dim = b.rows if transpose_b else b.cols
    batch = _batch_shape(b.batch_shape, a.shape[:-2])
    out = torch.empty(batch + (m_dim, n_dim), dtype=out_dtype, device=b.device)
    stream(b, a, out, transpose_sparse=not transpose_b, transpose_dense=not transpose_a, out_transposed=True)
    return out
