"""The ``bsr_dsd_pipelined`` CUDA kernel (``csrc/bsr_dsd_pipelined.cu``):
one CTA per output tile, the trip count read on the card, a 4-stage
``cp.async`` ring over the row's (block, k-chunk) sequence.

Port of ``sputnik_tpu/kernels/bsr_dsd_pipelined.py``'s kernel. Its DSD and
DDS are ``bsr_dsd.dsd`` / ``bsr_dsd.dds`` with ``launch=pipelined`` (the
registry's ``cuda_pipelined``): they share the stream kernel's shapes,
checks, batch axis, CPU plain version and DDS operand swap, and differ only
in the kernel launched. The kernel takes bf16 or fp32 operands of one dtype
(JAX's ``_PALLAS_DTYPES``) with a bf16 or fp32 output, in all four
transpose modes. A matrix with no nonzero blocks is zeros without a
launch, as JAX's is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.bsr_dsd import launch_args

__all__ = ["pipelined", "KINDS", "LAUNCHES"]

# Launches of bsr_dsd_pipelined in this process.
LAUNCHES = 0

# Operand / output dtype -> kernel code.
KINDS = {torch.bfloat16: 0, torch.float32: 1}


def _check_dtypes(operand, other, out) -> None:
    if operand not in KINDS or other != operand:
        raise ValueError(f"bsr_dsd_pipelined takes bf16 or fp32 operands of one dtype, got {operand} and {other}")
    if out not in KINDS:
        raise ValueError(f"bsr_dsd_pipelined: output dtype {out} not supported (bf16 or fp32)")


@functools.cache
def _kernel():
    fn = _build.load("bsr_dsd_pipelined").bsr_dsd_pipelined
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 6
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def pipelined(
    sparse: BlockSparseMatrix,
    dense: torch.Tensor,
    out: torch.Tensor,
    *,
    transpose_sparse: bool,
    transpose_dense: bool,
    out_transposed: bool,
    out_scale=None,
) -> None:
    """Launch ``bsr_dsd_pipelined``: ``op(sparse) @ op(dense)`` into ``out``
    (``([batch,] M, N)``, or ``([batch,] N, M)`` with ``out_transposed``),
    the launcher ``bsr_dsd.dsd`` / ``dds`` take. Raises ``ValueError`` for
    what the kernel does not take (``bsr_dsd.launch_args``; dtypes other
    than bf16 / fp32; an ``out_scale``, which only the stream kernel
    applies)."""
    global LAUNCHES
    if out_scale is not None:
        raise ValueError("bsr_dsd_pipelined takes no out_scale (the int8 path runs on bsr_dsd_stream)")
    if sparse.nnz_blocks == 0:
        out.zero_()
        return
    args = launch_args(
        "bsr_dsd_pipelined", sparse, dense, out, transpose_sparse=transpose_sparse,
        transpose_dense=transpose_dense, out_transposed=out_transposed, check_dtypes_fn=_check_dtypes,
    )
    err = _kernel()(
        *args, KINDS[sparse.dtype], KINDS[out.dtype], int(transpose_sparse), int(transpose_dense),
        torch.cuda.current_stream(sparse.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_dsd_pipelined launch failed: cudaError {err}")
    LAUNCHES += 1
