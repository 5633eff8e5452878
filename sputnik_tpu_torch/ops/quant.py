"""Symmetric int8 quantized BSR SpMM, the serving path
(``sputnik_tpu/ops/quant.py``).

int8 operands run on the tensor cores' integer path with an exact int32
accumulator, and the dequantization scale ``scale_a * scale_b`` is applied
at the kernel's flush, so the output leaves the kernel in the serving dtype
(``bsr_dsd_stream`` with ``kernel="stream"``, ``bsr_bres`` with
``kernel="bres"``; on CPU tensors their plain versions). Per-block-row
scales take the raw int32 out of the kernel and one elementwise scale and
cast after it.

Quantization is symmetric: ``q = clip(round(x / scale), -127, 127)`` with
``scale = max|x| / 127``, the division in fp32 by the fp32-rounded scale
and ``torch.round`` rounding half to even, as the JAX package's
weak-typed divide and ``jnp.round`` do, so both give the same int8 values.
``quantize`` / ``quantize_bsr`` read the absmax back (offline weight
preparation); the matmuls read nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_qstream

__all__ = ["quantize", "quantize_bsr", "matmul_dsd_q8", "matmul_dds_q8"]

_DSD_KERNELS = {"stream": bsr_dsd.dsd, "bres": bsr_qstream.dsd_bres}
_DDS_KERNELS = {"stream": bsr_dsd.dds, "bres": bsr_qstream.dds_bres}


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=like.device)


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale)) as contiguous int8, whatever ``x``'s layout
    (the kernels take contiguous operands)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8).contiguous()


def quantize(x: torch.Tensor):
    """Symmetric per-tensor int8: ``(q, scale)`` with ``x ~= q * scale``
    (``scale`` a Python float). Reads the absmax back."""
    amax = float(x.float().abs().max())
    scale = (amax / 127.0) if amax > 0 else 1.0
    return _to_int8(x, _f32(scale, x)), scale


def quantize_bsr(m: BlockSparseMatrix, *, per: str = "tensor"):
    """Quantize a BSR matrix's block values, metadata unchanged.

    ``per="tensor"``: one Python float scale (dequantized in the kernel's
    flush). ``per="block_row"``: a ``(block_rows,)`` fp32 tensor of scales,
    tighter for rows of unequal magnitude; dequantized by one elementwise
    pass over the output."""
    if per == "tensor":
        q, scale = quantize(m.data)
        return m.with_data(q), scale
    if per != "block_row":
        raise ValueError(f"per must be 'tensor' or 'block_row', got {per!r}")
    block_max = m.data.float().abs().amax(dim=(1, 2))
    rows = m.row_indices.long()
    amax = torch.zeros(m.block_rows, dtype=torch.float32, device=m.device).scatter_reduce(
        0, rows, block_max, reduce="amax", include_self=True)
    scales = torch.where(amax > 0, amax / _f32(127.0, amax), torch.ones_like(amax))
    return m.with_data(_to_int8(m.data, scales[rows][:, None, None])), scales


def _check_int8(name: str, sparse: BlockSparseMatrix, dense: torch.Tensor) -> None:
    if sparse.dtype != torch.int8 or dense.dtype != torch.int8:
        raise ValueError(f"{name} takes int8 operands, got {sparse.dtype}/{dense.dtype}")


def _kernel(table: dict, kernel: str):
    if kernel not in table:
        raise ValueError(f"kernel must be one of {sorted(table)}, got {kernel!r}")
    return table[kernel]


def matmul_dsd_q8(
    a_q: BlockSparseMatrix,
    b_q: torch.Tensor,
    *,
    scale_a,
    scale_b: float,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=torch.bfloat16,
    kernel: str = "stream",
    **kw,
) -> torch.Tensor:
    """C ~= op(A) @ op(B) from int8 operands: exact int32 accumulation, the
    dequantization at the flush (``scale_a`` a float), or (``scale_a`` a
    per-block-row tensor) the raw int32 sum scaled and cast after it."""
    _check_int8("matmul_dsd_q8", a_q, b_q)
    fn = _kernel(_DSD_KERNELS, kernel)
    if isinstance(scale_a, (float, int)):
        return fn(a_q, b_q, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                  out_scale=float(scale_a) * float(scale_b), **kw)
    if transpose_a:
        raise ValueError("per-block-row scales need transpose_a=False (the scale follows the OUTPUT row)")
    raw = fn(a_q, b_q, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=torch.int32, **kw)
    row_scale = torch.repeat_interleave(scale_a.to(torch.float32) * _f32(scale_b, scale_a), a_q.block_size)
    return (raw.float() * row_scale[:, None]).to(out_dtype)


def matmul_dds_q8(
    a_q: torch.Tensor,
    b_q: BlockSparseMatrix,
    *,
    scale_a: float,
    scale_b: float,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=torch.bfloat16,
    kernel: str = "stream",
    **kw,
) -> torch.Tensor:
    """C ~= op(A) @ op(B_sparse) from int8 operands (per-tensor scales)."""
    _check_int8("matmul_dds_q8", b_q, a_q)
    return _kernel(_DDS_KERNELS, kernel)(
        a_q, b_q, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
        out_scale=float(scale_a) * float(scale_b), **kw)
