"""Dense-detour variants of SSD / SDS / DSS (``sputnik_tpu/kernels/via_dense.py``).

Above a block density the JAX package runs the stream kernel on the full
dense output (SSD / SDS, then gathers the topology's blocks) or on one
densified operand (DSS) rather than the sparse-output kernels: a
flops-for-bandwidth trade measured on the TPU. The port keeps the
threshold so that both packages route alike; it waits to be measured on
the H100. No kernel of its own: each is the ``bsr_dsd_stream`` kernel
(DSD or DDS) plus a block gather or a densify in PyTorch.
"""

from __future__ import annotations

from sputnik_tpu_torch.formats import BlockSparseMatrix, bsr_to_dense
from sputnik_tpu_torch.kernels import bsr_dsd
from sputnik_tpu_torch.kernels.reference import extract_blocks

__all__ = ["ssd", "sds", "dss", "DENSITY_THRESHOLD"]

# Below this block density the direct sparse-output kernels win (the JAX
# package's crossover, measured on a TPU).
DENSITY_THRESHOLD = 1 / 16


def ssd(a: BlockSparseMatrix, b, topology: BlockSparseMatrix, *, transpose_a=False, transpose_b=False,
        out_dtype=None):
    out_dtype = out_dtype or topology.dtype
    full = bsr_dsd.dsd(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype)
    return topology.with_data(extract_blocks(full, topology))


def sds(a, b: BlockSparseMatrix, topology: BlockSparseMatrix, *, transpose_a=False, transpose_b=False,
        out_dtype=None):
    out_dtype = out_dtype or topology.dtype
    full = bsr_dsd.dds(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype)
    return topology.with_data(extract_blocks(full, topology))


def dss(a: BlockSparseMatrix, b: BlockSparseMatrix, *, transpose_a=False, transpose_b=False, out_dtype=None):
    """Densify the side with fewer nonzeros; keep the other sparse in the
    stream kernel."""
    out_dtype = out_dtype or a.dtype
    if a.nnz_blocks <= b.nnz_blocks:
        return bsr_dsd.dds(bsr_to_dense(a), b, transpose_a=transpose_a, transpose_b=transpose_b,
                           out_dtype=out_dtype)
    return bsr_dsd.dsd(a, bsr_to_dense(b), transpose_a=transpose_a, transpose_b=transpose_b,
                       out_dtype=out_dtype)
