"""BSR matmul front ends: DSD, DDS and SDD (``sputnik_tpu/ops/matmul.py``).

Shape checks (the reference's ``ValidMatmul``), then first-fit dispatch:

1. ``xla_dense_detour`` — a near-dense sparse operand (block density
   >= ``DENSIFY_THRESHOLD``) is densified and multiplied with one fp32
   ``torch.matmul``, on any device, as the JAX package hands it to XLA's
   dense dot.
2. the Hopper kernel (``cuda_stream`` for DSD/DDS, ``cuda_output_stationary``
   for SDD) — every CUDA problem; the wrapper raises for one it cannot take.
3. ``torch_reference`` — the plain PyTorch version, for CPU tensors only.

No CUDA problem reaches the plain version unless it is named through
``variant=`` (or :func:`registry.forced_variant`).
"""

from __future__ import annotations

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_sdd, reference
from sputnik_tpu_torch.ops import registry

__all__ = ["matmul_dsd", "matmul_dds", "matmul_sdd", "DENSIFY_THRESHOLD"]

# At and above this block density the sparse operand is effectively dense
# (sputnik_tpu/kernels/via_dense.py: DENSIFY_THRESHOLD).
DENSIFY_THRESHOLD = 0.8


def _on(device_type: str, *xs) -> bool:
    return all((x.data if isinstance(x, BlockSparseMatrix) else x).device.type == device_type for x in xs)


def _on_cuda(*xs) -> bool:
    return _on("cuda", *xs)


def _cpu_can(*args, **_) -> bool:
    return _on("cpu", *args)


def _dense_can(sparse: BlockSparseMatrix) -> bool:
    return sparse.density >= DENSIFY_THRESHOLD


# The CUDA predicates claim every problem on the card; the kernel wrappers
# raise for one the kernel does not take instead of handing it elsewhere.
registry.register("dsd", "xla_dense_detour", lambda a, b, **kw: _dense_can(a), reference.dsd)
registry.register("dsd", "cuda_stream", lambda a, b, **kw: _on_cuda(a, b), bsr_dsd.dsd)
registry.register("dsd", "torch_reference", _cpu_can, reference.dsd)

registry.register("dds", "xla_dense_detour", lambda a, b, **kw: _dense_can(b), reference.dds)
registry.register("dds", "cuda_stream", lambda a, b, **kw: _on_cuda(a, b), bsr_dsd.dds)
registry.register("dds", "torch_reference", _cpu_can, reference.dds)

registry.register("sdd", "xla_dense_detour", lambda a, b, t, **kw: _dense_can(t), reference.sdd)
registry.register("sdd", "cuda_output_stationary", lambda a, b, t, **kw: _on_cuda(a, b, t), bsr_sdd.sdd)
registry.register("sdd", "torch_reference", _cpu_can, reference.sdd)


def matmul_dsd(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> torch.Tensor:
    """C[M, N] = op(A_sparse) @ op(B_dense)."""
    k_a = a.rows if transpose_a else a.cols
    k_b = b.shape[-1] if transpose_b else b.shape[-2]
    if k_a != k_b:
        raise ValueError(
            f"dsd contraction mismatch: op(A) gives k={k_a}, op(B) gives "
            f"k={k_b} (A {a.shape} ta={transpose_a}, B {tuple(b.shape)} tb={transpose_b})"
        )
    return registry.dispatch(
        "dsd", a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


def matmul_dds(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> torch.Tensor:
    """C[M, N] = op(A_dense) @ op(B_sparse)."""
    k_a = a.shape[-2] if transpose_a else a.shape[-1]
    k_b = b.cols if transpose_b else b.rows
    if k_a != k_b:
        raise ValueError(
            f"dds contraction mismatch: op(A) gives k={k_a}, op(B) gives "
            f"k={k_b} (A {tuple(a.shape)} ta={transpose_a}, B {b.shape} tb={transpose_b})"
        )
    return registry.dispatch(
        "dds", a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


def matmul_sdd(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> BlockSparseMatrix:
    """C_sparse = op(A) @ op(B) masked to ``topology`` (attention scores)."""
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    k_a = a.shape[-2] if transpose_a else a.shape[-1]
    k_b = b.shape[-1] if transpose_b else b.shape[-2]
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    if k_a != k_b:
        raise ValueError(f"sdd contraction mismatch: op(A) gives k={k_a}, op(B) gives k={k_b}")
    if (m_dim, n_dim) != topology.shape:
        raise ValueError(f"sdd output shape {(m_dim, n_dim)} != topology {topology.shape}")
    return registry.dispatch(
        "sdd", a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )
