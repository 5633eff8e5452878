"""Gradients of DSD, DDS and SDD (``sputnik_tpu/ops/autodiff.py:84-167``).

The three ops close under differentiation, so every backward stays sparse:

    dsd:  dA = sdd(g, B, topo_A)            dB = dsd(A^T, g) / dds(g^T, A)
    dds:  dA = dds(g, B^T)                  dB = sdd(A, g, topo_B)
    sdd:  dA = dsd(g_s, B^T)                dB = dds(A^T, g_s)

Each is a ``torch.autograd.Function`` whose backward calls the raw
dispatching matmuls of ``ops/matmul.py``; like JAX's VJPs it passes them no
options, so first-fit dispatch, and a ``registry.forced_variant`` block the
backward runs in, pick its kernels. A ``BlockSparseMatrix`` is not a
tensor: a Function takes the matrix's ``data`` as its tensor input and
carries the matrix (its topology) beside it. The gradient of a sparse
operand is a data tensor on the primal topology in the primal's dtype (JAX:
``_bsr_cotangent``); a sparse output's gradient is read on the output's
topology (``_restore``). ``db`` comes out in ``b``'s dtype and ``da`` in
``a``'s. An operand broadcast over the other's batch axis (heads) gets the
gradient summed over that axis.
"""

from __future__ import annotations

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.ops.matmul import matmul_dds, matmul_dsd, matmul_sdd

__all__ = ["dsd", "dds", "sdd"]


def _fit(grad: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``grad`` summed over a leading batch axis that ``like`` lacks, in
    ``like``'s dtype."""
    if grad.ndim > like.ndim:
        grad = grad.float().sum(dim=0)
    return grad.to(like.dtype)


class _Dsd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_data, b, a, ta, tb, opts):
        ctx.save_for_backward(a_data, b)
        ctx.meta = (a, ta, tb)
        return matmul_dsd(a.with_data(a_data), b, transpose_a=ta, transpose_b=tb, **opts)

    @staticmethod
    def backward(ctx, g):
        a_data, b = ctx.saved_tensors
        a, ta, tb = ctx.meta
        a = a.with_data(a_data)
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            # d op(A)[m, k] = sum_n g[m, n] op(B)[k, n], masked to A's topology
            if not ta:
                da = matmul_sdd(g, b, a, transpose_a=False, transpose_b=not tb)
            else:  # stored A is (K, M): dA = op(B) @ g^T
                da = matmul_sdd(b, g, a, transpose_a=tb, transpose_b=True)
            da = _fit(da.data, a_data)
        if ctx.needs_input_grad[1]:
            # d op(B)[k, n] = sum_m op(A)[m, k] g[m, n]
            if not tb:
                db = matmul_dsd(a, g, transpose_a=not ta, transpose_b=False, out_dtype=b.dtype)
            else:  # stored B is (N, K): dB = g^T @ op(A)
                db = matmul_dds(g, a, transpose_a=True, transpose_b=ta, out_dtype=b.dtype)
            db = _fit(db, b)
        return da, db, None, None, None, None


class _Dds(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b_data, b, ta, tb, opts):
        ctx.save_for_backward(a, b_data)
        ctx.meta = (b, ta, tb)
        return matmul_dds(a, b.with_data(b_data), transpose_a=ta, transpose_b=tb, **opts)

    @staticmethod
    def backward(ctx, g):
        a, b_data = ctx.saved_tensors
        b, ta, tb = ctx.meta
        b = b.with_data(b_data)
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            # d op(A)[m, k] = sum_n g[m, n] op(B)[k, n]
            if not ta:
                da = matmul_dds(g, b, transpose_a=False, transpose_b=not tb, out_dtype=a.dtype)
            else:
                da = matmul_dsd(b, g, transpose_a=tb, transpose_b=True, out_dtype=a.dtype)
            da = _fit(da, a)
        if ctx.needs_input_grad[1]:
            # d op(B)[k, n] = sum_m op(A)[m, k] g[m, n], masked to B's topology
            if not tb:
                db = matmul_sdd(a, g, b, transpose_a=not ta, transpose_b=False)
            else:
                db = matmul_sdd(g, a, b, transpose_a=True, transpose_b=ta)
            db = _fit(db.data, b_data)
        return da, db, None, None, None, None


class _Sdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, topology, ta, tb, opts):
        ctx.save_for_backward(a, b)
        ctx.meta = (topology, ta, tb)
        return matmul_sdd(a, b, topology, transpose_a=ta, transpose_b=tb, **opts).data

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        topology, ta, tb = ctx.meta
        gs = topology.with_data(g.contiguous().to(topology.dtype))
        da = db = None
        # d op(A) = g_s @ op(B)^T,  d op(B) = op(A)^T @ g_s  (g_s sparse: DSD / DDS)
        if ctx.needs_input_grad[0]:
            if not ta:
                da = matmul_dsd(gs, b, transpose_a=False, transpose_b=not tb, out_dtype=a.dtype)
            else:
                da = matmul_dds(b, gs, transpose_a=tb, transpose_b=True, out_dtype=a.dtype)
            da = _fit(da, a)
        if ctx.needs_input_grad[1]:
            if not tb:
                db = matmul_dds(a, gs, transpose_a=not ta, transpose_b=False, out_dtype=b.dtype)
            else:
                db = matmul_dsd(gs, a, transpose_a=True, transpose_b=ta, out_dtype=b.dtype)
            db = _fit(db, b)
        return da, db, None, None, None, None


def dsd(a: BlockSparseMatrix, b: torch.Tensor, *, transpose_a=False, transpose_b=False, **opts) -> torch.Tensor:
    """Differentiable DSD: C = op(A_sparse) @ op(B); gradients reach
    ``a.data`` and ``b``."""
    return _Dsd.apply(a.data, b, a, transpose_a, transpose_b, opts)


def dds(a: torch.Tensor, b: BlockSparseMatrix, *, transpose_a=False, transpose_b=False, **opts) -> torch.Tensor:
    """Differentiable DDS: C = op(A) @ op(B_sparse)."""
    return _Dds.apply(a, b.data, b, transpose_a, transpose_b, opts)


def sdd(a: torch.Tensor, b: torch.Tensor, topology: BlockSparseMatrix, *, transpose_a=False,
        transpose_b=False, **opts) -> BlockSparseMatrix:
    """Differentiable SDD: the blocks of op(A) @ op(B) at ``topology``; the
    result's ``data`` carries the graph. The topology's own values get no
    gradient."""
    return topology.with_data(_Sdd.apply(a, b, topology, transpose_a, transpose_b, opts))
