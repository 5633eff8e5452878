"""CSR engine: SpMM, SDDMM, sparse softmax, row swizzle
(``sputnik_tpu/ops/csr.py``).

Dispatch by format, as in the JAX package:

* a ``SellMatrix`` goes to the SELL kernels (``kernels/sell.py``), through
  ``torch.autograd.Function``s whose backwards are the same kernels;
* a ``CsrMatrix`` with a ``dense_mirror`` goes to one dense matmul (JAX
  hands it to XLA's dot); any other ``CsrMatrix`` is converted by
  ``SellMatrix.from_csr`` on the host and goes to the kernels. A CSR on the
  card is read back for that conversion: it is construction, not the hot
  path; convert once and pass the ``SellMatrix`` where it matters;
* an ``EllMatrix`` goes to the plain ELL functions (``spmm_ell`` and
  relatives), which JAX also computes outside Pallas.

Raw-CSR ``sddmm`` and ``sparse_softmax`` are plain torch, as in JAX. The
softmax's row reductions are ``torch.segment_reduce`` over the offsets
(the way ``ops/softmax.py`` reduces BSR rows): each row in order, no
``scatter_reduce`` / ``index_add_`` atomics, and no ``max_row_nnz`` hint,
so offsets built on the card (``CsrMatrix.transpose()`` of a card matrix)
work as host-built ones do.

Gradients flow to the sparse values and to the dense operands; the topology
(indices, counts, permutation) carries none, and padding slots get zero
gradient, so a fine-tune keeps the pattern.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from sputnik_tpu_torch.formats import CsrMatrix, EllMatrix, SellMatrix, sorted_row_swizzle
from sputnik_tpu_torch.kernels import sell as sell_kernels

__all__ = [
    "spmm",
    "sddmm",
    "sparse_softmax",
    "row_swizzle",
    "ell_from_csr",
    "spmm_ell",
    "sddmm_ell",
    "sparse_softmax_ell",
    "sparse_softmax_sell",
]

Sparse = Union[CsrMatrix, EllMatrix, SellMatrix]


# --- differentiable SELL kernels -------------------------------------------


class _SellSpmm(torch.autograd.Function):
    """C = A_sell @ B over ``values``; backward: dvalues by SDDMM at A's
    pattern (fp32, cast to the values' dtype), dB by the transposed SpMM."""

    @staticmethod
    def forward(ctx, values, b, a: SellMatrix, out_dtype):
        a = a.with_values(values)
        ctx.save_for_backward(values, b)
        ctx.a = a
        return sell_kernels.spmm(a, b, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        values, b = ctx.saved_tensors
        a = ctx.a.with_values(values)
        g = g.contiguous()
        dvalues = db = None
        if ctx.needs_input_grad[0]:
            dvalues = sell_kernels.sddmm(g, b, a, out_dtype=torch.float32).values.to(values.dtype)
        if ctx.needs_input_grad[1]:
            db = sell_kernels.spmm_t(a, g, out_dtype=b.dtype)
        return dvalues, db, None, None


class _SellSddmm(torch.autograd.Function):
    """values = (A B^T) at the topology's slots; backward: dA by SpMM and dB
    by the transposed SpMM of the incoming values gradient."""

    @staticmethod
    def forward(ctx, a, b, topology: SellMatrix, out_dtype):
        ctx.save_for_backward(a, b)
        ctx.topology = topology
        return sell_kernels.sddmm(a, b, topology, out_dtype=out_dtype).values

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gs = ctx.topology.with_values(g.to(ctx.topology.dtype).contiguous())
        da = db = None
        if ctx.needs_input_grad[0]:
            da = sell_kernels.spmm(gs, b, out_dtype=a.dtype)
        if ctx.needs_input_grad[1]:
            db = sell_kernels.spmm_t(gs, a, out_dtype=b.dtype)
        return da, db, None, None


class _SellSoftmax(torch.autograd.Function):
    """The softmax kernel over ``values``; backward in plain torch, as JAX
    does it in jnp: dx = scale * p * (g - sum_row(p * g))."""

    @staticmethod
    def forward(ctx, values, m: SellMatrix, scale):
        p = sell_kernels.sparse_softmax(m.with_values(values), scale=scale).values
        ctx.save_for_backward(p)
        ctx.scale = scale
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        pf, gf = p.float(), g.float()
        dv = pf * (gf - (pf * gf).sum(dim=(0, 1), keepdim=True))
        if ctx.scale is not None:
            dv = dv * ctx.scale
        return dv.to(p.dtype), None, None


# --- SpMM ------------------------------------------------------------------


def spmm(a: Sparse, b: torch.Tensor, *, transpose_b: bool = False, out_dtype=None) -> torch.Tensor:
    """C[M, N] = A_sparse @ op(B_dense)   (upstream Sputnik ``CudaSpmm``).

    A ``SellMatrix`` runs on the kernels; a ``CsrMatrix`` with a dense
    mirror is one fp32 matmul; any other ``CsrMatrix`` is converted to SELL
    on the host first (read back from the card if it lives there); an
    ``EllMatrix`` takes the plain row-gather path."""
    out_dtype = out_dtype or a.dtype
    if transpose_b:
        b = b.T
    if isinstance(a, SellMatrix):
        return _SellSpmm.apply(a.values, b, a, out_dtype)
    if isinstance(a, EllMatrix):
        return spmm_ell(a, b, out_dtype=out_dtype)
    if a.nnz == 0:
        return torch.zeros((a.rows, b.shape[1]), dtype=out_dtype, device=b.device)
    if a.dense_mirror is not None:
        return torch.matmul(a.dense_mirror.float(), b.float()).to(out_dtype)
    s = SellMatrix.from_csr(a)
    return _SellSpmm.apply(s.values, b, s, out_dtype)


def spmm_ell(a: EllMatrix, b: torch.Tensor, *, out_dtype=None, chunk: int = 16) -> torch.Tensor:
    """ELL SpMM: over width chunks, a row-gather of B and a fused fp32
    multiply-accumulate; no scatter."""
    out_dtype = out_dtype or a.dtype
    rows, width = a.values.shape
    n = b.shape[1]
    acc = torch.zeros((rows, n), dtype=torch.float32, device=b.device)
    # Padding values are zero already (format contract), so no mask needed.
    for w0 in range(0, width, chunk):
        v = a.values[:, w0:w0 + chunk].float()
        c = a.indices[:, w0:w0 + chunk].long()
        g = b[c.reshape(-1)].reshape(rows, c.shape[1], n).float()
        acc = acc + torch.einsum("rw,rwn->rn", v, g)
    return acc.to(out_dtype)


# --- SDDMM -----------------------------------------------------------------


def sddmm(a: torch.Tensor, b: torch.Tensor, topology: Sparse, *, transpose_b: bool = True, out_dtype=None):
    """values[e] = A[row[e], :] . op(B)[:, col[e]]   (upstream ``CudaSddmm``).

    With ``transpose_b=True`` (the Sputnik default) rows of A are dotted
    with rows of B. Returns the topology's format with new values."""
    out_dtype = out_dtype or topology.dtype
    if not transpose_b:
        b = b.T  # normalize to (N, K) rows
    if isinstance(topology, SellMatrix):
        return topology.with_values(_SellSddmm.apply(a, b, topology, out_dtype))
    if isinstance(topology, EllMatrix):
        return sddmm_ell(a, b, topology, out_dtype=out_dtype)
    if topology.nnz == 0:
        return topology.with_values(torch.zeros((0,), dtype=out_dtype, device=a.device))
    lhs = a[topology.row_indices.long()].float()
    rhs = b[topology.indices.long()].float()
    return topology.with_values((lhs * rhs).sum(dim=-1).to(out_dtype))


def sddmm_ell(a: torch.Tensor, b: torch.Tensor, topology: EllMatrix, *, out_dtype=None,
              chunk: int = 16) -> EllMatrix:
    """ELL SDDMM: values[r, w] = A[r] . B[cols[r, w]]; 0 at padding slots."""
    out_dtype = out_dtype or topology.dtype
    rows, width = topology.indices.shape
    k = a.shape[1]
    a32 = a.float()
    parts = []
    for w0 in range(0, width, chunk):
        c = topology.indices[:, w0:w0 + chunk].long()
        g = b[c.reshape(-1)].reshape(rows, c.shape[1], k).float()
        parts.append(torch.einsum("rk,rwk->rw", a32, g))
    vals = torch.cat(parts, dim=1) if parts else torch.zeros((rows, 0), device=a.device)
    vals = torch.where(topology.valid_mask(), vals, 0.0)
    return topology.with_values(vals.to(out_dtype))


# --- sparse softmax --------------------------------------------------------


def sparse_softmax_ell(a: EllMatrix, *, scale: Optional[float] = None) -> EllMatrix:
    """Row softmax over the valid slots: dense masked math."""
    v = a.values.float()
    if scale is not None:
        v = v * scale
    mask = a.valid_mask()
    v = v.masked_fill(~mask, float("-inf"))
    m = v.amax(dim=1, keepdim=True).clamp(min=-torch.finfo(torch.float32).max)
    e = torch.where(mask, torch.exp(v - m), 0.0)
    s = e.sum(dim=1, keepdim=True).clamp(min=1e-30)
    return a.with_values((e / s).to(a.dtype))


def _sparse_softmax_sell_plain(a: SellMatrix, *, scale: Optional[float] = None) -> SellMatrix:
    """The JAX package's jnp chain (its default SELL softmax), differentiable
    by autograd."""
    v = a.values.float()
    if scale is not None:
        v = v * scale
    mask = a.valid_mask()
    v = v.masked_fill(~mask, float("-inf"))
    m = v.amax(dim=(0, 1), keepdim=True).clamp(min=-torch.finfo(torch.float32).max)
    e = torch.where(mask, torch.exp(v - m), 0.0)
    s = e.sum(dim=(0, 1), keepdim=True).clamp(min=1e-30)
    return a.with_values((e / s).to(a.dtype))


def sparse_softmax_sell(a: SellMatrix, *, scale: Optional[float] = None,
                        variant: Optional[str] = None) -> SellMatrix:
    """Row softmax over a SELL matrix.

    ``"pallas"`` is the one-pass softmax kernel (``sell_softmax``) with its
    gradient; ``"jnp"`` is the plain torch chain. ``None`` takes the kernel
    on a CUDA tensor and the plain chain on the CPU: the JAX package
    defaults to its jnp chain for a TPU reason (a Pallas grid step costs
    ~0.5 us there, more than the softmax's work), which does not hold on
    the card. Other names raise."""
    if variant is None:
        variant = "pallas" if a.values.is_cuda else "jnp"
    if variant == "jnp":
        return _sparse_softmax_sell_plain(a, scale=scale)
    if variant != "pallas":
        raise ValueError(f"sell softmax variant must be 'jnp' or 'pallas', got {variant!r}")
    return a.with_values(_SellSoftmax.apply(a.values, a, scale))


def sparse_softmax(a: Sparse, *, scale: Optional[float] = None, variant: Optional[str] = None):
    """Row-wise softmax over the nonzero values (upstream ``SparseSoftmax``),
    numerically stable by the row max. Padding entries of a CSR take part
    like real ones, as in the reference."""
    if isinstance(a, SellMatrix):
        return sparse_softmax_sell(a, scale=scale, variant=variant)
    if isinstance(a, EllMatrix):
        return sparse_softmax_ell(a, scale=scale)
    if a.nnz == 0:
        return a
    v = a.values.float()
    if scale is not None:
        v = v * scale
    rows = a.row_indices.long()
    # The max only keeps exp finite: the result does not depend on it, so
    # no gradient flows through it. Empty rows reduce to -inf / 0 and are
    # never read.
    row_max = torch.segment_reduce(v.detach(), "max", offsets=a.offsets, unsafe=True)
    v = torch.exp(v - row_max[rows])
    row_sum = torch.segment_reduce(v, "sum", offsets=a.offsets, unsafe=True)
    return a.with_values((v / row_sum[rows]).to(a.dtype))


# --- helpers ---------------------------------------------------------------


def row_swizzle(a: CsrMatrix) -> torch.Tensor:
    """Row ordering by descending nnz (Sputnik ``SortedRowSwizzle``)."""
    return sorted_row_swizzle(a.offsets)


def ell_from_csr(a: CsrMatrix, width: int):
    """Pad every row to a static ``width``: (values, cols, valid), each
    (rows, width); entries past a row's nnz point at column 0 with value 0."""
    w = torch.arange(width, dtype=torch.int32, device=a.offsets.device)[None, :]
    slots = a.offsets[:-1][:, None] + w
    valid = slots < a.offsets[1:][:, None]
    slots = slots.clamp(max=max(a.nnz - 1, 0)).long()
    vals = torch.where(valid, a.values[slots], torch.zeros((), dtype=a.dtype, device=a.values.device))
    cols = torch.where(valid, a.indices[slots], 0)
    return vals, cols, valid

