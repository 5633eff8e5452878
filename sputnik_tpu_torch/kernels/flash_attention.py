"""Single-head fused block-sparse attention and the fused SDD + softmax
(``sputnik_tpu/kernels/flash_attention.py``).

``flash_block_attention`` is the single-head flash attention the JAX
package takes for traced metadata. Its forward, dQ and dK/dV passes
(``_kernel``, ``_dq_kernel``, ``_dkv_kernel``) compute, head by head, the
function that ``flash_mha``'s three CUDA kernels compute: those walk each
block-row's (block-column's) stored blocks from the offsets on the card,
one CTA per 64-row tile, keep every stored block, zero empty rows and
columns and use the same log-sum-exp sentinel. So the port runs them with
one head, as ``bsr_sdd`` serves both of JAX's SDD kernels. Unlike
``flash_mha`` it does not merge a (row, column) block stored twice, as
JAX's per-row plan does not. ``fused_backward=False`` recomputes the
gradient through the unfused chain (SDD -> BSR softmax -> DSD), as JAX's
does. JAX's ``group`` (K/V blocks per TPU grid step) shapes a schedule the
CUDA kernels do not have; the port takes no such argument.

``sdd_softmax_fused`` is the fused SDD + softmax: the score pass
(``kernels/bsr_softmax.py``'s ``sdd_softmax`` kernel: the masked fp32
scores of every stored block in packed order and the row stats) and the
normalize pass with scale 1 and no mask as its epilogue, two launches as
JAX's kernel and its XLA epilogue are. It is not differentiable, as JAX's
is not.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_softmax
from sputnik_tpu_torch.kernels import flash_mha as fm

__all__ = ["flash_block_attention", "sdd_softmax_fused", "flash_attention_heads"]


def _unfused(q, k, v, topology, causal, scale):
    from sputnik_tpu_torch import ops

    scores = ops.sdd(q, k, topology, transpose_b=True)
    probs = ops.bsr_softmax(scores, scale=scale, causal=causal)
    return ops.dsd(probs, v, out_dtype=q.dtype)


class _FlashRecompute(torch.autograd.Function):
    """``fused_backward=False`` (``flash_attention.py:853-869``): the flash
    forward keeps only its inputs; the backward recomputes through the
    unfused chain and takes its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, topology, causal, scale):
        out, _ = fm.passes(q, k, v, topology).fwd(q, k, v, topology, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.meta = (topology, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        topology, causal, scale = ctx.meta
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = _unfused(*leaves, topology, causal, scale)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def flash_attention_heads(q, k, v, topology: BlockSparseMatrix, *, causal: bool, scale: float,
                          fused_backward: bool = True) -> torch.Tensor:
    """``flash_block_attention`` for each head of (H, T, dh) q and (H, Tk,
    dh) k, v over one topology: one launch of each kernel for all heads
    (the JAX package ``vmap``-s the single-head function)."""
    if topology.nnz_blocks == 0:
        return torch.zeros_like(q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if fused_backward:
        return fm.FlashMHA.apply(q, k, v, topology, bool(causal), float(scale), None)
    return _FlashRecompute.apply(q, k, v, topology, bool(causal), float(scale))


def flash_block_attention(
    q: torch.Tensor,  # (T, dh)
    k: torch.Tensor,  # (Tk, dh)
    v: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    fused_backward: bool = True,
) -> torch.Tensor:
    """Fused single-head block-sparse attention, O(T * dh) memory;
    differentiable in q, k, v. ``scale=None`` is 1/sqrt(dh). Every stored
    block takes part, duplicates included. Backward: the flash-2 dQ and
    dK/dV kernels (``fused_backward=True``) or the unfused chain's VJP."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_heads(q[None], k[None], v[None], topology, causal=causal, scale=scale,
                                 fused_backward=fused_backward)[0]


def sdd_softmax_fused(
    q: torch.Tensor,  # ([batch,] T, dh)
    k: torch.Tensor,  # ([batch,] Tk, dh)
    topology: BlockSparseMatrix,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    out_dtype=None,
) -> BlockSparseMatrix:
    """probs = softmax(scale * q @ k^T at topology), one score pass and one
    normalize pass; ``scale=None`` applies no scaling. A leading batch axis
    on q and k gives batched data (one launch of each kernel)."""
    scale = 1.0 if scale is None else float(scale)
    out_dtype = out_dtype or topology.dtype
    if topology.nnz_blocks == 0:
        return topology
    scores, m, l = bsr_softmax.scores(q.contiguous(), k.contiguous(), topology, scale=scale, causal=causal)
    probs = bsr_softmax.normalize(scores, m, l, topology, scale=1.0, causal=False, out_dtype=out_dtype)
    return topology.with_data(probs)
