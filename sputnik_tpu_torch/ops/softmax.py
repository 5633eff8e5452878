"""Row softmax over BSR blocks, and the fused SDD + softmax
(``sputnik_tpu/ops/softmax.py``).

Each element-row is normalized over that row's stored blocks only; absent
blocks take no probability. ``causal=True`` masks the upper triangle of
diagonal blocks and every block above the diagonal.

Two variants, the JAX package's names:

* ``"pallas"``: the two-pass kernels (``kernels/bsr_softmax.py``: a stats
  pass and a normalize pass on the card, their plain versions on the CPU),
  with JAX's custom VJP.
* ``"jnp"``: the plain torch chain of the JAX package's default, with
  autograd through it.

``variant=None`` takes the kernels on a CUDA tensor and the chain on the
CPU: the JAX package defaults to its chain for a TPU reason (a Pallas grid
step costs more there than a block's softmax work), which does not hold on
the card. Both read the topology's offsets where they are and need no
``max_row_nnz`` hint, so a topology built on the card works too. The
chain's segment reductions are ``torch.segment_reduce`` over the offsets:
each segment is reduced in order, where ``scatter_reduce`` / ``index_add_``
would add with atomics and change the sums from run to run.
"""

from __future__ import annotations

from typing import Optional

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels.bsr_softmax import bsr_softmax_pallas, segment

__all__ = ["bsr_softmax", "sdd_softmax"]


def _bsr_softmax_chain(m: BlockSparseMatrix, scale: Optional[float], causal: bool) -> BlockSparseMatrix:
    """The JAX package's jnp chain: masked lanes at -inf, segment max and
    sum over the block-rows, fp32, returned in ``m``'s dtype."""
    bs = m.block_size
    data = m.data.float()
    if scale is not None:
        data = data * scale
    if causal:
        idx = torch.arange(bs, device=data.device)
        intra = idx[:, None] >= idx[None, :]  # lower triangle inside a block
        on_diag = (m.row_indices == m.indices)[:, None, None]
        below = (m.row_indices > m.indices)[:, None, None]
        keep = torch.where(on_diag, intra[None], below)
        data = data.masked_fill(~keep, float("-inf"))
    rows = m.row_indices.long()
    # The max only keeps exp finite: the result does not depend on it, so
    # no gradient flows through it.
    row_max = segment(data.detach().amax(dim=-1), m.offsets, "max")
    row_max = row_max.clamp(min=-torch.finfo(torch.float32).max)  # empty rows
    e = torch.exp(data - row_max[..., rows, :, None])
    row_sum = segment(e.sum(dim=-1), m.offsets, "sum")
    denom = row_sum[..., rows, :, None].clamp(min=1e-30)
    return m.with_data((e / denom).to(m.dtype))


def bsr_softmax(
    m: BlockSparseMatrix,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    variant: Optional[str] = None,
) -> BlockSparseMatrix:
    """Row-wise softmax over the nonzero blocks; batched data is normalized
    per batch entry. ``variant``: ``"pallas"`` (the kernels), ``"jnp"`` (the
    torch chain) or ``None`` (the kernels on the card, the chain on the CPU);
    other names raise. ``scale=None`` applies no scaling."""
    if m.nnz_blocks == 0:
        return m
    if variant is None:
        variant = "pallas" if m.data.is_cuda else "jnp"
    if variant == "jnp":
        return _bsr_softmax_chain(m, scale, causal)
    if variant != "pallas":
        raise ValueError(f"bsr_softmax variant must be 'pallas' or 'jnp', got {variant!r}")
    return bsr_softmax_pallas(m, scale=scale, causal=causal)


def sdd_softmax(
    q: torch.Tensor,
    k: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    out_dtype=None,
) -> BlockSparseMatrix:
    """softmax(scale * q @ k^T at topology), the fused SDD + softmax: one
    score pass and the normalize pass. As in the JAX package,
    ``scale=None`` applies NO scaling (attention callers pass 1/sqrt(dh)),
    and the result equals ``bsr_softmax(matmul_sdd(q, k, topology,
    transpose_b=True), scale=scale, causal=causal)``."""
    from sputnik_tpu_torch.kernels.flash_attention import sdd_softmax_fused

    return sdd_softmax_fused(q, k, topology, scale=1.0 if scale is None else scale, causal=causal,
                             out_dtype=out_dtype)
