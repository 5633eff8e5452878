"""Row softmax over BSR blocks (``sputnik_tpu/ops/softmax.py``, the jnp variant).

Each element-row is normalized over that row's stored blocks only; absent
blocks take no probability. ``causal=True`` masks the upper triangle of
diagonal blocks and every block above the diagonal.

The JAX package reduces with ``segment_max`` / ``segment_sum``. Their
natural PyTorch forms (``scatter_reduce``, ``index_add_``) use atomics on
CUDA and would change the sums from run to run. Instead the blocks of each
block-row are gathered into a padded ``(block_rows, max_row_nnz)`` layout
and reduced along it, which is deterministic: the topology's blocks are in
block-row order, so row ``r`` holds slots ``offsets[r] .. offsets[r+1]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix

__all__ = ["bsr_softmax"]


def _row_slots(m: BlockSparseMatrix):
    """(slots, valid): ``(block_rows, max_row_nnz)`` positions in ``data``
    of each block-row's blocks, and which of them are real."""
    width = max(m.max_row_nnz or 0, 1)
    starts = m.offsets[:-1].long()
    slots = starts[:, None] + torch.arange(width, device=m.offsets.device)[None, :]
    valid = slots < m.offsets[1:].long()[:, None]
    return slots.clamp(max=max(m.nnz_blocks - 1, 0)), valid


def bsr_softmax(
    m: BlockSparseMatrix,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> BlockSparseMatrix:
    """Row-wise softmax over the nonzero blocks; batched data is normalized
    per batch entry. Computes in fp32 and returns ``m``'s dtype."""
    bs = m.block_size
    if m.nnz_blocks == 0:
        return m
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
    slots, valid = _row_slots(m)  # (br, w)
    mask = valid[:, :, None]  # (br, w, 1) against (..., br, w, bs)
    blk_max = data.amax(dim=-1)  # (..., nnz, bs): max over the block's columns
    row_max = blk_max[..., slots, :].masked_fill(~mask, float("-inf")).amax(dim=-2)
    row_max = row_max.clamp(min=-torch.finfo(torch.float32).max)  # empty rows
    e = torch.exp(data - row_max[..., rows, :, None])
    blk_sum = e.sum(dim=-1)
    row_sum = blk_sum[..., slots, :].masked_fill(~mask, 0.0).sum(dim=-2)
    denom = row_sum[..., rows, :, None].clamp(min=1e-30)
    return m.with_data((e / denom).to(m.dtype))
