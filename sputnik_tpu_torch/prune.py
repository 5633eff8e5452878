"""Block-sparsity pruning and sparse-training utilities
(``sputnik_tpu/prune.py``).

- :func:`block_scores` — per-block saliency of a dense matrix;
- :func:`block_magnitude_prune` — dense -> BSR keeping the top-k blocks by
  norm;
- :func:`gradual_sparsity` — the Zhu & Gupta (2017) cubic schedule;
- :func:`rigl_block_update` — one RigL (Evci et al., 2020) topology refresh
  at block granularity: drop the lowest-norm fraction of active blocks,
  regrow as many inactive blocks of largest gradient norm, surviving
  blocks keep their values and regrown ones start at zero.

The nonzero-block budget is fixed by the target sparsity, so a refresh
swaps which blocks are active without changing any shape. The topology is
chosen on the host: the block scores are computed on the data's device and
read back once per prune or refresh, the top-k picked with a stable sort
(``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk`` leaves
the order of ties unspecified), and the metadata built in numpy. The
result is therefore host-known (``BlockSparseMatrix.host_known``), the
port's counterpart of the concrete metadata the JAX package's eager calls
give, and takes the planned kernels; the block data stays on its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix

__all__ = ["block_scores", "block_magnitude_prune", "gradual_sparsity", "rigl_block_update"]


def _scores(blocks32: torch.Tensor, dims, score: str) -> torch.Tensor:
    if score == "l2":
        return torch.sum(blocks32 * blocks32, dim=dims)
    if score == "l1":
        return torch.sum(torch.abs(blocks32), dim=dims)
    raise ValueError(f"score must be 'l1' or 'l2', got {score!r}")


def block_scores(w: torch.Tensor, block_size: int, *, score: str = "l2") -> torch.Tensor:
    """``(rows / bs, cols / bs)`` fp32 saliency of each block of a dense
    ``(rows, cols)`` matrix: the squared Frobenius norm (``"l2"``) or the
    absolute sum (``"l1"``)."""
    rows, cols = w.shape
    bs = block_size
    if rows % bs or cols % bs:
        raise ValueError(f"shape {tuple(w.shape)} not divisible by block_size {bs}")
    return _scores(w.reshape(rows // bs, bs, cols // bs, bs).float(), (1, 3), score)


def _top_k(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` largest scores, ties by the lower index."""
    return np.argsort(-scores, kind="stable")[:k]


def _topology(flat_sorted: np.ndarray, n_block_rows: int, n_block_cols: int):
    """CSR-order (offsets, column ids, row ids) of sorted flat block ids
    (row-major, so ascending flat order is block-CSR order)."""
    rows_b = (flat_sorted // n_block_cols).astype(np.int32)
    cols_b = (flat_sorted % n_block_cols).astype(np.int32)
    counts = np.bincount(rows_b, minlength=n_block_rows)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return offsets, cols_b, rows_b


def block_magnitude_prune(
    w: torch.Tensor,
    block_size: int,
    *,
    sparsity: Optional[float] = None,
    nnz_blocks: Optional[int] = None,
    score: str = "l2",
) -> BlockSparseMatrix:
    """One-shot block-magnitude pruning: dense -> BSR on ``w``'s device,
    the top-k blocks by norm. Exactly one of ``sparsity`` (the fraction of
    blocks removed) or ``nnz_blocks`` (blocks kept)."""
    rows, cols = w.shape
    bs = block_size
    n_br, n_bc = rows // bs, cols // bs
    total = n_br * n_bc
    if (sparsity is None) == (nnz_blocks is None):
        raise ValueError("pass exactly one of sparsity= or nnz_blocks=")
    if nnz_blocks is None:
        if not 0.0 <= sparsity < 1.0:
            raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
        nnz_blocks = max(1, int(round((1.0 - sparsity) * total)))
    k = int(nnz_blocks)
    if not 1 <= k <= total:
        raise ValueError(f"nnz_blocks {k} out of range [1, {total}]")
    scores = block_scores(w, bs, score=score).reshape(total).cpu().numpy()  # the one read back
    flat = np.sort(_top_k(scores, k))
    offsets, cols_b, rows_b = _topology(flat, n_br, n_bc)
    blocks = w.reshape(n_br, bs, n_bc, bs).transpose(1, 2).reshape(total, bs, bs)
    data = blocks[torch.as_tensor(flat, device=w.device)]
    return BlockSparseMatrix.create(data, offsets, cols_b, (rows, cols), row_indices=rows_b)


def gradual_sparsity(
    step: int,
    *,
    final_sparsity: float,
    initial_sparsity: float = 0.0,
    begin_step: int = 0,
    end_step: int,
) -> float:
    """Zhu & Gupta (2017): ``s(t) = s_f + (s_i - s_f) (1 - (t - t0) / (t1 -
    t0))^3`` with t clamped to [begin_step, end_step]; a Python float."""
    if end_step <= begin_step:
        raise ValueError("end_step must be > begin_step")
    t = min(max(int(step), begin_step), end_step)
    frac = (t - begin_step) / (end_step - begin_step)
    return final_sparsity + (initial_sparsity - final_sparsity) * (1.0 - frac) ** 3


def rigl_block_update(
    m: BlockSparseMatrix,
    dense_grad: torch.Tensor,
    *,
    drop_fraction: float = 0.3,
    score: str = "l2",
) -> BlockSparseMatrix:
    """One RigL refresh: drop the ``drop_fraction`` of active blocks with
    the smallest value norm, regrow as many blocks inactive before the
    update with the largest norm of ``dense_grad`` (the loss gradient with
    respect to the dense weight). The block count is unchanged; the
    row / column nnz hints are the budget-stable ``min(budget, block_cols)``
    and ``min(budget, block_rows)``, as the JAX package sets them."""
    bs = m.block_size
    n_br, n_bc = m.block_rows, m.block_cols
    total = n_br * n_bc
    k = m.nnz_blocks
    if tuple(dense_grad.shape) != m.shape:
        raise ValueError(f"dense_grad shape {tuple(dense_grad.shape)} != {m.shape}")
    if not 0.0 <= drop_fraction <= 1.0:
        raise ValueError(f"drop_fraction must be in [0, 1], got {drop_fraction}")
    n_drop = min(int(round(drop_fraction * k)), total - k)
    if n_drop <= 0:
        return m
    if m.host_known:
        rows_np, cols_np = m.host_row_indices(), m.host_metadata()[1]
    else:  # metadata built on the card: read back once, as the scores are
        rows_np, cols_np = m.row_indices.cpu().numpy(), m.indices.cpu().numpy()
    flat = rows_np.astype(np.int64) * n_bc + cols_np
    # One read back of both score vectors.
    wnorm = _scores(m.data.float(), (1, 2), score).cpu().numpy()
    gscore = block_scores(dense_grad, bs, score=score).reshape(total).cpu().numpy()
    keep_pos = _top_k(wnorm, k - n_drop)
    kept_flat = flat[keep_pos]
    active = np.zeros(total, bool)
    active[flat] = True
    grown_flat = _top_k(np.where(active, -np.inf, gscore), n_drop)
    new_flat = np.sort(np.concatenate([kept_flat, grown_flat]))
    offsets, cols_b, rows_b = _topology(new_flat, n_br, n_bc)
    posmap = np.full(total, -1, np.int64)
    posmap[kept_flat] = keep_pos
    src = posmap[new_flat]
    gathered = m.data[torch.as_tensor(np.maximum(src, 0), device=m.device)]
    data = torch.where(torch.as_tensor(src >= 0, device=m.device)[:, None, None], gathered,
                       torch.zeros((), dtype=m.dtype, device=m.device))
    return BlockSparseMatrix.create(data, offsets, cols_b, m.shape, row_indices=rows_b,
                                    max_row_nnz=min(k, n_bc), max_col_nnz=min(k, n_br))
