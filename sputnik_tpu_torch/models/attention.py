"""Block-sparse attention: SDD (scores) -> BSR softmax -> DSD (output), or
the fused flash kernels.

Port of ``sputnik_tpu/models/attention.py``: the band and causal
topologies, multi-head and single-head attention (unfused, or ``fused=True``
through ``flash_mha``) and the band decode attention. Heads are a batch
axis of the ops (one kernel launch per op for all heads) where the JAX
package ``vmap``-s a single-head function.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels.flash_mha import flash_mha

__all__ = [
    "band_topology",
    "causal_block_topology",
    "block_sparse_attention",
    "multihead_block_sparse_attention",
    "decode_band_attention",
]


def _topology_from_mask(mask: np.ndarray, t: int, bs: int, dtype, device) -> BlockSparseMatrix:
    rows, cols = np.nonzero(mask)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=t // bs))]).astype(np.int32)
    data = torch.zeros((len(rows), bs, bs), dtype=dtype, device=device)
    return BlockSparseMatrix.create(data, offsets, cols.astype(np.int32), (t, t))


def band_topology(
    seq_len: int, window_blocks: int, block_size: int = 128, *,
    dtype=torch.bfloat16, device=None, global_blocks: int = 0,
) -> BlockSparseMatrix:
    """Banded (local-window) score topology, optionally with leading global
    blocks attending everywhere and attended by everyone."""
    nb = seq_len // block_size
    r = np.arange(nb)[:, None]
    c = np.arange(nb)[None, :]
    mask = np.abs(r - c) < window_blocks
    if global_blocks:
        mask[:global_blocks, :] = True
        mask[:, :global_blocks] = True
    return _topology_from_mask(mask, seq_len, block_size, dtype, device)


def causal_block_topology(
    seq_len: int, block_size: int = 128, *, window_blocks: Optional[int] = None,
    dtype=torch.bfloat16, device=None,
) -> BlockSparseMatrix:
    """Block-lower-triangular topology, optionally banded; use with
    ``bsr_softmax(..., causal=True)`` for exact causal attention."""
    nb = seq_len // block_size
    r = np.arange(nb)[:, None]
    c = np.arange(nb)[None, :]
    mask = c <= r
    if window_blocks is not None:
        mask &= (r - c) < window_blocks
    return _topology_from_mask(mask, seq_len, block_size, dtype, device)


def multihead_block_sparse_attention(
    q: torch.Tensor,  # (H, T, dh)
    k: torch.Tensor,
    v: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    fused: bool = False,
) -> torch.Tensor:
    """(H, T, dh) attention over a score topology shared by all heads: one
    SDD and one DSD for all heads, or with ``fused=True`` one ``flash_mha``
    (the JAX package's route for concrete metadata, which the port always
    has). Returns (H, T, dh)."""
    if fused:
        return flash_mha(q, k, v, topology, causal=causal, scale=scale)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = ops.sdd(q.contiguous(), k.contiguous(), topology, transpose_b=True)
    probs = ops.bsr_softmax(scores, scale=scale, causal=causal)
    return ops.dsd(probs, v.contiguous())


def block_sparse_attention(q, k, v, topology, *, causal: bool = False, scale: Optional[float] = None,
                           fused: bool = False):
    """Single-head (T, dh) block-sparse attention; ``fused=True`` runs the
    multi-head flash kernel with one head, as the JAX package does."""
    return multihead_block_sparse_attention(
        q[None], k[None], v[None], topology, causal=causal, scale=scale, fused=fused
    )[0]


def _attend_pages(q, k_sel, v_sel, sel_valid, scale):
    """Exact softmax attention of one query over gathered KV pages:
    q (..., dh), k_sel / v_sel (..., n, bs, dh), sel_valid (n, bs)."""
    scores = torch.einsum("...kbd,...d->...kb", k_sel.float(), q.float()) * scale
    scores = scores.masked_fill(~sel_valid, float("-inf"))
    m = scores.amax(dim=(-2, -1), keepdim=True).clamp(min=-3e38)  # all-masked guard
    e = torch.where(sel_valid, torch.exp(scores - m), 0.0)
    denom = e.sum(dim=(-2, -1)).clamp(min=1e-30)[..., None]
    out = torch.einsum("...kb,...kbd->...d", e, v_sel.float()) / denom
    return out.to(q.dtype)


def decode_band_attention(
    q: torch.Tensor,  # (..., dh)
    k_cache: torch.Tensor,  # (..., T, dh)
    v_cache: torch.Tensor,
    window_blocks: int,
    pos: int,
    *,
    block_size: int = 128,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode-step attention with the training band topology's mask: the
    token at ``pos`` attends to cache pages ``(pos//bs - window_blocks,
    pos//bs]`` at positions ``<= pos``. Leading axes (batch, heads) are
    independent queries over their own caches. ``pos`` is a host int: the
    decode loop runs in Python, one position for the whole batch."""
    t, dh = k_cache.shape[-2:]
    bs = block_size
    if t % bs:
        raise ValueError(f"cache len {t} not divisible by block {bs}")
    s_k = t // bs
    if not 1 <= window_blocks <= s_k:
        raise ValueError(f"window_blocks {window_blocks} out of range [1, {s_k}]")
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    dev = k_cache.device
    pages = pos // bs - window_blocks + 1 + torch.arange(window_blocks, device=dev)
    page_ok = pages >= 0  # early positions: window clipped at the start
    idx = pages.clamp(min=0)
    sel_pos = idx[:, None] * bs + torch.arange(bs, device=dev)[None, :]
    sel_valid = (sel_pos <= pos) & page_ok[:, None]
    kb = k_cache.reshape(k_cache.shape[:-2] + (s_k, bs, dh))
    vb = v_cache.reshape(v_cache.shape[:-2] + (s_k, bs, dh))
    return _attend_pages(q, kb[..., idx, :, :], vb[..., idx, :, :], sel_valid, scale)
