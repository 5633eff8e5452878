"""Block-sparse attention: SDD (scores) -> BSR softmax -> DSD (output), or
the fused flash kernels.

Port of ``sputnik_tpu/models/attention.py``: the band and causal
topologies, the content-routed top-k topology (built on the card), multi-
and single-head attention (unfused, or ``fused=True`` through the flash
kernels), and the band and top-k decode attention. Heads are a batch axis
of the ops (one kernel launch per op for all heads) where the JAX package
``vmap``-s a single-head function.

``fused=True`` routes as the JAX package does, with its "concrete
metadata" read as "metadata known on the host"
(``BlockSparseMatrix.host_known``): host-known topologies go to
``flash_mha`` (a duplicated block counted once), topologies built on the
card to ``flash_block_attention`` (every stored block).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels.flash_attention import flash_attention_heads, flash_block_attention
from sputnik_tpu_torch.kernels.flash_mha import flash_mha
from sputnik_tpu_torch.utils import tracing
from sputnik_tpu_torch.utils.device import resolve_device

__all__ = [
    "flash_block_attention",
    "band_topology",
    "causal_block_topology",
    "topk_block_topology",
    "decode_topk_attention",
    "block_sparse_attention",
    "multihead_block_sparse_attention",
    "decode_band_attention",
]


def _topology_from_mask(mask: np.ndarray, t: int, bs: int, dtype, device) -> BlockSparseMatrix:
    device = resolve_device(device)
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
    blocks attending everywhere and attended by everyone. ``device=None``
    builds on the card."""
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
    ``bsr_softmax(..., causal=True)`` for exact causal attention.
    ``device=None`` builds on the card."""
    nb = seq_len // block_size
    r = np.arange(nb)[:, None]
    c = np.arange(nb)[None, :]
    mask = c <= r
    if window_blocks is not None:
        mask &= (r - c) < window_blocks
    return _topology_from_mask(mask, seq_len, block_size, dtype, device)


def topk_block_topology(
    q: torch.Tensor,  # (T, dh)
    k: torch.Tensor,  # (Tk, dh)
    k_blocks: int,
    *,
    block_size: int = 128,
    causal: bool = True,
    include_local: bool = True,
    dtype=None,
) -> BlockSparseMatrix:
    """Content-routed topology: per query block, the ``k_blocks`` key blocks
    of highest mean-pooled q.k^T block score, built on q's device with no
    read back (``torch.topk``, then a sort). Every block-row holds exactly
    ``k_blocks`` blocks; the hints are ``max_row_nnz = k_blocks`` and
    ``max_col_nnz = T / block_size``, as the JAX package sets them. Metadata
    built on the card is not host-known, so ``fused=True`` attention over it
    takes ``flash_block_attention``.

    ``include_local`` forces each query block's diagonal key block in.
    Under ``causal=True`` future blocks rank below every valid one, in a
    fixed order; rows too early to have ``k_blocks`` valid blocks select some
    future blocks, which the causal softmax masks to zero."""
    bs = block_size
    t, tk = q.shape[0], k.shape[0]
    if t % bs or tk % bs:
        raise ValueError(f"seq lens ({t}, {tk}) not divisible by block {bs}")
    s_q, s_k = t // bs, tk // bs
    if not 1 <= k_blocks <= s_k:
        raise ValueError(f"k_blocks {k_blocks} out of range [1, {s_k}]")
    dev = q.device
    qp = q.reshape(s_q, bs, -1).mean(dim=1).float()
    kp = k.reshape(s_k, bs, -1).mean(dim=1).float()
    scores = qp @ kp.T  # (s_q, s_k) pooled block scores
    r = torch.arange(s_q, device=dev)[:, None]
    c = torch.arange(s_k, device=dev)[None, :]
    if causal:
        # Future blocks below every valid one; the column term makes which
        # of them win fixed (its 1024 step is above the fp32 ulp at 1e9).
        scores = torch.where(c <= r, scores, -1e9 - c.float() * 1024.0)
    if include_local:
        scores = torch.where(c == r.clamp(max=s_k - 1), float("inf"), scores)
    idx = torch.topk(scores, k_blocks, dim=1).indices.sort(dim=1).values  # distinct columns
    offsets = torch.arange(s_q + 1, dtype=torch.int32, device=dev) * k_blocks
    indices = idx.reshape(-1).to(torch.int32)
    row_indices = torch.arange(s_q * k_blocks, dtype=torch.int32, device=dev) // k_blocks
    data = torch.zeros((s_q * k_blocks, bs, bs), dtype=dtype or q.dtype, device=dev)
    return BlockSparseMatrix.create(data, offsets, indices, (t, tk), row_indices=row_indices,
                                    max_row_nnz=k_blocks, max_col_nnz=s_q)


@tracing.traced("attention", inputs=(0, 1, 2))
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
    SDD, one softmax and one DSD for all heads, or with ``fused=True`` the
    flash kernels: ``flash_mha`` for host-known metadata, else
    ``flash_block_attention`` for each head (one launch for all). Returns
    (H, T, dh)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if fused:
        if topology.host_known:
            return flash_mha(q, k, v, topology, causal=causal, scale=scale)
        return flash_attention_heads(q, k, v, topology, causal=causal, scale=scale)
    scores = ops.sdd(q.contiguous(), k.contiguous(), topology, transpose_b=True)
    probs = ops.bsr_softmax(scores, scale=scale, causal=causal)
    return ops.dsd(probs, v.contiguous())


def block_sparse_attention(q, k, v, topology, *, causal: bool = False, scale: Optional[float] = None,
                           fused: bool = False):
    """Single-head (T, dh) block-sparse attention; ``fused=True`` runs
    ``flash_mha`` with one head on host-known metadata and
    ``flash_block_attention`` on metadata built on the card, as the JAX
    package routes concrete and traced metadata."""
    return multihead_block_sparse_attention(
        q[None], k[None], v[None], topology, causal=causal, scale=scale, fused=fused
    )[0]


def _attend_pages(q, k_sel, v_sel, sel_valid, scale):
    """Exact softmax attention of one query over gathered KV pages:
    q (..., dh), k_sel / v_sel (..., n, bs, dh), sel_valid (n, bs) or, per
    query, (..., n, bs)."""
    scores = torch.einsum("...kbd,...d->...kb", k_sel.float(), q.float()) * scale
    scores = scores.masked_fill(~sel_valid, float("-inf"))
    m = scores.amax(dim=(-2, -1), keepdim=True).clamp(min=-3e38)  # all-masked guard
    e = torch.where(sel_valid, torch.exp(scores - m), 0.0)
    denom = e.sum(dim=(-2, -1)).clamp(min=1e-30)[..., None]
    out = torch.einsum("...kb,...kbd->...d", e, v_sel.float()) / denom
    return out.to(q.dtype)


@tracing.traced("attention", inputs=(0, 1, 2))
def decode_topk_attention(
    q: torch.Tensor,  # (..., dh): one decode step
    k_cache: torch.Tensor,  # (..., T, dh)
    v_cache: torch.Tensor,
    k_blocks: int,
    *,
    block_size: int = 128,
    valid_len=None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a block-paged KV cache with
    content-routed pages (Quest-style): rank the cache's ``block_size``
    pages by pooled q.k score, then exact softmax attention over the top
    ``k_blocks`` pages only. Leading axes (batch, heads) are independent
    queries over their own caches, each choosing its own pages.

    ``valid_len`` (an int, or a tensor broadcasting against the leading
    axes) masks cache positions ``>= valid_len``: they get no probability,
    the pooled page keys average valid positions only, and pages with no
    valid position rank below every valid page, in a fixed order."""
    t, dh = k_cache.shape[-2:]
    bs = block_size
    if t % bs:
        raise ValueError(f"cache len {t} not divisible by block {bs}")
    s_k = t // bs
    if not 1 <= k_blocks <= s_k:
        raise ValueError(f"k_blocks {k_blocks} out of range [1, {s_k}]")
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    dev = k_cache.device
    lead = k_cache.shape[:-2]
    kb = k_cache.reshape(lead + (s_k, bs, dh))
    vb = v_cache.reshape(lead + (s_k, bs, dh))
    pos = torch.arange(t, device=dev).reshape(s_k, bs)
    if valid_len is not None:
        # (s_k, bs), or (..., s_k, bs) for a tensor of lengths.
        valid = pos < (valid_len[..., None, None] if isinstance(valid_len, torch.Tensor) else valid_len)
        # Sums in fp32 as the keys are read (no fp32 copy of the cache).
        kpool = torch.where(valid[..., None], kb, 0).sum(dim=-2, dtype=torch.float32) \
            / valid.sum(dim=-1).clamp(min=1)[..., None]
    else:
        valid = torch.ones((s_k, bs), dtype=torch.bool, device=dev)
        kpool = kb.sum(dim=-2, dtype=torch.float32) / bs
    page_scores = torch.einsum("...kd,...d->...k", kpool, q.float())
    if valid_len is not None:
        fill = -1e9 - torch.arange(s_k, device=dev, dtype=torch.float32) * 1024.0
        page_scores = torch.where(valid.any(dim=-1), page_scores, fill)
    idx = torch.topk(page_scores, k_blocks, dim=-1).indices  # (..., k_blocks) distinct pages
    gather = idx[..., None, None].expand(idx.shape + (bs, dh))
    sel_valid = torch.gather(valid.expand(page_scores.shape + (bs,)), -2,
                             idx[..., None].expand(idx.shape + (bs,)))
    return _attend_pages(q, torch.gather(kb, -3, gather), torch.gather(vb, -3, gather), sel_valid, scale)


@tracing.traced("attention", inputs=(0, 1, 2))
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
