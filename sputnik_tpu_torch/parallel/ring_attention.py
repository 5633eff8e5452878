"""Ring block-sparse attention: context parallelism for sequences too long
to all-gather K/V (``sputnik_tpu/parallel/ring_attention.py``).

K/V stay sequence-sharded and ROTATE around the ring (``batch_isend_irecv``,
JAX's ``ppermute``: rank a sends to a + 1) while each query shard folds one
K/V band per step into an online-softmax state (acc, m, l). Memory per
rank: one band plus O(T_local * dh) state. The score topology is
partitioned into an (S x S) band grid on the host; each (query band, kv
band) cell is a small slot list, empty cells (banded topologies have many)
costing one padding-only fold.

Two band-fold paths:

* ``fused=True`` (default): each band folds through ONE kernel,
  ``flash_band_fold`` (``csrc/flash_fold.cu``), threading the UNnormalized
  state across ring steps. ``causal=True`` masks at GLOBAL block ids, so
  the result equals single-device elementwise-causal attention.
* ``fused=False``: the unfused chain (SDD + segment stats + DSD) with
  block-granular masking from the topology pattern only.

:func:`ring_step` is one rank's fold of one band, a plain function of
(rank i, held band j, the band, the state); :func:`ring_block_sparse_attention`
is its collective loop and :func:`ring_block_sparse_attention_sequential`
drives every rank's steps in turn in one process, handing each step the
band the rotation would have delivered (a smoke and test aid for one card;
no entry point calls it).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix, _host_numpy
from sputnik_tpu_torch.kernels.bsr_softmax import segment
from sputnik_tpu_torch.kernels.flash_attention import flash_band_fold
from sputnik_tpu_torch.kernels.flash_mha import NEG_INF
from sputnik_tpu_torch.parallel.attention import finalize, initial_state
from sputnik_tpu_torch.parallel.sharding import rank_of, ring_shift

__all__ = ["RingTopology", "partition_topology_ring", "ring_block_sparse_attention"]


class RingTopology:
    """(S x S) band grid of a score topology, shard-stacked (host-built).

    ``rows`` / ``cols``: (S, S, P) int32. Cell (i, j) holds query-band i's
    blocks over kv-band j, row / col ids rebased into the bands, padded to
    the global max cell size P; padding slots duplicate the cell's LAST
    real slot (rows stay non-decreasing) and are masked by ``valid``:
    (S, S) int32 real block counts."""

    def __init__(self, rows, cols, valid, n_shards, band_blocks, block_size):
        self.rows = rows
        self.cols = cols
        self.valid = valid
        self.n_shards = n_shards
        self.band_blocks = band_blocks
        self.block_size = block_size


def partition_topology_ring(topology: BlockSparseMatrix, n_shards: int) -> RingTopology:
    """Partition a (T, T)-block topology into the (S x S) band grid, on the
    topology's device."""
    if topology.block_rows % n_shards or topology.block_cols % n_shards:
        raise ValueError(
            f"block grid {topology.block_rows}x{topology.block_cols} not divisible by {n_shards}"
        )
    band = topology.block_rows // n_shards
    ri = _host_numpy(topology.row_indices)
    ci = _host_numpy(topology.indices)
    bi, bj = ri // band, ci // band
    cells = [[None] * n_shards for _ in range(n_shards)]
    p = 1
    for i in range(n_shards):
        for j in range(n_shards):
            sel = (bi == i) & (bj == j)
            cells[i][j] = (ri[sel] - i * band, ci[sel] - j * band)
            p = max(p, int(sel.sum()))
    rows = np.zeros((n_shards, n_shards, p), np.int32)
    cols = np.zeros((n_shards, n_shards, p), np.int32)
    valid = np.zeros((n_shards, n_shards), np.int32)
    for i in range(n_shards):
        for j in range(n_shards):
            r, c = cells[i][j]
            n = len(r)
            valid[i, j] = n
            rows[i, j, :n] = r
            cols[i, j, :n] = c
            if n:  # the last real slot repeated: rows stay non-decreasing
                rows[i, j, n:] = r[-1]
                cols[i, j, n:] = c[-1]
    device = topology.data.device
    return RingTopology(torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device),
                        torch.from_numpy(valid).to(device), n_shards, band, topology.block_size)


def _band_fold(q_l, k_band, v_band, rows, cols, valid, band_blocks, bs, scale, state):
    """Fold one K/V band into the (acc, m, l) state through the unfused
    chain: SDD scores, segment max / sum over the block-rows, DSD."""
    acc, m, l = state
    t_local = q_l.shape[0]
    p = rows.shape[0]
    device = q_l.device
    counts = torch.zeros(band_blocks, dtype=torch.int32, device=device).index_add_(
        0, rows.long(), torch.ones(p, dtype=torch.int32, device=device))
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=device), counts.cumsum(0).to(torch.int32)])
    topo = BlockSparseMatrix.create(torch.zeros((p, bs, bs), dtype=q_l.dtype, device=device), offsets, cols,
                                    (t_local, band_blocks * bs), row_indices=rows)
    scores = ops.matmul_sdd(q_l, k_band, topo, transpose_b=True)
    # Cell-padding slots (duplicates of the last real slot) to -1e30.
    ok = (torch.arange(p, device=device) < valid)[:, None, None]
    sdata = torch.where(ok, scores.data.float() * scale, NEG_INF)
    m_band = segment(sdata.amax(dim=2), offsets, "max", initial=NEG_INF).reshape(-1)  # (t_local,)
    m_new = torch.maximum(m, m_band)
    e = torch.exp(sdata - m_new.reshape(band_blocks, bs)[rows.long()][:, :, None])
    # Rows that have seen no valid block anywhere still carry m_new = -1e30,
    # where a padded block's exp(-1e30 - (-1e30)) = 1 would leak in: mask.
    e = torch.where(ok, e, 0.0)
    l_band = segment(e.sum(dim=2), offsets, "sum").reshape(-1)
    o_band = ops.matmul_dsd(scores.with_data(e.to(q_l.dtype)), v_band, out_dtype=torch.float32)
    corr = torch.exp(m - m_new)
    return acc * corr[:, None] + o_band, m_new, l * corr + l_band


def ring_step(q_l: torch.Tensor, k_band: torch.Tensor, v_band: torch.Tensor, topology: RingTopology, i: int, j: int,
              state, *, scale: float, causal: bool, fused: bool):
    """Rank ``i``'s fold of kv band ``j`` (held in ``k_band`` / ``v_band``)
    into ``state``."""
    rows, cols = topology.rows[i, j], topology.cols[i, j]
    valid = topology.valid[i, j]
    band, bs = topology.band_blocks, topology.block_size
    if fused:
        flags = (torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device) < valid).to(torch.int32)
        return flash_band_fold(q_l, k_band, v_band, rows, cols, flags, state, bs=bs, scale=scale, causal=causal,
                               row_offset_blocks=i * band, col_offset_blocks=j * band)
    return _band_fold(q_l, k_band, v_band, rows, cols, valid, band, bs, scale, state)


def _start(q_l: torch.Tensor, fused: bool):
    t, dh = q_l.shape
    if fused:
        return initial_state(t, dh, q_l.device)
    return (torch.zeros((t, dh), dtype=torch.float32, device=q_l.device),
            torch.full((t,), NEG_INF, dtype=torch.float32, device=q_l.device),
            torch.zeros((t,), dtype=torch.float32, device=q_l.device))


def _finish(state, dtype, fused: bool) -> torch.Tensor:
    acc, _, l = state
    return finalize(acc, l[:, 0:1] if fused else l[:, None], dtype)


def _check(q, topology: RingTopology, causal: bool, fused: bool, scale):
    if causal and not fused:
        raise ValueError("causal masking requires the fused band fold")
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def ring_block_sparse_attention(
    q: torch.Tensor,  # (T / S, dh): this rank's band of each
    k: torch.Tensor,
    v: torch.Tensor,
    topology: RingTopology,
    group=None,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    fused: bool = True,
) -> torch.Tensor:
    """Ring attention over ``group``; q, k, v stay sharded, and the result
    is this rank's rows. ``causal=True`` (fused path only) masks each score
    block to the exact global causal triangle."""
    scale = _check(q, topology, causal, fused, scale)
    s = topology.n_shards
    i = rank_of(group, s)
    k_buf, v_buf = k.contiguous(), v.contiguous()
    state = _start(q, fused)
    for r in range(s):
        j = (i - r) % s  # kv band currently held
        if r != s - 1:  # issue the rotation before the fold
            k_next, v_next = torch.empty_like(k_buf), torch.empty_like(v_buf)
            reqs = ring_shift([k_buf, v_buf], [k_next, v_next], dst=(i + 1) % s, src=(i - 1) % s, group=group)
        state = ring_step(q, k_buf, v_buf, topology, i, j, state, scale=scale, causal=causal, fused=fused)
        if r != s - 1:
            for req in reqs:
                req.wait()
            k_buf, v_buf = k_next, v_next
    return _finish(state, q.dtype, fused)


def ring_block_sparse_attention_sequential(q, k, v, topology: RingTopology, *, scale: Optional[float] = None,
                                           causal: bool = False, fused: bool = True) -> List[torch.Tensor]:
    """Every rank's :func:`ring_block_sparse_attention` output in turn, from
    the whole q, k, v: step r of rank i folds band ``(i - r) % S``, the
    one the rotation delivers."""
    scale = _check(q, topology, causal, fused, scale)
    s = topology.n_shards
    qs, ks, vs = (x.chunk(s) for x in (q, k, v))
    outs = []
    for i in range(s):
        q_l = qs[i].contiguous()
        state = _start(q_l, fused)
        for r in range(s):
            j = (i - r) % s
            state = ring_step(q_l, ks[j].contiguous(), vs[j].contiguous(), topology, i, j, state, scale=scale,
                              causal=causal, fused=fused)
        outs.append(_finish(state, q.dtype, fused))
    return outs
