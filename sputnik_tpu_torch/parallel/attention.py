"""Sequence-parallel block-sparse attention over a process group
(``sputnik_tpu/parallel/attention.py``).

The QUERY sequence is sharded: the score topology is row-partitioned with
the queries (each rank owns the score block-rows of its query band), so
SDD, the row softmax and the DSD against V are all local. K/V move instead
of scores: replicated (no communication) or sequence-sharded and
all-gathered before the local chain. For contexts too long to gather, see
``parallel/ring_attention.py``.

``fused=True`` runs each rank's chain through one flash band fold
(``kernels/flash_attention.py::flash_band_fold``, exact elementwise causal
at global block ids); ``fused=False`` keeps the SDD -> softmax -> DSD
chain, with shard-padding slots masked to -inf. Causal masking there is
taken at global coordinates too: JAX shifts the local topology's row ids
by the query band and asks ``bsr_softmax`` for its causal mask; the port's
softmax reduces rows through the local offsets, so the same global-diagonal
mask is applied to the scores before a non-causal softmax instead (the
same values: masking commutes with the scale).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels.flash_attention import LANES, flash_band_fold
from sputnik_tpu_torch.kernels.flash_mha import NEG_INF
from sputnik_tpu_torch.parallel.sharding import ShardedBlockSparseMatrix, all_gather, partition_bsr_rows, rank_of

__all__ = ["sharded_block_sparse_attention", "partition_topology_rows"]


def partition_topology_rows(topology: BlockSparseMatrix, n_shards: int) -> ShardedBlockSparseMatrix:
    """Row-partition a score topology with the query bands (host-side)."""
    return partition_bsr_rows(topology, n_shards)


def initial_state(t: int, dh: int, device) -> tuple:
    """The fold's empty state: acc 0, m -1e30, l 0 (fp32)."""
    return (torch.zeros((t, dh), dtype=torch.float32, device=device),
            torch.full((t, LANES), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((t, LANES), dtype=torch.float32, device=device))


def finalize(acc: torch.Tensor, l_col: torch.Tensor, dtype) -> torch.Tensor:
    """acc / l, with rows that saw no block (l == 0) exactly zero."""
    out = acc / l_col.clamp(min=1e-30)
    return torch.where(l_col > 0, out, 0.0).to(dtype)


def valid_counts(topology: ShardedBlockSparseMatrix) -> torch.Tensor:
    if topology.valid_counts is not None:
        return topology.valid_counts
    # Structures without valid_counts: every slot is real.
    return torch.full((topology.n_shards,), topology.data.shape[1], dtype=torch.int32, device=topology.data.device)


def _global_causal(scores: BlockSparseMatrix, row_offset_blocks: int) -> BlockSparseMatrix:
    """Scores outside the causal triangle at GLOBAL block ids set to -inf."""
    bs = scores.block_size
    idx = torch.arange(bs, device=scores.data.device)
    rows = scores.row_indices + row_offset_blocks
    cols = scores.indices
    keep = torch.where((rows == cols)[:, None, None], (idx[:, None] >= idx[None, :])[None],
                       (rows > cols)[:, None, None])
    return scores.with_data(scores.data.masked_fill(~keep, float("-inf")))


def attention_rank(q_l: torch.Tensor, k_full: torch.Tensor, v_full: torch.Tensor, topology: ShardedBlockSparseMatrix,
                   s: int, *, causal: bool, scale: float, fused: bool) -> torch.Tensor:
    """Rank ``s``'s body of :func:`sharded_block_sparse_attention`: its query
    band against the whole K / V."""
    topo_l = topology.local_matrix(s)
    bs = topology.block_size
    row_offset = s * (topology.local_rows // bs)
    nnz = topo_l.nnz_blocks
    real = torch.arange(nnz, dtype=torch.int32, device=q_l.device) < valid_counts(topology)[s]
    if fused:
        acc, _, l = flash_band_fold(
            q_l, k_full, v_full, topo_l.row_indices, topo_l.indices, real.to(torch.int32),
            initial_state(q_l.shape[0], q_l.shape[1], q_l.device), bs=bs, scale=scale, causal=causal,
            row_offset_blocks=row_offset, col_offset_blocks=0,
        )
        return finalize(acc, l[:, 0:1], q_l.dtype)
    scores = ops.matmul_sdd(q_l, k_full, topo_l, transpose_b=True)
    # Shard-padding blocks are duplicate slots: SDD writes scores into
    # them, which would count twice in the row softmax. Mask to -inf so
    # they carry zero probability (and add zero in the DSD).
    scores = scores.with_data(scores.data.masked_fill(~real[:, None, None], float("-inf")))
    if causal:
        scores = _global_causal(scores, row_offset)
    probs = ops.bsr_softmax(scores, scale=scale)
    return ops.matmul_dsd(probs, v_full, out_dtype=q_l.dtype)


def sharded_block_sparse_attention(
    q: torch.Tensor,  # (T / S, dh): this rank's query band
    k: torch.Tensor,  # (T, dh) replicated, or (T / S, dh) this rank's band
    v: torch.Tensor,
    topology: ShardedBlockSparseMatrix,
    group=None,
    *,
    kv_replicated: bool = True,
    causal: bool = False,
    scale: Optional[float] = None,
    fused: bool = True,
) -> torch.Tensor:
    """Sequence-parallel single-head block-sparse attention: this rank's
    rows of the output. Communication: none (replicated K/V) or one K/V
    all-gather (sequence-sharded K/V)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = rank_of(group, topology.n_shards)
    if not kv_replicated:
        k, v = all_gather(k, group), all_gather(v, group)
    return attention_rank(q, k, v, topology, s, causal=causal, scale=scale, fused=fused)


def sharded_block_sparse_attention_sequential(q, k, v, topology: ShardedBlockSparseMatrix, *, causal: bool = False,
                                              scale: Optional[float] = None,
                                              fused: bool = True) -> List[torch.Tensor]:
    """Every rank's :func:`sharded_block_sparse_attention` output in turn,
    from the whole q, k, v (what the K/V gather delivers too): a smoke and
    test aid for one card; no entry point calls it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return [attention_rank(q_s.contiguous(), k, v, topology, s, causal=causal, scale=scale, fused=fused)
            for s, q_s in enumerate(q.chunk(topology.n_shards))]
