"""Distributed layer: partitioned sparse matmuls and sequence-parallel and
ring block-sparse attention over a ``torch.distributed`` process group
(``sputnik_tpu/parallel``). Each op takes the rank's local shards and a
``group`` where JAX takes global arrays and a ``Mesh``; see
``parallel/sharding.py``. The pipeline and the communication audit are
not ported yet."""

from sputnik_tpu_torch.parallel.attention import partition_topology_rows, sharded_block_sparse_attention
from sputnik_tpu_torch.parallel.ring_attention import (
    RingTopology,
    partition_topology_ring,
    ring_block_sparse_attention,
)
from sputnik_tpu_torch.parallel.sharding import (
    BandedShardedBlockSparseMatrix,
    ShardedBlockSparseMatrix,
    ShardedCsrMatrix,
    ShardedSellMatrix,
    partition_bsr_rows,
    partition_bsr_rows_kbands,
    partition_csr_rows,
    partition_sell_cols,
    partition_sell_rows,
    sharded_dsd,
    sharded_dsd_ring,
    sharded_sdd,
    sharded_spmm,
    sharded_spmm_kshard,
    sharded_spmm_sell,
)

__all__ = [
    "BandedShardedBlockSparseMatrix",
    "ShardedBlockSparseMatrix",
    "ShardedCsrMatrix",
    "ShardedSellMatrix",
    "partition_bsr_rows",
    "partition_bsr_rows_kbands",
    "partition_csr_rows",
    "partition_sell_rows",
    "partition_sell_cols",
    "sharded_dsd",
    "sharded_dsd_ring",
    "sharded_sdd",
    "sharded_spmm",
    "sharded_spmm_sell",
    "sharded_spmm_kshard",
    "sharded_block_sparse_attention",
    "partition_topology_rows",
    "RingTopology",
    "partition_topology_ring",
    "ring_block_sparse_attention",
]
