"""Row- and contraction-partitioned sparse matmuls over a
``torch.distributed`` process group (``sputnik_tpu/parallel/sharding.py``).

The partitioners are the JAX package's, step for step, on the host
(numpy): a sparse matrix is split into equal bands of rows, each shard a
complete local BSR / CSR / SELL, padded to one nnz so that the stacked
arrays are rectangular; only the dense operand ever moves. The structures
keep all S shards stacked, on the device of the matrix they were made
from.

Where JAX passes global arrays and a ``Mesh`` to ``shard_map``, PyTorch is
SPMD over processes. So each op here

* takes ``group`` (``None``: the default group) in place of ``mesh`` /
  ``axis``; its size must equal the operand's ``n_shards``;
* takes the rank's local shard of every sharded dense operand and returns
  the rank's local shard of the output;
* takes the sharded sparse structure as the partitioner built it, and
  selects shard ``dist.get_rank(group)``.

JAX's collectives map to ``all_gather_into_tensor`` (``all_gather(tiled)``),
``reduce_scatter_tensor`` (``psum_scatter(tiled)``) and
``batch_isend_irecv`` (``ppermute``), each taking its single-tensor name
where the installed torch has it. They run on the tensors' device: NCCL on
the card, gloo on the CPU.

Each op is a per-rank body (``*_rank`` / ``*_step``: a plain function of
the rank and what the collectives delivered) and its collective glue. The
``*_sequential`` functions run all S ranks' bodies in turn in one process,
handing each the operand its collectives would have delivered, and return
the S local outputs: a smoke and test aid for one card, where NCCL refuses
two ranks on one device. No entry point falls back to them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sputnik_tpu_torch.formats import BlockSparseMatrix, CsrMatrix, SellMatrix, _host_numpy
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_sdd
from sputnik_tpu_torch.kernels import sell as sell_kernels
from sputnik_tpu_torch.ops import csr as csr_ops

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
]


# ----------------------------------------------------------- collectives --
def rank_of(group, n_shards: int) -> int:
    """This process's rank in ``group``, after JAX's check that the mesh
    axis holds as many devices as the operand has shards."""
    world = dist.get_world_size(group)
    if world != n_shards:
        raise ValueError(f"process group has {world} ranks, operand has {n_shards} shards")
    return dist.get_rank(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather(tiled=True)`` along dim 0."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``psum_scatter(scatter_dimension=0, tiled=True)``."""
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + tuple(x.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    scatter(out, x.contiguous(), group=group)
    return out


def ring_shift(sends, recvs, *, dst: int, src: int, group):
    """Issue one ``ppermute`` step: each of ``sends`` to rank ``dst``, each
    of ``recvs`` from rank ``src`` (ranks of ``group``). Returns the
    requests; wait on them before reading ``recvs``."""

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    ops = [dist.P2POp(dist.isend, x, peer(dst), group) for x in sends]
    ops += [dist.P2POp(dist.irecv, y, peer(src), group) for y in recvs]
    return dist.batch_isend_irecv(ops)


# ------------------------------------------------------------------- BSR --
@dataclasses.dataclass(frozen=True)
class ShardedBlockSparseMatrix:
    """Row-partitioned BSR: shard-stacked local matrices with equal padded
    nnz. ``data[s]`` etc. is shard s's local BSR over block-rows
    ``[s * rows_per_shard, (s+1) * rows_per_shard)``. ``valid_counts[s]`` is
    the number of REAL (non-padding) blocks in shard s: padding blocks are
    zero-valued duplicate slots, inert in matmuls, but ops that WRITE into
    the topology (SDD -> softmax) must mask slots past this count."""

    data: torch.Tensor  # (S, P, bs, bs)
    offsets: torch.Tensor  # (S, local_block_rows + 1)
    indices: torch.Tensor  # (S, P)
    row_indices: torch.Tensor  # (S, P) local block-row ids
    shape: Tuple[int, int]  # global
    block_size: int
    n_shards: int
    max_row_nnz: Optional[int]
    valid_counts: Optional[torch.Tensor] = None  # (S,) int32

    @property
    def local_rows(self) -> int:
        return self.shape[0] // self.n_shards

    def local_matrix(self, s: Optional[int] = None) -> BlockSparseMatrix:
        """Shard ``s``'s local BSR (shard 0 for ``None``)."""
        i = 0 if s is None else s
        return _local_bsr(self, self.data[i], self.offsets[i], self.indices[i], self.row_indices[i])


def _local_bsr(sm, data, offsets, indices, row_indices) -> BlockSparseMatrix:
    """The local BSR of one shard's arrays."""
    return BlockSparseMatrix.create(
        data, offsets, indices, (sm.local_rows, sm.shape[1]), row_indices=row_indices, max_row_nnz=sm.max_row_nnz,
    )


def _stack(parts, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.stack(parts)).to(device=device, dtype=dtype)


def partition_bsr_rows(m: BlockSparseMatrix, n_shards: int) -> ShardedBlockSparseMatrix:
    """Split a BSR into ``n_shards`` equal bands of block-rows (host-side).

    Shards are padded to the max per-shard nnz with zero-valued blocks
    duplicating the shard's last slot, (last local row, 0) for an empty
    shard, the padding attributed to the last local row."""
    if m.block_rows % n_shards:
        raise ValueError(f"block_rows {m.block_rows} not divisible by {n_shards}")
    rows_per = m.block_rows // n_shards
    offs = _host_numpy(m.offsets)
    idx = _host_numpy(m.indices)
    rowid = _host_numpy(m.row_indices)
    data = _host_numpy(m.data)

    shards = []
    for s in range(n_shards):
        lo, hi = offs[s * rows_per], offs[(s + 1) * rows_per]
        local_offs = offs[s * rows_per: (s + 1) * rows_per + 1] - lo
        shards.append((data[lo:hi], local_offs, idx[lo:hi], rowid[lo:hi] - s * rows_per))
    pad_to = max(max(sh[0].shape[0] for sh in shards), 1)
    bs = m.block_size

    d_out, o_out, i_out, r_out = [], [], [], []
    for d, o, i, r in shards:
        n = d.shape[0]
        pad = pad_to - n
        if pad:
            d = np.concatenate([d, np.zeros((pad, bs, bs), d.dtype)])
            i = np.concatenate([i, np.full(pad, i[-1] if n else 0, np.int32)])
            r = np.concatenate([r, np.full(pad, r[-1] if n else rows_per - 1, np.int32)])
            o = o.copy()
            o[-1] += pad
        d_out.append(d)
        o_out.append(o)
        i_out.append(i)
        r_out.append(r)
    device = m.data.device
    return ShardedBlockSparseMatrix(
        data=_stack(d_out, m.dtype, device),
        offsets=_stack(o_out, torch.int32, device),
        indices=_stack(i_out, torch.int32, device),
        row_indices=_stack(r_out, torch.int32, device),
        shape=m.shape,
        block_size=bs,
        n_shards=n_shards,
        max_row_nnz=None,
        valid_counts=torch.tensor([sh[0].shape[0] for sh in shards], dtype=torch.int32, device=device),
    )


def dsd_rank(a: ShardedBlockSparseMatrix, s: int, b_full: torch.Tensor, *, out_dtype=None, **options):
    """Rank ``s``'s body of :func:`sharded_dsd`: its rows of A @ B."""
    return bsr_dsd.dsd(a.local_matrix(s), b_full, out_dtype=out_dtype, **options)


def sharded_dsd(a: ShardedBlockSparseMatrix, b: torch.Tensor, group=None, *, b_sharded_k: bool = False,
                out_dtype=None, **options) -> torch.Tensor:
    """Row-partitioned SpMM: this rank's rows of A_sharded @ B.

    ``b_sharded_k=False``: ``b`` is the whole B, replicated; no
    communication. ``b_sharded_k=True``: ``b`` is this rank's K band of B,
    all-gathered before the local kernel."""
    s = rank_of(group, a.n_shards)
    return dsd_rank(a, s, all_gather(b, group) if b_sharded_k else b, out_dtype=out_dtype, **options)


def sharded_dsd_sequential(a: ShardedBlockSparseMatrix, b: torch.Tensor, *, out_dtype=None,
                           **options) -> List[torch.Tensor]:
    """Every rank's :func:`sharded_dsd` output in turn, from the whole B
    (what the K-sharded gather delivers too)."""
    return [dsd_rank(a, s, b, out_dtype=out_dtype, **options) for s in range(a.n_shards)]


# --------------------------------------------------------- BSR, K-banded --
@dataclasses.dataclass(frozen=True)
class BandedShardedBlockSparseMatrix:
    """Row-partitioned BSR additionally split into per-shard K-bands, for
    the ring schedule: ``data[s, j]`` holds shard s's blocks whose
    block-column falls in contraction band j, column ids re-based to the
    band. All (s, j) cells are padded to one nnz (zero-valued duplicate
    slots, inert)."""

    data: torch.Tensor  # (S, S, P, bs, bs)
    offsets: torch.Tensor  # (S, S, local_block_rows + 1)
    indices: torch.Tensor  # (S, S, P) band-local block-col ids
    row_indices: torch.Tensor  # (S, S, P) shard-local block-row ids
    shape: Tuple[int, int]  # global
    block_size: int
    n_shards: int
    max_row_nnz: Optional[int]

    @property
    def local_rows(self) -> int:
        return self.shape[0] // self.n_shards

    def band_matrix(self, s: int, j: int) -> BlockSparseMatrix:
        """Shard ``s``'s blocks in K band ``j``, as a local BSR."""
        return BlockSparseMatrix.create(
            self.data[s, j], self.offsets[s, j], self.indices[s, j], (self.local_rows, self.shape[1] // self.n_shards),
            row_indices=self.row_indices[s, j], max_row_nnz=self.max_row_nnz,
        )


def partition_bsr_rows_kbands(m: BlockSparseMatrix, n_shards: int) -> BandedShardedBlockSparseMatrix:
    """Split a BSR into ``n_shards`` row bands x ``n_shards`` K-bands
    (host-side), the operand layout :func:`sharded_dsd_ring` consumes.
    Every cell pads to the GLOBAL max cell occupancy."""
    if m.block_rows % n_shards:
        raise ValueError(f"block_rows {m.block_rows} not divisible by {n_shards}")
    if m.block_cols % n_shards:
        raise ValueError(f"block_cols {m.block_cols} not divisible by {n_shards}")
    rows_per = m.block_rows // n_shards
    kbb = m.block_cols // n_shards  # block-cols per band
    offs = _host_numpy(m.offsets)
    idx = _host_numpy(m.indices)
    rowid = _host_numpy(m.row_indices)
    data = _host_numpy(m.data)

    cells = []
    for s in range(n_shards):
        lo, hi = offs[s * rows_per], offs[(s + 1) * rows_per]
        i_s, r_s, d_s = idx[lo:hi], rowid[lo:hi] - s * rows_per, data[lo:hi]
        for j in range(n_shards):
            sel = (i_s // kbb) == j
            cells.append((d_s[sel], i_s[sel] - j * kbb, r_s[sel]))
    pad_to = max(max(c[0].shape[0] for c in cells), 1)
    bs = m.block_size
    max_row = 0

    d_out, o_out, i_out, r_out = [], [], [], []
    for d, i, r in cells:
        n = d.shape[0]
        pad = pad_to - n
        if pad:
            d = np.concatenate([d, np.zeros((pad, bs, bs), d.dtype)])
            i = np.concatenate([i, np.full(pad, i[-1] if n else 0, np.int32)])
            r = np.concatenate([r, np.full(pad, r[-1] if n else rows_per - 1, np.int32)])
        o = np.zeros(rows_per + 1, np.int64)
        np.add.at(o[1:], r, 1)
        o = np.cumsum(o)
        max_row = max(max_row, int((o[1:] - o[:-1]).max()))
        d_out.append(d)
        o_out.append(o)
        i_out.append(i.astype(np.int32))
        r_out.append(r.astype(np.int32))

    device = m.data.device

    def grid(parts, dtype):
        return _stack(parts, dtype, device).reshape((n_shards, n_shards) + parts[0].shape)

    return BandedShardedBlockSparseMatrix(
        data=grid(d_out, m.dtype),
        offsets=grid(o_out, torch.int32),
        indices=grid(i_out, torch.int32),
        row_indices=grid(r_out, torch.int32),
        shape=m.shape,
        block_size=bs,
        n_shards=n_shards,
        max_row_nnz=max_row,
    )


def dsd_ring_step(a: BandedShardedBlockSparseMatrix, d: int, t: int, b_band: torch.Tensor,
                  **options) -> torch.Tensor:
    """Rank ``d``'s step ``t`` of :func:`sharded_dsd_ring`: its blocks of K
    band ``(d + t) % S`` times that band of B (the one it holds at step t),
    in fp32."""
    j = (d + t) % a.n_shards
    return bsr_dsd.dsd(a.band_matrix(d, j), b_band, out_dtype=torch.float32, **options)


def _check_ring(a: BandedShardedBlockSparseMatrix, k_rows: int) -> None:
    if k_rows != a.shape[1]:
        raise ValueError(f"contraction mismatch: A cols {a.shape[1]}, B rows {k_rows}")


def sharded_dsd_ring(a: BandedShardedBlockSparseMatrix, b: torch.Tensor, group=None, *, out_dtype=None,
                     **options) -> torch.Tensor:
    """Ring-overlapped SpMM: this rank's rows of A_banded @ B[K sharded];
    ``b`` is this rank's K band.

    Where :func:`sharded_dsd` with ``b_sharded_k=True`` gathers the whole
    dense operand, the ring keeps ONE band resident: at step t rank d holds
    band ``(d + t) % S``, receiving the next from rank d + 1 and passing
    its own to rank d - 1. The rotation is issued before the step's
    compute and depends only on the band held, so the transfer overlaps
    the kernel. Partials accumulate in fp32."""
    n_shards = a.n_shards
    d = rank_of(group, n_shards)
    _check_ring(a, b.shape[0] * n_shards)
    b_cur = b.contiguous()
    acc = None
    for t in range(n_shards):
        if t + 1 < n_shards:  # issue the rotation before the compute
            b_next = torch.empty_like(b_cur)
            reqs = ring_shift([b_cur], [b_next], dst=(d - 1) % n_shards, src=(d + 1) % n_shards, group=group)
        part = dsd_ring_step(a, d, t, b_cur, **options)
        acc = part if acc is None else acc + part
        if t + 1 < n_shards:
            for req in reqs:
                req.wait()
            b_cur = b_next
    return acc.to(out_dtype or b.dtype)


def sharded_dsd_ring_sequential(a: BandedShardedBlockSparseMatrix, b: torch.Tensor, *, out_dtype=None,
                                **options) -> List[torch.Tensor]:
    """Every rank's :func:`sharded_dsd_ring` output in turn, from the whole
    B: step t of rank d gets the band the rotation delivers, ``(d + t) % S``."""
    _check_ring(a, b.shape[0])
    bands = b.chunk(a.n_shards)
    outs = []
    for d in range(a.n_shards):
        acc = None
        for t in range(a.n_shards):
            part = dsd_ring_step(a, d, t, bands[(d + t) % a.n_shards].contiguous(), **options)
            acc = part if acc is None else acc + part
        outs.append(acc.to(out_dtype or b.dtype))
    return outs


def sdd_rank(a_local: torch.Tensor, b: torch.Tensor, topology: ShardedBlockSparseMatrix, s: int, *,
             out_dtype=None, **options) -> BlockSparseMatrix:
    """Rank ``s``'s body of :func:`sharded_sdd`."""
    return bsr_sdd.sdd(a_local, b, topology.local_matrix(s), out_dtype=out_dtype, **options)


def sharded_sdd(a: torch.Tensor, b: torch.Tensor, topology: ShardedBlockSparseMatrix, group=None, *,
                out_dtype=None, **options) -> BlockSparseMatrix:
    """Row-partitioned SDDMM: ``a`` is this rank's row band, ``b``
    replicated. Returns this rank's shard of the output: its local BSR with
    the computed blocks (JAX's stacked ``data[rank]``)."""
    return sdd_rank(a, b, topology, rank_of(group, topology.n_shards), out_dtype=out_dtype, **options)


def sharded_sdd_sequential(a: torch.Tensor, b: torch.Tensor, topology: ShardedBlockSparseMatrix, *,
                           out_dtype=None, **options) -> List[BlockSparseMatrix]:
    """Every rank's :func:`sharded_sdd` output in turn, from the whole A."""
    return [sdd_rank(a_s.contiguous(), b, topology, s, out_dtype=out_dtype, **options)
            for s, a_s in enumerate(a.chunk(topology.n_shards))]


# ------------------------------------------------------------------- CSR --
@dataclasses.dataclass(frozen=True)
class ShardedCsrMatrix:
    """Row-partitioned CSR, same scheme as :class:`ShardedBlockSparseMatrix`."""

    values: torch.Tensor  # (S, P)
    indices: torch.Tensor  # (S, P)
    offsets: torch.Tensor  # (S, local_rows + 1)
    row_indices: torch.Tensor  # (S, P)
    shape: Tuple[int, int]
    n_shards: int

    @property
    def local_rows(self) -> int:
        return self.shape[0] // self.n_shards

    def local_matrix(self, s: int) -> CsrMatrix:
        """Shard ``s``'s local CSR."""
        return CsrMatrix.create(self.values[s], self.indices[s], self.offsets[s], (self.local_rows, self.shape[1]),
                                row_indices=self.row_indices[s])


def partition_csr_rows(m: CsrMatrix, n_shards: int) -> ShardedCsrMatrix:
    if m.rows % n_shards:
        raise ValueError(f"rows {m.rows} not divisible by {n_shards}")
    rows_per = m.rows // n_shards
    offs = _host_numpy(m.offsets)
    idx = _host_numpy(m.indices)
    rowid = _host_numpy(m.row_indices)
    vals = _host_numpy(m.values)

    shards = []
    for s in range(n_shards):
        lo, hi = offs[s * rows_per], offs[(s + 1) * rows_per]
        local_offs = offs[s * rows_per: (s + 1) * rows_per + 1] - lo
        shards.append((vals[lo:hi], local_offs, idx[lo:hi], rowid[lo:hi] - s * rows_per))
    pad_to = max(max(sh[0].shape[0] for sh in shards), 1)

    v_out, o_out, i_out, r_out = [], [], [], []
    for v, o, i, r in shards:
        pad = pad_to - v.shape[0]
        if pad:
            v = np.concatenate([v, np.zeros(pad, v.dtype)])
            i = np.concatenate([i, np.full(pad, i[-1] if i.size else 0, np.int32)])
            r = np.concatenate([r, np.full(pad, r[-1] if r.size else rows_per - 1, np.int32)])
            o = o.copy()
            o[-1] += pad
        v_out.append(v)
        o_out.append(o)
        i_out.append(i)
        r_out.append(r)
    device = m.values.device
    return ShardedCsrMatrix(
        values=_stack(v_out, m.dtype, device),
        indices=_stack(i_out, torch.int32, device),
        offsets=_stack(o_out, torch.int32, device),
        row_indices=_stack(r_out, torch.int32, device),
        shape=m.shape,
        n_shards=n_shards,
    )


def spmm_rank(a: ShardedCsrMatrix, s: int, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Rank ``s``'s body of :func:`sharded_spmm`."""
    return csr_ops.spmm(a.local_matrix(s), b, out_dtype=out_dtype)


def sharded_spmm(a: ShardedCsrMatrix, b: torch.Tensor, group=None, *, out_dtype=None) -> torch.Tensor:
    """Row-partitioned CSR SpMM, B replicated: this rank's rows of A @ B."""
    return spmm_rank(a, rank_of(group, a.n_shards), b, out_dtype=out_dtype)


def sharded_spmm_sequential(a: ShardedCsrMatrix, b: torch.Tensor, *, out_dtype=None) -> List[torch.Tensor]:
    return [spmm_rank(a, s, b, out_dtype=out_dtype) for s in range(a.n_shards)]


# ------------------------------------------------------------------ SELL --
@dataclasses.dataclass(frozen=True)
class ShardedSellMatrix:
    """Partitioned SELL matrix, shard-stacked.

    ``partition="rows"``: shard s owns rows [s*local, (s+1)*local); arrays
    are ``(S, n_chunks, width, local_rows_padded)``. ``partition="cols"``:
    shard s owns a contraction-column band; arrays are ``(S,
    chunks_per_shard, width, rows_padded)`` and local SpMM results are
    partial sums over k. Padding slots hold the sentinel ``chunk``."""

    values: torch.Tensor
    indices: torch.Tensor
    shape: Tuple[int, int]  # global logical
    chunk: int
    n_shards: int
    partition: str  # "rows" | "cols"

    def local_sell(self, s: int) -> SellMatrix:
        """Shard ``s``'s local SellMatrix (validity from the sentinel)."""
        values, indices = self.values[s], self.indices[s]
        if self.partition == "rows":
            rows = self.shape[0] // self.n_shards
            return SellMatrix(values=values, indices=indices, shape=(rows, self.shape[1]), chunk=self.chunk,
                              pad_rows=self.values.shape[3] - rows)
        return SellMatrix(values=values, indices=indices, shape=(self.shape[0], self.values.shape[1] * self.chunk),
                          chunk=self.chunk, pad_rows=self.values.shape[3] - self.shape[0])


def _host_csr(vals, idx, offs, shape) -> CsrMatrix:
    """A CSR on the host (fp32 values) for SellMatrix.from_csr."""
    return CsrMatrix.create(torch.as_tensor(np.asarray(vals, np.float32)), idx, offs, shape)


def _sell_arrays(sm: SellMatrix):
    return _host_numpy(sm.values), _host_numpy(sm.indices)


def partition_sell_rows(m: CsrMatrix, n_shards: int, *, chunk: int = 128) -> ShardedSellMatrix:
    """Row-partition a CSR into shard-local SELL matrices (host-side); the
    slot width is the per-shard maximum padded to the global maximum."""
    if m.rows % n_shards:
        raise ValueError(f"rows {m.rows} not divisible by {n_shards}")
    rows_per = m.rows // n_shards
    offs = _host_numpy(m.offsets)
    idx = _host_numpy(m.indices)
    vals = _host_numpy(m.values)
    locals_ = []
    for s in range(n_shards):
        lo, hi = offs[s * rows_per], offs[(s + 1) * rows_per]
        local = _host_csr(vals[lo:hi], idx[lo:hi], offs[s * rows_per: (s + 1) * rows_per + 1] - lo, (rows_per, m.cols))
        locals_.append(SellMatrix.from_csr(local, chunk=chunk))
    width = max(sm.width for sm in locals_)
    sv, sc = [], []
    for sm in locals_:
        v, c = _sell_arrays(sm)
        pad = width - sm.width
        if pad:
            v = np.pad(v, ((0, 0), (0, pad), (0, 0)))
            c = np.pad(c, ((0, 0), (0, pad), (0, 0)), constant_values=chunk)
        sv.append(v)
        sc.append(c)
    device = m.values.device
    return ShardedSellMatrix(values=_stack(sv, m.dtype, device), indices=_stack(sc, torch.int32, device),
                             shape=m.shape, chunk=chunk, n_shards=n_shards, partition="rows")


def partition_sell_cols(m: CsrMatrix, n_shards: int, *, chunk: int = 128) -> ShardedSellMatrix:
    """Contraction(column)-partition a CSR into shard-local SELL bands: a
    local SpMM against the matching K band of B gives a PARTIAL product
    over full rows, which :func:`sharded_spmm_kshard` reduce-scatters."""
    if m.cols % (n_shards * chunk):
        raise ValueError(
            f"cols {m.cols} must be divisible by n_shards*chunk = {n_shards * chunk} for aligned K bands"
        )
    cols_per = m.cols // n_shards
    idx = _host_numpy(m.indices)
    vals = _host_numpy(m.values)
    rowid = _host_numpy(m.row_indices)
    locals_ = []
    for s in range(n_shards):
        lo_c, hi_c = s * cols_per, min((s + 1) * cols_per, m.cols)
        band_cols = max(hi_c - lo_c, chunk)
        sel = (idx >= lo_c) & (idx < hi_c)
        offs = np.concatenate([[0], np.cumsum(np.bincount(rowid[sel], minlength=m.rows))]).astype(np.int32)
        band = _host_csr(vals[sel], idx[sel] - lo_c, offs, (m.rows, band_cols))
        locals_.append(SellMatrix.from_csr(band, chunk=chunk))
    width = max(sm.width for sm in locals_)
    chunks_per = max(sm.n_chunks for sm in locals_)
    sv, sc = [], []
    for sm in locals_:
        v, c = _sell_arrays(sm)
        pad_w = width - sm.width
        pad_ch = chunks_per - sm.n_chunks
        if pad_w or pad_ch:
            v = np.pad(v, ((0, pad_ch), (0, pad_w), (0, 0)))
            c = np.pad(c, ((0, pad_ch), (0, pad_w), (0, 0)), constant_values=chunk)
        sv.append(v)
        sc.append(c)
    device = m.values.device
    return ShardedSellMatrix(values=_stack(sv, m.dtype, device), indices=_stack(sc, torch.int32, device),
                             shape=m.shape, chunk=chunk, n_shards=n_shards, partition="cols")


def spmm_sell_rank(a: ShardedSellMatrix, s: int, b_full: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Rank ``s``'s body of :func:`sharded_spmm_sell`."""
    return sell_kernels.spmm(a.local_sell(s), b_full, out_dtype=out_dtype)


def _check_partition(a: ShardedSellMatrix, want: str, op: str) -> None:
    if a.partition != want:
        raise ValueError(f"{op} needs a {'row' if want == 'rows' else 'column'}-partitioned matrix")


def sharded_spmm_sell(a: ShardedSellMatrix, b: torch.Tensor, group=None, *, b_sharded_k: bool = False,
                      out_dtype=None) -> torch.Tensor:
    """Row-partitioned SELL SpMM: B replicated (no communication) or
    K-sharded (``b`` this rank's band, all-gathered first)."""
    _check_partition(a, "rows", "sharded_spmm_sell")
    s = rank_of(group, a.n_shards)
    return spmm_sell_rank(a, s, all_gather(b, group) if b_sharded_k else b, out_dtype=out_dtype)


def sharded_spmm_sell_sequential(a: ShardedSellMatrix, b: torch.Tensor, *, out_dtype=None) -> List[torch.Tensor]:
    _check_partition(a, "rows", "sharded_spmm_sell")
    return [spmm_sell_rank(a, s, b, out_dtype=out_dtype) for s in range(a.n_shards)]


def spmm_kshard_partial(a: ShardedSellMatrix, s: int, b_band: torch.Tensor) -> torch.Tensor:
    """Rank ``s``'s body of :func:`sharded_spmm_kshard`: its full-row
    partial product, fp32."""
    return sell_kernels.spmm(a.local_sell(s), b_band, out_dtype=torch.float32)


def sharded_spmm_kshard(a: ShardedSellMatrix, b: torch.Tensor, group=None, *, out_dtype=None) -> torch.Tensor:
    """Contraction-sharded SpMM: this rank holds a K band of A and the
    matching band ``b`` of B, computes a full-row partial product in fp32,
    and the partials are reduce-scattered into this rank's rows of C."""
    _check_partition(a, "cols", "sharded_spmm_kshard")
    s = rank_of(group, a.n_shards)
    return reduce_scatter(spmm_kshard_partial(a, s, b), group).to(out_dtype or a.values.dtype)


def sharded_spmm_kshard_sequential(a: ShardedSellMatrix, b: torch.Tensor, *, out_dtype=None) -> List[torch.Tensor]:
    """Every rank's :func:`sharded_spmm_kshard` output, from the whole B:
    the partials summed in rank order, then split by rows."""
    _check_partition(a, "cols", "sharded_spmm_kshard")
    parts = [spmm_kshard_partial(a, s, b_s.contiguous()) for s, b_s in enumerate(b.chunk(a.n_shards))]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return [x.to(out_dtype or a.values.dtype) for x in total.chunk(a.n_shards)]
