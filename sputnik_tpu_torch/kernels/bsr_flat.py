"""Exact work-list ("flat schedule") SSD / SDS / DSS / SSS on the
``bsr_flat`` CUDA kernel (``csrc/bsr_flat.cu``).

Port of ``sputnik_tpu/kernels/bsr_flat.py``. A work item is (output block,
sparse stream block, dense tile or second operand's block); the planners
enumerate every item of a problem once, on the host, from the numpy copies
of the metadata (``BlockSparseMatrix.host_metadata``), ordered by output
block and padded per output to a multiple of ``group`` with flag-0
duplicates. Their output equals the JAX planners' field by field, so a
schedule means the same work in both packages; ``group`` and ``slab`` only
shape the TPU's grid steps; the CUDA kernel walks items one by one and
skips the flag-0 ones.

The kernel runs one CTA per output block (visited or not): the CTA reads
its run of items from per-output item offsets derived at plan time from
the schedule's non-decreasing ``out_ids``, accumulates in fp32 and stores
the block once, zeros when the run is empty. There is no separate zeroing
pass and no stale memory.

On CPU tensors the ops compute the kernel's plain PyTorch version
(:func:`flat_reference`): the same items as fp32 gathers, one ``bmm`` and
an ``index_add`` per output. On CUDA tensors they launch the kernel, or
raise for a problem it does not take: a block size other than 128, a dtype
other than bf16 / fp32, operands of two dtypes, or data with a batch axis.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build

__all__ = [
    "FlatSchedule", "DEFAULT_GROUP", "plan_sparse_out", "plan_dss", "plan_sss",
    "ssd_flat", "sds_flat", "dss_flat", "sss_flat", "flat_reference", "block_products", "tiles_to_dense",
    "product_shape", "sparse_out_shapes", "check_operands", "check_metadata", "LAUNCHES",
]

DEFAULT_GROUP = 4  # work items per TPU grid step (the JAX package's, measured there)

# Kernel launches in this process; each launch of bsr_flat adds one.
LAUNCHES = 0

KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# What the second operand of a work item is: a dense tile of B (SSD), a
# dense tile of A (SDS), or a block of the second sparse operand (DSS, SSS).
KIND_SSD, KIND_SDS, KIND_BLOCKS = 0, 1, 2
_KIND = {"ssd": KIND_SSD, "sds": KIND_SDS, "dss": KIND_BLOCKS, "sss": KIND_BLOCKS}


@dataclasses.dataclass(frozen=True)
class FlatSchedule:
    """Flattened matmul work list; every array is int32 numpy.

    ``out_ids`` is per step (length ``n_steps``, non-decreasing); the item
    arrays (``dep_ids`` / ``data_ids`` / ``other_ids`` / ``flags``) have
    length ``n_steps * group``. ``data_ids`` index the stream operand's
    blocks; ``dep_ids`` are contraction block ids (SSD / SDS) or the second
    operand's blocks (DSS / SSS); ``other_ids`` carry the output block's
    other coordinate. ``flags`` mark real items (0: group padding).
    ``unvisited_ids`` lists output blocks with no item; ``total`` counts the
    real items."""

    out_ids: np.ndarray
    dep_ids: np.ndarray
    data_ids: np.ndarray
    other_ids: np.ndarray
    flags: np.ndarray
    unvisited_ids: np.ndarray
    slab_ids: np.ndarray
    kind: str  # "ssd" | "sds" | "dss" | "sss"
    total: int
    group: int
    n_steps: int
    all_visited: bool
    slab: bool
    # Per (device, n_out): the item offsets and item arrays as tensors.
    _device: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def item_offsets(self, n_out: int) -> np.ndarray:
        """(n_out + 1,) int32: output block ``o``'s items are
        ``[offsets[o], offsets[o + 1])`` (empty for an unvisited block)."""
        if self.n_steps and int(self.out_ids[-1]) >= n_out:
            raise ValueError(f"schedule reaches output block {int(self.out_ids[-1])} of {n_out}")
        counts = np.bincount(self.out_ids, minlength=n_out) * self.group
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def device_arrays(self, device: torch.device, n_out: int):
        """(item offsets, dep_ids, data_ids, other_ids, flags) on ``device``,
        uploaded once per device and output size: later calls read nothing
        from the host."""
        key = (device, n_out)
        if key not in self._device:
            host = (self.item_offsets(n_out), self.dep_ids, self.data_ids, self.other_ids, self.flags)
            self._device[key] = tuple(torch.as_tensor(np.ascontiguousarray(x, np.int32)).to(device) for x in host)
        return self._device[key]


# ---------------------------------------------------------------- planners --
def _ragged_positions(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], starts[i]+counts[i]) ranges (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0,), np.int32)
    cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (
        np.arange(total, dtype=np.int64) - np.repeat(cum, counts) + np.repeat(starts.astype(np.int64), counts)
    ).astype(np.int32)


def _empty() -> np.ndarray:
    return np.zeros((0,), np.int32)


def _batch_items(out_ids, sub_arrays, group: int, kind: str, total: int, unvisited) -> FlatSchedule:
    """Group consecutive same-output items ``group`` per step; pad each
    output block's run with flag-0 duplicates of its last item."""
    unvisited = np.asarray(unvisited, np.int32)
    if total == 0:
        z = _empty()
        return FlatSchedule(
            out_ids=z, dep_ids=z, data_ids=z, other_ids=z, flags=z, unvisited_ids=unvisited, slab_ids=z,
            kind=kind, total=0, group=group, n_steps=0, all_visited=unvisited.size == 0, slab=False,
        )
    uniq, counts = np.unique(out_ids, return_counts=True)
    # Adaptive group: batching pays on the TPU only when output blocks
    # average at least ~group items; otherwise padding dominates.
    avg = total / max(len(uniq), 1)
    group = max(1, min(group, int(round(avg))))
    padded = (-(-counts // group)) * group
    total_p = int(padded.sum())
    cum_items = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cum_p = np.concatenate([[0], np.cumsum(padded)[:-1]])
    local = np.arange(total_p, dtype=np.int64) - np.repeat(cum_p, padded)
    orig_local = np.minimum(local, np.repeat(counts, padded) - 1)
    item = np.repeat(cum_items, padded) + orig_local
    flags = (local < np.repeat(counts, padded)).astype(np.int32)
    step_out = np.repeat(uniq, padded // group).astype(np.int32)
    dep, data, other = (np.asarray(s)[item].astype(np.int32) for s in sub_arrays)
    return FlatSchedule(
        out_ids=step_out, dep_ids=dep, data_ids=data, other_ids=other, flags=flags,
        unvisited_ids=unvisited, slab_ids=_empty(), kind=kind, total=total, group=group,
        n_steps=len(step_out), all_visited=unvisited.size == 0, slab=False,
    )


def _stream_np(stream: BlockSparseMatrix, transposed: bool):
    offs, dep, data = stream.host_metadata(transposed)
    return offs, dep.astype(np.int32), data.astype(np.int32)


def plan_sparse_out(
    stream: BlockSparseMatrix,
    topology: BlockSparseMatrix,
    *,
    kind: str,
    stream_transposed: bool,
    group: int = DEFAULT_GROUP,
    slab: bool = False,
) -> FlatSchedule:
    """Exact schedule for a sparse-output matmul with one sparse operand
    (``kind`` "ssd": the stream is A, grouped by output row; "sds": the
    stream is B, grouped by output column). ``slab=True`` (natural-order
    streams only) pads each output's run out to group-aligned slabs of the
    stream, as the TPU's one-DMA-per-step mode needs; the kernel reads the
    same items either way."""
    offs, dep, data = _stream_np(stream, stream_transposed)
    t_rows, t_cols = topology.host_row_indices(), topology.host_indices
    if kind == "ssd":
        group_of, other_of = t_rows, t_cols
    elif kind == "sds":
        group_of, other_of = t_cols, t_rows
    else:
        raise ValueError(f"kind must be 'ssd' or 'sds', got {kind!r}")
    counts = (offs[1:] - offs[:-1])[group_of]
    total = int(counts.sum())
    unvisited = np.nonzero(counts == 0)[0].astype(np.int32)
    if slab:
        if stream_transposed:
            raise ValueError("slab schedules need a natural-order stream")
        g = group
        starts, ends = offs[group_of], offs[group_of] + counts
        a_starts = (starts // g) * g
        a_ends = -(-ends // g) * g
        n_sub = np.maximum(a_ends - a_starts, 0) // g  # slabs per output block
        step_out = np.repeat(np.arange(len(group_of), dtype=np.int32), n_sub)
        slab_ids = _ragged_positions(a_starts // g, n_sub)
        pos = np.repeat(slab_ids.astype(np.int64), g) * g + np.tile(np.arange(g, dtype=np.int64), len(slab_ids))
        flags = ((pos >= np.repeat(starts, n_sub * g)) & (pos < np.repeat(ends, n_sub * g))).astype(np.int32)
        pos_c = np.clip(pos, 0, max(len(dep) - 1, 0))
        return FlatSchedule(
            out_ids=step_out, dep_ids=dep[pos_c].astype(np.int32), data_ids=pos_c.astype(np.int32),
            other_ids=other_of[np.repeat(step_out, g)].astype(np.int32), flags=flags,
            unvisited_ids=unvisited, slab_ids=slab_ids.astype(np.int32), kind=kind, total=total, group=g,
            n_steps=len(step_out), all_visited=unvisited.size == 0, slab=True,
        )
    out_ids = np.repeat(np.arange(len(group_of), dtype=np.int32), counts)
    pos = _ragged_positions(offs[group_of], counts)
    return _batch_items(out_ids, (dep[pos], data[pos], other_of[out_ids]), group, kind, total, unvisited)


def plan_dss(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    group: int = DEFAULT_GROUP,
) -> FlatSchedule:
    """Exact intersection schedule for dense = sparse @ sparse: for every
    output tile (m, n), the k-blocks present in both op(A) row m and op(B)
    column n. Output tile ids are ``m * n_blocks + n``."""
    a_offs, a_dep, a_data = _stream_np(a, transpose_a)
    # op(B) iterated k-major: natural order when B is (K, N), transposed
    # metadata when op(B) = B^T.
    b_offs, b_dep, b_data = _stream_np(b, transpose_b)
    n_blocks = (b.rows if transpose_b else b.cols) // b.block_size
    m_blocks = len(a_offs) - 1
    outs, aposs, bposs = [], [], []
    for m in range(m_blocks):
        ks = a_dep[a_offs[m]: a_offs[m + 1]]
        apos_m = a_data[a_offs[m]: a_offs[m + 1]]
        bcounts = b_offs[ks + 1] - b_offs[ks]
        if bcounts.sum() == 0:
            continue
        pos = _ragged_positions(b_offs[ks], bcounts)
        ns = b_dep[pos]
        order = np.argsort(ns, kind="stable")
        outs.append(m * n_blocks + ns[order])
        aposs.append(np.repeat(apos_m, bcounts)[order])
        bposs.append(b_data[pos][order])
    if outs:
        out_ids = np.concatenate(outs).astype(np.int32)
        a_ids = np.concatenate(aposs).astype(np.int32)
        b_ids = np.concatenate(bposs).astype(np.int32)
    else:
        out_ids = a_ids = b_ids = _empty()
    visited = np.zeros((m_blocks * n_blocks,), bool)
    visited[out_ids] = True
    unvisited = np.nonzero(~visited)[0].astype(np.int32)
    return _batch_items(out_ids, (b_ids, a_ids, np.zeros_like(out_ids)), group, "dss", len(out_ids), unvisited)


def plan_sss(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    group: int = DEFAULT_GROUP,
) -> FlatSchedule:
    """Exact schedule for sparse = sparse @ sparse: for each topology block
    (m, n), the k-blocks present in both op(A) row m and op(B) column n (op(A)'s
    row stream against op(B)'s position map, on the host). Output blocks
    with an empty intersection are unvisited and come out zero."""
    a_offs, a_dep, a_data = _stream_np(a, transpose_a)
    b_offs, b_idx, _ = b.host_metadata()
    pos_b = np.full((b.block_rows, b.block_cols), -1, np.int32)
    b_rows = np.repeat(np.arange(b.block_rows), np.diff(b_offs))
    np.maximum.at(pos_b, (b_rows, b_idx), np.arange(len(b_idx), dtype=np.int32))
    pos_kn = pos_b.T if transpose_b else pos_b  # op(B)'s (k, n) block
    t_rows, t_cols = topology.host_row_indices(), topology.host_indices
    nnz_c = topology.nnz_blocks
    counts = (a_offs[1:] - a_offs[:-1])[t_rows]
    pos = _ragged_positions(a_offs[t_rows], counts)
    item_out = np.repeat(np.arange(nnz_c, dtype=np.int64), counts)
    b_pos = pos_kn[a_dep[pos], t_cols[item_out]]
    sel = b_pos >= 0
    out_ids = item_out[sel].astype(np.int32)
    a_ids = a_data[pos][sel].astype(np.int32)
    b_ids = b_pos[sel].astype(np.int32)
    visited = np.zeros((nnz_c,), bool)
    visited[out_ids] = True
    unvisited = np.nonzero(~visited)[0].astype(np.int32)
    return _batch_items(out_ids, (b_ids, a_ids, np.zeros_like(out_ids)), group, "sss", len(out_ids), unvisited)


# ----------------------------------------------------------- plain version --
def _dense_tiles(x: torch.Tensor) -> torch.Tensor:
    """(R, C) -> (R // 128, C // 128, 128, 128) view of its 128 x 128 tiles."""
    bs = 128
    return x.reshape(x.shape[0] // bs, bs, x.shape[1] // bs, bs).transpose(1, 2)


def block_products(kind: int, stream_data, operand, data_ids, dep_ids, other_ids, out_ids, n_out: int,
                   *, transpose_a: bool, transpose_b: bool, block_size: int = 128) -> torch.Tensor:
    """fp32 ``(n_out, bs, bs)``: for every item, op(A) . op(B) of its two
    tiles summed into its output block, as fp32 gathers, one ``bmm`` and one
    ``index_add``. ``kind`` and the id arrays (int64 tensors on the data's
    device) mean what they mean to the kernels: the stream block
    ``data_ids``, and the dense tile at (``dep_ids``, ``other_ids``) of B
    (SSD) or A (SDS), or the second operand's block ``dep_ids``."""
    bs = block_size
    out = torch.zeros((n_out, bs, bs), dtype=torch.float32, device=stream_data.device)
    if not out_ids.numel():
        return out
    blk = stream_data.float()[data_ids]
    if kind == KIND_SSD:  # op(A) = stream block, op(B) = dense tile (k, n)
        tiles = _dense_tiles(operand.float())
        lhs = blk.transpose(1, 2) if transpose_a else blk
        rhs = tiles[other_ids, dep_ids].transpose(1, 2) if transpose_b else tiles[dep_ids, other_ids]
    elif kind == KIND_SDS:  # op(A) = dense tile (m, k), op(B) = stream block
        tiles = _dense_tiles(operand.float())
        lhs = tiles[dep_ids, other_ids].transpose(1, 2) if transpose_a else tiles[other_ids, dep_ids]
        rhs = blk.transpose(1, 2) if transpose_b else blk
    else:  # both blocks
        lhs = blk.transpose(1, 2) if transpose_a else blk
        rhs = operand.float()[dep_ids]
        rhs = rhs.transpose(1, 2) if transpose_b else rhs
    return out.index_add_(0, out_ids, torch.bmm(lhs, rhs))


def product_shape(a, b, transpose_a: bool, transpose_b: bool):
    """(M, N) of op(A) @ op(B) for sparse or dense operands; raises when the
    contraction dims differ."""
    m, ka = tuple(a.shape[-2:])[::-1] if transpose_a else tuple(a.shape[-2:])
    kb, n = tuple(b.shape[-2:])[::-1] if transpose_b else tuple(b.shape[-2:])
    if ka != kb:
        raise ValueError(f"contraction mismatch: op(A) gives k={ka}, op(B) gives k={kb}")
    return m, n


def tiles_to_dense(tiles: torch.Tensor, m_blocks: int, n_blocks: int) -> torch.Tensor:
    bs = tiles.shape[-1]
    return tiles.reshape(m_blocks, n_blocks, bs, bs).transpose(1, 2).reshape(m_blocks * bs, n_blocks * bs)


def flat_reference(schedule: FlatSchedule, stream_data, operand, n_out: int, *, transpose_a: bool,
                   transpose_b: bool) -> torch.Tensor:
    """The plain version of ``bsr_flat``: fp32 ``(n_out, bs, bs)`` sums of
    the schedule's real items (flag 1), from the same schedule arrays."""
    live = np.nonzero(schedule.flags)[0]
    dev = stream_data.device
    ids = [torch.as_tensor(x[live].astype(np.int64), device=dev)
           for x in (schedule.data_ids, schedule.dep_ids, schedule.other_ids)]
    out_ids = torch.as_tensor(np.repeat(schedule.out_ids, schedule.group)[live].astype(np.int64), device=dev)
    return block_products(_KIND[schedule.kind], stream_data, operand, *ids, out_ids, n_out,
                          transpose_a=transpose_a, transpose_b=transpose_b)


# ------------------------------------------------------------------ kernel --
@functools.cache
def _kernel():
    fn = _build.load("bsr_flat").bsr_flat
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def check_operands(name: str, inputs, out: torch.Tensor, sparse=()) -> None:
    """The checks every sparse-output kernel wrapper makes before a launch:
    ``inputs`` ((label, tensor) pairs) and ``out`` are CUDA tensors on one
    device, contiguous and 16-byte aligned; the inputs are bf16 or fp32 of
    one dtype, the output bf16 or fp32; ``sparse`` operands have 128-blocks
    and no batch axis."""
    for label, t in list(inputs) + [("out", out)]:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors; {label} is on {t.device}")
        if t.device != out.device:
            raise ValueError(f"{name}: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
    dtypes = {t.dtype for _, t in inputs}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise ValueError(f"{name} takes bf16 or fp32 operands of one dtype, got {sorted(map(str, dtypes))}")
    if out.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: output dtype {out.dtype} not supported")
    for m in sparse:
        if m.block_size != 128:
            raise ValueError(f"{name}: block size must be 128, got {m.block_size}")
        if m.data.ndim != 3:
            raise ValueError(f"{name}: sparse data with a batch axis is not supported")


def sparse_out_shapes(a, b, topology: BlockSparseMatrix, transpose_a: bool, transpose_b: bool) -> None:
    """Shape checks of SSD / SDS / SSS: op(A) @ op(B) must have the
    topology's shape."""
    m, n = product_shape(a, b, transpose_a, transpose_b)
    if topology.shape != (m, n):
        raise ValueError(f"topology is {topology.rows}x{topology.cols}, product is {m}x{n}")


def check_metadata(name: str, device, *tensors) -> None:
    """Metadata a kernel reads: contiguous int32 on the output's device
    (``None`` entries are skipped)."""
    for t in tensors:
        if t is not None and (t.dtype != torch.int32 or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name}: metadata must be contiguous int32 on {device}")


def _launch(schedule: FlatSchedule, stream: torch.Tensor, operand: torch.Tensor, out: torch.Tensor, n_out: int,
            *, n_blocks_out: int, transpose_a: bool, transpose_b: bool) -> None:
    """Launch ``bsr_flat`` over ``n_out`` output blocks into ``out``: the
    packed ``(n_out, 128, 128)`` blocks, or (``n_blocks_out`` > 0) the dense
    ``(M, N)`` matrix whose tile ``o`` is (o // n_blocks_out, o % n_blocks_out)."""
    global LAUNCHES
    offsets, dep, data, other, flags = schedule.device_arrays(out.device, n_out)
    err = _kernel()(
        stream.data_ptr(), operand.data_ptr(), out.data_ptr(),
        offsets.data_ptr(), dep.data_ptr(), data.data_ptr(), other.data_ptr(), flags.data_ptr(),
        n_out, _KIND[schedule.kind], n_blocks_out,
        operand.shape[-1], out.shape[-1],
        int(stream.dtype == torch.float32), int(out.dtype == torch.float32),
        int(transpose_a), int(transpose_b),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_flat launch failed: cudaError {err}")
    LAUNCHES += 1


def _check_kcat(kcat) -> None:
    # On the TPU kcat fuses a step's group dots into one deeper dot; the
    # CUDA kernel has no grid steps to fuse, so both settings run the same.
    if not isinstance(kcat, bool):
        raise ValueError(f"kcat must be a bool, got {kcat!r}")


def _sparse_out(schedule: FlatSchedule, stream: BlockSparseMatrix, operand: torch.Tensor,
                topology: BlockSparseMatrix, *, transpose_a, transpose_b, out_dtype, sparse=()):
    nnz_c, bs = topology.nnz_blocks, topology.block_size
    if not stream.data.is_cuda and not operand.is_cuda:
        sums = flat_reference(schedule, stream.data, operand, nnz_c, transpose_a=transpose_a,
                              transpose_b=transpose_b)
        return topology.with_data(sums.to(out_dtype))
    out = torch.empty((nnz_c, bs, bs), dtype=out_dtype, device=stream.device)
    check_operands(f"bsr_flat ({schedule.kind})", [("stream", stream.data), ("operand", operand)], out,
                   sparse=(stream, topology) + tuple(sparse))
    if nnz_c:
        _launch(schedule, stream.data, operand, out, nnz_c, n_blocks_out=0, transpose_a=transpose_a,
                transpose_b=transpose_b)
    return topology.with_data(out)


def _check_kind(schedule: FlatSchedule, kind: str) -> None:
    if schedule.kind != kind:
        raise ValueError(f"schedule kind {schedule.kind!r} != {kind!r}")


def ssd_flat(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: Optional[FlatSchedule] = None,
    kcat: bool = False,
) -> BlockSparseMatrix:
    """C_sparse = op(A_sparse) @ op(B_dense) via an exact work list."""
    _check_kcat(kcat)
    sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    if schedule is None:
        schedule = plan_sparse_out(a, topology, kind="ssd", stream_transposed=transpose_a)
    _check_kind(schedule, "ssd")
    return _sparse_out(schedule, a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b,
                       out_dtype=out_dtype or topology.dtype)


def sds_flat(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: Optional[FlatSchedule] = None,
    kcat: bool = False,
) -> BlockSparseMatrix:
    """C_sparse = op(A_dense) @ op(B_sparse) via an exact work list. B
    streams grouped by op(B)'s column, so a non-transposed B iterates
    through its transpose metadata."""
    _check_kcat(kcat)
    sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    if schedule is None:
        schedule = plan_sparse_out(b, topology, kind="sds", stream_transposed=not transpose_b)
    _check_kind(schedule, "sds")
    return _sparse_out(schedule, b, a, topology, transpose_a=transpose_a, transpose_b=transpose_b,
                       out_dtype=out_dtype or topology.dtype)


def sss_flat(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: Optional[FlatSchedule] = None,
    kcat: bool = False,
) -> BlockSparseMatrix:
    """C_sparse = op(A_sparse) @ op(B_sparse) masked to ``topology`` via the
    exact intersection work list."""
    _check_kcat(kcat)
    bs = topology.block_size
    if a.block_size != bs or b.block_size != bs:
        raise ValueError(f"block size mismatch: {a.block_size}/{b.block_size} vs {bs}")
    sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    if schedule is None:
        schedule = plan_sss(a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b)
    _check_kind(schedule, "sss")
    return _sparse_out(schedule, a, b.data, topology, transpose_a=transpose_a, transpose_b=transpose_b,
                       out_dtype=out_dtype or topology.dtype, sparse=(b,))


def dss_flat(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: Optional[FlatSchedule] = None,
    kcat: bool = False,
) -> torch.Tensor:
    """C[M, N] = op(A_sparse) @ op(B_sparse) via the exact merged work list."""
    _check_kcat(kcat)
    out_dtype = out_dtype or a.dtype
    bs = a.block_size
    if b.block_size != bs:
        raise ValueError(f"block size mismatch: {bs} vs {b.block_size}")
    m_dim, n_dim = product_shape(a, b, transpose_a, transpose_b)
    if schedule is None:
        schedule = plan_dss(a, b, transpose_a=transpose_a, transpose_b=transpose_b)
    _check_kind(schedule, "dss")
    m_blocks, n_blocks = m_dim // bs, n_dim // bs
    if not a.data.is_cuda and not b.data.is_cuda:
        sums = flat_reference(schedule, a.data, b.data, m_blocks * n_blocks, transpose_a=transpose_a,
                              transpose_b=transpose_b)
        return tiles_to_dense(sums, m_blocks, n_blocks).to(out_dtype)
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=a.device)
    check_operands("bsr_flat (dss)", [("a", a.data), ("b", b.data)], out, sparse=(a, b))
    if m_blocks * n_blocks:
        _launch(schedule, a.data, b.data, out, m_blocks * n_blocks, n_blocks_out=n_blocks,
                transpose_a=transpose_a, transpose_b=transpose_b)
    return out
