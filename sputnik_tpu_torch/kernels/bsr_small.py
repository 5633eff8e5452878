"""DSD / DDS and SDD at block sizes 16, 32 and 64 on the ``bsr_small_dsd``
and ``bsr_small_sdd`` CUDA kernels (``csrc/bsr_small.cu``).

Port of ``sputnik_tpu/kernels/bsr_small.py``. A block smaller than the
128-wide tile is packed: ``pack = 128 // bs`` blocks of one block-row make
one depth-128 product (DSD), ``pack`` output blocks of one block-row one
full-K product (SDD). The plans are made on the host from host-known
metadata, equal to the JAX package's element for element:

* :func:`plan_smallblock` (DSD / DDS): steps of up to ``pack`` blocks of one
  block-row (block-column of A when ``transposed``, through the transpose
  metadata), padding slots on data id ``nnz`` (a zero block), ``out_ids``
  (the 128-row super-row of each step) non-decreasing;
* :func:`plan_sdd_smallblock` (SDD): the JAX package's ``native.pack_rows``,
  here in numpy (:func:`pack_rows`).

DDS runs as ``C^T = dsd(B, A)`` with flipped flags, the kernel storing the
transpose. On CPU tensors the wrappers compute their kernel's plain version
from the same plan (:func:`dsd_small_reference`, :func:`sdd_small_reference`);
on CUDA tensors they launch the kernel, or raise for a problem it does not
take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.common import cdiv, oriented

__all__ = [
    "dsd_smallblock", "dds_smallblock", "sdd_smallblock", "plan_smallblock", "plan_sdd_smallblock",
    "pack_rows", "SmallPlan", "SddPlan", "dsd_small_reference", "sdd_small_reference", "LAUNCHES",
    "SMALL_BLOCK_SIZES",
]

SUPER = 128  # packed depth of a DSD step; the output tile width
SMALL_BLOCK_SIZES = (16, 32, 64)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches in this process, per kernel.
LAUNCHES = {"bsr_small_dsd": 0, "bsr_small_sdd": 0}


# ---------------------------------------------------------------- planners --
@dataclasses.dataclass(eq=False)
class SmallPlan:
    """The DSD plan (int32 numpy but ``row_counts``, int64, as JAX's):
    ``out_ids`` / ``subs`` per step (super-row and block-row within it),
    ``deps`` / ``datas`` per slot (``n_steps * pack``)."""

    out_ids: np.ndarray
    subs: np.ndarray
    deps: np.ndarray
    datas: np.ndarray
    n_steps: int
    row_counts: np.ndarray  # steps per super-row
    transposed: bool
    block_size: int
    _device: Dict = dataclasses.field(default_factory=dict, repr=False)

    def device_arrays(self, device: torch.device):
        """(super-row step offsets, subs, deps, datas, block-row of each
        step) on ``device``, uploaded once per device: later calls read
        nothing from the host."""
        if device not in self._device:
            offsets = np.concatenate([[0], np.cumsum(self.row_counts)])
            rows = self.out_ids.astype(np.int64) * (SUPER // self.block_size) + self.subs
            self._device[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(x, np.int32)).to(device)
                for x in (offsets, self.subs, self.deps, self.datas, rows))
        return self._device[device]


@dataclasses.dataclass(eq=False)
class SddPlan:
    """The SDD plan: ``rows`` per step, ``cols`` per slot (padding 0),
    ``src[i]`` the slot of nonzero block ``i``."""

    rows: np.ndarray
    cols: np.ndarray
    src: np.ndarray
    n_steps: int
    block_size: int
    _device: Dict = dataclasses.field(default_factory=dict, repr=False)

    def slot_blocks(self) -> np.ndarray:
        """The inverse of ``src``: the block of each slot, -1 for padding."""
        pack = SUPER // self.block_size
        slots = np.full(self.n_steps * pack, -1, np.int32)
        slots[self.src] = np.arange(len(self.src), dtype=np.int32)
        return slots

    def device_arrays(self, device: torch.device):
        """(rows, cols, slot blocks, src) on ``device``, uploaded once."""
        if device not in self._device:
            self._device[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(x, np.int32)).to(device)
                for x in (self.rows, self.cols, self.slot_blocks(), self.src))
        return self._device[device]


def plan_smallblock(a: BlockSparseMatrix, *, transposed: bool = False) -> SmallPlan:
    """The DSD plan of host-known ``a``: step = up to ``pack`` consecutive
    blocks of one block-row (block-column when ``transposed``), padding
    slots on block index ``nnz``; ``out_ids`` non-decreasing."""
    bs = a.block_size
    if bs not in SMALL_BLOCK_SIZES:
        raise ValueError(f"small-block plans take block sizes {SMALL_BLOCK_SIZES}, got {bs}")
    pack = SUPER // bs
    offs, deps_all, data_all = a.host_metadata(transposed)
    if not transposed:
        data_all = None
    nnz = a.nnz_blocks
    n_rows = len(offs) - 1
    offs64 = offs.astype(np.int64)
    counts = offs64[1:] - offs64[:-1]
    spr = -(-counts // pack)  # steps per row
    n_steps = int(spr.sum())
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), spr)
    row_first = np.concatenate([[0], np.cumsum(spr)])
    step_in_row = np.arange(n_steps, dtype=np.int64) - np.repeat(row_first[:-1], spr)
    pos = (np.repeat(offs64[:-1], spr) + step_in_row * pack)[:, None] + np.arange(pack, dtype=np.int64)
    valid = pos < np.repeat(offs64[1:], spr)[:, None]
    pos_c = np.minimum(pos, max(nnz - 1, 0))
    deps = np.where(valid, np.asarray(deps_all)[pos_c], 0).reshape(-1)
    phys_all = np.arange(nnz, dtype=np.int64) if data_all is None else data_all
    datas = np.where(valid, np.asarray(phys_all)[pos_c], nnz).reshape(-1)
    out_ids = rows // pack
    subs = rows % pack
    row_counts = np.bincount(out_ids, minlength=cdiv(n_rows, pack)).astype(np.int64)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return SmallPlan(out_ids=i32(out_ids), subs=i32(subs), deps=i32(deps), datas=i32(datas), n_steps=n_steps,
                     row_counts=row_counts, transposed=transposed, block_size=bs)


def pack_rows(offsets: np.ndarray, indices: np.ndarray, pack: int):
    """Pack each row's nonzeros into ceil(count / pack) steps of ``pack``
    slots: ``(rows, cols, src, n_steps)``, per-step row ids, per-slot column
    ids (padding 0) and the step-major slot of every nonzero. The JAX
    package's ``native.pack_rows`` (``sputnik_native.cc``), in numpy."""
    offsets = np.ascontiguousarray(offsets, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    n_rows = len(offsets) - 1
    nnz = int(offsets[-1])
    counts = offsets[1:].astype(np.int64) - offsets[:-1]
    spr = -(-counts // pack)
    n_steps = int(spr.sum())
    if n_steps == 0:
        z = np.zeros((0,), np.int32)
        return z, z, np.zeros((nnz,), np.int32), 0
    rows = np.repeat(np.arange(n_rows, dtype=np.int32), spr)
    row_first_step = np.concatenate([[0], np.cumsum(spr)])
    step_in_row = np.arange(n_steps, dtype=np.int64) - np.repeat(row_first_step[:-1], spr)
    step_lo = np.repeat(offsets[:-1].astype(np.int64), spr) + step_in_row * pack
    pos = step_lo[:, None] + np.arange(pack, dtype=np.int64)
    valid = pos < np.repeat(offsets[1:].astype(np.int64), spr)[:, None]
    pos_c = np.minimum(pos, max(nnz - 1, 0))
    cols = np.where(valid, indices[pos_c], 0).astype(np.int32).reshape(-1)
    slots = np.arange(n_steps, dtype=np.int64)[:, None] * pack + np.arange(pack)
    src = np.zeros((nnz,), np.int32)
    src[pos[valid]] = slots[valid].astype(np.int32)
    return rows, cols, src, n_steps


def plan_sdd_smallblock(topology: BlockSparseMatrix) -> SddPlan:
    """The SDD plan of a host-known topology: step = up to ``pack``
    consecutive nonzero output blocks of one block-row."""
    bs = topology.block_size
    if bs not in SMALL_BLOCK_SIZES:
        raise ValueError(f"small-block plans take block sizes {SMALL_BLOCK_SIZES}, got {bs}")
    offs, indices, _ = topology.host_metadata()
    rows, cols, src, n_steps = pack_rows(offs, indices, SUPER // bs)
    return SddPlan(rows=rows, cols=cols, src=src, n_steps=n_steps, block_size=bs)


# ---------------------------------------------------------- plain versions --
def _step_chunks(n_steps: int, per_step: int):
    """Step ranges whose fp32 intermediates stay near 128 MB."""
    size = max(1, (1 << 25) // max(per_step, 1))
    return [(s, min(s + size, n_steps)) for s in range(0, n_steps, size)]


def dsd_small_reference(plan: SmallPlan, data: torch.Tensor, b: torch.Tensor, *, n_rows: int, transpose_a: bool,
                        transpose_b: bool, out_dtype) -> torch.Tensor:
    """``bsr_small_dsd``'s plain version on the same plan: each step's
    packed (bs x 128) A tile against its (128 x N) stack of dense panels,
    fp32, added into its block-row; ``(n_rows * bs, N)``."""
    bs = plan.block_size
    pack = SUPER // bs
    dev = data.device
    op_b = oriented(b, transpose_b)
    k_dim, n_dim = op_b.shape
    panels = op_b.reshape(k_dim // bs, bs, n_dim)
    blocks = oriented(torch.cat([data, data.new_zeros((1, bs, bs))]), transpose_a)
    _, _, deps, datas, rows = (x.long() for x in plan.device_arrays(dev))
    out = torch.zeros((n_rows, bs, n_dim), dtype=torch.float32, device=dev)
    for s0, s1 in _step_chunks(plan.n_steps, SUPER * n_dim):
        c = s1 - s0
        tiles = blocks[datas[s0 * pack:s1 * pack]].reshape(c, pack, bs, bs).permute(0, 2, 1, 3).reshape(c, bs, SUPER)
        stack = panels[deps[s0 * pack:s1 * pack]].reshape(c, SUPER, n_dim)
        out.index_add_(0, rows[s0:s1], torch.bmm(tiles.float(), stack.float()))
    return out.reshape(n_rows * bs, n_dim).to(out_dtype)


def sdd_small_reference(plan: SddPlan, a: torch.Tensor, b: torch.Tensor, *, transpose_a: bool, transpose_b: bool,
                        out_dtype) -> torch.Tensor:
    """``bsr_small_sdd``'s plain version on the same plan: each step's
    (bs x K) A strip against its ``pack`` (bs x K) B strips, fp32, then
    the slots gathered into block order; ``(nnz, bs, bs)``."""
    bs = plan.block_size
    pack = SUPER // bs
    op_a = oriented(a, transpose_a)  # (M, K)
    op_bt = oriented(b, not transpose_b)  # (N, K)
    k_dim = op_a.shape[1]
    a_rows = op_a.reshape(op_a.shape[0] // bs, bs, k_dim)
    b_rows = op_bt.reshape(op_bt.shape[0] // bs, bs, k_dim)
    rows, cols, _, src = (x.long() for x in plan.device_arrays(a.device))
    slots = torch.empty((plan.n_steps * pack, bs, bs), dtype=torch.float32, device=a.device)
    for s0, s1 in _step_chunks(plan.n_steps, SUPER * k_dim):
        c = s1 - s0
        strip = a_rows[rows[s0:s1]].float()
        stack = b_rows[cols[s0 * pack:s1 * pack]].reshape(c, SUPER, k_dim).float()
        prod = torch.bmm(strip, stack.transpose(1, 2))  # (c, bs, pack * bs)
        slots[s0 * pack:s1 * pack] = prod.reshape(c, bs, pack, bs).permute(0, 2, 1, 3).reshape(c * pack, bs, bs)
    return slots[src].to(out_dtype)


# ------------------------------------------------------------------ kernels --
@functools.cache
def _lib():
    lib = _build.load("bsr_small")
    lib.bsr_small_dsd.restype = ctypes.c_int
    lib.bsr_small_dsd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    lib.bsr_small_sdd.restype = ctypes.c_int
    lib.bsr_small_sdd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    return lib


def _check(name: str, inputs, out: torch.Tensor, bs: int) -> None:
    """What both kernels take: CUDA tensors on one device, contiguous and
    16-byte aligned, 2-D dense operands and 3-D block data (no batch axis),
    bf16 or fp32 inputs of one dtype, a bf16 or fp32 output, blocks of 16,
    32 or 64."""
    for label, t in list(inputs) + [("out", out)]:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors; {label} is on {t.device}")
        if t.device != out.device:
            raise ValueError(f"{name}: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
    for label, t in inputs:
        if t.ndim != (3 if label == "sparse data" else 2):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}; no batch axis is taken")
    dtypes = {t.dtype for _, t in inputs}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise ValueError(f"{name} takes bf16 or fp32 operands of one dtype, got {sorted(map(str, dtypes))}")
    if out.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: output dtype {out.dtype} not supported")
    if bs not in SMALL_BLOCK_SIZES:
        raise ValueError(f"{name}: block size must be 16, 32 or 64, got {bs}")


def _plan_for(plan: SmallPlan, sparse: BlockSparseMatrix, transposed: bool) -> SmallPlan:
    if plan is None:
        return plan_smallblock(sparse, transposed=transposed)
    if plan.transposed != transposed or plan.block_size != sparse.block_size:
        raise ValueError("the schedule was planned for another orientation or block size")
    return plan


def _dsd_launch(plan: SmallPlan, sparse: BlockSparseMatrix, dense: torch.Tensor, out: torch.Tensor, *,
                transpose_sparse: bool, transpose_dense: bool, out_transposed: bool) -> None:
    """``op(sparse) @ op(dense)`` into ``out`` (``(M, N)``, or ``(N, M)``
    with ``out_transposed``)."""
    bs = sparse.block_size
    _check("bsr_small_dsd", [("sparse data", sparse.data), ("dense", dense)], out, bs)
    m_dim = sparse.cols if transpose_sparse else sparse.rows
    k_dim = sparse.rows if transpose_sparse else sparse.cols
    n_dim = dense.shape[0] if transpose_dense else dense.shape[1]
    if (dense.shape[1] if transpose_dense else dense.shape[0]) != k_dim:
        raise ValueError(f"bsr_small_dsd: contraction mismatch, sparse gives k={k_dim}")
    if n_dim % SUPER:
        raise ValueError(f"bsr_small_dsd: N={n_dim} must be a multiple of 128")
    if tuple(out.shape) != ((n_dim, m_dim) if out_transposed else (m_dim, n_dim)):
        raise ValueError(f"bsr_small_dsd: out is {tuple(out.shape)} for a {m_dim} x {n_dim} product")
    n_rows = m_dim // bs
    n_super = cdiv(n_rows, SUPER // bs)
    if n_super > 65535:
        raise ValueError("bsr_small_dsd: more than 65535 super-rows")
    offsets, subs, deps, datas, _ = plan.device_arrays(out.device)
    row_stride, col_stride = (1, m_dim) if out_transposed else (n_dim, 1)
    err = _lib().bsr_small_dsd(
        sparse.data.data_ptr(), offsets.data_ptr(), subs.data_ptr(), deps.data_ptr(), datas.data_ptr(),
        dense.data_ptr(), out.data_ptr(), sparse.nnz_blocks, n_rows, n_super, n_dim,
        dense.stride(0), row_stride, col_stride, bs,
        int(dense.dtype == torch.float32), int(out.dtype == torch.float32),
        int(transpose_sparse), int(transpose_dense), torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_small_dsd launch failed: cudaError {err}")
    LAUNCHES["bsr_small_dsd"] += 1


def dsd_smallblock(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: SmallPlan = None,
) -> torch.Tensor:
    """C = op(A_smallblock) @ op(B) at block sizes 16 / 32 / 64; a given
    ``schedule`` must come from ``plan_smallblock(a, transposed=transpose_a)``."""
    out_dtype = out_dtype or a.dtype
    plan = _plan_for(schedule, a, transpose_a)
    m_dim = a.cols if transpose_a else a.rows
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    if not a.data.is_cuda and not b.is_cuda:
        return dsd_small_reference(plan, a.data, b, n_rows=m_dim // a.block_size, transpose_a=transpose_a,
                                   transpose_b=transpose_b, out_dtype=out_dtype)
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=a.device)
    _dsd_launch(plan, a, b, out, transpose_sparse=transpose_a, transpose_dense=transpose_b, out_transposed=False)
    return out


def dds_smallblock(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: SmallPlan = None,
) -> torch.Tensor:
    """C = op(A) @ op(B_smallblock), run as C^T = dsd(B, A) with flipped
    flags; a given ``schedule`` must come from
    ``plan_smallblock(b, transposed=not transpose_b)``."""
    out_dtype = out_dtype or b.dtype
    plan = _plan_for(schedule, b, not transpose_b)
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    n_dim = b.rows if transpose_b else b.cols
    if not a.is_cuda and not b.data.is_cuda:
        ct = dsd_small_reference(plan, b.data, a, n_rows=n_dim // b.block_size, transpose_a=not transpose_b,
                                 transpose_b=not transpose_a, out_dtype=out_dtype)
        return ct.transpose(0, 1).contiguous()
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=b.device)
    _dsd_launch(plan, b, a, out, transpose_sparse=not transpose_b, transpose_dense=not transpose_a,
                out_transposed=True)
    return out


def sdd_smallblock(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: SddPlan = None,
) -> BlockSparseMatrix:
    """C_smallblock = op(A) @ op(B) masked to ``topology`` (block sizes 16 /
    32 / 64); a given ``schedule`` must come from
    ``plan_sdd_smallblock(topology)``."""
    out_dtype = out_dtype or topology.dtype
    bs = topology.block_size
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    k_dim = a.shape[-2] if transpose_a else a.shape[-1]
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    if (b.shape[-1] if transpose_b else b.shape[-2]) != k_dim:
        raise ValueError(f"sdd_smallblock: contraction mismatch, A gives k={k_dim}")
    if (m_dim, n_dim) != topology.shape:
        raise ValueError(f"sdd_smallblock: output shape {(m_dim, n_dim)} != topology {topology.shape}")
    plan = schedule if schedule is not None else plan_sdd_smallblock(topology)
    if plan.block_size != bs:
        raise ValueError("the schedule was planned for another block size")
    if topology.nnz_blocks == 0:
        return topology.with_data(torch.empty((0, bs, bs), dtype=out_dtype, device=topology.device))
    if not a.is_cuda and not b.is_cuda:
        return topology.with_data(sdd_small_reference(plan, a, b, transpose_a=transpose_a, transpose_b=transpose_b,
                                                      out_dtype=out_dtype))
    out = torch.empty((topology.nnz_blocks, bs, bs), dtype=out_dtype, device=a.device)
    _check("bsr_small_sdd", [("a", a), ("b", b)], out, bs)
    if k_dim % 16:
        raise ValueError(f"bsr_small_sdd: K={k_dim} must be a multiple of 16")
    if topology.data.ndim != 3:
        raise ValueError("bsr_small_sdd: a topology with a batch axis is not supported")
    rows, cols, slot_blocks, _ = plan.device_arrays(out.device)
    err = _lib().bsr_small_sdd(
        a.data_ptr(), b.data_ptr(), rows.data_ptr(), cols.data_ptr(), slot_blocks.data_ptr(), out.data_ptr(),
        plan.n_steps, k_dim, a.stride(0), b.stride(0), bs,
        int(a.dtype == torch.float32), int(out.dtype == torch.float32),
        int(transpose_a), int(transpose_b), torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_small_sdd launch failed: cudaError {err}")
    LAUNCHES["bsr_small_sdd"] += 1
    return topology.with_data(out)
