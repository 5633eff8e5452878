"""DSD / DDS with a full-K panel of the dense operand resident in shared
memory, on the ``bsr_panel`` CUDA kernel (``csrc/bsr_panel.cu``).

Port of ``sputnik_tpu/kernels/bsr_panel.py``:

* :func:`plan_stream`: the sparse operand's blocks group-major by output
  block-row, batched ``group`` per step through the flat-schedule machinery
  (``bsr_flat._batch_items``, adaptive group, flag-0 padding), equal to
  JAX's element for element; needs host-known metadata (JAX: concrete);
* :func:`panel_fits` and :func:`_pick_panel_tile`: JAX's VMEM budget test
  and output-panel tile, kept so that both packages route alike (the
  registry's predicate) and raise alike; the CUDA kernel's panel width comes
  from shared memory instead (:func:`_panel_width`);
* :func:`dsd_panel` / :func:`dds_panel`: the kernel walks each output
  block-row's schedule items against a resident panel of W columns; DDS runs
  as ``C^T = op(B)^T @ op(A)^T`` on the same kernel, as JAX's mirror does.

On CPU tensors the wrappers compute the kernel's plain version
(:func:`panel_reference`: the schedule's live items through
``bsr_cres.resident_reference``); on CUDA tensors they launch the kernel,
or raise for a problem it does not take. Schedules are cached per topology
and uploaded once per device (``FlatSchedule.device_arrays``), so a call
with a warm cache copies nothing from the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.bsr_cres import _check, resident_reference, split_rows
from sputnik_tpu_torch.kernels.bsr_flat import FlatSchedule, _batch_items, _ragged_positions, _stream_np
from sputnik_tpu_torch.kernels.common import cached_plan

__all__ = ["dsd_panel", "dds_panel", "plan_stream", "panel_fits", "panel_reference", "LAUNCHES"]

_PANEL_BUDGET = 4 << 20  # the JAX package's resident dense-panel bytes (TPU VMEM)
_PANEL_BUDGET_STAGED = 2 << 20  # ... for k-minor panels, which it restages
_GROUP = 4  # sparse blocks per TPU grid step

# Launches of bsr_panel in this process.
LAUNCHES = 0

_KINDS = {torch.bfloat16: 0, torch.float32: 1}
# The kernel's panel widths, widest first, and a CTA's shared memory on the
# H100 (232,448 bytes).
_WIDTHS = (64, 32, 16, 8)
_SMEM_LIMIT = 227 * 1024


def panel_fits(k_dim: int, itemsize: int, lanes: int = 128) -> bool:
    """JAX's test: does a full-K panel of the minimum width fit its (staged)
    VMEM budget?"""
    return k_dim * lanes * itemsize <= _PANEL_BUDGET_STAGED


def _pick_panel_tile(n_dim: int, k_dim: int, itemsize: int, bs: int, staged: bool) -> int:
    """JAX's output-panel tile: the largest 128-multiple divisor of n_dim
    whose (K, bn) panel fits its VMEM budget (0: none)."""
    budget = _PANEL_BUDGET_STAGED if staged else _PANEL_BUDGET
    cap = int(budget // (k_dim * itemsize))
    best = 0
    t = bs
    while t <= n_dim:
        if n_dim % t == 0 and t <= cap:
            best = t
        t += bs
    return best


def plan_stream(sparse: BlockSparseMatrix, *, transposed: bool, group: int = _GROUP) -> FlatSchedule:
    """The sparse operand's group-major block stream, batched ``group`` per
    step (JAX's ``plan_stream``); ``transposed`` streams op(S) = S^T by its
    rows, through the transpose metadata. Needs host-known metadata."""
    offs, dep, data = _stream_np(sparse, transposed)
    counts = offs[1:] - offs[:-1]
    total = int(counts.sum())
    unvisited = np.nonzero(counts == 0)[0].astype(np.int32)
    out_ids = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    pos = _ragged_positions(offs[:-1], counts)
    return _batch_items(out_ids, (dep[pos], data[pos], np.zeros_like(out_ids)), group, "stream", total, unvisited)


# ----------------------------------------------------------- plain version --
def panel_reference(schedule: FlatSchedule, data: torch.Tensor, dense: torch.Tensor, *, row_blocks: int,
                    transpose_sparse: bool, transpose_dense: bool, out_dtype) -> torch.Tensor:
    """The kernel's plain version in the DSD view, on the same schedule: each
    live item's block op(S)[data] times the dense strip op(D)[dep], fp32,
    added into its output block-row, then the flush; ``(row_blocks * 128,
    N)``, zeros where a row has no item."""
    live = np.nonzero(schedule.flags)[0]
    rows = np.repeat(schedule.out_ids, schedule.group)[live]
    return resident_reference(schedule.dep_ids[live], rows, schedule.data_ids[live], data, dense,
                              row_blocks=row_blocks, transpose_sparse=transpose_sparse,
                              transpose_dense=transpose_dense, out_dtype=out_dtype)


# ------------------------------------------------------------------ kernel --
@functools.cache
def _lib():
    lib = _build.load("bsr_panel")
    lib.bsr_panel.restype = ctypes.c_int
    lib.bsr_panel.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    lib.bsr_panel_smem_bytes.restype = ctypes.c_longlong
    lib.bsr_panel_smem_bytes.argtypes = [ctypes.c_int] * 5
    return lib


def _panel_width(in_kind: int, n_cols: int, k_dim: int, ts: bool, td: bool) -> int:
    """The widest kernel panel that divides N and fits a CTA's shared memory."""
    lib = _lib()
    for w in _WIDTHS:
        if n_cols % w == 0 and 0 < lib.bsr_panel_smem_bytes(in_kind, w, k_dim, int(ts), int(td)) <= _SMEM_LIMIT:
            return w
    raise ValueError(f"bsr_panel: no panel of K = {k_dim} fits {_SMEM_LIMIT} bytes of shared memory")


def _panel(sparse: BlockSparseMatrix, dense: torch.Tensor, schedule: FlatSchedule, *, ts: bool, td: bool,
           r_dim: int, n_cols: int, k_dim: int, out_dtype, out_shape, row_stride: int,
           col_stride: int) -> torch.Tensor:
    """C'(R, N) = op(sparse) @ op(dense) on ``bsr_panel`` (the DSD view)."""
    global LAUNCHES
    row_blocks = r_dim // sparse.block_size
    if not sparse.data.is_cuda and not dense.is_cuda:
        out = panel_reference(schedule, sparse.data, dense, row_blocks=row_blocks, transpose_sparse=ts,
                              transpose_dense=td, out_dtype=out_dtype)
        return out if row_stride != 1 else out.transpose(0, 1).contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=sparse.device)
    _check("bsr_panel", sparse, dense, out, n_cols)
    if row_blocks > 65535:
        raise ValueError("bsr_panel: more than 65535 output block-rows")
    offsets, deps, datas, _, flags = schedule.device_arrays(out.device, row_blocks)
    width = _panel_width(_KINDS[sparse.dtype], n_cols, k_dim, ts, td)
    err = _lib().bsr_panel(
        sparse.data.data_ptr(), offsets.data_ptr(), deps.data_ptr(), datas.data_ptr(), flags.data_ptr(),
        dense.data_ptr(), out.data_ptr(), row_blocks, n_cols, k_dim, width, split_rows(row_blocks, n_cols // width),
        dense.stride(0), row_stride, col_stride, _KINDS[sparse.dtype], _KINDS[out_dtype], int(ts), int(td),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_panel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _schedule(sparse: BlockSparseMatrix, transposed: bool, schedule: Optional[FlatSchedule]) -> FlatSchedule:
    if schedule is not None:
        return schedule
    return cached_plan((sparse.indices,), ("panel", transposed), lambda: plan_stream(sparse, transposed=transposed))


def dsd_panel(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: Optional[FlatSchedule] = None,
) -> torch.Tensor:
    """C[M, N] = op(A_sparse) @ op(B_dense), B panel-resident (JAX's
    ``dsd_panel``). ``schedule`` is a :func:`plan_stream` of ``a``; without
    one, the schedule of host-known metadata is made and cached."""
    out_dtype = out_dtype or a.dtype
    bs = a.block_size
    m_dim, k_dim = (a.cols, a.rows) if transpose_a else (a.rows, a.cols)
    bk, n_dim = (b.shape[-1], b.shape[-2]) if transpose_b else (b.shape[-2], b.shape[-1])
    if bk != k_dim:
        raise ValueError(f"contraction mismatch: A gives k={k_dim}, B gives {bk}")
    if a.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=a.device)
    schedule = _schedule(a, transpose_a, schedule)
    if _pick_panel_tile(n_dim, k_dim, b.element_size(), bs, staged=transpose_b) == 0:
        raise ValueError("dsd_panel: no panel tile fits the VMEM budget")
    return _panel(a, b, schedule, ts=transpose_a, td=transpose_b, r_dim=m_dim, n_cols=n_dim, k_dim=k_dim,
                  out_dtype=out_dtype, out_shape=(m_dim, n_dim), row_stride=n_dim, col_stride=1)


def dds_panel(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    schedule: Optional[FlatSchedule] = None,
) -> torch.Tensor:
    """C[M, N] = op(A_dense) @ op(B_sparse), A's (W, K) row panel resident
    (JAX's ``dds_panel``); ``schedule`` is a :func:`plan_stream` of ``b``
    with ``transposed=not transpose_b``."""
    out_dtype = out_dtype or b.dtype
    bs = b.block_size
    n_dim, k_dim = (b.rows, b.cols) if transpose_b else (b.cols, b.rows)
    ak, m_dim = (a.shape[-2], a.shape[-1]) if transpose_a else (a.shape[-1], a.shape[-2])
    if ak != k_dim:
        raise ValueError(f"contraction mismatch: B gives k={k_dim}, A gives {ak}")
    if b.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=b.device)
    schedule = _schedule(b, not transpose_b, schedule)
    if _pick_panel_tile(m_dim, k_dim, a.element_size(), bs, staged=not transpose_a) == 0:
        raise ValueError("dds_panel: no panel tile fits the VMEM budget")
    return _panel(b, a, schedule, ts=not transpose_b, td=not transpose_a, r_dim=n_dim, n_cols=m_dim, k_dim=k_dim,
                  out_dtype=out_dtype, out_shape=(m_dim, n_dim), row_stride=1, col_stride=n_dim)
