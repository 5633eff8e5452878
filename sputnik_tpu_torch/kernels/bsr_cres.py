"""DSD / DDS with the blocks streamed contraction-major and the fp32
accumulator kept until one flush, on the ``bsr_cres`` and ``bsr_gres``
CUDA kernels (``csrc/bsr_cres.cu``).

Port of ``sputnik_tpu/kernels/bsr_cres.py``:

* :func:`dsd_cres` / :func:`dds_cres` (JAX's ``_cres_kernel``, its DDS
  first fit): the blocks in dep-major order (:func:`_dep_major_arrays`,
  built where the metadata lives, so metadata built on the card takes it
  too), the accumulator of the whole output; JAX gates it on that
  accumulator fitting its VMEM (:func:`fits_vmem`, ``ACC_BUDGET``);
* :func:`dsd_gres` / :func:`dds_gres` (JAX's ``_gres_kernel``): the host
  plan :func:`plan_gres`, output block-rows in groups of ``group_rows``
  (:func:`_pick_group_rows`), each group's blocks sorted by (dep, row)
  and padded with flag-0 slots to the largest group.

DDS runs as ``C^T = op(B)^T @ op(A)^T`` on the same kernels, as JAX's
mirror does. ``ACC_BUDGET`` is the JAX package's VMEM figure, kept so that
both packages route alike (to be measured again on the H100); the kernels
keep their accumulator in an L2-resident device scratch (gres: in shared
memory when a group's rows fit), see ``csrc/bsr_cres.cu``.

On CPU tensors the wrappers compute the kernels' plain version
(:func:`resident_reference`: each block's product added into its output
rows in stream order, then the flush); on CUDA tensors they launch the
kernel, or raise for a problem it does not take. Plans and stream arrays
are cached per topology.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build, reference
from sputnik_tpu_torch.kernels.common import cached_plan, oriented

__all__ = ["dsd_cres", "dds_cres", "dsd_gres", "dds_gres", "plan_gres", "fits_vmem", "resident_reference",
           "ACC_BUDGET", "LAUNCHES"]

ACC_BUDGET = 96 * 1024 * 1024  # the JAX package's fp32 accumulator cap (TPU v5e VMEM is 128 MB)

# Kernel launches in this process, per kernel.
LAUNCHES = {"bsr_cres": 0, "bsr_gres": 0}

# Operand / output dtype -> kernel code.
_KINDS = {torch.bfloat16: 0, torch.float32: 1}
# cres slabs are 32 columns wide; output block-rows split into ranges until
# the CTAs cover the card's 132 SMs.
_CRES_WIDTH = 32
_SMS = 132
# A CTA's shared memory on the H100 (232,448 bytes).
_SMEM_LIMIT = 227 * 1024


def fits_vmem(m_dim: int, n_dim: int, dense_strip_bytes: int) -> bool:
    return m_dim * n_dim * 4 + 4 * dense_strip_bytes <= ACC_BUDGET


def _dep_major_arrays(s: BlockSparseMatrix, op_transposed: bool):
    """(deps, outs, datas) of op(S)'s blocks sorted by op-column k, int32
    on the metadata's device (JAX's ``_dep_major_arrays``)."""
    rows, cols, datas = s.iteration_arrays(not op_transposed)
    return rows.to(torch.int32), cols.to(torch.int32), datas.to(torch.int32)


def _op_row_arrays_np(s: BlockSparseMatrix, op_transposed: bool):
    """numpy (rows, deps, datas) of op(S)'s blocks in op-row-major order."""
    offs, deps, datas = s.host_metadata(op_transposed)
    rows = np.repeat(np.arange(len(offs) - 1, dtype=np.int64), np.diff(offs))
    return rows, np.asarray(deps, np.int64), np.asarray(datas, np.int64)


def plan_gres(s: BlockSparseMatrix, *, op_transposed: bool, group_rows: int):
    """The JAX package's host plan of the group-resident schedule, equal to
    it element for element: op rows in groups of ``group_rows``; within a
    group the blocks sorted by (dep, row); every group padded to the
    largest group's count ``s_max`` with flag-0 slots parked on the group's
    last dep and data ids. Returns ``(deps, subs, datas, flags, n_groups,
    s_max)``, the arrays int32 numpy flattened (n_groups, s_max). Needs
    host-known metadata."""
    rows, deps, datas = _op_row_arrays_np(s, op_transposed)
    grp = rows // group_rows
    order = np.lexsort((rows, deps, grp))  # group major, dep, then row
    grp_s, dep_s, sub_s, data_s = grp[order], deps[order], (rows % group_rows)[order], datas[order]
    n_groups = -(-((s.cols if op_transposed else s.rows) // s.block_size) // group_rows)
    counts = np.bincount(grp_s, minlength=n_groups)
    s_max = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(grp_s)) - starts[grp_s]
    last = np.maximum(starts + counts - 1, 0)
    pad = np.arange(s_max)[None, :] >= counts[:, None]

    def lay(vals, fill):
        out = np.zeros((n_groups, s_max), np.int64)
        out[grp_s, pos] = vals
        return np.where(pad, fill[:, None], out)

    has = counts > 0
    dep_p = lay(dep_s, np.where(has, dep_s[last] if len(dep_s) else 0, 0))
    data_p = lay(data_s, np.where(has, data_s[last] if len(data_s) else 0, 0))
    sub_p = lay(sub_s, np.zeros(n_groups, np.int64))
    flag_p = lay(np.ones_like(sub_s), np.zeros(n_groups, np.int64))
    i32 = lambda x: np.ascontiguousarray(x.reshape(-1), np.int32)  # noqa: E731
    return i32(dep_p), i32(sub_p), i32(data_p), i32(flag_p), int(n_groups), s_max


def _pick_group_rows(out_blocks: int, other_dim: int, bs: int) -> int:
    """Largest power-of-two group whose fp32 accumulator fits the budget
    (minus headroom for the double-buffered strips), as JAX's."""
    g = 1
    while g * 2 <= out_blocks and (g * 2) * bs * other_dim * 4 <= ACC_BUDGET - 8 * 2 ** 20:
        g *= 2
    return g


# ----------------------------------------------------------- plain version --
def resident_reference(deps, rows, datas, data: torch.Tensor, dense: torch.Tensor, *, row_blocks: int,
                       transpose_sparse: bool, transpose_dense: bool, out_dtype) -> torch.Tensor:
    """The kernels' plain version in the DSD view: each stream entry's block
    op(S)[data] times the dense strip op(D)[dep], fp32, added into output
    block-row ``rows``, then the flush; ``(row_blocks * 128, N)``. Rows with
    no entry are zeros."""
    bs = data.shape[-1]
    op_d = oriented(dense, transpose_dense)  # (K, N)
    n_dim = op_d.shape[1]
    panels = op_d.reshape(op_d.shape[0] // bs, bs, n_dim)
    blocks = oriented(data, transpose_sparse)
    deps, rows, datas = (torch.as_tensor(x).to(data.device).long() for x in (deps, rows, datas))
    acc = torch.zeros((row_blocks, bs, n_dim), dtype=torch.float32, device=data.device)
    step = max(1, (1 << 24) // (bs * n_dim))
    for s0 in range(0, deps.shape[0], step):
        s1 = min(s0 + step, deps.shape[0])
        acc.index_add_(0, rows[s0:s1], reference.product(blocks[datas[s0:s1]], panels[deps[s0:s1]]))
    return reference.flush(acc.reshape(row_blocks * bs, n_dim), out_dtype)


def _gres_rows(plan):
    """The live slots of a gres plan as (deps, groups, subs, datas): the
    stream the plain version adds up (output block-row group * group_rows
    + sub)."""
    deps, subs, datas, flags, n_groups, s_max = plan
    deps, subs, datas, flags = (np.asarray(torch.as_tensor(x).cpu()) for x in (deps, subs, datas, flags))
    group_rows_of = np.repeat(np.arange(n_groups), s_max)
    live = flags != 0
    return deps[live], group_rows_of[live], subs[live], datas[live]


# ------------------------------------------------------------------ kernel --
@functools.cache
def _lib():
    lib = _build.load("bsr_cres")
    lib.bsr_cres.restype = ctypes.c_int
    lib.bsr_cres.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.bsr_gres.restype = ctypes.c_int
    lib.bsr_gres.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.bsr_resident_staging_bytes.restype = ctypes.c_longlong
    lib.bsr_resident_staging_bytes.argtypes = [ctypes.c_int] * 3
    return lib


def _check(kernel: str, sparse: BlockSparseMatrix, dense: torch.Tensor, out: torch.Tensor, n_cols: int) -> None:
    data = sparse.data
    for name, t in (("sparse data", data), ("dense", dense), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {t.device}")
        if t.device != out.device:
            raise ValueError(f"{kernel}: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and 16-byte aligned")
    if data.dtype not in _KINDS or dense.dtype != data.dtype:
        raise ValueError(f"{kernel} takes bf16 or fp32 operands of one dtype, got {data.dtype} and {dense.dtype}")
    if out.dtype not in _KINDS:
        raise ValueError(f"{kernel}: output dtype {out.dtype} not supported (bf16 or fp32)")
    if sparse.block_size != 128:
        raise ValueError(f"{kernel}: block size must be 128, got {sparse.block_size}")
    if data.ndim != 3 or dense.ndim != 2:
        raise ValueError(f"{kernel}: operands with a batch axis are not supported")
    if n_cols % 128:
        raise ValueError(f"{kernel}: the dense dimension {n_cols} must be a multiple of 128")


def split_rows(row_blocks: int, n_slabs: int) -> int:
    """Block-rows per range of a kernel with a CTA per (column slab, row
    range): halve the ranges until slabs x ranges reach the card's SMs (or
    a range is one block-row)."""
    ranges = 1
    while n_slabs * ranges < _SMS and ranges * 2 <= row_blocks:
        ranges *= 2
    return -(-row_blocks // ranges)


def _stream_arrays(sparse: BlockSparseMatrix, op_transposed: bool):
    return cached_plan((sparse.indices,), ("cres", op_transposed),
                       lambda: _dep_major_arrays(sparse, op_transposed))


def _cres(sparse: BlockSparseMatrix, dense: torch.Tensor, *, ts: bool, td: bool, r_dim: int, n_cols: int,
          out_dtype, out_shape, row_stride: int, col_stride: int) -> torch.Tensor:
    """C'(R, N) = op(sparse) @ op(dense) on ``bsr_cres`` (the DSD view)."""
    deps, rows, datas = _stream_arrays(sparse, ts)
    if not sparse.data.is_cuda and not dense.is_cuda:
        out = resident_reference(deps, rows, datas, sparse.data, dense, row_blocks=r_dim // 128,
                                 transpose_sparse=ts, transpose_dense=td, out_dtype=out_dtype)
        return out if row_stride != 1 else out.transpose(0, 1).contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=sparse.device)
    _check("bsr_cres", sparse, dense, out, n_cols)
    if deps.device != out.device:
        raise ValueError("bsr_cres: the metadata is on another device than the operands")
    acc = torch.empty((r_dim, n_cols), dtype=torch.float32, device=out.device)
    err = _lib().bsr_cres(
        sparse.data.data_ptr(), deps.data_ptr(), rows.data_ptr(), datas.data_ptr(), deps.shape[0],
        dense.data_ptr(), acc.data_ptr(), out.data_ptr(), r_dim // 128, n_cols, split_rows(r_dim // 128, n_cols // _CRES_WIDTH),
        dense.stride(0), row_stride, col_stride, _KINDS[sparse.dtype], _KINDS[out_dtype], int(ts), int(td),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_cres launch failed: cudaError {err}")
    LAUNCHES["bsr_cres"] += 1
    return out


def dsd_cres(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **_,
) -> torch.Tensor:
    """C = op(A_sparse) @ op(B_dense), the accumulator of the whole output
    kept until one flush per output block-row (JAX's ``dsd_cres``)."""
    out_dtype = out_dtype or a.dtype
    m_dim, k_dim = (a.cols, a.rows) if transpose_a else (a.rows, a.cols)
    bk, n_dim = (b.shape[-1], b.shape[-2]) if transpose_b else (b.shape[-2], b.shape[-1])
    if bk != k_dim:
        raise ValueError(f"contraction mismatch: A gives k={k_dim}, B gives {bk}")
    if a.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=a.device)
    return _cres(a, b, ts=transpose_a, td=transpose_b, r_dim=m_dim, n_cols=n_dim, out_dtype=out_dtype,
                 out_shape=(m_dim, n_dim), row_stride=n_dim, col_stride=1)


def dds_cres(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **_,
) -> torch.Tensor:
    """C = op(A_dense) @ op(B_sparse), the mirror (JAX's ``dds_cres``): op(B)
    streamed by its row k, one flush per output block-column."""
    out_dtype = out_dtype or b.dtype
    n_dim, k_dim = (b.rows, b.cols) if transpose_b else (b.cols, b.rows)
    ak, m_dim = (a.shape[-2], a.shape[-1]) if transpose_a else (a.shape[-1], a.shape[-2])
    if ak != k_dim:
        raise ValueError(f"contraction mismatch: B gives k={k_dim}, A gives {ak}")
    if b.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=b.device)
    return _cres(b, a, ts=not transpose_b, td=not transpose_a, r_dim=n_dim, n_cols=m_dim, out_dtype=out_dtype,
                 out_shape=(m_dim, n_dim), row_stride=1, col_stride=n_dim)


def _device_plan(plan, device: torch.device):
    """A gres plan's four arrays as int32 tensors on ``device``, uploaded
    once per plan."""
    return cached_plan((plan[0],), ("gres_device", str(device)),
                       lambda: tuple(torch.as_tensor(x).to(device, torch.int32).contiguous() for x in plan[:4]))


def _gres_width(n_cols: int) -> int:
    """Slabs of 32 columns where they fill the card, else 16."""
    return 32 if n_cols // 32 >= _SMS else 16


def _gres(sparse: BlockSparseMatrix, dense: torch.Tensor, plan, *, ts: bool, td: bool, r_dim: int, n_cols: int,
          group_rows: int, out_dtype, out_shape, row_stride: int, col_stride: int) -> torch.Tensor:
    if not sparse.data.is_cuda and not dense.is_cuda:
        deps, groups, subs, datas = _gres_rows(plan)
        out = resident_reference(deps, groups * group_rows + subs, datas, sparse.data, dense,
                                 row_blocks=r_dim // 128, transpose_sparse=ts, transpose_dense=td,
                                 out_dtype=out_dtype)
        return out if row_stride != 1 else out.transpose(0, 1).contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=sparse.device)
    _check("bsr_gres", sparse, dense, out, n_cols)
    deps, subs, datas, flags = _device_plan(plan, out.device)
    n_groups, s_max = plan[4], plan[5]
    if n_groups > 65535 or n_groups * s_max != deps.shape[0] or n_groups * group_rows * 128 < r_dim:
        raise ValueError("bsr_gres: the plan is for another problem")
    width = _gres_width(n_cols)
    lib = _lib()
    staging = lib.bsr_resident_staging_bytes(_KINDS[sparse.dtype], width, int(td))
    in_smem = staging + group_rows * 128 * width * 4 <= _SMEM_LIMIT
    acc = None if in_smem else torch.empty((r_dim, n_cols), dtype=torch.float32, device=out.device)
    err = lib.bsr_gres(
        sparse.data.data_ptr(), deps.data_ptr(), subs.data_ptr(), datas.data_ptr(), flags.data_ptr(), n_groups,
        s_max, group_rows, dense.data_ptr(), None if acc is None else acc.data_ptr(), out.data_ptr(),
        r_dim // 128, n_cols, width, dense.stride(0), row_stride, col_stride, _KINDS[sparse.dtype],
        _KINDS[out_dtype], int(ts), int(td), torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_gres launch failed: cudaError {err}")
    LAUNCHES["bsr_gres"] += 1
    return out


def _cached_gres_plan(s: BlockSparseMatrix, op_transposed: bool, group_rows: int):
    return cached_plan((s.indices,), ("gres", op_transposed, group_rows),
                       lambda: plan_gres(s, op_transposed=op_transposed, group_rows=group_rows))


def dsd_gres(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    group_rows: int | None = None,
    plan=None,
    **_,
) -> torch.Tensor:
    """C = op(A_sparse) @ op(B_dense) on the group-resident plan (JAX's
    ``dsd_gres``): ``group_rows`` output block-rows share an accumulator and
    their blocks stream dep-sorted. ``plan`` is a :func:`plan_gres` result;
    without one, the plan of host-known metadata is made and cached."""
    out_dtype = out_dtype or a.dtype
    bs = a.block_size
    m_dim, k_dim = (a.cols, a.rows) if transpose_a else (a.rows, a.cols)
    bk, n_dim = (b.shape[-1], b.shape[-2]) if transpose_b else (b.shape[-2], b.shape[-1])
    if bk != k_dim:
        raise ValueError(f"contraction mismatch: A gives k={k_dim}, B gives {bk}")
    if a.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=a.device)
    if group_rows is None:
        group_rows = _pick_group_rows(m_dim // bs, n_dim, bs)
    if plan is None:
        plan = _cached_gres_plan(a, transpose_a, group_rows)
    return _gres(a, b, plan, ts=transpose_a, td=transpose_b, r_dim=m_dim, n_cols=n_dim, group_rows=group_rows,
                 out_dtype=out_dtype, out_shape=(m_dim, n_dim), row_stride=n_dim, col_stride=1)


def dds_gres(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    group_rows: int | None = None,
    plan=None,
    **_,
) -> torch.Tensor:
    """C = op(A_dense) @ op(B_sparse), group-resident output columns (JAX's
    ``dds_gres``)."""
    out_dtype = out_dtype or b.dtype
    bs = b.block_size
    n_dim, k_dim = (b.rows, b.cols) if transpose_b else (b.cols, b.rows)
    ak, m_dim = (a.shape[-2], a.shape[-1]) if transpose_a else (a.shape[-1], a.shape[-2])
    if ak != k_dim:
        raise ValueError(f"contraction mismatch: B gives k={k_dim}, A gives {ak}")
    if b.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=b.device)
    if group_rows is None:
        group_rows = _pick_group_rows(n_dim // bs, m_dim, bs)
    if plan is None:
        # op(B)'s rows here are the output's columns.
        plan = _cached_gres_plan(b, not transpose_b, group_rows)
    return _gres(b, a, plan, ts=not transpose_b, td=not transpose_a, r_dim=n_dim, n_cols=m_dim,
                 group_rows=group_rows, out_dtype=out_dtype, out_shape=(m_dim, n_dim), row_stride=1,
                 col_stride=n_dim)
