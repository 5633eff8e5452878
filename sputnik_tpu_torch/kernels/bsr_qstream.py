"""DSD / DDS on the ``bsr_bres`` CUDA kernel (``csrc/bsr_bres.cu``): the
q-batched plan of the JAX package's dense-resident schedule.

Port of the bres part of ``sputnik_tpu/kernels/bsr_qstream.py``
(``dsd_bres``, ``dds_bres``, ``_plan``). A plan step is ``q`` blocks of one
output block-row (DSD) or column (DDS), contracted as one product of
depth ``q * 128``, with ``out_scale`` at the flush; bf16, fp32 and int8
(exact int32 accumulation) operands, all four transpose modes. The plan
(:func:`plan`) pads every group's run to a multiple of ``q`` slots,
forward-fills a padding slot's ids from its lane's previous step and counts
each step's live slots (``nv``). Host-known metadata is planned on the host
in numpy, equal to JAX's concrete plan; metadata built on the card is
planned on the card with torch ops (:func:`plan_on_device`), at JAX's
static worst-case length, reading nothing back. Plans are cached per
topology.

On CPU tensors the wrappers compute the kernel's plain version from the
same plan (:func:`bres_reference`); on CUDA tensors they launch the kernel,
or raise for a problem it does not take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build, reference
from sputnik_tpu_torch.kernels.bsr_dsd import IN_KINDS, OUT_KINDS, check_dtypes
from sputnik_tpu_torch.kernels.common import cached_plan, oriented

__all__ = ["dsd_bres", "dds_bres", "plan", "plan_on_device", "BresPlan", "bres_reference", "LAUNCHES",
           "BRES_MAX_DENSE_BYTES"]

# The JAX package's VMEM budget for the resident dense operand (a TPU
# figure, kept so that both packages route alike; to be measured again on
# the H100).
BRES_MAX_DENSE_BYTES = 96 << 20

# Launches of bsr_bres in this process.
LAUNCHES = 0


@dataclasses.dataclass(eq=False)
class BresPlan:
    """Slot ``s`` of step ``s // q`` holds block ``data_q[s]`` contracting
    panel ``dep_q[s]`` into output group ``out_q[s]``; the first ``nv[j]``
    slots of step ``j`` are live. ``step_offsets`` (``n_groups + 1``) is
    each group's step range, what a CTA of the kernel walks. numpy for a
    host plan, tensors on the card for a device plan."""

    out_q: object
    dep_q: object
    data_q: object
    nv: object
    n_steps: int
    step_offsets: object
    q: int
    _device: Dict = dataclasses.field(default_factory=dict, repr=False)

    def device_arrays(self, device: torch.device):
        """(step offsets, dep_q, data_q, nv, out_q) as int32 on ``device``,
        uploaded once for a host plan."""
        if device not in self._device:
            self._device[device] = tuple(
                x.to(device) if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.ascontiguousarray(x, np.int32)).to(device)
                for x in (self.step_offsets, self.dep_q, self.data_q, self.nv, self.out_q))
        return self._device[device]


def _ffill_lane_np(vals, valid, q):
    """Forward-fill invalid slots from the same lane's previous step."""
    v = vals.reshape(-1, q)
    ok = valid.reshape(-1, q)
    idx = np.where(ok, np.arange(v.shape[0])[:, None], 0)
    ff = np.maximum.accumulate(idx, axis=0)
    return np.take_along_axis(v, ff, axis=0).reshape(-1)


def _ffill_lane_torch(vals, valid, q):
    v = vals.reshape(-1, q)
    ok = valid.reshape(-1, q)
    idx = torch.where(ok, torch.arange(v.shape[0], dtype=torch.int64, device=v.device)[:, None], 0)
    ff = torch.cummax(idx, dim=0).values
    return torch.take_along_dim(v, ff, dim=0).reshape(-1)


def plan(out_ids, dep_ids, data_ids, counts, q: int) -> BresPlan:
    """The padded slot plan on the host (numpy), the JAX package's
    ``_plan(..., concrete=True)`` step for step."""
    counts = np.asarray(counts)
    out_ids, dep_ids, data_ids = (np.asarray(x) for x in (out_ids, dep_ids, data_ids))
    n_groups = counts.shape[0]
    nnz = out_ids.shape[0]
    plen = -(-counts // q) * q
    starts = np.concatenate([np.zeros(1, counts.dtype), np.cumsum(plen)])
    total = int(starts[-1])
    n_steps = max(total // q, 1)
    s = np.arange(n_steps * q, dtype=np.int64)
    g = np.clip(np.searchsorted(starts, s, side="right") - 1, 0, n_groups - 1)
    w = s - starts[g]
    off = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
    valid = w < counts[g]
    src = np.clip(off[g] + np.minimum(w, counts[g] - 1), 0, nnz - 1)
    # Output id: dead slots take the last live slot's (JAX: the out index
    # parked on the previous tile); ids: the lane's previous step's.
    ff = np.maximum.accumulate(np.where(valid, np.arange(s.shape[0]), 0))
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return BresPlan(
        out_q=i32(out_ids[src][ff]), dep_q=i32(_ffill_lane_np(dep_ids[src], valid, q)),
        data_q=i32(_ffill_lane_np(data_ids[src], valid, q)), nv=i32(valid.reshape(-1, q).sum(1)),
        n_steps=n_steps, step_offsets=i32(starts // q), q=q,
    )


def plan_on_device(out_ids, dep_ids, data_ids, counts, q: int) -> BresPlan:
    """The same plan built on the card from metadata that lives there (the
    JAX package's ``_plan(..., concrete=False)``): the static worst-case
    length ``nnz + n_groups * (q - 1)`` slots, rounded up to ``q``, and no
    value read back."""
    dev = counts.device
    counts = counts.to(torch.int64)
    n_groups = counts.shape[0]
    nnz = out_ids.shape[0]
    plen = (counts + q - 1) // q * q
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(plen, 0)])
    total = -(-(nnz + n_groups * (q - 1)) // q) * q
    n_steps = max(total // q, 1)
    s = torch.arange(n_steps * q, dtype=torch.int64, device=dev)
    g = (torch.searchsorted(starts, s, right=True) - 1).clamp(0, n_groups - 1)
    w = s - starts[g]
    off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)])
    valid = w < counts[g]
    src = (off[g] + torch.minimum(w, counts[g] - 1)).clamp(0, nnz - 1)
    idx = torch.where(valid, torch.arange(s.shape[0], dtype=torch.int64, device=dev), 0)
    ff = torch.cummax(idx, dim=0).values
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return BresPlan(
        out_q=i32(out_ids.long()[src][ff]), dep_q=i32(_ffill_lane_torch(dep_ids.long()[src], valid, q)),
        data_q=i32(_ffill_lane_torch(data_ids.long()[src], valid, q)), nv=i32(valid.reshape(-1, q).sum(1)),
        n_steps=n_steps, step_offsets=i32(starts // q), q=q,
    )


def sparse_plan(sparse: BlockSparseMatrix, transposed: bool, q: int) -> BresPlan:
    """The plan of ``sparse`` streamed by block-row (or, ``transposed``, by
    block-column through the transpose metadata), cached per topology: on
    the host for host-known metadata, else on the card."""
    def build():
        if sparse.host_known:
            offs, deps, data = sparse.host_metadata(transposed)
            out_ids = np.repeat(np.arange(len(offs) - 1, dtype=np.int32), np.diff(offs))
            return plan(out_ids, deps, data, np.diff(offs), q)
        out_ids, deps, data = sparse.iteration_arrays(transposed)
        m = sparse.with_transpose_metadata() if transposed else sparse
        groups = m.offsets_t if transposed else m.offsets
        return plan_on_device(out_ids, deps, data, groups[1:] - groups[:-1], q)

    return cached_plan((sparse.indices,), ("bres", transposed, q), build)


# ----------------------------------------------------------- plain version --
def bres_reference(bres: BresPlan, data: torch.Tensor, dense: torch.Tensor, *, n_groups: int,
                   transpose_sparse: bool, transpose_dense: bool, out_dtype, out_scale=None) -> torch.Tensor:
    """``bsr_bres``'s plain version on the same plan: every live slot's
    block against its dense panel (fp32, or exact int32 for int8), summed
    into its output group, then the flush; ``(n_groups * 128, N)``."""
    bs = data.shape[-1]
    dev = data.device
    op_d = oriented(dense, transpose_dense)  # (K, N)
    n_dim = op_d.shape[1]
    panels = op_d.reshape(op_d.shape[0] // bs, bs, n_dim)
    blocks = oriented(data, transpose_sparse)
    _, dep_q, data_q, nv, out_q = (x.long() for x in bres.device_arrays(dev))
    live = (torch.arange(bres.q, device=dev)[None, :] < nv[:, None]).reshape(-1)
    # Dead slots add a zero block: their block index still points at a
    # real block, so mask the product instead of gathering conditionally.
    acc = None
    step = max(1, (1 << 24) // (bs * n_dim))
    for s0 in range(0, out_q.shape[0], step):
        s1 = min(s0 + step, out_q.shape[0])
        prod = reference.product(blocks[data_q[s0:s1]], panels[dep_q[s0:s1]])
        prod = prod * live[s0:s1, None, None].to(prod.dtype)
        if acc is None:
            acc = torch.zeros((n_groups, bs, n_dim), dtype=prod.dtype, device=dev)
        acc.index_add_(0, out_q[s0:s1], prod)
    return reference.flush(acc.reshape(n_groups * bs, n_dim), out_dtype, out_scale)


# ------------------------------------------------------------------ kernel --
@functools.cache
def _kernel():
    fn = _build.load("bsr_bres").bsr_bres
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    return fn


def _launch(bres: BresPlan, sparse: BlockSparseMatrix, dense: torch.Tensor, out: torch.Tensor, *,
            transpose_sparse: bool, transpose_dense: bool, out_transposed: bool, out_scale) -> None:
    global LAUNCHES
    data = sparse.data
    for name, t in (("sparse data", data), ("dense", dense), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"bsr_bres needs CUDA tensors; {name} is on {t.device}")
        if t.device != out.device:
            raise ValueError("bsr_bres: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bsr_bres: {name} must be contiguous and 16-byte aligned")
    check_dtypes("bsr_bres", data.dtype, dense.dtype, out.dtype, out_scale)
    if sparse.block_size != 128:
        raise ValueError(f"bsr_bres: block size must be 128, got {sparse.block_size}")
    if data.ndim != 3 or dense.ndim != 2:
        raise ValueError("bsr_bres: operands with a batch axis are not supported")
    m_dim = sparse.cols if transpose_sparse else sparse.rows
    n_dim = dense.shape[0] if transpose_dense else dense.shape[1]
    if n_dim % 128:
        raise ValueError(f"bsr_bres: N={n_dim} must be a multiple of 128")
    n_groups = m_dim // 128
    if n_groups > 65535:
        raise ValueError("bsr_bres: more than 65535 block-rows")
    offsets, dep_q, data_q, nv, _ = bres.device_arrays(out.device)
    if offsets.shape[0] != n_groups + 1:
        raise ValueError("bsr_bres: the plan is for another problem")
    row_stride, col_stride = (1, m_dim) if out_transposed else (n_dim, 1)
    err = _kernel()(
        data.data_ptr(), offsets.data_ptr(), dep_q.data_ptr(), data_q.data_ptr(), nv.data_ptr(),
        dense.data_ptr(), out.data_ptr(), n_groups, n_dim, bres.q, dense.stride(0), row_stride, col_stride,
        IN_KINDS[data.dtype], OUT_KINDS[out.dtype], 1.0 if out_scale is None else float(out_scale),
        int(transpose_sparse), int(transpose_dense), torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_bres launch failed: cudaError {err}")
    LAUNCHES += 1


def dsd_bres(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    q: int = 8,
    out_scale=None,
) -> torch.Tensor:
    """C = op(A_sparse) @ op(B), ``q`` blocks of an output block-row per
    step, times ``out_scale`` at the flush. (The JAX package's ``accum``
    picks how a TPU step sums its q dots; a CTA here sums them in one
    register tile, so there is no such choice.)"""
    out_dtype = out_dtype or a.dtype
    m_dim = a.cols if transpose_a else a.rows
    k_dim = a.rows if transpose_a else a.cols
    if (b.shape[-1] if transpose_b else b.shape[-2]) != k_dim:
        raise ValueError(f"contraction mismatch: A gives k={k_dim}, B gives {tuple(b.shape)}")
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    if a.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=a.device)
    bres = sparse_plan(a, transpose_a, q)
    if not a.data.is_cuda and not b.is_cuda:
        return bres_reference(bres, a.data, b, n_groups=m_dim // a.block_size, transpose_sparse=transpose_a,
                              transpose_dense=transpose_b, out_dtype=out_dtype, out_scale=out_scale)
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=a.device)
    _launch(bres, a, b, out, transpose_sparse=transpose_a, transpose_dense=transpose_b, out_transposed=False,
            out_scale=out_scale)
    return out


def dds_bres(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    q: int = 8,
    out_scale=None,
) -> torch.Tensor:
    """C = op(A) @ op(B_sparse) as C^T = op(B)^T @ op(A)^T, ``q`` blocks of
    an output block-column per step."""
    out_dtype = out_dtype or b.dtype
    n_dim = b.rows if transpose_b else b.cols
    k_dim = b.cols if transpose_b else b.rows
    if (a.shape[-2] if transpose_a else a.shape[-1]) != k_dim:
        raise ValueError(f"contraction mismatch: B gives k={k_dim}, A gives {tuple(a.shape)}")
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    if b.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=b.device)
    bres = sparse_plan(b, not transpose_b, q)
    if not a.is_cuda and not b.data.is_cuda:
        ct = bres_reference(bres, b.data, a, n_groups=n_dim // b.block_size, transpose_sparse=not transpose_b,
                            transpose_dense=not transpose_a, out_dtype=out_dtype, out_scale=out_scale)
        return ct.transpose(0, 1).contiguous()
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=b.device)
    _launch(bres, b, a, out, transpose_sparse=not transpose_b, transpose_dense=not transpose_a,
            out_transposed=True, out_scale=out_scale)
    return out
