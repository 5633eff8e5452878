"""DSD on the column-stacked q-slot plan, on the ``bsr_cstack`` CUDA kernel
(``csrc/bsr_cstack.cu``).

Port of ``sputnik_tpu/kernels/bsr_cstack.py``: A's blocks walked
contraction-major (grouped by the contraction block k), q slots of one k per
plan step, each block's product added into its output block-row of an fp32
accumulator kept until one flush. The plan is the q-stream's
(``bsr_qstream.sparse_plan`` through A's transpose metadata: groups = A's
block-columns), which is JAX's ``_dep_major_arrays`` + ``_plan``: on the
host for host-known metadata, on the card at JAX's static worst-case length
for metadata built there, reading nothing back. Plans are cached per
topology.

``q`` is the kernel's real stack depth: the number of slots whose blocks
run against one staging of the dense strip. ``n_tile`` is the TPU
accumulator's column tile (JAX's nt, :func:`cstack_tile`); the CUDA kernel
keeps its accumulator in an L2-resident device scratch and its CTAs own
32-column slabs, so ``n_tile`` has no counterpart and is only validated.
:func:`cstack_fits` is JAX's VMEM gate, kept so that both packages route
and raise alike.

On CPU tensors :func:`dsd_cstack` computes the kernel's plain version
(:func:`cstack_reference`, on the same plan); on CUDA tensors it launches
the kernel, or raises for a problem it does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.bsr_cres import ACC_BUDGET, _KINDS, _check, resident_reference, split_rows
from sputnik_tpu_torch.kernels.bsr_qstream import BresPlan, sparse_plan

__all__ = ["dsd_cstack", "cstack_fits", "cstack_tile", "cstack_plan", "cstack_reference", "LAUNCHES"]

# Launches of bsr_cstack in this process.
LAUNCHES = 0

_SLAB = 32  # output columns of a CTA (csrc/bsr_cstack.cu)


def cstack_fits(m_dim: int, n_tile: int) -> bool:
    """JAX's gate: the (m, n_tile) fp32 accumulator within ``ACC_BUDGET``."""
    return m_dim * n_tile * 4 <= ACC_BUDGET


def cstack_tile(m_dim: int, n_dim: int, n_tile: int) -> int:
    """JAX's accumulator tile: ``min(n_tile, n_dim)``, halved (a multiple of
    128, at least 128) until the accumulator fits."""
    nt = min(n_tile, n_dim)
    while nt > 128 and not cstack_fits(m_dim, nt):
        nt = max(128, (nt // 2) // 128 * 128)
    return nt


def cstack_plan(a: BlockSparseMatrix, q: int) -> BresPlan:
    """The q-slot plan of A's blocks by contraction block: its ``out_q`` are
    the slots' k (JAX's ``k_q``), its ``dep_q`` their output block-rows
    (``row_q``)."""
    return sparse_plan(a, True, q)


# ----------------------------------------------------------- plain version --
def cstack_reference(plan: BresPlan, data: torch.Tensor, dense: torch.Tensor, *, m_blocks: int,
                     transpose_dense: bool, out_dtype) -> torch.Tensor:
    """The kernel's plain version on the same plan: every live slot's block
    times the strip op(B)[k], fp32, added into its output block-row, then the
    flush; ``(m_blocks * 128, N)``."""
    _, rows, datas, nv, ks = (x.long() for x in plan.device_arrays(data.device))
    live = (torch.arange(plan.q, device=data.device)[None, :] < nv[:, None]).reshape(-1)
    return resident_reference(ks[live], rows[live], datas[live], data, dense, row_blocks=m_blocks,
                              transpose_sparse=False, transpose_dense=transpose_dense, out_dtype=out_dtype)


# ------------------------------------------------------------------ kernel --
@functools.cache
def _kernel():
    fn = _build.load("bsr_cstack").bsr_cstack
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    return fn


def _launch(plan: BresPlan, a: BlockSparseMatrix, b: torch.Tensor, out: torch.Tensor, *, transpose_b: bool) -> None:
    global LAUNCHES
    m_dim, n_dim = out.shape
    _check("bsr_cstack", a, b, out, n_dim)
    m_blocks = m_dim // a.block_size
    _, rows, datas, nv, ks = plan.device_arrays(out.device)
    acc = torch.empty((m_dim, n_dim), dtype=torch.float32, device=out.device)
    err = _kernel()(
        a.data.data_ptr(), ks.data_ptr(), rows.data_ptr(), datas.data_ptr(), nv.data_ptr(), plan.n_steps, plan.q,
        b.data_ptr(), acc.data_ptr(), out.data_ptr(), m_blocks, n_dim, split_rows(m_blocks, n_dim // _SLAB),
        b.stride(0), _KINDS[a.dtype], _KINDS[out.dtype], int(transpose_b),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_cstack launch failed: cudaError {err}")
    LAUNCHES += 1


def dsd_cstack(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    q: int = 8,
    n_tile: int = 8192,
) -> torch.Tensor:
    """C[M, N] = A_sparse @ op(B_dense), q same-k blocks per strip staging
    (JAX's ``dsd_cstack``). ``transpose_a`` is not supported, as in JAX (the
    registry's predicate refuses it)."""
    if transpose_a:
        raise ValueError("dsd_cstack supports transpose_a=False only")
    if int(q) < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    out_dtype = out_dtype or a.dtype
    m_dim, k_dim = a.rows, a.cols
    bk, n_dim = (b.shape[-1], b.shape[-2]) if transpose_b else (b.shape[-2], b.shape[-1])
    if bk != k_dim:
        raise ValueError(f"contraction mismatch: A gives k={k_dim}, B gives {bk}")
    if a.nnz_blocks == 0:
        return torch.zeros((m_dim, n_dim), dtype=out_dtype, device=a.device)
    plan = cstack_plan(a, int(q))
    if not cstack_fits(m_dim, 128):
        raise ValueError(
            f"dsd_cstack: whole-output fp32 accumulator for m={m_dim} exceeds the VMEM budget even at the minimum "
            f"128-lane tile ({m_dim * 128 * 4} > {ACC_BUDGET} bytes)"
        )
    nt = cstack_tile(m_dim, n_dim, n_tile)
    if nt < 128 or nt % 128:
        raise ValueError(f"dsd_cstack: n_tile {n_tile} gives a tile of {nt} columns, not a multiple of 128")
    if not a.data.is_cuda and not b.is_cuda:
        return cstack_reference(plan, a.data, b, m_blocks=m_dim // a.block_size, transpose_dense=transpose_b,
                                out_dtype=out_dtype)
    out = torch.empty((m_dim, n_dim), dtype=out_dtype, device=a.device)
    _launch(plan, a, b, out, transpose_b=transpose_b)
    return out
