"""SDD (sparse = dense @ dense, masked to a topology) on the ``bsr_sdd``
and ``bsr_sdd_bres`` CUDA kernels (``csrc/bsr_sdd.cu``,
``csrc/bsr_sdd_bres.cu``).

Port of ``sputnik_tpu/kernels/bsr_sdd.py``:

* :func:`sdd` (``sdd`` and ``sdd_panel``): one CTA per nonzero output
  block, full-K loop, output written in the topology's packed data order.
  The dense operands may carry one leading batch axis (attention heads);
  the output data then has it too;
* :func:`sdd_bres` (the input-resident schedule, the registry's
  ``cuda_bres``): the plan :func:`plan_sdd_bres` (``bsr_small.pack_rows``,
  equal to the JAX package's ``native.pack_rows``, cached per topology)
  takes up to ``pack`` consecutive output blocks of one block-row per step,
  which share one strip of op(A); no batch axis, as in JAX.
  ``SDD_BRES_MAX_BYTES`` is JAX's VMEM budget for the two resident
  operands, kept so that both packages route alike (to be measured again
  on the H100).

On CPU tensors the wrappers compute the plain PyTorch version
(:func:`sdd_reference`, :func:`sdd_bres_reference` on the same plan); on
CUDA tensors they launch the kernel, or raise for a problem the kernel does
not take.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build, reference
from sputnik_tpu_torch.kernels.bsr_small import pack_rows
from sputnik_tpu_torch.kernels.common import cached_plan, oriented

__all__ = ["sdd", "launch", "sdd_reference", "sdd_bres", "plan_sdd_bres", "sdd_bres_reference", "n_steps_bytes",
           "LAUNCHES", "BRES_LAUNCHES", "SDD_BRES_MAX_BYTES"]

# Kernel launches in this process; each launch of bsr_sdd adds one to
# LAUNCHES, of bsr_sdd_bres to BRES_LAUNCHES.
LAUNCHES = 0
BRES_LAUNCHES = 0

# The JAX package's VMEM budget for both resident operands (TPU v5e: 128 MB).
SDD_BRES_MAX_BYTES = 96 << 20

KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# The kernel's plain version: one fp32 dense matmul, then the topology's blocks.
sdd_reference = reference.sdd


@functools.cache
def _kernel():
    fn = _build.load("bsr_sdd").bsr_sdd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 5
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    return fn


def _batch(x: torch.Tensor):
    if x.ndim == 2:
        return 1, 0
    if x.ndim == 3:
        return x.shape[0], x.stride(0)
    raise ValueError(f"bsr_sdd: expected 2 or 3 dims, got shape {tuple(x.shape)}")


def launch(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    out: torch.Tensor,
    *,
    transpose_a: bool,
    transpose_b: bool,
) -> None:
    """Launch ``bsr_sdd``: the blocks of ``op(a) @ op(b)`` at ``topology``
    into ``out`` (``([batch,] nnz, 128, 128)``). Raises ``ValueError`` for
    anything the kernel does not take: CPU tensors, other dtypes, block sizes
    other than 128, K not a multiple of 128, non-contiguous or misaligned data.
    """
    global LAUNCHES
    for name, t in (("a", a), ("b", b), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"bsr_sdd needs CUDA tensors; {name} is on {t.device}")
        if t.device != a.device:
            raise ValueError("bsr_sdd: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bsr_sdd: {name} must be contiguous and 16-byte aligned")
    if a.dtype not in KERNEL_DTYPES or b.dtype != a.dtype:
        raise ValueError(f"bsr_sdd takes bf16 or fp32 operands of one dtype, got {a.dtype} and {b.dtype}")
    if out.dtype not in KERNEL_DTYPES:
        raise ValueError(f"bsr_sdd: output dtype {out.dtype} not supported")
    bs = topology.block_size
    if bs != 128:
        raise ValueError(f"bsr_sdd: block size must be 128, got {bs}")
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    k_dim = a.shape[-2] if transpose_a else a.shape[-1]
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    kb = b.shape[-1] if transpose_b else b.shape[-2]
    if kb != k_dim:
        raise ValueError(f"bsr_sdd: contraction mismatch, A gives k={k_dim}, B gives {kb}")
    if (m_dim, n_dim) != topology.shape:
        raise ValueError(f"bsr_sdd: output shape {(m_dim, n_dim)} != topology {topology.shape}")
    if k_dim % 128:
        raise ValueError(f"bsr_sdd: K={k_dim} must be a multiple of 128")
    a_batch, a_bstride = _batch(a)
    b_batch, b_bstride = _batch(b)
    batch = max(a_batch, b_batch)
    if {a_batch, b_batch} - {1, batch}:
        raise ValueError(f"bsr_sdd: batch axes disagree ({a_batch} and {b_batch})")
    out_shape = ((batch,) if a.ndim == 3 or b.ndim == 3 else ()) + (topology.nnz_blocks, bs, bs)
    if tuple(out.shape) != out_shape:
        raise ValueError(f"bsr_sdd: out is {tuple(out.shape)}, expected {out_shape}")
    if batch > 65535:
        raise ValueError("bsr_sdd: more than 65535 batch entries")
    rows, cols = topology.row_indices, topology.indices
    for name, t in (("row_indices", rows), ("indices", cols)):
        if t.dtype != torch.int32 or t.device != a.device or not t.is_contiguous():
            raise ValueError(f"bsr_sdd: {name} must be contiguous int32 on {a.device}")
    err = _kernel()(
        a.data_ptr(), b.data_ptr(), rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
        topology.nnz_blocks, k_dim, batch,
        a.stride(-2), b.stride(-2),
        a_bstride if a_batch > 1 else 0, b_bstride if b_batch > 1 else 0,
        out.stride(0) if out.ndim == 4 else 0,
        int(a.dtype == torch.float32), int(out.dtype == torch.float32),
        int(transpose_a), int(transpose_b),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_sdd launch failed: cudaError {err}")
    LAUNCHES += 1


def sdd(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
) -> BlockSparseMatrix:
    """C_sparse = op(A) @ op(B) masked to ``topology``; a new matrix sharing
    ``topology``'s metadata with freshly computed blocks."""
    out_dtype = out_dtype or topology.dtype
    if not a.is_cuda and not b.is_cuda:
        return sdd_reference(a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype)
    batch = max(tuple(a.shape[:-2]), tuple(b.shape[:-2]), key=len)
    bs = topology.block_size
    out = torch.empty(batch + (topology.nnz_blocks, bs, bs), dtype=out_dtype, device=a.device)
    launch(a, b, topology, out, transpose_a=transpose_a, transpose_b=transpose_b)
    return topology.with_data(out)


# ------------------------------------------------------ the resident plan --
def plan_sdd_bres(topology: BlockSparseMatrix, pack: int = 4):
    """``(rows, cols, src, n_steps)``: a step is up to ``pack`` consecutive
    nonzero output blocks of one block-row; ``src[i]`` is output block i's
    step-major slot (JAX's ``plan_sdd_bres``, int32 numpy). Needs
    host-known metadata."""
    offs, indices, _ = topology.host_metadata()
    rows, cols, src, n_steps = pack_rows(offs, indices, pack)
    i32 = lambda x: np.ascontiguousarray(x, np.int32)  # noqa: E731
    return i32(rows), i32(cols), i32(src), n_steps


def n_steps_bytes(bs: int, pack: int) -> int:
    """Per-step output-tile bytes (double-buffered f32 upper bound), as JAX's."""
    return bs * pack * bs * 4


def _slot_blocks(schedule, nnz: int) -> np.ndarray:
    """The inverse of the plan's ``src``: the output block of each slot,
    -1 for a padding slot."""
    rows, cols, src, n_steps = schedule
    dst = np.full(len(np.asarray(cols)), -1, np.int32)
    dst[np.asarray(src)] = np.arange(nnz, dtype=np.int32)
    return dst


def sdd_bres_reference(schedule, a: torch.Tensor, b: torch.Tensor, *, transpose_a: bool, transpose_b: bool,
                       out_dtype, nnz: int, bs: int = 128) -> torch.Tensor:
    """``bsr_sdd_bres``'s plain version on the same plan: output block i is
    op(A)'s strip of its step's row times op(B)'s strip of its slot's
    column over the full K, fp32, then the cast; ``(nnz, bs, bs)``."""
    rows, cols, src = (torch.as_tensor(np.asarray(x)).long() for x in schedule[:3])
    pack = cols.shape[0] // max(schedule[3], 1)
    blk_rows = rows[src // pack].to(a.device)
    blk_cols = cols[src].to(a.device)
    a3 = oriented(a, transpose_a)  # (M, K)
    b3 = oriented(b, not transpose_b)  # (N, K)
    k_dim = a3.shape[1]
    a3 = a3.reshape(a3.shape[0] // bs, bs, k_dim)
    b3 = b3.reshape(b3.shape[0] // bs, bs, k_dim)
    out = torch.empty((nnz, bs, bs), dtype=out_dtype, device=a.device)
    step = max(1, (1 << 24) // (bs * k_dim))
    for s0 in range(0, nnz, step):
        s1 = min(s0 + step, nnz)
        prod = reference.product(a3[blk_rows[s0:s1]], b3[blk_cols[s0:s1]].transpose(1, 2))
        out[s0:s1] = prod.to(out_dtype)
    return out


@functools.cache
def _bres_kernel():
    fn = _build.load("bsr_sdd_bres").bsr_sdd_bres
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


def _device_schedule(schedule, nnz: int, device: torch.device):
    """(rows, cols, slot blocks) as int32 on ``device``, uploaded once per plan."""
    def build():
        arrays = (schedule[0], schedule[1], _slot_blocks(schedule, nnz))
        return tuple(torch.as_tensor(np.asarray(x)).to(device, torch.int32).contiguous() for x in arrays)

    return cached_plan((schedule[2],), ("sdd_bres_device", str(device)), build)


def sdd_bres(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    pack: int = 4,
    schedule=None,
) -> BlockSparseMatrix:
    """C_sparse = op(A) @ op(B) at ``topology`` on the input-resident plan
    (JAX's ``sdd_bres``): ``pack`` output blocks of one block-row per step
    share one strip of op(A). ``schedule`` is a :func:`plan_sdd_bres`
    result; without one, the plan of host-known metadata is made and
    cached. All four transpose modes are taken as stored."""
    global BRES_LAUNCHES
    out_dtype = out_dtype or topology.dtype
    bs = topology.block_size
    nnz = topology.nnz_blocks
    if nnz == 0:
        return topology
    m_dim, k_dim = (a.shape[-1], a.shape[-2]) if transpose_a else (a.shape[-2], a.shape[-1])
    n_dim, kb = (b.shape[-2], b.shape[-1]) if transpose_b else (b.shape[-1], b.shape[-2])
    if kb != k_dim:
        raise ValueError(f"contraction mismatch: A gives k={k_dim}, B gives {kb}")
    if (m_dim, n_dim) != topology.shape:
        raise ValueError(f"sdd_bres: output shape {(m_dim, n_dim)} != topology {topology.shape}")
    if schedule is None:
        schedule = cached_plan((topology.indices,), ("sdd_bres", pack), lambda: plan_sdd_bres(topology, pack))
    if not a.is_cuda and not b.is_cuda:
        return topology.with_data(sdd_bres_reference(schedule, a, b, transpose_a=transpose_a,
                                                     transpose_b=transpose_b, out_dtype=out_dtype, nnz=nnz, bs=bs))
    out = torch.empty((nnz, bs, bs), dtype=out_dtype, device=a.device)
    for name, t in (("a", a), ("b", b), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"bsr_sdd_bres needs CUDA tensors; {name} is on {t.device}")
        if t.device != out.device:
            raise ValueError("bsr_sdd_bres: operands are on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bsr_sdd_bres: {name} must be contiguous and 16-byte aligned")
    if a.dtype not in KERNEL_DTYPES or b.dtype != a.dtype or out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"bsr_sdd_bres takes bf16 or fp32 operands of one dtype and output, got {a.dtype}, "
                         f"{b.dtype} and {out_dtype}")
    if bs != 128:
        raise ValueError(f"bsr_sdd_bres: block size must be 128, got {bs}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("bsr_sdd_bres: operands with a batch axis are not supported")
    if k_dim % 128:
        raise ValueError(f"bsr_sdd_bres: K={k_dim} must be a multiple of 128")
    rows, cols, dst = _device_schedule(schedule, nnz, out.device)
    n_steps = schedule[3]
    if n_steps > 2 ** 31 - 1 or cols.shape[0] != n_steps * pack:
        raise ValueError(f"bsr_sdd_bres: the schedule is not a plan of pack {pack}")
    err = _bres_kernel()(
        a.data_ptr(), b.data_ptr(), rows.data_ptr(), cols.data_ptr(), dst.data_ptr(), out.data_ptr(), n_steps, pack,
        k_dim, a.stride(0), b.stride(0), int(a.dtype == torch.float32), int(out_dtype == torch.float32),
        int(transpose_a), int(transpose_b), torch.cuda.current_stream(out.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"bsr_sdd_bres launch failed: cudaError {err}")
    BRES_LAUNCHES += 1
    return topology.with_data(out)
