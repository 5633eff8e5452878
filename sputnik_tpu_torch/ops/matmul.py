"""BSR matmul front ends: the seven dense / sparse layout combinations
(``sputnik_tpu/ops/matmul.py``).

Shape checks (the reference's ``ValidMatmul``), then first-fit dispatch in
the JAX package's order, with its "concrete metadata" read as "metadata
known on the host" (``BlockSparseMatrix.host_known``) and each of its
Pallas predicates on the port's counterpart. DSD, DDS and SDD:

1. ``xla_dense_detour`` — a near-dense sparse operand (block density
   >= ``DENSIFY_THRESHOLD``) is densified and multiplied with one fp32
   ``torch.matmul``, on any device, as the JAX package hands it to XLA's
   dense dot.
2. the Hopper kernel (``cuda_stream`` for DSD/DDS, ``cuda_output_stationary``
   for SDD) — the CUDA problems the JAX package's Pallas predicates accept
   (128-multiple blocks and dense dim, bf16 / fp32); the wrapper raises for
   the rest of what it cannot take (mixed dtypes, misaligned data). DSD /
   DDS also register ``cuda_bres`` / ``cuda_bres_q4`` (q-batched steps,
   JAX's ``pallas_bres``), which first fit never reaches past the stream
   kernel, as in JAX.
3. ``cuda_smallblock`` — block sizes 16 / 32 / 64 with host-known metadata
   (JAX's ``_*_small_can``): the packed small-block kernels, whose plans are
   cached per topology.
4. ``jnp_fallback`` — the rest of the CUDA problems (a head dim of 64, an
   empty operand, small blocks built on the card): the densify detour, the
   JAX package's own fallback.
5. ``torch_reference`` — the plain PyTorch version, for CPU tensors only.

SSD / SDS / DSS / SSS:

* SSD / SDS: ``cuda_flat`` (128-multiple blocks equal to the topology's, and
  a ``schedule=`` or host-known metadata at topology density < 0.25) ->
  ``dense_extract`` (what the stream kernel takes, at topology density
  >= 1/16: the dense product, then a block gather) ->
  ``cuda_output_stationary`` (128-multiple blocks) -> ``cuda_smallblock``
  (the packed DSD / DDS, then a block gather) -> ``jnp_fallback`` ->
  ``torch_reference``.
* DSS: ``cuda_flat`` (density product < 0.1 and host-known) -> ``densify``
  (the side with fewer blocks at density >= 1/16) -> ``cuda_worklist``
  (not host-known, and the work list's budget from the nnz hints below the
  masked kernel's steps) -> ``cuda_masked_stream`` -> ``cuda_smallblock``
  -> ``jnp_fallback`` -> ``torch_reference``; all but the last two need
  JAX's ``_dss_can`` (128-multiple blocks of one size, both operands
  nonempty).
* SSS: ``cuda_flat`` -> ``dss_extract`` (DSS's first fit, then a block
  gather) -> ``jnp_fallback`` -> ``torch_reference``.

The thresholds (0.25, 1/16, 0.1, and ``bsr_qstream.BRES_MAX_DENSE_BYTES``)
are the JAX package's, measured on a TPU: kept so that both packages route
alike, to be measured again on the H100. ``cuda_flat`` and
``cuda_smallblock`` take CPU problems too, and then compute their kernel's
plain version from the same plan. Plans, work lists and position maps are
cached per operand / topology pair, keyed on the metadata tensors through
weak references, so that a backward through the same topologies never
plans again and a forward with warm plans reads nothing from the card.

No CUDA problem a kernel takes reaches a plain version unless it is
named through ``variant=`` (or :func:`registry.forced_variant`).
"""

from __future__ import annotations

import functools

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import (
    bsr_dsd, bsr_dss, bsr_flat, bsr_qstream, bsr_sdd, bsr_small, bsr_ssd, reference, via_dense,
)
from sputnik_tpu_torch.kernels.bsr_flat import FlatSchedule, plan_dss, plan_sparse_out, plan_sss
from sputnik_tpu_torch.kernels.common import _PLANS, cached_plan  # noqa: F401  (_PLANS: the cache)
from sputnik_tpu_torch.ops import registry

__all__ = [
    "matmul_dsd", "matmul_dds", "matmul_sdd", "matmul_ssd", "matmul_sds", "matmul_dss", "matmul_sss", "matmul",
    "FlatSchedule", "plan_ssd", "plan_sds", "plan_dss", "plan_sss", "DENSIFY_THRESHOLD",
]

# At and above this block density the sparse operand is effectively dense
# (sputnik_tpu/kernels/via_dense.py: DENSIFY_THRESHOLD).
DENSIFY_THRESHOLD = 0.8


def _on(device_type: str, *xs) -> bool:
    return all((x.data if isinstance(x, BlockSparseMatrix) else x).device.type == device_type for x in xs)


def _on_cuda(*xs) -> bool:
    return _on("cuda", *xs)


def _cpu_can(*args, **_) -> bool:
    return _on("cpu", *args)


def _dense_can(sparse: BlockSparseMatrix) -> bool:
    return sparse.density >= DENSIFY_THRESHOLD


_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _dtypes_ok(*dtypes) -> bool:
    return all(d in _KERNEL_DTYPES for d in dtypes)


def _kernel_ok(sparse: BlockSparseMatrix, dense_dim: int, *dtypes) -> bool:
    """The JAX package's ``_pallas_ok``: 128-multiple blocks and dense dim,
    bf16 / fp32 dtypes. The CUDA kernels take what it takes; the wrappers
    still raise for the rest of what they do not take (mixed dtypes,
    misaligned data)."""
    return sparse.block_size % 128 == 0 and dense_dim % 128 == 0 and _dtypes_ok(*dtypes)


def _dsd_ok(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    """JAX's ``_dsd_can``."""
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    return a.nnz_blocks > 0 and _kernel_ok(a, n_dim, a.dtype, b.dtype, out_dtype or a.dtype)


def _dds_ok(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    """JAX's ``_dds_can``."""
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    return b.nnz_blocks > 0 and _kernel_ok(b, m_dim, a.dtype, b.dtype, out_dtype or b.dtype)


def _dsd_cuda_can(a, b, **kw):
    return _on_cuda(a, b) and _dsd_ok(a, b, **kw)


def _dds_cuda_can(a, b, **kw):
    return _on_cuda(a, b) and _dds_ok(a, b, **kw)


def _sdd_cuda_can(a, b, t, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    k_dim = a.shape[-2] if transpose_a else a.shape[-1]
    return _on_cuda(a, b, t) and _kernel_ok(t, k_dim, a.dtype, b.dtype, out_dtype or t.dtype)


def _cuda_fallback_can(*args, **_) -> bool:
    return _on_cuda(*args)


def _unbatched(*xs) -> bool:
    return all(len(x.shape) == 2 and (not isinstance(x, BlockSparseMatrix) or not x.batch_shape) for x in xs)


def _dsd_bres_can(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    """JAX's ``_dsd_bres_can``: K-major B whose bytes fit the TPU kernel's
    resident budget."""
    if transpose_b or not _unbatched(a, b) or not _dsd_cuda_can(a, b, transpose_a=transpose_a,
                                                                   out_dtype=out_dtype):
        return False
    return b.numel() * b.element_size() + 6 * a.block_size * b.shape[1] <= bsr_qstream.BRES_MAX_DENSE_BYTES


def _dds_bres_can(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    """JAX's ``_dds_bres_can``: K-major A (``transpose_a``)."""
    if not transpose_a or not _unbatched(a, b) or not _dds_cuda_can(a, b, transpose_a=True, transpose_b=transpose_b,
                                                                       out_dtype=out_dtype):
        return False
    return a.numel() * a.element_size() + 6 * b.block_size * a.shape[1] <= bsr_qstream.BRES_MAX_DENSE_BYTES


def _small_ok(sparse, dense_dim, k_dim, *dtypes) -> bool:
    """JAX's small-block predicates: 16 / 32 / 64-blocks, host-known
    metadata, bf16 / fp32; ``dense_dim`` a multiple of 128, ``k_dim`` of
    the block size. No batch axis (the JAX package has none here)."""
    return (sparse.block_size in bsr_small.SMALL_BLOCK_SIZES and sparse.nnz_blocks > 0 and sparse.host_known
            and dense_dim % 128 == 0 and k_dim % sparse.block_size == 0 and _dtypes_ok(*dtypes))


def _dsd_small_can(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    k_dim = b.shape[-1] if transpose_b else b.shape[-2]
    return _unbatched(a, b) and _small_ok(a, n_dim, k_dim, a.dtype, b.dtype, out_dtype or a.dtype)


def _dds_small_can(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    k_dim = a.shape[-2] if transpose_a else a.shape[-1]
    return _unbatched(a, b) and _small_ok(b, m_dim, k_dim, a.dtype, b.dtype, out_dtype or b.dtype)


def _sdd_small_can(a, b, t, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    """JAX's ``_sdd_small_can``, and K a multiple of 16 (the kernel stages
    16-byte vectors along K)."""
    k_dim = a.shape[-2] if transpose_a else a.shape[-1]
    return _unbatched(a, b, t) and _small_ok(t, 128, t.block_size, a.dtype, b.dtype, out_dtype or t.dtype) \
        and k_dim % 16 == 0


def _small_plan(m: BlockSparseMatrix, transposed: bool) -> bsr_small.SmallPlan:
    return cached_plan((m.indices,), ("small", transposed),
                       lambda: bsr_small.plan_smallblock(m, transposed=transposed))


def _dsd_small(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None, **_):
    return bsr_small.dsd_smallblock(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                                    schedule=_small_plan(a, transpose_a))


def _dds_small(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None, **_):
    return bsr_small.dds_smallblock(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                                    schedule=_small_plan(b, not transpose_b))


def _sdd_small(a, b, t, *, transpose_a=False, transpose_b=False, out_dtype=None, **_):
    plan = cached_plan((t.indices,), ("sdd_small",), lambda: bsr_small.plan_sdd_smallblock(t))
    return bsr_small.sdd_smallblock(a, b, t, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                                    schedule=plan)


# First fit, as the JAX package's: the kernel for what its ``_dsd_can`` /
# ``_dds_can`` / ``_sdd_can`` accept, the small-block kernels for what its
# ``_*_small_can`` accept, else ``jnp_fallback``, the densify detour (one
# fp32 torch.matmul, JAX's hand-off to XLA's dot).
registry.register("dsd", "xla_dense_detour", lambda a, b, **kw: _dense_can(a), reference.dsd)
registry.register("dsd", "cuda_stream", _dsd_cuda_can, bsr_dsd.dsd)
registry.register("dsd", "cuda_bres", _dsd_bres_can, bsr_qstream.dsd_bres)
registry.register("dsd", "cuda_bres_q4", _dsd_bres_can, functools.partial(bsr_qstream.dsd_bres, q=4))
registry.register("dsd", "cuda_smallblock", _dsd_small_can, _dsd_small)
registry.register("dsd", "jnp_fallback", _cuda_fallback_can, reference.dsd)
registry.register("dsd", "torch_reference", _cpu_can, reference.dsd)

registry.register("dds", "xla_dense_detour", lambda a, b, **kw: _dense_can(b), reference.dds)
registry.register("dds", "cuda_stream", _dds_cuda_can, bsr_dsd.dds)
registry.register("dds", "cuda_bres", _dds_bres_can, bsr_qstream.dds_bres)
registry.register("dds", "cuda_bres_q4", _dds_bres_can, functools.partial(bsr_qstream.dds_bres, q=4))
registry.register("dds", "cuda_smallblock", _dds_small_can, _dds_small)
registry.register("dds", "jnp_fallback", _cuda_fallback_can, reference.dds)
registry.register("dds", "torch_reference", _cpu_can, reference.dds)

registry.register("sdd", "xla_dense_detour", lambda a, b, t, **kw: _dense_can(t), reference.sdd)
registry.register("sdd", "cuda_output_stationary", _sdd_cuda_can, bsr_sdd.sdd)
registry.register("sdd", "cuda_smallblock", _sdd_small_can, _sdd_small)
registry.register("sdd", "jnp_fallback", _cuda_fallback_can, reference.sdd)
registry.register("sdd", "torch_reference", _cpu_can, reference.sdd)


def matmul_dsd(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> torch.Tensor:
    """C[M, N] = op(A_sparse) @ op(B_dense)."""
    k_a = a.rows if transpose_a else a.cols
    k_b = b.shape[-1] if transpose_b else b.shape[-2]
    if k_a != k_b:
        raise ValueError(
            f"dsd contraction mismatch: op(A) gives k={k_a}, op(B) gives "
            f"k={k_b} (A {a.shape} ta={transpose_a}, B {tuple(b.shape)} tb={transpose_b})"
        )
    return registry.dispatch(
        "dsd", a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


def matmul_dds(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> torch.Tensor:
    """C[M, N] = op(A_dense) @ op(B_sparse)."""
    k_a = a.shape[-2] if transpose_a else a.shape[-1]
    k_b = b.cols if transpose_b else b.rows
    if k_a != k_b:
        raise ValueError(
            f"dds contraction mismatch: op(A) gives k={k_a}, op(B) gives "
            f"k={k_b} (A {tuple(a.shape)} ta={transpose_a}, B {b.shape} tb={transpose_b})"
        )
    return registry.dispatch(
        "dds", a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


def matmul_sdd(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> BlockSparseMatrix:
    """C_sparse = op(A) @ op(B) masked to ``topology`` (attention scores)."""
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    k_a = a.shape[-2] if transpose_a else a.shape[-1]
    k_b = b.shape[-1] if transpose_b else b.shape[-2]
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    if k_a != k_b:
        raise ValueError(f"sdd contraction mismatch: op(A) gives k={k_a}, op(B) gives k={k_b}")
    if (m_dim, n_dim) != topology.shape:
        raise ValueError(f"sdd output shape {(m_dim, n_dim)} != topology {topology.shape}")
    return registry.dispatch(
        "sdd", a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


# ---------------------------------------------------------------------------
# Plans cached per operand / topology pair (``kernels/common.py``)
# ---------------------------------------------------------------------------


def plan_ssd(a: BlockSparseMatrix, topology: BlockSparseMatrix, *, transpose_a: bool = False) -> FlatSchedule:
    """The exact SSD work list, planned on the host from host-known
    metadata; pass it to ``matmul_ssd(..., schedule=)``."""
    return plan_sparse_out(a, topology, kind="ssd", stream_transposed=transpose_a)


def plan_sds(b: BlockSparseMatrix, topology: BlockSparseMatrix, *, transpose_b: bool = False) -> FlatSchedule:
    """The exact SDS work list (see :func:`plan_ssd`)."""
    return plan_sparse_out(b, topology, kind="sds", stream_transposed=not transpose_b)


def _host(*ms: BlockSparseMatrix) -> bool:
    return all(m.host_known for m in ms)


# ---------------------------------------------------------------------------
# SSD / SDS: sparse = sparse @ dense / dense @ sparse
# ---------------------------------------------------------------------------


def _ssd_flat(a, b, topology, *, transpose_a=False, transpose_b=False, out_dtype=None, schedule=None,
              kcat=False, **_):
    if schedule is None:
        schedule = cached_plan((a.indices, topology.indices), ("ssd", transpose_a),
                               lambda: plan_ssd(a, topology, transpose_a=transpose_a))
    return bsr_flat.ssd_flat(a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b,
                             out_dtype=out_dtype, schedule=schedule, kcat=kcat)


def _sds_flat(a, b, topology, *, transpose_a=False, transpose_b=False, out_dtype=None, schedule=None,
              kcat=False, **_):
    if schedule is None:
        schedule = cached_plan((b.indices, topology.indices), ("sds", transpose_b),
                               lambda: plan_sds(b, topology, transpose_b=transpose_b))
    return bsr_flat.sds_flat(a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b,
                             out_dtype=out_dtype, schedule=schedule, kcat=kcat)


def _options(fn, *names):
    """``fn`` taking only the options ``names`` (and the transposes and
    out_dtype); other options meant for other variants are dropped, as the
    JAX package's kernels drop them with ``**_``."""
    keep = {"transpose_a", "transpose_b", "out_dtype", *names}
    return lambda *args, **kw: fn(*args, **{k: v for k, v in kw.items() if k in keep})


def _ssd_can(a, b, t, out_dtype=None, **kw):
    """JAX's ``_ssd_can``: 128-multiple blocks, A's equal to the topology's."""
    return (a.block_size % 128 == 0 and a.block_size == t.block_size
            and _dtypes_ok(a.dtype, b.dtype, out_dtype or t.dtype))


def _sds_can(a, b, t, out_dtype=None, **kw):
    """JAX's ``_sds_can``."""
    return (b.block_size % 128 == 0 and b.block_size == t.block_size
            and _dtypes_ok(a.dtype, b.dtype, out_dtype or t.dtype))


def _ssd_flat_can(a, b, t, schedule=None, **kw):
    return _ssd_can(a, b, t, **kw) and (schedule is not None or (t.density < 0.25 and _host(a, t)))


def _sds_flat_can(a, b, t, schedule=None, **kw):
    return _sds_can(a, b, t, **kw) and (schedule is not None or (t.density < 0.25 and _host(b, t)))


def _ssd_small_can(a, b, t, schedule=None, out_dtype=None, **kw):
    """JAX's ``_ssd_small_can``: a ``schedule`` is the flat path's plan, so
    it is refused here."""
    return (schedule is None and t.block_size == a.block_size and _unbatched(t)
            and _dsd_small_can(a, b, out_dtype=out_dtype or t.dtype, **kw))


def _sds_small_can(a, b, t, schedule=None, out_dtype=None, **kw):
    return (schedule is None and t.block_size == b.block_size and _unbatched(t)
            and _dds_small_can(a, b, out_dtype=out_dtype or t.dtype, **kw))


def _ssd_small(a, b, t, *, transpose_a=False, transpose_b=False, out_dtype=None, **_):
    return via_dense.ssd_smallblock(a, b, t, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                                    schedule=_small_plan(a, transpose_a))


def _sds_small(a, b, t, *, transpose_a=False, transpose_b=False, out_dtype=None, **_):
    return via_dense.sds_smallblock(a, b, t, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                                    schedule=_small_plan(b, not transpose_b))


registry.register("ssd", "cuda_flat", _ssd_flat_can, _ssd_flat)
registry.register("ssd", "dense_extract",
                  lambda a, b, t, **kw: _dsd_ok(a, b, **kw) and t.density >= via_dense.DENSITY_THRESHOLD,
                  _options(via_dense.ssd))
registry.register("ssd", "cuda_output_stationary", lambda a, b, t, **kw: _on_cuda(a, b, t) and _ssd_can(a, b, t, **kw),
                  _options(bsr_ssd.ssd, "max_steps"))
registry.register("ssd", "cuda_smallblock", _ssd_small_can, _ssd_small)
registry.register("ssd", "jnp_fallback", _cuda_fallback_can, _options(reference.ssd))
registry.register("ssd", "torch_reference", _cpu_can, _options(reference.ssd))

registry.register("sds", "cuda_flat", _sds_flat_can, _sds_flat)
registry.register("sds", "dense_extract",
                  lambda a, b, t, **kw: _dds_ok(a, b, **kw) and t.density >= via_dense.DENSITY_THRESHOLD,
                  _options(via_dense.sds))
registry.register("sds", "cuda_output_stationary", lambda a, b, t, **kw: _on_cuda(a, b, t) and _sds_can(a, b, t, **kw),
                  _options(bsr_ssd.sds, "max_steps"))
registry.register("sds", "cuda_smallblock", _sds_small_can, _sds_small)
registry.register("sds", "jnp_fallback", _cuda_fallback_can, _options(reference.sds))
registry.register("sds", "torch_reference", _cpu_can, _options(reference.sds))


def matmul_ssd(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> BlockSparseMatrix:
    """C_sparse = op(A_sparse) @ op(B_dense) masked to ``topology``."""
    bsr_flat.sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    return registry.dispatch(
        "ssd", a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


def matmul_sds(
    a: torch.Tensor,
    b: BlockSparseMatrix,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> BlockSparseMatrix:
    """C_sparse = op(A_dense) @ op(B_sparse) masked to ``topology``."""
    bsr_flat.sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    return registry.dispatch(
        "sds", a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


# ---------------------------------------------------------------------------
# DSS: dense = sparse @ sparse
# ---------------------------------------------------------------------------


def _dss_flat(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None, schedule=None, kcat=False, **_):
    if schedule is None:
        schedule = cached_plan((a.indices, b.indices), ("dss", transpose_a, transpose_b),
                               lambda: plan_dss(a, b, transpose_a=transpose_a, transpose_b=transpose_b))
    return bsr_flat.dss_flat(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                             schedule=schedule, kcat=kcat)


def _dss_worklist(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None, work_budget=None,
                  worklist=None, **_):
    if worklist is None and a.nnz_blocks and b.nnz_blocks:
        worklist = cached_plan(
            (a.indices, b.indices), ("dss_worklist", transpose_a, transpose_b, work_budget),
            lambda: bsr_dss.build_dss_worklist(a, b, transpose_a=transpose_a, transpose_b=transpose_b,
                                               work_budget=work_budget))
    return bsr_dss.dss_worklist(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                                worklist=worklist)


def _dss_masked(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None, max_steps=None, **_):
    pos = cached_plan((b.indices,), ("position_map",), b.position_map)
    return bsr_dss.dss(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                       max_steps=max_steps, pos_map=pos)


def _dss_can(a, b, out_dtype=None, **kw):
    """JAX's ``_dss_can``: 128-multiple blocks of one size, both operands
    nonempty."""
    return (a.block_size % 128 == 0 and a.block_size == b.block_size and a.nnz_blocks > 0 and b.nnz_blocks > 0
            and _dtypes_ok(a.dtype, b.dtype, out_dtype or a.dtype))


def _dss_flat_can(a, b, schedule=None, **kw):
    return _dss_can(a, b, **kw) and (schedule is not None or (a.density * b.density < 0.1 and _host(a, b)))


def _dss_densify_can(a, b, **kw):
    fewer = a if a.nnz_blocks <= b.nnz_blocks else b
    return _dss_can(a, b, **kw) and fewer.density >= via_dense.DENSITY_THRESHOLD


def _dss_worklist_can(a, b, transpose_a=False, transpose_b=False, work_budget=None, **kw):
    """The exact work list built on the card, for metadata not known on the
    host, when its static bound undercuts the masked kernel's steps."""
    if _host(a, b) or not _dss_can(a, b, **kw):
        return False
    budget = work_budget if work_budget is not None else bsr_dss.worklist_budget(
        a, b, transpose_a=transpose_a, transpose_b=transpose_b)
    if budget is None:
        return False
    bs = a.block_size
    m_blocks = (a.cols if transpose_a else a.rows) // bs
    n_blocks = (b.rows if transpose_b else b.cols) // bs
    k_blocks = (a.rows if transpose_a else a.cols) // bs
    row_hint = a.max_col_nnz if transpose_a else a.max_row_nnz
    return budget < m_blocks * n_blocks * (row_hint or k_blocks)


def _dss_small_can(a, b, schedule=None, out_dtype=None, **kw):
    """JAX's ``_dss_small_can``: the side with fewer blocks densified, the
    other through the packed kernel's predicate (a matrix's ``shape`` reads
    as the dense operand's)."""
    if schedule is not None or a.block_size != b.block_size or a.block_size not in bsr_small.SMALL_BLOCK_SIZES:
        return False
    if a.nnz_blocks <= b.nnz_blocks:  # densify a; b rides the packed DDS
        return _dds_small_can(a, b, out_dtype=out_dtype or a.dtype, **kw)
    return _dsd_small_can(a, b, out_dtype=out_dtype or a.dtype, **kw)


def _dss_small(a, b, *, transpose_a=False, transpose_b=False, out_dtype=None, **_):
    plan = _small_plan(b, not transpose_b) if a.nnz_blocks <= b.nnz_blocks else _small_plan(a, transpose_a)
    return via_dense.dss_smallblock(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype,
                                    schedule=plan)


registry.register("dss", "cuda_flat", _dss_flat_can, _dss_flat)
registry.register("dss", "densify", _dss_densify_can, _options(via_dense.dss))
registry.register("dss", "cuda_worklist", _dss_worklist_can, _dss_worklist)
registry.register("dss", "cuda_masked_stream", lambda a, b, **kw: _on_cuda(a, b) and _dss_can(a, b, **kw),
                  _dss_masked)
registry.register("dss", "cuda_smallblock", _dss_small_can, _dss_small)
registry.register("dss", "jnp_fallback", _cuda_fallback_can, _options(reference.dss))
registry.register("dss", "torch_reference", _cpu_can, _options(reference.dss))


def matmul_dss(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> torch.Tensor:
    """C[M, N] = op(A_sparse) @ op(B_sparse)."""
    bsr_flat.product_shape(a, b, transpose_a, transpose_b)
    return registry.dispatch(
        "dss", a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


# ---------------------------------------------------------------------------
# SSS: sparse = sparse @ sparse, masked to a topology
# ---------------------------------------------------------------------------


def _sss_flat(a, b, topology, *, transpose_a=False, transpose_b=False, out_dtype=None, schedule=None,
              kcat=False, **_):
    if schedule is None:
        schedule = cached_plan(
            (a.indices, b.indices, topology.indices), ("sss", transpose_a, transpose_b),
            lambda: plan_sss(a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b))
    return bsr_flat.sss_flat(a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b,
                             out_dtype=out_dtype, schedule=schedule, kcat=kcat)


def _sss_via_dss(a, b, topology, *, transpose_a=False, transpose_b=False, out_dtype=None, **options):
    out_dtype = out_dtype or topology.dtype
    full = matmul_dss(a, b, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options)
    return topology.with_data(reference.extract_blocks(full, topology))


def _sss_flat_can(a, b, topology, schedule=None, out_dtype=None, **kw):
    """JAX's ``_sss_flat_can``: 128-multiple blocks of one size."""
    if not (a.block_size == b.block_size == topology.block_size and a.block_size % 128 == 0
            and _dtypes_ok(a.dtype, b.dtype, out_dtype or topology.dtype)):
        return False
    return schedule is not None or (topology.density < 0.25 and _host(a, b, topology))


registry.register("sss", "cuda_flat", _sss_flat_can, _sss_flat)
# JAX's _sss_can is a shape check, which matmul_sss has made.
registry.register("sss", "dss_extract", lambda a, b, t, **kw: True, _sss_via_dss)
registry.register("sss", "jnp_fallback", _cuda_fallback_can, _options(reference.sss))
registry.register("sss", "torch_reference", _cpu_can, _options(reference.sss))


def matmul_sss(
    a: BlockSparseMatrix,
    b: BlockSparseMatrix,
    topology: BlockSparseMatrix,
    *,
    transpose_a: bool = False,
    transpose_b: bool = False,
    out_dtype=None,
    **options,
) -> BlockSparseMatrix:
    """C_sparse = op(A_sparse) @ op(B_sparse) masked to ``topology`` (no
    reference analogue; it completes the operand / output sparsity cube)."""
    bsr_flat.sparse_out_shapes(a, b, topology, transpose_a, transpose_b)
    return registry.dispatch(
        "sss", a, b, topology, transpose_a=transpose_a, transpose_b=transpose_b, out_dtype=out_dtype, **options
    )


# ---------------------------------------------------------------------------
# Generic entry point
# ---------------------------------------------------------------------------


def matmul(a, b, *, topology: BlockSparseMatrix = None, **kw):
    """Type-dispatching matmul: the op follows from which operands are
    sparse and whether an output ``topology`` is given."""
    a_sp, b_sp = isinstance(a, BlockSparseMatrix), isinstance(b, BlockSparseMatrix)
    if topology is None:
        if a_sp and b_sp:
            return matmul_dss(a, b, **kw)
        if a_sp:
            return matmul_dsd(a, b, **kw)
        if b_sp:
            return matmul_dds(a, b, **kw)
        lhs = a.transpose(-1, -2) if kw.get("transpose_a") else a
        rhs = b.transpose(-1, -2) if kw.get("transpose_b") else b
        return torch.matmul(lhs.float(), rhs.float()).to(kw.get("out_dtype") or a.dtype)
    if a_sp and b_sp:
        return matmul_sss(a, b, topology, **kw)
    if a_sp:
        return matmul_ssd(a, b, topology, **kw)
    if b_sp:
        return matmul_sds(a, b, topology, **kw)
    return matmul_sdd(a, b, topology, **kw)
