"""BSR matmul front ends: the seven dense / sparse layout combinations
(``sputnik_tpu/ops/matmul.py``).

Shape checks (the reference's ``ValidMatmul``), then first-fit dispatch.
DSD, DDS and SDD:

1. ``xla_dense_detour`` — a near-dense sparse operand (block density
   >= ``DENSIFY_THRESHOLD``) is densified and multiplied with one fp32
   ``torch.matmul``, on any device, as the JAX package hands it to XLA's
   dense dot.
2. the Hopper kernel (``cuda_stream`` for DSD/DDS, ``cuda_output_stationary``
   for SDD) — the CUDA problems the JAX package's Pallas predicates accept
   (128-multiple blocks and dense dim, bf16 / fp32); the wrapper raises for
   the rest of what it cannot take (mixed dtypes, misaligned data).
3. ``jnp_fallback`` — the rest of the CUDA problems (a head dim of 64, an
   empty operand): the densify detour, the JAX package's own fallback.
4. ``torch_reference`` — the plain PyTorch version, for CPU tensors only.

SSD / SDS / DSS / SSS follow the JAX package's first-fit order, with its
"concrete metadata" read as "metadata known on the host"
(``BlockSparseMatrix.host_known``):

* SSD / SDS: ``cuda_flat`` (a ``schedule=`` was given, or host-known
  metadata and topology density < 0.25) -> ``dense_extract`` (topology
  density >= 1/16: the stream kernel on the dense product, then a block
  gather) -> ``cuda_output_stationary`` -> ``torch_reference``.
* DSS: ``cuda_flat`` (density product < 0.1 and host-known) -> ``densify``
  (the side with fewer blocks at density >= 1/16) -> ``cuda_worklist``
  (not host-known, and the work list's budget from the nnz hints below the
  masked kernel's steps) -> ``cuda_masked_stream`` -> ``torch_reference``.
* SSS: ``cuda_flat`` -> ``dss_extract`` (DSS, then a block gather) ->
  ``torch_reference``.

The thresholds (0.25, 1/16, 0.1) are the JAX package's, measured on a TPU:
kept so that both packages route alike, to be measured again on the H100.
``cuda_flat`` takes CPU problems too, and then computes its kernel's plain
version from the same plan. Plans, work lists and position maps are cached
per operand / topology pair, keyed on the metadata tensors through weak
references, so that a backward through the same topologies never plans
again and a forward with warm plans reads nothing from the card.

No CUDA problem a kernel takes reaches a plain version unless it is
named through ``variant=`` (or :func:`registry.forced_variant`).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_dss, bsr_flat, bsr_sdd, bsr_ssd, reference, via_dense
from sputnik_tpu_torch.kernels.bsr_flat import FlatSchedule, plan_dss, plan_sparse_out, plan_sss
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


def _kernel_ok(sparse: BlockSparseMatrix, dense_dim: int, *dtypes) -> bool:
    """The JAX package's ``_pallas_ok``: 128-multiple blocks and dense dim,
    bf16 / fp32 dtypes. The CUDA kernels take what it takes; the wrappers
    still raise for the rest of what they do not take (mixed dtypes,
    misaligned data)."""
    return sparse.block_size % 128 == 0 and dense_dim % 128 == 0 and all(d in _KERNEL_DTYPES for d in dtypes)


def _dsd_cuda_can(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    n_dim = b.shape[-2] if transpose_b else b.shape[-1]
    return (_on_cuda(a, b) and a.nnz_blocks > 0
            and _kernel_ok(a, n_dim, a.dtype, b.dtype, out_dtype or a.dtype))


def _dds_cuda_can(a, b, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    m_dim = a.shape[-1] if transpose_a else a.shape[-2]
    return (_on_cuda(a, b) and b.nnz_blocks > 0
            and _kernel_ok(b, m_dim, a.dtype, b.dtype, out_dtype or b.dtype))


def _sdd_cuda_can(a, b, t, transpose_a=False, transpose_b=False, out_dtype=None, **kw):
    k_dim = a.shape[-2] if transpose_a else a.shape[-1]
    return _on_cuda(a, b, t) and _kernel_ok(t, k_dim, a.dtype, b.dtype, out_dtype or t.dtype)


def _cuda_fallback_can(*args, **_) -> bool:
    return _on_cuda(*args)


# First fit on the card, as the JAX package's: the kernel for what its
# ``_dsd_can`` / ``_dds_can`` / ``_sdd_can`` accept, else ``jnp_fallback``,
# the densify detour (one fp32 torch.matmul, JAX's hand-off to XLA's dot).
registry.register("dsd", "xla_dense_detour", lambda a, b, **kw: _dense_can(a), reference.dsd)
registry.register("dsd", "cuda_stream", _dsd_cuda_can, bsr_dsd.dsd)
registry.register("dsd", "jnp_fallback", _cuda_fallback_can, reference.dsd)
registry.register("dsd", "torch_reference", _cpu_can, reference.dsd)

registry.register("dds", "xla_dense_detour", lambda a, b, **kw: _dense_can(b), reference.dds)
registry.register("dds", "cuda_stream", _dds_cuda_can, bsr_dsd.dds)
registry.register("dds", "jnp_fallback", _cuda_fallback_can, reference.dds)
registry.register("dds", "torch_reference", _cpu_can, reference.dds)

registry.register("sdd", "xla_dense_detour", lambda a, b, t, **kw: _dense_can(t), reference.sdd)
registry.register("sdd", "cuda_output_stationary", _sdd_cuda_can, bsr_sdd.sdd)
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
# Plans cached per operand / topology pair
# ---------------------------------------------------------------------------

_PLANS: Dict[tuple, Tuple[tuple, object]] = {}


def cached_plan(tensors: Sequence[torch.Tensor], key: tuple, build: Callable[[], object]):
    """``build()`` once per ``key`` and set of metadata ``tensors`` (by
    identity, through weak references: the entry goes when one of them
    does). Descriptors made by ``with_data`` / ``with_transpose_metadata``
    / ``astype`` share their metadata tensors, so they share the plan."""
    full = (key, tuple(id(t) for t in tensors))
    hit = _PLANS.get(full)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    value = build()
    refs = tuple(weakref.ref(t, lambda _, k=full: _PLANS.pop(k, None)) for t in tensors)
    _PLANS[full] = (refs, value)
    return value


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


def _flat_sparse_out_can(stream, topology, schedule=None):
    return schedule is not None or (topology.density < 0.25 and _host(stream, topology))


registry.register("ssd", "cuda_flat", lambda a, b, t, schedule=None, **kw: _flat_sparse_out_can(a, t, schedule),
                  _ssd_flat)
registry.register("ssd", "dense_extract",
                  lambda a, b, t, **kw: a.nnz_blocks > 0 and t.density >= via_dense.DENSITY_THRESHOLD,
                  _options(via_dense.ssd))
registry.register("ssd", "cuda_output_stationary", lambda a, b, t, **kw: _on_cuda(a, b, t),
                  _options(bsr_ssd.ssd, "max_steps"))
registry.register("ssd", "torch_reference", _cpu_can, _options(reference.ssd))

registry.register("sds", "cuda_flat", lambda a, b, t, schedule=None, **kw: _flat_sparse_out_can(b, t, schedule),
                  _sds_flat)
registry.register("sds", "dense_extract",
                  lambda a, b, t, **kw: b.nnz_blocks > 0 and t.density >= via_dense.DENSITY_THRESHOLD,
                  _options(via_dense.sds))
registry.register("sds", "cuda_output_stationary", lambda a, b, t, **kw: _on_cuda(a, b, t),
                  _options(bsr_ssd.sds, "max_steps"))
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


def _dss_flat_can(a, b, schedule=None, **kw):
    return schedule is not None or (a.density * b.density < 0.1 and _host(a, b))


def _dss_densify_can(a, b, **kw):
    fewer = a if a.nnz_blocks <= b.nnz_blocks else b
    return a.nnz_blocks > 0 and b.nnz_blocks > 0 and fewer.density >= via_dense.DENSITY_THRESHOLD


def _dss_worklist_can(a, b, transpose_a=False, transpose_b=False, work_budget=None, **kw):
    """The exact work list built on the card, for metadata not known on the
    host, when its static bound undercuts the masked kernel's steps."""
    if _host(a, b):
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


registry.register("dss", "cuda_flat", _dss_flat_can, _dss_flat)
registry.register("dss", "densify", _dss_densify_can, _options(via_dense.dss))
registry.register("dss", "cuda_worklist", _dss_worklist_can, _dss_worklist)
registry.register("dss", "cuda_masked_stream", lambda a, b, **kw: _on_cuda(a, b), _dss_masked)
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


def _sss_flat_can(a, b, topology, schedule=None, **kw):
    if not a.block_size == b.block_size == topology.block_size:
        return False
    return schedule is not None or (topology.density < 0.25 and _host(a, b, topology))


registry.register("sss", "cuda_flat", _sss_flat_can, _sss_flat)
registry.register("sss", "dss_extract", lambda a, b, t, **kw: True, _sss_via_dss)
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
