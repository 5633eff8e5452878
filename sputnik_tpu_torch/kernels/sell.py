"""The sliced-ELL (SELL) CSR engine on the ``sell`` CUDA kernels
(``csrc/sell.cu``): SpMM, the transposed SpMM, SDDMM and the row softmax.

Port of ``sputnik_tpu/kernels/sell.py``, with its signatures and checks.
Each function has one Hopper kernel (``sell_spmm``, ``sell_spmm_t``,
``sell_sddmm``, ``sell_softmax``) and a plain PyTorch version beside it
(``*_reference``: gathers by the valid slots and fp32 sums, the masked
softmax chain). The kernels read only valid slots, gather dense rows along
N, and fold the row permutation of a row-sorted matrix into their row
addressing, where the JAX package gathers rows before and after its
kernels; the results are the same.

The transposed SpMM gathers over the SELL layout of A^T
(``formats.SellTranspose``, ``SellMatrix.transpose_plan``): each output row
(a column of A) sums its slots in a fixed order and is written once, no
scatter. ``SellMatrix.from_csr`` builds the plan on the host with the
matrix, and value updates keep it, so the fine-tune's steps read nothing
back; a matrix built without one (a shard's local matrix) gets it at its
first transposed SpMM, with one read of its indices to the host, and keeps
it (``SellMatrix.transpose_layout``).

JAX's ``variant``, ``row_tile`` and ``n_tile`` choose among TPU schedules of
one function and are gated by the TPU's VMEM (``_fused_fits``,
``_sddmm_use_fused``). They are accepted and validated here and then run
the one kernel: the VMEM gates are TPU limits and are not carried over.

Each function dispatches through the registry (``sell_spmm``,
``sell_spmm_t``, ``sell_sddmm``, ``sell_softmax``): ``cuda_sell`` on CUDA
tensors, which launches the kernel or raises ``ValueError`` for a problem
it does not take, and ``torch_reference`` on CPU tensors or under
``registry.forced_variant("torch_reference")``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from sputnik_tpu_torch.formats import SellMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.ops import registry

__all__ = [
    "spmm", "spmm_t", "sddmm", "sparse_softmax", "spmm_reference", "spmm_t_reference",
    "sddmm_reference", "sparse_softmax_reference", "LAUNCHES",
]

# Kernel launches in this process, by kernel; each launch adds one.
LAUNCHES = {"sell_spmm": 0, "sell_spmm_t": 0, "sell_sddmm": 0, "sell_softmax": 0}

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_TR = 128  # SellMatrix pads rows to a multiple of this
_NEG = -1e30


@functools.cache
def _lib():
    lib = _build.load("sell")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "sell_spmm": [ptr] * 6 + [i32] * 11 + [ptr],
        "sell_spmm_t": [ptr] * 7 + [i32] * 11 + [ptr],
        "sell_sddmm": [ptr] * 6 + [i32] * 10 + [ptr],
        "sell_softmax": [ptr] * 4 + [i32] * 4 + [ctypes.c_float, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


# ------------------------------------------------------------ row orders --
def _permute_rows_in(x: torch.Tensor, a: SellMatrix) -> torch.Tensor:
    """Logical row order -> storage order (sorted matrices), padding rows."""
    if x.shape[0] < a.rows_padded:
        x = torch.cat([x, x.new_zeros((a.rows_padded - x.shape[0],) + tuple(x.shape[1:]))])
    if a.row_perm is None:
        return x
    return x.index_select(0, a.row_perm.long())


def _unpermute_rows(out: torch.Tensor, a: SellMatrix) -> torch.Tensor:
    """Storage row order -> logical (inverse of the construction sort)."""
    if a.row_perm is None:
        return out
    return out.index_select(0, torch.argsort(a.row_perm.long()))


# ------------------------------------------------------- plain versions --
def _slot_columns(a: SellMatrix):
    """(valid, columns): which slots hold a nonzero (sentinel test, as the
    JAX kernels' compare-select), and each slot's global column (0 at
    padding), both (n_chunks, width, rows_padded)."""
    valid = a.indices < a.chunk
    base = torch.arange(a.n_chunks, device=a.indices.device)[:, None, None] * a.chunk
    return valid, torch.where(valid, a.indices.long() + base, 0)


def spmm_reference(a: SellMatrix, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Plain version of ``sell_spmm``: per slot, gather the B rows of the
    valid slots and sum the fp32 products over the chunks and slots."""
    out_dtype = out_dtype or a.dtype
    valid, cols = _slot_columns(a)
    vals = torch.where(valid, a.values.float(), 0.0)
    bf = b.float()
    acc = torch.zeros((a.rows_padded, b.shape[1]), dtype=torch.float32, device=b.device)
    for w in range(a.width):
        acc += (vals[:, w, :, None] * bf[cols[:, w, :]]).sum(dim=0)
    return _unpermute_rows(acc, a)[: a.rows].to(out_dtype)


def spmm_t_reference(a: SellMatrix, x: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Plain version of ``sell_spmm_t``: each chunk's (chunk x rows) panel of
    A^T, one compare-select per slot (the JAX kernel's own formulation, with
    no scatter), times X in storage row order, in fp32."""
    out_dtype = out_dtype or a.dtype
    xs = _permute_rows_in(x.float(), a)
    lanes = torch.arange(a.chunk, device=a.indices.device)[None, :, None]
    panel = torch.zeros((a.n_chunks, a.chunk, a.rows_padded), dtype=torch.float32, device=x.device)
    vals = a.values.float()
    for w in range(a.width):
        panel += torch.where(a.indices[:, w, None, :] == lanes, vals[:, w, None, :], 0.0)
    out = torch.matmul(panel, xs).reshape(a.n_chunks * a.chunk, x.shape[1])
    return out[: a.cols].to(out_dtype)


def sddmm_reference(a: torch.Tensor, b: torch.Tensor, topology: SellMatrix, *, out_dtype=None) -> SellMatrix:
    """Plain version of ``sell_sddmm``: per slot, the fp32 dot product of the
    slot's A row with its gathered B row; 0 at padding slots."""
    out_dtype = out_dtype or topology.dtype
    valid, cols = _slot_columns(topology)
    af = _permute_rows_in(a.float(), topology)
    bf = b.float()
    out = torch.zeros(tuple(topology.values.shape), dtype=torch.float32, device=a.device)
    for w in range(topology.width):
        out[:, w, :] = (bf[cols[:, w, :]] * af[None]).sum(dim=-1)
    out = torch.where(valid, out, 0.0)
    return topology.with_values(out.to(out_dtype))


def _softmax_valid(m: SellMatrix) -> torch.Tensor:
    """The kernel's validity: a prefix of each (chunk, row)'s slots from
    ``slot_counts``, else the slots that do not hold the sentinel."""
    if m.slot_counts is not None:
        slot = torch.arange(m.width, device=m.slot_counts.device)[None, :, None]
        return slot < m.slot_counts[:, None, :]
    return m.indices != m.chunk


def sparse_softmax_reference(m: SellMatrix, *, scale: Optional[float] = None) -> SellMatrix:
    """Plain version of ``sell_softmax``: the masked fp32 chain of the JAX
    kernel (-1e30 mask, max clamped at -3e38, sum at 1e-30)."""
    nc, w, rp = m.values.shape
    v = m.values.float()
    if scale is not None:
        v = v * scale
    v2 = torch.where(_softmax_valid(m), v, _NEG).reshape(nc * w, rp)
    mx = v2.amax(dim=0, keepdim=True).clamp(min=-3e38)
    e = torch.where(v2 > 0.5 * _NEG, torch.exp(v2 - mx), 0.0)
    s = e.sum(dim=0, keepdim=True).clamp(min=1e-30)
    return m.with_values((e / s).reshape(nc, w, rp).to(m.dtype))


# ------------------------------------------------------------ launches --
def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_topology(kernel: str, a: SellMatrix, device: torch.device) -> None:
    for name in ("indices", "slot_counts", "row_perm"):
        t = getattr(a, name)
        if t is not None and (t.dtype != torch.int32 or t.device != device or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be contiguous int32 on {device}")
    if a.rows_padded % _TR:
        raise ValueError(f"{kernel}: rows_padded {a.rows_padded} is not a multiple of {_TR}")


def _check_dense(kernel: str, device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {t.device}")
        if t.device != device:
            raise ValueError(f"{kernel}: operands are on different devices")
        if t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"{kernel} takes bf16 or fp32 tensors, {name} is {t.dtype}")


def _elements_per_lane(n: int, *tensors: torch.Tensor) -> int:
    """Elements each lane loads at once: the widest load of at most 16 bytes
    that divides ``n``, keeps a warp's 32 lanes within ``n`` where it can,
    and that every tensor's base is aligned to."""
    size = max(t.element_size() for t in tensors)
    ept = 16 // size
    while ept > 1 and (n % ept or 32 * ept > n or any(t.data_ptr() % (ept * t.element_size()) for t in tensors)):
        ept //= 2
    return ept


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


def _spmm_cuda(a: SellMatrix, b: torch.Tensor, *, out_dtype) -> torch.Tensor:
    device = a.values.device
    _check_dense("sell_spmm", device, values=a.values, b=b)
    _check_topology("sell_spmm", a, device)
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"sell_spmm: output dtype {out_dtype} not supported")
    values, b = a.values.contiguous(), b.contiguous()
    n = b.shape[1]
    out = torch.empty((a.rows, n), dtype=out_dtype, device=device)
    ept = _elements_per_lane(n, b, out)
    err = _lib().sell_spmm(
        values.data_ptr(), a.indices.data_ptr(), _ptr(a.slot_counts), _ptr(a.row_perm),
        b.data_ptr(), out.data_ptr(), a.n_chunks, a.width, a.rows_padded, a.chunk, a.rows, a.cols, n,
        int(a.dtype == torch.float32), int(b.dtype == torch.float32), int(out_dtype == torch.float32),
        ept, _stream(device),
    )
    _raise_on("sell_spmm", err)
    return out


def _spmm_t_cuda(a: SellMatrix, x: torch.Tensor, *, out_dtype) -> torch.Tensor:
    device = a.values.device
    _check_dense("sell_spmm_t", device, values=a.values, x=x)
    _check_topology("sell_spmm_t", a, device)
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"sell_spmm_t: output dtype {out_dtype} not supported")
    if a.values.numel() >= 2 ** 31:
        raise ValueError(f"sell_spmm_t: {a.values.numel()} slots do not fit the int32 position map")
    t = a.transpose_layout()
    for name in ("positions", "indices", "slot_counts", "row_perm"):
        m = getattr(t, name)
        if m is not None and (m.dtype != torch.int32 or m.device != device or not m.is_contiguous()):
            raise ValueError(f"sell_spmm_t: the transposed plan's {name} must be contiguous int32 on {device}")
    values, x = a.values.contiguous(), x.contiguous()
    n = x.shape[1]
    out = torch.empty((a.cols, n), dtype=out_dtype, device=device)
    ept = _elements_per_lane(n, x, out)
    err = _lib().sell_spmm_t(
        values.data_ptr(), t.positions.data_ptr(), t.indices.data_ptr(), t.slot_counts.data_ptr(),
        _ptr(t.row_perm), x.data_ptr(), out.data_ptr(), t.n_chunks, t.width, t.rows_padded, t.chunk, t.rows,
        t.cols, n, int(a.dtype == torch.float32), int(x.dtype == torch.float32), int(out_dtype == torch.float32),
        ept, _stream(device),
    )
    _raise_on("sell_spmm_t", err)
    return out


def _sddmm_cuda(a: torch.Tensor, b: torch.Tensor, topology: SellMatrix, *, out_dtype) -> SellMatrix:
    device = topology.indices.device
    _check_dense("sell_sddmm", device, a=a, b=b)
    _check_topology("sell_sddmm", topology, device)
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"sell_sddmm: output dtype {out_dtype} not supported")
    if a.dtype != b.dtype:  # one operand dtype in the kernel; bf16 -> fp32 is exact
        a, b = a.float(), b.float()
    a, b = a.contiguous(), b.contiguous()
    k = a.shape[1]
    out = torch.empty(tuple(topology.values.shape), dtype=out_dtype, device=device)
    ept = _elements_per_lane(k, a, b)
    err = _lib().sell_sddmm(
        topology.indices.data_ptr(), _ptr(topology.slot_counts), _ptr(topology.row_perm),
        a.data_ptr(), b.data_ptr(), out.data_ptr(), topology.n_chunks, topology.width,
        topology.rows_padded, topology.chunk, topology.rows, topology.cols, k,
        int(a.dtype == torch.float32), int(out_dtype == torch.float32), ept, _stream(device),
    )
    _raise_on("sell_sddmm", err)
    return topology.with_values(out)


def _softmax_cuda(m: SellMatrix, *, scale: Optional[float] = None) -> SellMatrix:
    device = m.values.device
    _check_dense("sell_softmax", device, values=m.values)
    _check_topology("sell_softmax", m, device)
    values = m.values.contiguous()
    out = torch.empty_like(values)
    nc, w, rp = values.shape
    err = _lib().sell_softmax(
        values.data_ptr(), m.indices.data_ptr(), _ptr(m.slot_counts), out.data_ptr(), nc, w, rp, m.chunk,
        1.0 if scale is None else float(scale), int(values.dtype == torch.float32), _stream(device),
    )
    _raise_on("sell_softmax", err)
    return m.with_values(out)


def _on_cuda(*xs, **_) -> bool:
    return any((x.values if isinstance(x, SellMatrix) else x).is_cuda for x in xs)


def _on_cpu(*xs, **_) -> bool:
    return not _on_cuda(*xs)


registry.register("sell_spmm", "cuda_sell", _on_cuda, _spmm_cuda)
registry.register("sell_spmm", "torch_reference", _on_cpu, spmm_reference)
registry.register("sell_spmm_t", "cuda_sell", _on_cuda, _spmm_t_cuda)
registry.register("sell_spmm_t", "torch_reference", _on_cpu, spmm_t_reference)
registry.register("sell_sddmm", "cuda_sell", _on_cuda, _sddmm_cuda)
registry.register("sell_sddmm", "torch_reference", _on_cpu, sddmm_reference)
registry.register("sell_softmax", "cuda_sell", _on_cuda, _softmax_cuda)
registry.register("sell_softmax", "torch_reference", _on_cpu, sparse_softmax_reference)


# ------------------------------------------------------------ front ends --
def _check_variant(op: str, variant) -> None:
    if variant not in (None, "fused", "chunked"):
        raise ValueError(f"sell {op} variant must be None, 'fused' or 'chunked', got {variant!r}")


def spmm(
    a: SellMatrix,
    b: torch.Tensor,
    *,
    out_dtype=None,
    n_tile: int = 512,
    variant: Optional[str] = None,
    row_tile: Optional[int] = None,
) -> torch.Tensor:
    """C[rows, N] = A_sell @ B[cols, N]   (upstream Sputnik ``CudaSpmm``)."""
    out_dtype = out_dtype or a.dtype
    if b.shape[0] != a.cols:
        raise ValueError(f"contraction mismatch: A cols={a.cols}, B rows={b.shape[0]}")
    _check_variant("spmm", variant)
    if n_tile < 1:
        raise ValueError(f"n_tile must be positive, got {n_tile}")
    if row_tile is not None and (row_tile < _TR or row_tile % _TR or a.rows_padded % row_tile):
        raise ValueError(f"spmm row_tile {row_tile} must be a multiple of {_TR} dividing rows_padded {a.rows_padded}")
    return registry.dispatch("sell_spmm", a, b, out_dtype=out_dtype)


def spmm_t(a: SellMatrix, x: torch.Tensor, *, out_dtype=None, n_tile: int = 512) -> torch.Tensor:
    """C[cols, N] = A_sell^T @ X[rows, N], the weight-gradient shape."""
    out_dtype = out_dtype or a.dtype
    if x.shape[0] != a.rows:
        raise ValueError(f"contraction mismatch: A rows={a.rows}, X rows={x.shape[0]}")
    if n_tile < 1:
        raise ValueError(f"n_tile must be positive, got {n_tile}")
    return registry.dispatch("sell_spmm_t", a, x, out_dtype=out_dtype)


def sddmm(
    a: torch.Tensor,
    b: torch.Tensor,
    topology: SellMatrix,
    *,
    out_dtype=None,
    variant: Optional[str] = None,
) -> SellMatrix:
    """values[r, slot] = A[r, :] . B[col(slot), :]  (``CudaSddmm`` shape).

    ``a`` is (rows, k); ``b`` is (cols, k). The output keeps ``topology``'s
    SELL layout; padding slots get 0."""
    out_dtype = out_dtype or topology.dtype
    rows, k = a.shape
    if rows != topology.rows:
        raise ValueError(f"A rows={rows} != topology rows={topology.rows}")
    if tuple(b.shape) != (topology.cols, k):
        raise ValueError(f"B must be (cols, k)=({topology.cols}, {k}), got {tuple(b.shape)}")
    _check_variant("sddmm", variant)
    return registry.dispatch("sell_sddmm", a, b, topology, out_dtype=out_dtype)


def sparse_softmax(m: SellMatrix, *, scale: Optional[float] = None) -> SellMatrix:
    """Row softmax over a SELL matrix's valid slots, one pass: validity from
    ``m.slot_counts`` when present (the indices are not read), else from
    the sentinel."""
    nc, w, rp = m.values.shape
    if w == 0 or rp == 0:
        return m
    return registry.dispatch("sell_softmax", m, scale=scale)
