"""Fused block-sparse multi-head attention on the ``flash_mha`` CUDA kernels
(``csrc/flash_mha.cu``): the forward with its log-sum-exp, the flash-2 dQ
and the dK/dV pass, tied together by a ``torch.autograd.Function``.

Port of ``sputnik_tpu/kernels/flash_mha.py``. ``flash_mha`` takes
``(H, T, dh)`` queries and ``(H, Tk, dh)`` keys and values, and a score
topology of shape ``(T, Tk)`` shared by all heads; per head it computes
``softmax(q k^T * scale)`` over the topology's blocks (``causal`` masks as
``bsr_softmax(causal=True)`` does) times ``v``, without materialising the
scores. The backward computes ``dvec = rowsum(dO * O)`` in fp32 in plain
torch, as the JAX package does outside its kernels, then launches the dQ
kernel (walking each query block-row) and the dK/dV kernel (walking each
key block-column through the transpose metadata).

The kernels take bf16 or fp32 operands of one dtype, a head dim in
``HEAD_DIMS`` (the instantiated kernels) and block size 128; on CUDA
tensors anything else raises ``ValueError``.

bf16 at head dim 128 has a forward of its own, ``flash_mha_fwd_wgmma``
(TMA + wgmma, the softmax online in registers; its outputs are the other
forward's, so the same backward reads its lse); ``flash_mha_fwd`` keeps
fp32 and the other head dims. It also reads fewer key / value heads than
query heads in place (GQA) and takes a token-exact sliding ``window``,
which makes it the registry op ``bsr_attention`` (variant
``cuda_flash_wgmma``): the whole of ``multihead_block_sparse_attention``'s
unfused chain (SDD, softmax, DSD) in one launch, where its predicate
:func:`attention_fits` holds. It counts in
``LAUNCHES["flash_mha_fwd_wgmma"]``.

A (row, column) block stored twice counts once, as the JAX package's pair
plan counts it (``np.unique``, ``sputnik_tpu/kernels/flash_mha.py:52-79``):
for metadata known on the host ``flash_mha`` runs on the topology with the
duplicates merged (:func:`dedup_topology`, built once per topology). The
kernels themselves walk every stored block, which is what
``flash_block_attention`` computes (``kernels/flash_attention.py``); a
topology built on the card is used as it is, since finding its duplicates
would read it back. On CPU
tensors each pass computes its plain PyTorch version (``fwd_reference``,
``dq_reference``, ``dkv_reference``: dense masked math in fp32 on the
densified topology), inside the same forward and backward, so the CPU runs
the port's own backward formula. ``flash_mha`` dispatches through the
registry (``cuda_flash`` on the card, ``torch_reference`` on the CPU or
under ``registry.forced_variant``), forward and backward alike.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.common import cached_plan
from sputnik_tpu_torch.ops import registry

__all__ = [
    "flash_mha", "fwd", "dq", "dkv", "fwd_reference", "dq_reference", "dkv_reference",
    "launch_fwd", "launch_dq", "launch_dkv", "LAUNCHES", "HEAD_DIMS", "FlashMHA", "passes", "dedup_topology",
    "launch_fwd_wgmma", "fwd_wgmma", "attention_fits", "bsr_attention",
]

# Kernel launches in this process, by kernel; each launch adds one.
LAUNCHES = {"flash_mha_fwd": 0, "flash_mha_dq": 0, "flash_mha_dkv": 0, "flash_mha_fwd_wgmma": 0}

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# Head dims csrc/flash_mha.cu instantiates: every multiple of 16 up to 128
# (the repo's configs use 64 and 128).
HEAD_DIMS = tuple(range(16, 129, 16))
NEG_INF = -1e30  # finite mask value: a fully masked row gives p = 0, not NaN
POS_BIG = 1e30  # lse of a row with no mass: exp(s - POS_BIG) = 0


@functools.cache
def _lib():
    lib = _build.load("flash_mha")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 4 + [f32] + [i32] * 3 + [ptr]  # heads, t, tk, dh, scale, causal, in_f32, out_f32, stream
    for fn, n_ptrs in ((lib.flash_mha_fwd, 7), (lib.flash_mha_dq, 9), (lib.flash_mha_dkv, 10)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * n_ptrs + tail
    # heads, kv_group, t, tk, scale, causal, window, out_f32, stream
    lib.flash_mha_fwd_wgmma.restype = ctypes.c_int
    lib.flash_mha_fwd_wgmma.argtypes = [ptr] * 7 + [i32] * 4 + [f32] + [i32] * 3 + [ptr]
    return lib


# -------------------------------------------------------------- the checks --
def _check_problem(kernel: str, topology: BlockSparseMatrix, kv_group: int = 1, **operands):
    """(heads, t, tk, dh) of a problem the kernels take; ValueError
    otherwise. ``operands`` are q, k, v and dout, all of one dtype; k and v
    hold ``heads / kv_group`` heads."""
    q, k, v = operands["q"], operands["k"], operands["v"]
    for name, x in operands.items():
        if not x.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {x.device}")
        if x.device != q.device:
            raise ValueError(f"{kernel}: operands are on different devices")
        if x.dtype != q.dtype:
            raise ValueError(f"{kernel} takes bf16 or fp32 operands of one dtype, got {q.dtype} and {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and 16-byte aligned")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{kernel} takes bf16 or fp32 operands of one dtype, got {q.dtype}")
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{kernel}: expected q (H, T, dh), k and v (H, Tk, dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    h, t, dh = q.shape
    if dh not in HEAD_DIMS or k.shape[2] != dh:
        raise ValueError(f"{kernel}: head dim must be one of {HEAD_DIMS} (the instantiated kernels) and equal "
                         f"for q and k, got {dh} and {k.shape[2]}")
    if k.shape[0] * kv_group != h:
        raise ValueError(f"{kernel}: {h} query heads but {k.shape[0]} key heads (kv_group {kv_group})")
    if "dout" in operands and operands["dout"].shape != q.shape:
        raise ValueError(f"{kernel}: dout is {tuple(operands['dout'].shape)}, expected {tuple(q.shape)}")
    if topology.block_size != 128:
        raise ValueError(f"{kernel}: block size must be 128, got {topology.block_size}")
    if topology.shape != (t, k.shape[1]):
        raise ValueError(f"{kernel}: topology {topology.shape} does not fit T={t}, Tk={k.shape[1]}")
    if h > 65535:
        raise ValueError(f"{kernel}: more than 65535 heads")
    return h, t, k.shape[1], dh


def _check_tensor(kernel: str, name: str, x: torch.Tensor, shape, dtypes, device) -> None:
    if tuple(x.shape) != tuple(shape) or x.dtype not in dtypes or x.device != device:
        raise ValueError(f"{kernel}: {name} must be {tuple(shape)} of {dtypes} on {device}, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be contiguous and 16-byte aligned")


def _metadata(kernel: str, topology: BlockSparseMatrix, transposed: bool, device):
    if transposed:
        m = topology.with_transpose_metadata()
        groups, members = m.offsets_t, m.indices_t
    else:
        groups, members = topology.offsets, topology.indices
    for name, x in (("offsets", groups), ("indices", members)):
        if x.dtype != torch.int32 or x.device != device or not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous int32 on {device}")
    return groups.data_ptr(), members.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


# ------------------------------------------------------------- the launches --
def launch_fwd(q, k, v, topology, out, lse, *, causal: bool, scale: float) -> None:
    """Launch ``flash_mha_fwd`` into ``out`` (q's shape, bf16 or fp32) and
    ``lse`` ((H, T) fp32)."""
    kernel = "flash_mha_fwd"
    h, t, tk, dh = _check_problem(kernel, topology, q=q, k=k, v=v)
    _check_tensor(kernel, "out", out, q.shape, KERNEL_DTYPES, q.device)
    _check_tensor(kernel, "lse", lse, (h, t), (torch.float32,), q.device)
    offsets, indices = _metadata(kernel, topology, False, q.device)
    err = _lib().flash_mha_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets, indices, out.data_ptr(), lse.data_ptr(),
        h, t, tk, dh, scale, int(causal), int(q.dtype == torch.float32), int(out.dtype == torch.float32),
        _stream(q.device),
    )
    _raise_on(kernel, err)


def launch_fwd_wgmma(q, k, v, topology, out, lse, *, causal: bool, scale: float, window: int = 0) -> None:
    """Launch ``flash_mha_fwd_wgmma`` into ``out`` (q's shape, bf16 or fp32)
    and ``lse`` ((H, T) fp32): bf16 q (H, T, 128), k and v (H_kv, Tk, 128)
    with H_kv a divisor of H; ``window`` (tokens, 0: none) keeps key ``j``
    of query ``i`` only where ``i - j < window``."""
    kernel = "flash_mha_fwd_wgmma"
    if q.dtype != torch.bfloat16 or q.shape[-1] != 128:
        raise ValueError(f"{kernel} takes bf16 at head dim 128, got {q.dtype} at {q.shape[-1]}")
    if k.ndim != 3 or not 0 < k.shape[0] <= q.shape[0] or q.shape[0] % k.shape[0]:
        raise ValueError(f"{kernel}: {q.shape[0]} query heads do not group over key heads {tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"{kernel}: window must be >= 0, got {window}")
    kv_group = q.shape[0] // k.shape[0]
    h, t, tk, dh = _check_problem(kernel, topology, kv_group, q=q, k=k, v=v)
    _check_tensor(kernel, "out", out, q.shape, KERNEL_DTYPES, q.device)
    _check_tensor(kernel, "lse", lse, (h, t), (torch.float32,), q.device)
    offsets, indices = _metadata(kernel, topology, False, q.device)
    err = _lib().flash_mha_fwd_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), offsets, indices, out.data_ptr(), lse.data_ptr(),
        h, kv_group, t, tk, scale, int(causal), int(window), int(out.dtype == torch.float32), _stream(q.device),
    )
    _raise_on(kernel, err)


def _check_backward(kernel, q, k, v, dout, lse, dvec, topology):
    h, t, tk, dh = _check_problem(kernel, topology, q=q, k=k, v=v, dout=dout)
    _check_tensor(kernel, "lse", lse, (h, t), (torch.float32,), q.device)
    _check_tensor(kernel, "dvec", dvec, (h, t), (torch.float32,), q.device)
    return h, t, tk, dh


def launch_dq(q, k, v, dout, lse, dvec, topology, dq_out, *, causal: bool, scale: float) -> None:
    """Launch ``flash_mha_dq`` into ``dq_out`` (q's shape, bf16 or fp32)."""
    kernel = "flash_mha_dq"
    h, t, tk, dh = _check_backward(kernel, q, k, v, dout, lse, dvec, topology)
    _check_tensor(kernel, "dq", dq_out, q.shape, KERNEL_DTYPES, q.device)
    offsets, indices = _metadata(kernel, topology, False, q.device)
    err = _lib().flash_mha_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
        offsets, indices, dq_out.data_ptr(), h, t, tk, dh, scale, int(causal),
        int(q.dtype == torch.float32), int(dq_out.dtype == torch.float32), _stream(q.device),
    )
    _raise_on(kernel, err)


def launch_dkv(q, k, v, dout, lse, dvec, topology, dk_out, dv_out, *, causal: bool, scale: float) -> None:
    """Launch ``flash_mha_dkv`` into ``dk_out`` and ``dv_out`` (k's shape,
    one dtype, bf16 or fp32)."""
    kernel = "flash_mha_dkv"
    h, t, tk, dh = _check_backward(kernel, q, k, v, dout, lse, dvec, topology)
    _check_tensor(kernel, "dk", dk_out, k.shape, KERNEL_DTYPES, q.device)
    _check_tensor(kernel, "dv", dv_out, k.shape, (dk_out.dtype,), q.device)
    offsets_t, indices_t = _metadata(kernel, topology, True, q.device)
    err = _lib().flash_mha_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
        offsets_t, indices_t, dk_out.data_ptr(), dv_out.data_ptr(), h, t, tk, dh, scale, int(causal),
        int(q.dtype == torch.float32), int(dk_out.dtype == torch.float32), _stream(q.device),
    )
    _raise_on(kernel, err)


# ---------------------------------------------------------- plain versions --
def _multiplicity(topology: BlockSparseMatrix, causal: bool, device, window: int = 0) -> torch.Tensor:
    """(T, Tk) fp32: how many times the topology stores each element's block
    (0 where it stores none, 2 for a block stored twice: the kernels walk
    every stored block), zeroed by the causal mask (query position >= key
    position, flash_attention._keep_mask's block rule for equal block
    sizes) and outside a token-exact ``window`` (query i keeps key j where
    i - j < window; 0: none)."""
    bs, br, bc = topology.block_size, topology.block_rows, topology.block_cols
    flat = topology.row_indices.long().to(device) * bc + topology.indices.long().to(device)
    # Whole counts: the sum is exact in any order. No host tensor, so a CUDA
    # graph can capture it.
    counts = torch.zeros(br * bc, dtype=torch.float32, device=device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=device))
    mult = counts.view(br, bc).repeat_interleave(bs, 0).repeat_interleave(bs, 1)
    gap = torch.arange(topology.rows, device=device)[:, None] - torch.arange(topology.cols, device=device)
    if causal:
        mult = mult * (gap >= 0)
    if window:
        mult = mult * (gap < window)
    return mult


def _p_ds(q, k, v, dout, lse, dvec, topology, causal, scale):
    """P = exp(S - lse) on the mask, times each block's multiplicity, and
    dS = P * (dO V^T - dvec), in fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mult = _multiplicity(topology, causal, q.device)
    p = torch.where(mult > 0, torch.exp(s - lse[..., None]), 0.0) * mult
    return p, p * (torch.matmul(dout.float(), v.float().transpose(-1, -2)) - dvec[..., None])


def fwd_reference(q, k, v, topology, *, causal: bool, scale: float, out_dtype=None, window: int = 0):
    """(out, lse) of the forward in dense fp32 math; lse is (H, T) fp32. k
    and v may hold fewer heads (GQA: query head h reads head h / (H /
    H_kv)); ``window`` as :func:`launch_fwd_wgmma`'s."""
    if k.shape[0] != q.shape[0]:
        rep = q.shape[0] // k.shape[0]
        k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
    mult = _multiplicity(topology, causal, q.device, window)
    s = torch.where(mult > 0, torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mult > 0, torch.exp(s - m), 0.0) * mult
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / l.clamp(min=1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)), POS_BIG)[..., 0]
    return out.to(out_dtype or q.dtype), lse


def dq_reference(q, k, v, dout, lse, dvec, topology, *, causal: bool, scale: float, out_dtype=None):
    """dQ = scale * dS K."""
    _, ds = _p_ds(q, k, v, dout, lse, dvec, topology, causal, scale)
    return (torch.matmul(ds, k.float()) * scale).to(out_dtype or q.dtype)


def dkv_reference(q, k, v, dout, lse, dvec, topology, *, causal: bool, scale: float, out_dtype=None):
    """(dK, dV) = (scale * dS^T Q, P^T dO)."""
    p, ds = _p_ds(q, k, v, dout, lse, dvec, topology, causal, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


# ------------------------------------------- kernel or plain, by device --
def fwd(q, k, v, topology, *, causal: bool, scale: float, out_dtype=None):
    """(out, lse): the kernel on CUDA tensors (``flash_mha_fwd_wgmma`` for
    bf16 at head dim 128, else ``flash_mha_fwd``), the plain version on CPU
    ones."""
    if not q.is_cuda:
        return fwd_reference(q, k, v, topology, causal=causal, scale=scale, out_dtype=out_dtype)
    if _wgmma_takes(q, k, v):
        return fwd_wgmma(q, k, v, topology, causal=causal, scale=scale, out_dtype=out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    launch_fwd(q, k, v, topology, out, lse, causal=causal, scale=scale)
    return out, lse


def _wgmma_takes(q, k, v) -> bool:
    return all(x.dtype == torch.bfloat16 and x.shape[-1] == 128 for x in (q, k, v))


def fwd_wgmma(q, k, v, topology, *, causal: bool, scale: float, out_dtype=None, window: int = 0):
    """(out, lse) of ``flash_mha_fwd_wgmma`` on CUDA tensors (made
    contiguous); k and v may hold fewer heads (GQA)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    launch_fwd_wgmma(q, k, v, topology, out, lse, causal=causal, scale=scale, window=window)
    return out, lse


def dq(q, k, v, dout, lse, dvec, topology, *, causal: bool, scale: float, out_dtype=None):
    if not q.is_cuda:
        return dq_reference(q, k, v, dout, lse, dvec, topology, causal=causal, scale=scale, out_dtype=out_dtype)
    out = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    launch_dq(q, k, v, dout, lse, dvec, topology, out, causal=causal, scale=scale)
    return out


def dkv(q, k, v, dout, lse, dvec, topology, *, causal: bool, scale: float, out_dtype=None):
    if not q.is_cuda:
        return dkv_reference(q, k, v, dout, lse, dvec, topology, causal=causal, scale=scale, out_dtype=out_dtype)
    dk = torch.empty(k.shape, dtype=out_dtype or k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=out_dtype or v.dtype, device=q.device)
    launch_dkv(q, k, v, dout, lse, dvec, topology, dk, dv, causal=causal, scale=scale)
    return dk, dv


# ------------------------------------------------------ duplicated blocks --
def _merge_duplicates(topology: BlockSparseMatrix) -> Optional[BlockSparseMatrix]:
    """The merged topology, or None without a duplicate (the cache then
    holds no reference to ``topology``)."""
    offsets, indices, _ = topology.host_metadata()
    rows = np.repeat(np.arange(topology.block_rows, dtype=np.int64), np.diff(offsets))
    keys = rows * topology.block_cols + indices
    uniq = np.unique(keys)
    if len(uniq) == len(keys):
        return None
    u_rows = uniq // topology.block_cols
    u_offsets = np.concatenate([[0], np.cumsum(np.bincount(u_rows, minlength=topology.block_rows))])
    bs = topology.block_size
    # The kernels read only the metadata: the blocks are a stride-0 view.
    data = torch.zeros((), dtype=topology.dtype, device=topology.device).expand(len(uniq), bs, bs)
    merged = BlockSparseMatrix.create(data, u_offsets.astype(np.int32),
                                      (uniq % topology.block_cols).astype(np.int32), topology.shape)
    return merged.with_transpose_metadata()


def dedup_topology(topology: BlockSparseMatrix) -> BlockSparseMatrix:
    """``topology`` with each (row, column) block once, for metadata known
    on the host (cached per metadata tensors); ``topology`` itself when it
    has no duplicate or its metadata was built on the card."""
    if not topology.host_known or topology.nnz_blocks == 0:
        return topology
    merged = cached_plan((topology.offsets, topology.indices), ("flash_dedup",),
                         lambda: _merge_duplicates(topology))
    return topology if merged is None else merged


# ---------------------------------------------------- autograd and dispatch --
_Passes = collections.namedtuple("_Passes", "fwd dq dkv")
_PASSES = {
    "cuda_flash": _Passes(fwd, dq, dkv),
    "torch_reference": _Passes(fwd_reference, dq_reference, dkv_reference),
}


def passes(q, k, v, topology, variant: Optional[str] = None) -> _Passes:
    """The (fwd, dq, dkv) functions of the registry's first fit for the
    problem, or of ``variant``."""
    name = registry.dispatch_name("flash_mha", q, k, v, topology, variant=variant)
    registry.count_route("flash_mha", name)
    return _PASSES[name]


class FlashMHA(torch.autograd.Function):
    """custom_vjp of ``flash_mha`` (``flash_mha.py:526-545``): the forward
    saves (q, k, v, out, lse). Like the matmul VJPs, the backward dispatches
    when it runs, so ``registry.forced_variant`` governs it there."""

    @staticmethod
    def forward(ctx, q, k, v, topology, causal, scale, variant):
        out, lse = passes(q, k, v, topology, variant).fwd(q, k, v, topology, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (topology, causal, scale, variant)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        topology, causal, scale, variant = ctx.meta
        fns = passes(q, k, v, topology, variant)
        g = g.contiguous()  # the LM hands back a permuted gradient
        dvec = (g.float() * out.float()).sum(dim=-1)
        dq_ = fns.dq(q, k, v, g, lse, dvec, topology, causal=causal, scale=scale)
        dk_, dv_ = fns.dkv(q, k, v, g, lse, dvec, topology, causal=causal, scale=scale)
        return dq_, dk_, dv_, None, None, None, None


def _on_cuda(q, k, v, topology, **_) -> bool:
    return q.is_cuda and k.is_cuda and v.is_cuda


def _on_cpu(q, k, v, topology, **_) -> bool:
    return not (q.is_cuda or k.is_cuda or v.is_cuda)


def _launcher(name: str):
    def run(q, k, v, topology, *, causal, scale):
        return FlashMHA.apply(q, k, v, topology, causal, scale, name)
    return run


registry.register("flash_mha", "cuda_flash", _on_cuda, _launcher("cuda_flash"))
registry.register("flash_mha", "torch_reference", _on_cpu, _launcher("torch_reference"))


def attention_fits(q, k, v, topology, *, causal: bool, scale: float, window: int = 0) -> bool:
    """Whether ``bsr_attention``'s kernel takes the problem: bf16 q, k, v on
    the card at head dim 128, the causal mask, metadata known on the host,
    and no gradient recorded (the kernel has no backward of its own with
    GQA and the window; autograd then runs the chain)."""
    return (_on_cuda(q, k, v, topology) and causal and topology.host_known and topology.block_size == 128
            and _wgmma_takes(q, k, v)
            and not (torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))))


def bsr_attention(q, k, v, topology, *, causal: bool, scale: float, window: int = 0) -> torch.Tensor:
    """(H, T, 128) ``multihead_block_sparse_attention`` of the unfused chain
    (every stored block, as SDD -> softmax -> DSD walk them) in one
    ``flash_mha_fwd_wgmma`` launch: GQA and the window in the kernel."""
    return fwd_wgmma(q, k, v, topology, causal=causal, scale=scale, window=window)[0]


registry.register("bsr_attention", "cuda_flash_wgmma", attention_fits, bsr_attention)


def flash_mha(
    q: torch.Tensor,  # (H, T, dh)
    k: torch.Tensor,  # (H, Tk, dh)
    v: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    group: int = 8,
    rows_per_step: Optional[int] = None,
) -> torch.Tensor:
    """Fused multi-head block-sparse attention; differentiable in q, k, v.

    The signature and checks are JAX's: ``rows_per_step`` must be in 1..8
    and divide the query block-rows (``None`` picks the largest of 8, 4, 2
    that does, else 1), and a topology without blocks gives zeros.
    ``rows_per_step`` and ``group`` shape the TPU kernel's strips to the
    MXU; they do not shape the CUDA schedule (one CTA per 64-row tile, see
    ``csrc/flash_mha.cu``) and are only validated here. Each pass takes
    the registry's first fit (``cuda_flash`` on the card,
    ``torch_reference`` on the CPU) or the ``forced_variant`` it runs in.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n_rows = topology.block_rows
    if rows_per_step is None:
        rows_per_step = next((r for r in (8, 4, 2) if n_rows % r == 0), 1)
    rows_per_step = int(rows_per_step)
    if not 1 <= rows_per_step <= 8:
        raise ValueError(f"rows_per_step must be in 1..8, got {rows_per_step}")
    if int(group) < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    if topology.nnz_blocks == 0:
        return torch.zeros_like(q)
    if n_rows % rows_per_step:
        raise ValueError(f"flash_mha needs query block rows divisible by rows_per_step={rows_per_step}")
    topology = dedup_topology(topology)
    # Not registry.dispatch, whose launchers pin the variant for the
    # backward too: here the backward resolves its own when it runs.
    return FlashMHA.apply(q.contiguous(), k.contiguous(), v.contiguous(), topology,
                           bool(causal), float(scale), None)
