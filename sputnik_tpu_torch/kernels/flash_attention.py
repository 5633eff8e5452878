"""Single-head fused block-sparse attention and the fused SDD + softmax
(``sputnik_tpu/kernels/flash_attention.py``).

``flash_block_attention`` is the single-head flash attention the JAX
package takes for traced metadata. Its forward, dQ and dK/dV passes
(``_kernel``, ``_dq_kernel``, ``_dkv_kernel``) compute, head by head, the
function that ``flash_mha``'s three CUDA kernels compute: those walk each
block-row's (block-column's) stored blocks from the offsets on the card,
one CTA per 64-row tile, keep every stored block, zero empty rows and
columns and use the same log-sum-exp sentinel. So the port runs them with
one head, as ``bsr_sdd`` serves both of JAX's SDD kernels. Unlike
``flash_mha`` it does not merge a (row, column) block stored twice, as
JAX's per-row plan does not. ``fused_backward=False`` recomputes the
gradient through the unfused chain (SDD -> BSR softmax -> DSD), as JAX's
does. JAX's ``group`` (K/V blocks per TPU grid step) shapes a schedule the
CUDA kernels do not have; the port takes no such argument.

``sdd_softmax_fused`` is the fused SDD + softmax: the score pass
(``kernels/bsr_softmax.py``'s ``sdd_softmax`` kernel: the masked fp32
scores of every stored block in packed order and the row stats) and the
normalize pass with scale 1 and no mask as its epilogue, two launches as
JAX's kernel and its XLA epilogue are. It is not differentiable, as JAX's
is not.

``flash_band_fold`` is ring attention's inner step (``_fold_kernel``): one
K/V band folded into an unnormalized online-softmax state ``(acc, m, l)``
on the ``flash_band_fold`` CUDA kernel (``csrc/flash_fold.cu``). On CPU
tensors it computes :func:`flash_band_fold_reference`; on CUDA tensors it
launches the kernel or raises ``ValueError`` for a problem the kernel does
not take (block size other than 128, a head dim outside ``HEAD_DIMS``, a
dtype other than bf16 / fp32).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build, bsr_softmax
from sputnik_tpu_torch.kernels import flash_mha as fm

__all__ = [
    "flash_block_attention", "sdd_softmax_fused", "flash_attention_heads", "flash_band_fold",
    "flash_band_fold_reference", "launch_fold", "LAUNCHES",
]

# Launches of the fold kernel in this process; each launch adds one.
LAUNCHES = {"flash_band_fold": 0}
LANES = 128  # width of the m / l state (the TPU kernel's lane axis); lane 0 is live


def _unfused(q, k, v, topology, causal, scale):
    from sputnik_tpu_torch import ops

    scores = ops.sdd(q, k, topology, transpose_b=True)
    probs = ops.bsr_softmax(scores, scale=scale, causal=causal)
    return ops.dsd(probs, v, out_dtype=q.dtype)


class _FlashRecompute(torch.autograd.Function):
    """``fused_backward=False`` (``flash_attention.py:853-869``): the flash
    forward keeps only its inputs; the backward recomputes through the
    unfused chain and takes its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, topology, causal, scale):
        out, _ = fm.passes(q, k, v, topology).fwd(q, k, v, topology, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.meta = (topology, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        topology, causal, scale = ctx.meta
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = _unfused(*leaves, topology, causal, scale)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def flash_attention_heads(q, k, v, topology: BlockSparseMatrix, *, causal: bool, scale: float,
                          fused_backward: bool = True) -> torch.Tensor:
    """``flash_block_attention`` for each head of (H, T, dh) q and (H, Tk,
    dh) k, v over one topology: one launch of each kernel for all heads
    (the JAX package ``vmap``-s the single-head function)."""
    if topology.nnz_blocks == 0:
        return torch.zeros_like(q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if fused_backward:
        return fm.FlashMHA.apply(q, k, v, topology, bool(causal), float(scale), None)
    return _FlashRecompute.apply(q, k, v, topology, bool(causal), float(scale))


def flash_block_attention(
    q: torch.Tensor,  # (T, dh)
    k: torch.Tensor,  # (Tk, dh)
    v: torch.Tensor,
    topology: BlockSparseMatrix,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    fused_backward: bool = True,
) -> torch.Tensor:
    """Fused single-head block-sparse attention, O(T * dh) memory;
    differentiable in q, k, v. ``scale=None`` is 1/sqrt(dh). Every stored
    block takes part, duplicates included. Backward: the flash-2 dQ and
    dK/dV kernels (``fused_backward=True``) or the unfused chain's VJP."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return flash_attention_heads(q[None], k[None], v[None], topology, causal=causal, scale=scale,
                                 fused_backward=fused_backward)[0]


def sdd_softmax_fused(
    q: torch.Tensor,  # ([batch,] T, dh)
    k: torch.Tensor,  # ([batch,] Tk, dh)
    topology: BlockSparseMatrix,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    out_dtype=None,
) -> BlockSparseMatrix:
    """probs = softmax(scale * q @ k^T at topology), one score pass and one
    normalize pass; ``scale=None`` applies no scaling. A leading batch axis
    on q and k gives batched data (one launch of each kernel)."""
    scale = 1.0 if scale is None else float(scale)
    out_dtype = out_dtype or topology.dtype
    if topology.nnz_blocks == 0:
        return topology
    scores, m, l = bsr_softmax.scores(q.contiguous(), k.contiguous(), topology, scale=scale, causal=causal)
    probs = bsr_softmax.normalize(scores, m, l, topology, scale=1.0, causal=False, out_dtype=out_dtype)
    return topology.with_data(probs)


# --------------------------------------------------------- the band fold --
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def flash_band_fold_reference(q, k, v, rows, cols, flags, state: State, *, bs: int, scale: float,
                              causal: bool = False, row_offset_blocks: int = 0,
                              col_offset_blocks: int = 0) -> State:
    """Plain version of the fold kernel: the real slots' score blocks in one
    batched fp32 product, masked at global block ids, then the online
    update taken per slot rank (the i-th real slot of every block-row at
    once), so that each row sees its slots in order with the running max,
    as the kernel and the TPU kernel do, and ``p`` is rounded to ``v``'s
    dtype against the same max. Rows with no real slot and lanes 1-127 of
    ``m`` / ``l`` keep their input. Reads the slot count back (a plain
    version, off the main path)."""
    acc, m, l = (x.float().contiguous().clone() for x in state)
    t, dh = q.shape
    nb = t // bs
    real = torch.nonzero(flags > 0).flatten()
    if real.numel() == 0:
        return acc, m, l
    rr, cc = rows[real].long(), cols[real].long()
    kb = k.reshape(-1, bs, dh)
    vb = v.reshape(-1, bs, dh)[cc].float()
    s = torch.matmul(q.reshape(nb, bs, dh)[rr].float(), kb[cc].float().transpose(1, 2)) * scale
    if causal:
        gr, gc = rr + int(row_offset_blocks), cc + int(col_offset_blocks)
        idx = torch.arange(bs, device=q.device)
        tri = idx[:, None] >= idx[None, :]
        keep = torch.where((gr == gc)[:, None, None], tri, (gr > gc)[:, None, None])
        s = s.masked_fill(~keep, fm.NEG_INF)
    rank = torch.arange(rr.numel(), device=rr.device) - torch.searchsorted(rr, rr)
    a3 = acc.view(nb, bs, dh)
    mrow, lrow = m[:, 0].reshape(nb, bs).clone(), l[:, 0].reshape(nb, bs).clone()
    for i in range(int(rank.max()) + 1):
        sel = rank == i
        rk, sk = rr[sel], s[sel]  # distinct rows: one slot of each
        m_prev = mrow[rk]
        m_new = torch.maximum(m_prev, sk.amax(dim=-1))
        corr = torch.exp(m_prev - m_new)
        p = torch.where(sk > 0.5 * fm.NEG_INF, torch.exp(sk - m_new[..., None]), 0.0)
        lrow[rk] = lrow[rk] * corr + p.sum(dim=-1)
        a3[rk] = a3[rk] * corr[..., None] + torch.matmul(p.to(v.dtype).float(), vb[sel])
        mrow[rk] = m_new
    m[:, 0], l[:, 0] = mrow.flatten(), lrow.flatten()
    return acc, m, l


@functools.cache
def _fold_lib():
    lib = _build.load("flash_fold")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_band_fold.restype = i32
    lib.flash_band_fold.argtypes = [ptr] * 9 + [i32] * 3 + [ctypes.c_float] + [i32] * 4 + [ptr]
    return lib


def launch_fold(q, k, v, rows, cols, flags, acc, m, l, *, scale: float, causal: bool, row_offset_blocks: int = 0,
                col_offset_blocks: int = 0) -> None:
    """Launch ``flash_band_fold`` on the state ``(acc, m, l)`` in place. Raises
    ``ValueError`` for a problem the kernel does not take. ``rows`` must be
    non-decreasing and ``cols`` must index 128-blocks of ``k``."""
    kernel = "flash_band_fold"
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {x.device}")
        if x.device != q.device or x.dtype != q.dtype or x.dtype not in fm.KERNEL_DTYPES:
            raise ValueError(f"{kernel} takes bf16 or fp32 q, k, v of one dtype on one device, "
                             f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be a contiguous, 16-byte aligned (T, dh) matrix")
    (t, dh), tk = q.shape, k.shape[0]
    if dh not in fm.HEAD_DIMS or k.shape[1] != dh or v.shape != k.shape:
        raise ValueError(f"{kernel}: head dim must be one of {fm.HEAD_DIMS} (the instantiated kernels) and "
                         f"k, v (Tk, dh), got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if t % 128 or tk % 128:
        raise ValueError(f"{kernel}: T={t} and Tk={tk} must be multiples of the block size 128")
    fm._check_tensor(kernel, "acc", acc, (t, dh), (torch.float32,), q.device)
    for name, x in (("m", m), ("l", l)):
        fm._check_tensor(kernel, name, x, (t, LANES), (torch.float32,), q.device)
    for name, x in (("rows", rows), ("cols", cols), ("flags", flags)):  # 4-byte aligned is enough here
        if x.ndim != 1 or x.shape != rows.shape or x.dtype != torch.int32 or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{kernel}: rows, cols and flags must be contiguous 1-D int32 of one length on "
                             f"{q.device}, got {name} {tuple(x.shape)} {x.dtype} on {x.device}")
    err = _fold_lib().flash_band_fold(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rows.data_ptr(), cols.data_ptr(), flags.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), t, rows.shape[0], dh, float(scale), int(causal),
        int(row_offset_blocks), int(col_offset_blocks), int(q.dtype == torch.float32), fm._stream(q.device),
    )
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


def flash_band_fold(
    q: torch.Tensor,  # (t_local, dh)
    k: torch.Tensor,  # (band, dh)
    v: torch.Tensor,
    rows: torch.Tensor,  # (p,) band-local block-row ids (non-decreasing)
    cols: torch.Tensor,  # (p,) band-local block-col ids
    flags: torch.Tensor,  # (p,) int 1 = real slot
    state: State,  # (acc f32 (t, dh), m f32 (t, 128), l f32 (t, 128))
    *,
    bs: int,
    scale: float,
    causal: bool = False,
    row_offset_blocks: int = 0,  # global block offset of this query band
    col_offset_blocks: int = 0,  # global block offset of the held kv band
) -> State:
    """Fold one K/V band into a flash online-softmax state (ring attention's
    inner step); new tensors, the inputs untouched. Rows untouched by this
    band keep their input state; only lane 0 of ``m`` / ``l`` is live, and
    lanes 1-127 pass through. Finalize with ``acc / max(l[:, :1], eps)``.
    The kernel on CUDA tensors, :func:`flash_band_fold_reference` on CPU
    ones."""
    if not q.is_cuda:
        return flash_band_fold_reference(q, k, v, rows, cols, flags, state, bs=bs, scale=scale, causal=causal,
                                         row_offset_blocks=row_offset_blocks, col_offset_blocks=col_offset_blocks)
    if bs != 128:
        raise ValueError(f"flash_band_fold: block size must be 128, got {bs}")
    acc, m, l = (x.contiguous().clone() for x in state)
    launch_fold(q, k, v, rows, cols, flags, acc, m, l, scale=scale, causal=causal,
                row_offset_blocks=row_offset_blocks, col_offset_blocks=col_offset_blocks)
    return acc, m, l
