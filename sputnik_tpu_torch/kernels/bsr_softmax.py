"""The BSR row softmax on the ``bsr_softmax`` CUDA kernels
(``csrc/bsr_softmax.cu``): a stats pass (per-row online max and sum) and a
normalize pass, tied together by a ``torch.autograd.Function``; and the
score pass of the fused SDD + softmax.

Port of ``sputnik_tpu/kernels/bsr_softmax.py`` (``bsr_softmax_pallas``)
and of the score kernel of ``sputnik_tpu/kernels/flash_attention.py``
(``sdd_softmax_fused``'s ``_sdd_softmax_kernel``). Semantics are JAX's:
scores are scaled and causally masked (diagonal blocks keep their lower
triangle, blocks above the diagonal are masked) to the finite -1e30, a
masked lane gets probability 0 and a fully masked row comes out zero.
The stats and normalize passes (and their plain versions) also take
``window``, a token-exact window on top of the causal mask: query ``i``
keeps key ``j`` when ``i - window < j <= i`` (a multiple of 128 on the
card; 0 is none). The JAX package has no such mask. Data may carry one leading batch axis (attention heads sharing one
topology); ``m`` and ``l`` are then ``(batch, T)``.

The kernels walk each block-row's ``offsets[r] .. offsets[r + 1]`` on the
card: no ``max_row_nnz`` hint and no read back, so a topology built on the
card works as one built on the host. The plain versions beside them
(``stats_reference``, ``normalize_reference``, ``scores_reference``) need
no hint either: they reduce over the block-rows with ``torch.segment_reduce``
on the offsets, which loops over each segment in order (no atomics).

Each pass dispatches through the registry (``cuda_softmax`` on CUDA
tensors, ``torch_reference`` on CPU ones or under
``registry.forced_variant("torch_reference")``). On CUDA tensors a wrapper
launches its kernel or raises ``ValueError`` for a problem it does not take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.kernels.flash_mha import HEAD_DIMS  # the score pass instantiates the flash kernels' set
from sputnik_tpu_torch.ops import registry

__all__ = [
    "bsr_softmax_pallas", "stats", "normalize", "scores", "stats_reference", "normalize_reference",
    "scores_reference", "masked_scores", "window_keep", "segment", "LAUNCHES", "WINDOW_LAUNCHES", "NEG_INF",
    "HEAD_DIMS",
]

# Kernel launches in this process, by kernel; each launch adds one. A
# windowed launch of either pass also adds one to WINDOW_LAUNCHES.
LAUNCHES = {"bsr_softmax_stats": 0, "bsr_softmax_normalize": 0, "sdd_softmax": 0}
WINDOW_LAUNCHES = 0

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
NEG_INF = -1e30  # finite mask value: a fully masked row gives p = 0, not NaN
BS = 128


@functools.cache
def _lib():
    lib = _build.load("bsr_softmax")
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.bsr_softmax_stats.argtypes = [ptr] * 5 + [i32, i32, i64, f32, i32, i32, i32, ptr]
    lib.bsr_softmax_normalize.argtypes = [ptr] * 6 + [i32, i32, i32, i64, f32, i32, i32, i32, i32, ptr]
    lib.sdd_softmax.argtypes = [ptr] * 7 + [i32] * 5 + [f32, i32, i32, ptr]
    for fn in (lib.bsr_softmax_stats, lib.bsr_softmax_normalize, lib.sdd_softmax):
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------- plain versions --
def segment(x: torch.Tensor, offsets: torch.Tensor, reduce: str, initial: Optional[float] = None) -> torch.Tensor:
    """``(..., nnz, bs)`` reduced over the block-rows of ``offsets`` to
    ``(..., block_rows, bs)``, each segment in order (deterministic, no
    hint, no read back)."""
    lead, (nnz, bs) = x.shape[:-2], x.shape[-2:]
    flat = x.movedim(-2, 0).reshape(nnz, -1)
    out = torch.segment_reduce(flat, reduce, offsets=offsets, axis=0, unsafe=True, initial=initial)
    return out.reshape((offsets.shape[0] - 1,) + lead + (bs,)).movedim(0, -2)


def window_keep(topology: BlockSparseMatrix, window: int) -> torch.Tensor:
    """(nnz, bs, bs) bool: within each stored block, query ``i`` against
    key ``j`` (element indices) kept by the window, ``i - j < window``."""
    bs = topology.block_size
    idx = torch.arange(bs, device=topology.indices.device)
    gap = (topology.row_indices.long() - topology.indices.long())[:, None, None] * bs + idx[:, None] - idx[None, :]
    return gap < window


def masked_scores(data: torch.Tensor, topology: BlockSparseMatrix, scale: float, causal: bool,
                  window: int = 0) -> torch.Tensor:
    """``data * scale`` in fp32 with the causal mask at -1e30
    (``_masked_scores``, ``sputnik_tpu/kernels/bsr_softmax.py:42``), and the
    token-exact ``window`` (0: none)."""
    s = data.float() * scale
    if causal:
        idx = torch.arange(BS, device=data.device)
        intra = idx[:, None] >= idx[None, :]
        rows, cols = topology.row_indices, topology.indices
        keep = torch.where((rows == cols)[:, None, None], intra[None], (rows > cols)[:, None, None])
        if window:
            keep = keep & window_keep(topology, window)
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _online_stats(s: torch.Tensor, topology: BlockSparseMatrix) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, l), each ``(..., T)``, of masked fp32 scores ``s``."""
    m = segment(s.amax(dim=-1), topology.offsets, "max", initial=NEG_INF)
    e = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m[..., topology.row_indices.long(), :, None]), 0.0)
    l = segment(e.sum(dim=-1), topology.offsets, "sum")
    return m.flatten(-2), l.flatten(-2)


def stats_reference(data: torch.Tensor, topology: BlockSparseMatrix, *, scale: float, causal: bool,
                    window: int = 0):
    """(m, l): per element-row max and sum of exp(s - m) over the row's
    stored blocks, ``(..., T)`` fp32; an empty row gives (-1e30, 0)."""
    return _online_stats(masked_scores(data, topology, scale, causal, window), topology)


def normalize_reference(data, m, l, topology: BlockSparseMatrix, *, scale: float, causal: bool, out_dtype,
                        window: int = 0):
    """exp(s - m) / max(l, 1e-30) per stored block, 0 on masked lanes."""
    s = masked_scores(data, topology, scale, causal, window)
    rows = topology.row_indices.long()
    shape = m.shape[:-1] + (topology.block_rows, BS)
    m_sel = m.reshape(shape)[..., rows, :, None]
    l_sel = l.reshape(shape)[..., rows, :, None]
    e = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_sel), 0.0)
    return (e / l_sel.clamp(min=1e-30)).to(out_dtype)


def scores_reference(q, k, topology: BlockSparseMatrix, *, scale: float, causal: bool):
    """(scores, m, l) of the score pass: the masked fp32 ``q k^T * scale``
    of every stored block in packed order, and their row stats."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    br, bc = topology.block_rows, topology.block_cols
    blocks = s.reshape(s.shape[:-2] + (br, BS, bc, BS)).transpose(-3, -2)
    blocks = blocks[..., topology.row_indices.long(), topology.indices.long(), :, :]
    s = masked_scores(blocks, topology, scale, causal)
    return (s, *_online_stats(s, topology))


# -------------------------------------------------------------- the checks --
def _check_data(kernel: str, data: torch.Tensor, topology: BlockSparseMatrix):
    if not data.is_cuda:
        raise ValueError(f"{kernel} needs CUDA tensors; the data is on {data.device}")
    if data.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{kernel} takes bf16 or fp32 data, got {data.dtype}")
    if data.ndim not in (3, 4) or tuple(data.shape[-3:]) != (topology.nnz_blocks, BS, BS):
        raise ValueError(f"{kernel}: data must be ([batch,] {topology.nnz_blocks}, 128, 128), got "
                         f"{tuple(data.shape)}")
    if topology.block_size != BS:
        raise ValueError(f"{kernel}: block size must be 128, got {topology.block_size}")
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError(f"{kernel}: the data must be contiguous and 16-byte aligned")
    batch = data.shape[0] if data.ndim == 4 else 1
    if batch > 65535:
        raise ValueError(f"{kernel}: more than 65535 batch entries")
    return batch


def _metadata(kernel: str, device, *tensors) -> None:
    for x in tensors:
        if x.dtype != torch.int32 or x.device != device or not x.is_contiguous():
            raise ValueError(f"{kernel}: metadata must be contiguous int32 on {device}")


def _stats_out(kernel, batch, topology, device, *outs):
    for x in outs:
        if x.shape != (batch, topology.rows) or x.dtype != torch.float32 or x.device != device \
                or not x.is_contiguous():
            raise ValueError(f"{kernel}: m and l must be contiguous ({batch}, {topology.rows}) fp32 on {device}")


def _raise_on(kernel: str, err: int, windowed: bool = False) -> None:
    global WINDOW_LAUNCHES
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1
    WINDOW_LAUNCHES += int(windowed)


def _window_blocks(kernel: str, window: int, causal: bool) -> int:
    if window and (window % BS or window < 0 or not causal):
        raise ValueError(f"{kernel}: the window must be a nonnegative multiple of 128 under the causal mask, "
                         f"got {window} (causal={causal})")
    return window // BS


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------- the launches --
def launch_stats(data, topology: BlockSparseMatrix, m, l, *, scale: float, causal: bool, window: int = 0) -> None:
    """Launch ``bsr_softmax_stats`` into ``m`` and ``l`` ((batch, T) fp32)."""
    kernel = "bsr_softmax_stats"
    wb = _window_blocks(kernel, window, causal)
    batch = _check_data(kernel, data, topology)
    _metadata(kernel, data.device, topology.offsets, topology.indices)
    _stats_out(kernel, batch, topology, data.device, m, l)
    err = _lib().bsr_softmax_stats(
        data.data_ptr(), topology.offsets.data_ptr(), topology.indices.data_ptr(), m.data_ptr(), l.data_ptr(),
        topology.block_rows, batch, topology.nnz_blocks * BS * BS, float(scale), int(causal), wb,
        int(data.dtype == torch.float32), _stream(data.device),
    )
    _raise_on(kernel, err, bool(wb))


def launch_normalize(data, m, l, topology: BlockSparseMatrix, out, *, scale: float, causal: bool,
                     window: int = 0) -> None:
    """Launch ``bsr_softmax_normalize`` into ``out`` (data's shape, bf16 or
    fp32) from the stats ``m`` and ``l``."""
    kernel = "bsr_softmax_normalize"
    wb = _window_blocks(kernel, window, causal)
    batch = _check_data(kernel, data, topology)
    _metadata(kernel, data.device, topology.row_indices, topology.indices)
    _stats_out(kernel, batch, topology, data.device, m, l)
    if out.shape != data.shape or out.dtype not in KERNEL_DTYPES or out.device != data.device \
            or not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError(f"{kernel}: out must be contiguous {tuple(data.shape)} bf16 or fp32 on {data.device}")
    err = _lib().bsr_softmax_normalize(
        data.data_ptr(), m.data_ptr(), l.data_ptr(), topology.row_indices.data_ptr(),
        topology.indices.data_ptr(), out.data_ptr(), topology.nnz_blocks, topology.block_rows, batch,
        topology.nnz_blocks * BS * BS, float(scale), int(causal), wb, int(data.dtype == torch.float32),
        int(out.dtype == torch.float32), _stream(data.device),
    )
    _raise_on(kernel, err, bool(wb))


def launch_scores(q, k, topology: BlockSparseMatrix, scores, m, l, *, scale: float, causal: bool) -> None:
    """Launch ``sdd_softmax``'s score pass: q (batch, T, dh), k (batch, Tk,
    dh) of one dtype; scores (batch, nnz, 128, 128) fp32; m, l (batch, T)."""
    kernel = "sdd_softmax"
    for name, x in (("q", q), ("k", k)):
        if not x.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {x.device}")
        if x.dtype not in KERNEL_DTYPES or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{kernel} takes bf16 or fp32 q and k of one dtype on one device, got "
                             f"{q.dtype} and {k.dtype}")
        if x.ndim != 3 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous, 16-byte aligned (batch, T, dh)")
    batch, t, dh = q.shape
    if k.shape[0] != batch or k.shape[2] != dh:
        raise ValueError(f"{kernel}: q {tuple(q.shape)} and k {tuple(k.shape)} do not fit")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim must be one of {HEAD_DIMS} (the instantiated kernels), got {dh}")
    if topology.block_size != BS or topology.shape != (t, k.shape[1]):
        raise ValueError(f"{kernel}: topology {topology.shape} (block {topology.block_size}) does not fit "
                         f"T={t}, Tk={k.shape[1]}")
    if batch > 65535:
        raise ValueError(f"{kernel}: more than 65535 batch entries")
    _metadata(kernel, q.device, topology.offsets, topology.indices)
    _stats_out(kernel, batch, topology, q.device, m, l)
    if scores.shape != (batch, topology.nnz_blocks, BS, BS) or scores.dtype != torch.float32 \
            or scores.device != q.device or not scores.is_contiguous():
        raise ValueError(f"{kernel}: scores must be contiguous ({batch}, {topology.nnz_blocks}, 128, 128) fp32")
    err = _lib().sdd_softmax(
        q.data_ptr(), k.data_ptr(), topology.offsets.data_ptr(), topology.indices.data_ptr(), scores.data_ptr(),
        m.data_ptr(), l.data_ptr(), topology.nnz_blocks, topology.block_rows, k.shape[1], dh, batch,
        float(scale), int(causal), int(q.dtype == torch.float32), _stream(q.device),
    )
    _raise_on(kernel, err)


# ------------------------------------------------------ kernel or plain --
def _stats_cuda(data, topology, *, scale, causal, window=0):
    batch = data.shape[0] if data.ndim == 4 else 1
    m = torch.empty((batch, topology.rows), dtype=torch.float32, device=data.device)
    l = torch.empty_like(m)
    launch_stats(data, topology, m, l, scale=scale, causal=causal, window=window)
    lead = data.shape[:-3]
    return m.reshape(lead + (topology.rows,)), l.reshape(lead + (topology.rows,))


def _normalize_cuda(data, m, l, topology, *, scale, causal, out_dtype, window=0):
    batch = data.shape[0] if data.ndim == 4 else 1
    out = torch.empty(data.shape, dtype=out_dtype, device=data.device)
    launch_normalize(data, m.reshape(batch, -1), l.reshape(batch, -1), topology, out, scale=scale,
                     causal=causal, window=window)
    return out


def _scores_cuda(q, k, topology, *, scale, causal):
    lead = q.shape[:-2]
    q3, k3 = q.reshape((-1,) + q.shape[-2:]), k.reshape((-1,) + k.shape[-2:])
    batch = q3.shape[0]
    scores = torch.empty((batch, topology.nnz_blocks, BS, BS), dtype=torch.float32, device=q.device)
    m = torch.empty((batch, topology.rows), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    launch_scores(q3, k3, topology, scores, m, l, scale=scale, causal=causal)
    return (scores.reshape(lead + scores.shape[1:]), m.reshape(lead + (topology.rows,)),
            l.reshape(lead + (topology.rows,)))


def _on_cuda(*xs, **_) -> bool:
    return all(x.is_cuda for x in xs if isinstance(x, torch.Tensor))


def _on_cpu(*xs, **_) -> bool:
    return not any(x.is_cuda for x in xs if isinstance(x, torch.Tensor))


registry.register("bsr_softmax_stats", "cuda_softmax", _on_cuda, _stats_cuda)
registry.register("bsr_softmax_stats", "torch_reference", _on_cpu, stats_reference)
registry.register("bsr_softmax_normalize", "cuda_softmax", _on_cuda, _normalize_cuda)
registry.register("bsr_softmax_normalize", "torch_reference", _on_cpu, normalize_reference)
registry.register("sdd_softmax_scores", "cuda_softmax", _on_cuda, _scores_cuda)
registry.register("sdd_softmax_scores", "torch_reference", _on_cpu, scores_reference)


def stats(data, topology: BlockSparseMatrix, *, scale: float, causal: bool, window: int = 0):
    """(m, l) of the stats pass: the kernel on CUDA data, the plain version
    on CPU data."""
    return registry.dispatch("bsr_softmax_stats", data, topology, scale=scale, causal=causal, window=window)


def normalize(data, m, l, topology: BlockSparseMatrix, *, scale: float, causal: bool, out_dtype=None,
              window: int = 0):
    """The normalize pass into ``out_dtype`` (default: the data's)."""
    return registry.dispatch("bsr_softmax_normalize", data, m, l, topology, scale=scale, causal=causal,
                             out_dtype=out_dtype or data.dtype, window=window)


def scores(q, k, topology: BlockSparseMatrix, *, scale: float, causal: bool):
    """(scores fp32 in packed order, m, l) of the fused SDD + softmax's score
    pass; q and k are ``([batch,] T, dh)``."""
    return registry.dispatch("sdd_softmax_scores", q, k, topology, scale=scale, causal=causal)


# ---------------------------------------------------------------- autograd --
class _BsrSoftmax(torch.autograd.Function):
    """``bsr_softmax_pallas``'s custom VJP (``sputnik_tpu/kernels/
    bsr_softmax.py:191-200``): dx = scale * p * (g - rowdot), rowdot the
    segment sum of p * g over each block-row's stored blocks, in plain
    torch."""

    @staticmethod
    def forward(ctx, data, topology, scale, causal, window):
        m, l = stats(data, topology, scale=scale, causal=causal, window=window)
        p = normalize(data, m, l, topology, scale=scale, causal=causal, window=window)
        ctx.save_for_backward(p)
        ctx.meta = (topology, scale)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        topology, scale = ctx.meta
        pf, gf = p.float(), g.float()
        rowdot = segment((pf * gf).sum(dim=-1), topology.offsets, "sum")
        dx = scale * pf * (gf - rowdot[..., topology.row_indices.long(), :, None])
        return dx.to(p.dtype), None, None, None, None


def bsr_softmax_pallas(m: BlockSparseMatrix, *, scale: Optional[float] = None,
                       causal: bool = False, window: int = 0) -> BlockSparseMatrix:
    """Row softmax over the stored blocks by the two-pass kernels;
    differentiable in ``m.data``. ``scale=None`` scales by 1; ``window``
    (tokens, 0: none) as the module says."""
    if m.nnz_blocks == 0:
        return m
    sc = 1.0 if scale is None else float(scale)
    return m.with_data(_BsrSoftmax.apply(m.data.contiguous(), m, sc, bool(causal), int(window)))
