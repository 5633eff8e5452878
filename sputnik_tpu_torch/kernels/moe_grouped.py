"""The grouped expert FFN of the capacity-routed MoE (``moe_forward``'s
``impl="grouped"``) on the ``moe_grouped`` CUDA kernels
(``csrc/moe_grouped.cu``): bf16 operands read in place, fp32 accumulation
on Hopper's tensor cores, forward and backward.

For ``x`` (E * C, d) in expert-major capacity slots, ``w1`` (d, E * F) and
``w2`` (E * F, d), the FFN is ``y = gelu(x_e @ w1_e).bf16 @ w2_e`` per expert
e, in fp32 (the JAX package's two einsums with
``preferred_element_type=float32``, ``sputnik_tpu/models/moe.py:201-205``).

* :func:`grouped_ffn_reference` is the plain version: fp32 ``bmm`` on fp32
  copies of the bf16 operands, differentiated by autograd.
* :func:`grouped_ffn` is the kernel's route, a ``torch.autograd.Function``
  (:class:`GroupedFfn`) over six grouped GEMMs (:func:`forward_gemms`,
  :func:`backward_gemms`): h and y forward (the fp32 pre-activation kept
  for the backward when a gradient is wanted), then dh (fused with
  gelu'), dw2, dx and dw1. The backward's fp32 cotangents enter the
  products as three bf16 terms (:func:`split3`) whose sum is exact, so its
  products are the fp32 ones of the plain version up to summation order;
  the gradients are rounded to bf16 where the plain version's autograd
  rounds them.

Both dispatch through the registry as op ``moe_grouped_ffn``: variant
``cuda_grouped`` for bf16 CUDA problems with ``d`` and ``F`` multiples of
128 and ``C`` of 64, then ``torch_reference`` for every other problem (CPU
tensors, fp32 models on the card) and under
``registry.forced_variant("torch_reference")``.

:func:`gemm_reference` is the plain version of one launch, on the launch's
own description (:class:`Gemm`): the CPU tests run the whole autograd
Function on it, and ``chip_smoke.py`` holds each launch against it.

The dropless top-k SwiGLU MoE (``models/moe.py::topk_moe_forward``) runs
the same kernel ragged, forward only: its routed rows sit in expert groups
padded to whole row tiles of ``tile_rows`` (64 or 128), and each row tile
reads its expert from ``tile_expert`` on the device (-1: a tile past the
routed rows, skipped). :func:`ragged_swiglu_ffn` is two launches, ``h =
silu(x w_gate_e) * (x w_up_e)`` in bf16 (the SwiGLU epilogue: ``w13``
holds each expert's gate columns, then its up columns) and ``y = h
w2_e`` in fp32; :func:`ragged_swiglu_reference` is its plain version,
fp32 products per expert. Both dispatch as op ``moe_ragged_swiglu``:
``cuda_grouped`` for bf16 CUDA problems without autograd, ``d`` a multiple
of 128 and ``F`` of 64, then ``torch_reference`` for CPU problems (and
``forced_variant``); a CUDA problem the kernels refuse raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.ops import registry

__all__ = ["grouped_ffn", "grouped_ffn_reference", "GroupedFfn", "Operand", "Gemm", "plan", "gemm",
           "gemm_reference", "split3", "split3_reference", "forward_gemms", "backward_gemms", "ffn_forward",
           "ffn_backward", "ragged_gemms", "ragged_swiglu_ffn", "ragged_swiglu_reference", "LAUNCHES",
           "RAGGED_LAUNCHES"]

# Kernel launches in this process, by kernel; each launch adds one. A
# ragged launch of moe_grouped_gemm also adds one to RAGGED_LAUNCHES.
LAUNCHES = {"moe_grouped_gemm": 0, "moe_split3": 0}
RAGGED_LAUNCHES = 0

# Layouts: (A stored (K, M), B stored (K, N), terms of A, terms of B).
FORWARD, DATA_GRAD, WEIGHT_GRAD = 0, 1, 2
LAYOUTS = {FORWARD: (False, True, 1, 1), DATA_GRAD: (False, False, 3, 1), WEIGHT_GRAD: (True, True, 1, 3)}
EPI_F32, EPI_BF16, EPI_GELU, EPI_GELU_GRAD, EPI_SWIGLU = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class Operand:
    """A bf16 operand as the kernel's tensor map reads it: ``t`` is
    (terms, rows, cols), contiguous; expert e's matrix starts
    ``e * step[0]`` rows and ``e * step[1]`` columns in."""

    t: torch.Tensor
    step: Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Gemm:
    """One launch: ``C[e] = sum_t A_t[e] @ B_t[e]`` (M x N x K) for each of
    ``experts`` experts in layout ``kind``, then epilogue ``epi`` into
    ``out`` ((terms, rows, cols); expert e's tile starts ``e * out_step[0]``
    rows and ``e * out_step[1]`` columns in). ``aux`` is the fp32
    pre-activation, (rows, cols) like one term of ``out``: written by
    ``EPI_GELU`` when given, read by ``EPI_GELU_GRAD``. A ragged launch
    (``tile_expert``: int32, one entry per row tile of ``tile_rows``) has
    ``experts`` 1 and reads B's expert per row tile. ``glu``, with
    ``EPI_SWIGLU``: B holds ``2 n`` columns per expert, the gate's and,
    ``glu`` columns on, the up projection's; ``n`` outputs."""

    kind: int
    experts: int
    m: int
    n: int
    k: int
    a: Operand
    b: Operand
    out: torch.Tensor
    out_step: Tuple[int, int]
    epi: int
    aux: Optional[torch.Tensor] = None
    tile_expert: Optional[torch.Tensor] = None
    tile_rows: int = 0
    glu: int = 0


# A tile's throughput relative to 128 x 256 when every SM is busy: smaller
# tiles load more operand bytes per product and pay the prologue and the
# epilogue more often. Measured on the H100 SXM (NVIDIA H100 80GB HBM3,
# 700 W) as tile area x waves / time over the twelve launches of the
# MegaBlocks MoE-Small and MoE-Medium FFN (E 64, C 128), relative to
# 128 x 256's, the median of each tile (the launches spread from 0.49 to
# 1.08 around it: the weight gradients favour 128 x 256 most).
TILE_RATES = {(128, 256): 1.0, (64, 256): 0.89, (128, 128): 0.89, (64, 128): 0.86}


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, experts: int, sms: int, bm_only: int = 0) -> Tuple[int, int]:
    """(BM, BN) of a launch on a card of ``sms`` streaming multiprocessors
    (one CTA each: the ring takes the shared memory): the tile with the
    highest rate times the share of its waves that is busy (the last wave's
    idle SMs counted), the wider one on a tie. BM is 64 or 128 (``bm_only``
    when given), BN 128 or 256."""
    best = None
    for (bm, bn), rate in TILE_RATES.items():
        if m % bm or n % bn or (bm_only and bm != bm_only):
            continue
        tiles = experts * (m // bm) * (n // bn)
        key = (rate * tiles / (-(-tiles // sms) * sms), bn)
        if best is None or key > best[0]:
            best = (key, (bm, bn))
    if best is None:
        raise ValueError(f"moe_grouped_gemm: M {m} must be a multiple of 64 and N {n} of 128")
    return best[1]


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _lib():
    lib = _build.load("moe_grouped")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_grouped_gemm.argtypes = ([i32] * 7 + [ptr] + [i64] * 3 + [i32] * 2 + [ptr] + [i64] * 3 + [i32] * 2
                                     + [ptr] + [i64] * 3 + [ptr, i32, ptr, i32, ptr])
    lib.moe_split3.argtypes = [ptr, ptr, i64, ptr]
    for fn in (lib.moe_grouped_gemm, lib.moe_split3):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(kernel: str, err: int, ragged: bool = False) -> None:
    global RAGGED_LAUNCHES
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1
    RAGGED_LAUNCHES += int(ragged)


def _within(name: str, t: torch.Tensor, step, experts: int, rows: int, cols: int) -> None:
    if (experts - 1) * step[0] + rows > t.shape[-2] or (experts - 1) * step[1] + cols > t.shape[-1]:
        raise ValueError(f"moe_grouped_gemm: {experts} experts of {rows} x {cols} at steps {tuple(step)} "
                         f"do not fit {name} of shape {tuple(t.shape)}")


def _check(g: Gemm) -> None:
    a_mn, b_mn, terms_a, terms_b = LAYOUTS[g.kind]
    for name, t in (("a", g.a.t), ("b", g.b.t), ("out", g.out), ("aux", g.aux)):
        if t is None:
            continue
        if not t.is_cuda or t.device != g.out.device:
            raise ValueError(f"moe_grouped_gemm needs CUDA tensors on one device; {name} is on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_grouped_gemm: {name} must be contiguous and 16-byte aligned")
    for name, op, terms in (("a", g.a, terms_a), ("b", g.b, terms_b)):
        if op.t.dtype != torch.bfloat16 or op.t.ndim != 3 or op.t.shape[0] != terms:
            raise ValueError(f"moe_grouped_gemm: {name} must be bf16 ({terms}, rows, cols), got "
                             f"{op.t.dtype} {tuple(op.t.shape)}")
        if op.t.shape[-1] % 8:
            raise ValueError(f"moe_grouped_gemm: {name}'s rows of {op.t.shape[-1]} elements are not 16-byte "
                             "multiples (TMA)")
    if (g.epi == EPI_SWIGLU) != (g.glu > 0) or (g.glu and (g.kind != FORWARD or g.glu < g.n or g.glu % 64)):
        raise ValueError(f"moe_grouped_gemm: the SwiGLU epilogue goes with a forward launch and a glu offset of "
                         f"at least n, a multiple of 64 (epi {g.epi}, glu {g.glu}, n {g.n})")
    b_cols = g.glu + g.n if g.glu else g.n
    if g.tile_expert is not None:
        te = g.tile_expert
        if g.kind != FORWARD or g.experts != 1 or g.tile_rows not in (64, 128) or g.m % g.tile_rows:
            raise ValueError(f"moe_grouped_gemm: a ragged launch is a forward one with experts 1 and M {g.m} in "
                             f"row tiles of 64 or 128, got kind {g.kind}, experts {g.experts}, tile_rows "
                             f"{g.tile_rows}")
        if te.dtype != torch.int32 or te.device != g.out.device or not te.is_contiguous() \
                or tuple(te.shape) != (g.m // g.tile_rows,):
            raise ValueError(f"moe_grouped_gemm: tile_expert must be contiguous int32 ({g.m // g.tile_rows},) on "
                             f"{g.out.device}")
    # A ragged launch's experts of B are device ids, not read here: one must fit.
    _within("b", g.b.t, g.b.step, g.experts, *((g.k, b_cols) if b_mn else (b_cols, g.k)))
    _within("a", g.a.t, g.a.step, g.experts, *((g.k, g.m) if a_mn else (g.m, g.k)))
    _within("out", g.out, g.out_step, g.experts, g.m, g.n)
    want = (torch.float32 if g.epi == EPI_F32 else torch.bfloat16, 3 if g.epi == EPI_GELU_GRAD else 1)
    if (g.out.dtype, g.out.shape[0]) != want or g.out.ndim != 3:
        raise ValueError(f"moe_grouped_gemm: epilogue {g.epi} writes {want[0]} ({want[1]}, rows, cols), got "
                         f"{g.out.dtype} {tuple(g.out.shape)}")
    if g.epi == EPI_GELU_GRAD and g.aux is None:
        raise ValueError("moe_grouped_gemm: the gelu' epilogue reads the pre-activation (aux)")
    if g.aux is not None and (g.aux.dtype != torch.float32 or g.aux.shape != g.out.shape[1:]):
        raise ValueError(f"moe_grouped_gemm: aux must be fp32 {tuple(g.out.shape[1:])}")


def gemm(g: Gemm, tile: Optional[Tuple[int, int]] = None) -> None:
    """Launch ``moe_grouped_gemm`` for ``g`` in :func:`plan`'s tile, or in
    ``tile`` (BM, BN) when given; raises ``ValueError`` for what the kernel
    does not take."""
    _check(g)
    width = 2 * g.n if g.glu else g.n  # the columns of B a row tile multiplies
    bm, bn = tile or plan(g.m, width, g.experts, _sms(g.out.device), g.tile_rows)
    if bm not in (64, 128) or bn not in (128, 256) or g.m % bm or width % bn or g.k % 64 \
            or (g.tile_rows and bm != g.tile_rows):
        raise ValueError(f"moe_grouped_gemm: no {bm} x {bn} tiling of M {g.m}, N {width}, K {g.k}")
    rows, cols = g.out.shape[1:]
    ragged = g.tile_expert is not None
    err = _lib().moe_grouped_gemm(
        g.kind, bm, bn, g.experts, g.m, g.n, g.k,
        g.a.t.data_ptr(), *g.a.t.shape, *g.a.step, g.b.t.data_ptr(), *g.b.t.shape, *g.b.step,
        g.out.data_ptr(), cols, g.out_step[0] * cols + g.out_step[1], rows * cols,
        None if g.aux is None else g.aux.data_ptr(), g.epi,
        g.tile_expert.data_ptr() if ragged else None, g.glu,
        torch.cuda.current_stream(g.out.device).cuda_stream,
    )
    _raise_on("moe_grouped_gemm", err, ragged)


def _expert_matrix(op: Operand, e: int, term: int, rows: int, cols: int) -> torch.Tensor:
    r0, c0 = e * op.step[0], e * op.step[1]
    return op.t[term, r0:r0 + rows, c0:c0 + cols].float()


def split3_reference(g: torch.Tensor) -> torch.Tensor:
    """(3, *g.shape) bf16 whose sum is the fp32 ``g`` exactly (for |g| from
    2^-110, where the third term is still a normal number, to bf16's largest
    finite value): each term rounds what the ones before left to bf16's 8
    significand bits."""
    hi = g.to(torch.bfloat16)
    r = g - hi.float()
    mid = r.to(torch.bfloat16)
    return torch.stack([hi, mid, (r - mid.float()).to(torch.bfloat16)])


def _ragged_reference(g: Gemm) -> None:
    """gemm_reference of a ragged forward launch: each row tile against
    its expert's B (tiles of expert -1 untouched), fp32 products, the
    epilogue in fp32."""
    width = g.glu + g.n if g.glu else g.n
    for t, e in enumerate(g.tile_expert.tolist()):
        if e < 0:
            continue
        rows = slice(t * g.tile_rows, (t + 1) * g.tile_rows)
        a = g.a.t[0, rows, :g.k].float()
        r0, c0 = e * g.b.step[0], e * g.b.step[1]
        acc = a @ g.b.t[0, r0:r0 + g.k, c0:c0 + width].float()
        if g.epi == EPI_SWIGLU:
            acc = F.silu(acc[:, :g.n]) * acc[:, g.glu:g.glu + g.n]
        g.out[0, rows, :g.n] = acc.to(g.out.dtype)


def gemm_reference(g: Gemm) -> None:
    """The plain version of one launch, on any device: each expert's
    operands sliced as the tensor maps read them, fp32 products, the
    epilogue in fp32."""
    if g.tile_expert is not None:
        return _ragged_reference(g)
    a_mn, b_mn, terms_a, terms_b = LAYOUTS[g.kind]
    for e in range(g.experts):
        acc = 0.0
        for t in range(terms_a * terms_b):
            a = _expert_matrix(g.a, e, min(t, terms_a - 1), *((g.k, g.m) if a_mn else (g.m, g.k)))
            b = _expert_matrix(g.b, e, min(t, terms_b - 1), *((g.k, g.n) if b_mn else (g.n, g.k)))
            acc = acc + (a.T if a_mn else a) @ (b if b_mn else b.T)
        r0, c0 = e * g.out_step[0], e * g.out_step[1]
        tile = (slice(r0, r0 + g.m), slice(c0, c0 + g.n))
        if g.epi == EPI_GELU_GRAD:
            g_pre = torch.ops.aten.gelu_backward(acc.to(torch.bfloat16).float(), g.aux[tile], approximate="tanh")
            g.out[(slice(None),) + tile] = split3_reference(g_pre)
            continue
        if g.epi == EPI_GELU:
            if g.aux is not None:
                g.aux[tile] = acc
            acc = F.gelu(acc, approximate="tanh")
        g.out[0][tile] = acc.to(g.out.dtype)


def split3(g: torch.Tensor) -> torch.Tensor:
    """The kernel's :func:`split3_reference` of a contiguous fp32 CUDA
    tensor whose size is a multiple of 4."""
    if not g.is_cuda or g.dtype != torch.float32 or not g.is_contiguous() or g.numel() % 4 or g.data_ptr() % 16:
        raise ValueError(f"moe_split3 takes contiguous 16-byte aligned fp32 CUDA tensors of 4k elements, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    out = torch.empty((3,) + tuple(g.shape), dtype=torch.bfloat16, device=g.device)
    _raise_on("moe_split3", _lib().moe_split3(g.data_ptr(), out.data_ptr(), g.numel(),
                                               torch.cuda.current_stream(g.device).cuda_stream))
    return out


def _dims(x: torch.Tensor, w1: torch.Tensor, experts: int) -> Tuple[int, int, int]:
    """(C, d, F) of the problem."""
    return x.shape[0] // experts, x.shape[1], w1.shape[1] // experts


def forward_gemms(x, w1, w2, experts: int, h, y, pre=None) -> list:
    """The forward's launches: h = gelu(x w1_e) (bf16; fp32 ``pre`` when
    given), then y = h w2_e (fp32)."""
    c, d, f = _dims(x, w1, experts)
    return [
        Gemm(FORWARD, experts, c, f, d, Operand(x[None], (c, 0)), Operand(w1[None], (0, f)), h[None], (c, 0),
             EPI_GELU, pre),
        Gemm(FORWARD, experts, c, d, f, Operand(h[None], (c, 0)), Operand(w2[None], (f, 0)), y[None], (c, 0),
             EPI_F32),
    ]


def backward_gemms(gy3, x, w1, w2, h, pre, gp3, experts: int, dx=None, dw1=None, dw2=None) -> list:
    """The backward's launches on the three-term split ``gy3`` of g_y: g_pre
    = bf16(g_y w2_e^T) * gelu'(pre) into its split ``gp3``, then whichever
    of dw2 = h_e^T g_y, dx = g_pre w1_e^T and dw1 = x_e^T g_pre is given an
    output (bf16, or fp32 with the fp32 epilogue)."""
    c, d, f = _dims(x, w1, experts)
    epi = lambda out: EPI_F32 if out.dtype == torch.float32 else EPI_BF16  # noqa: E731
    gemms = [Gemm(DATA_GRAD, experts, c, f, d, Operand(gy3, (c, 0)), Operand(w2[None], (f, 0)), gp3, (c, 0),
                  EPI_GELU_GRAD, pre)]
    if dw2 is not None:
        gemms.append(Gemm(WEIGHT_GRAD, experts, f, d, c, Operand(h[None], (c, 0)), Operand(gy3, (c, 0)),
                          dw2[None], (f, 0), epi(dw2)))
    if dx is not None:
        gemms.append(Gemm(DATA_GRAD, experts, c, d, f, Operand(gp3, (c, 0)), Operand(w1[None], (0, f)),
                          dx[None], (c, 0), epi(dx)))
    if dw1 is not None:
        gemms.append(Gemm(WEIGHT_GRAD, experts, d, f, c, Operand(x[None], (c, 0)), Operand(gp3, (c, 0)),
                          dw1[None], (0, f), epi(dw1)))
    return gemms


def ffn_forward(x, w1, w2, experts: int, *, save_pre: bool, run: Callable = gemm):
    """(y fp32, h bf16, pre fp32 or None) through ``run`` (:func:`gemm` or
    :func:`gemm_reference`)."""
    _, d, f = _dims(x, w1, experts)
    h = torch.empty((x.shape[0], f), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((x.shape[0], d), dtype=torch.float32, device=x.device)
    pre = torch.empty((x.shape[0], f), dtype=torch.float32, device=x.device) if save_pre else None
    for g in forward_gemms(x, w1, w2, experts, h, y, pre):
        run(g)
    return y, h, pre


def ffn_backward(g_y, x, w1, w2, h, pre, experts: int, *, needs=(True, True, True),
                 grad_dtype=torch.bfloat16, run: Callable = gemm, split: Callable = split3):
    """(dx, dw1, dw2) for the fp32 cotangent ``g_y`` of y (None where
    ``needs`` says no), in ``grad_dtype``."""
    f = _dims(x, w1, experts)[2]
    new = lambda shape: torch.empty(shape, dtype=grad_dtype, device=x.device)  # noqa: E731
    dx = new(x.shape) if needs[0] else None
    dw1 = new(w1.shape) if needs[1] else None
    dw2 = new(w2.shape) if needs[2] else None
    gy3 = split(g_y.float().contiguous())
    gp3 = torch.empty((3, x.shape[0], f), dtype=torch.bfloat16, device=x.device)
    for g in backward_gemms(gy3, x, w1, w2, h, pre, gp3, experts, dx, dw1, dw2):
        run(g)
    return dx, dw1, dw2


class GroupedFfn(torch.autograd.Function):
    """The grouped FFN through ``run`` and ``split`` (the kernels, or their
    plain versions in the CPU tests). Saves x, w1, w2, h and the fp32
    pre-activation (E C F fp32) when ``save``."""

    @staticmethod
    def forward(ctx, x, w1, w2, experts, save, run, split):
        y, h, pre = ffn_forward(x, w1, w2, experts, save_pre=save, run=run)
        if save:
            ctx.save_for_backward(x, w1, w2, h, pre)
        ctx.meta = (experts, run, split)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        experts, run, split = ctx.meta
        x, w1, w2, h, pre = ctx.saved_tensors
        grads = ffn_backward(g, x, w1, w2, h, pre, experts, needs=ctx.needs_input_grad[:3], run=run, split=split)
        return (*grads, None, None, None, None)


def grouped_ffn_reference(x, w1, w2, experts: int) -> torch.Tensor:
    """The plain version: fp32 ``bmm`` on fp32 copies of the operands (y,
    fp32, (E * C, d)); h is rounded to x's dtype as JAX rounds it."""
    c, d, f = _dims(x, w1, experts)
    xg = x.reshape(experts, c, d).float()
    w1g = w1.reshape(d, experts, f).permute(1, 0, 2).float()  # (E, d, F)
    w2g = w2.reshape(experts, f, d).float()
    h = F.gelu(torch.bmm(xg, w1g), approximate="tanh").to(x.dtype)
    return torch.bmm(h.float(), w2g).reshape(experts * c, d)


def grouped_ffn(x, w1, w2, experts: int) -> torch.Tensor:
    """The kernels (an autograd Function; the fp32 pre-activation is kept
    only when a gradient is wanted)."""
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w2))
    return GroupedFfn.apply(x, w1, w2, experts, save, gemm, split3)


def _cuda_can(x, w1, w2, experts, **_) -> bool:
    """bf16 CUDA operands of the layout, d and F multiples of 128, C of 64."""
    if not (x.is_cuda and w1.is_cuda and w2.is_cuda) or {x.dtype, w1.dtype, w2.dtype} != {torch.bfloat16}:
        return False
    if x.ndim != 2 or x.shape[0] % experts:
        return False
    c, d, f = _dims(x, w1, experts)
    return (c % 64 == 0 and d % 128 == 0 and f % 128 == 0 and tuple(w1.shape) == (d, experts * f)
            and tuple(w2.shape) == (experts * f, d))


registry.register("moe_grouped_ffn", "cuda_grouped", _cuda_can, grouped_ffn)
registry.register("moe_grouped_ffn", "torch_reference", lambda *args, **kw: True, grouped_ffn_reference)


# ------------------------------------------- the ragged SwiGLU FFN (top-k) --
def ragged_gemms(x, w13, w2, experts: int, tile_expert, tile_rows: int, h, y) -> list:
    """The ragged SwiGLU FFN's two launches: h = silu(x w_gate_e) * (x
    w_up_e) in bf16, then y = h w2_e in fp32, expert e of each row tile
    from ``tile_expert``. x (rows, d); w13 (d, E * 2F), expert e's gate
    columns then its up columns; w2 (E * F, d)."""
    rows, d = x.shape
    f = w2.shape[0] // experts
    return [
        Gemm(FORWARD, 1, rows, f, d, Operand(x[None], (0, 0)), Operand(w13[None], (0, 2 * f)), h[None], (0, 0),
             EPI_SWIGLU, tile_expert=tile_expert, tile_rows=tile_rows, glu=f),
        Gemm(FORWARD, 1, rows, d, f, Operand(h[None], (0, 0)), Operand(w2[None], (f, 0)), y[None], (0, 0),
             EPI_F32, tile_expert=tile_expert, tile_rows=tile_rows),
    ]


def ragged_swiglu_ffn(x, w13, w2, experts: int, tile_expert, tile_rows: int, *, run: Callable = gemm):
    """y (rows, d) fp32 of the ragged SwiGLU FFN through ``run`` (the
    kernel, or :func:`gemm_reference`); the rows of tiles with expert -1
    are left unwritten."""
    h = torch.empty((x.shape[0], w2.shape[0] // experts), dtype=torch.bfloat16, device=x.device)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for g in ragged_gemms(x, w13, w2, experts, tile_expert, tile_rows, h, y):
        run(g)
    return y


def ragged_swiglu_reference(x, w13, w2, experts: int, tile_expert, tile_rows: int) -> torch.Tensor:
    """The plain version: per expert present, fp32 products on fp32 copies
    of its rows and weights, h rounded to x's dtype; rows of tiles with
    expert -1 are zero. Reads the experts present back to the host."""
    d, f = x.shape[1], w2.shape[0] // experts
    row_expert = tile_expert.long().repeat_interleave(tile_rows)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in torch.unique(row_expert[row_expert >= 0]).tolist():
        idx = torch.nonzero(row_expert == e).squeeze(1)
        gu = x[idx].float() @ w13[:, e * 2 * f:(e + 1) * 2 * f].float()
        h = (F.silu(gu[:, :f]) * gu[:, f:]).to(x.dtype)
        y[idx] = h.float() @ w2[e * f:(e + 1) * f].float()
    return y


def _ragged_cuda_can(x, w13, w2, experts, tile_expert, tile_rows, **_) -> bool:
    """bf16 CUDA operands with no gradient wanted (forward only), d a
    multiple of 128, F of 64, rows in whole tiles of 64 or 128."""
    ts = (x, w13, w2, tile_expert)
    if not all(t.is_cuda for t in ts) or {x.dtype, w13.dtype, w2.dtype} != {torch.bfloat16}:
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts[:3]):
        return False
    d, f = x.shape[1], w2.shape[0] // experts
    return (x.ndim == 2 and d % 128 == 0 and f % 64 == 0 and tile_rows in (64, 128) and x.shape[0] % tile_rows == 0
            and tuple(w13.shape) == (d, 2 * experts * f) and tuple(w2.shape) == (experts * f, d))


registry.register("moe_ragged_swiglu", "cuda_grouped", _ragged_cuda_can, ragged_swiglu_ffn)
def _ragged_plain_can(x, w13, w2, *_, **__) -> bool:
    """CPU operands only: on the card a problem the kernels refuse (a
    gradient wanted, other dtypes or widths) raises, rather than running
    the per-expert loop that reads the experts back to the host; the
    plain version runs there only under ``forced_variant``."""
    return not any(t.is_cuda for t in (x, w13, w2))


registry.register("moe_ragged_swiglu", "torch_reference", _ragged_plain_can, ragged_swiglu_reference)
