"""Random sparse-matrix generators and the fp64 oracle.

Port of ``sputnik_tpu/utils/testing.py``. The generators draw from a numpy
``Generator`` in exactly the same order as the JAX package's, so the same
seed gives both packages identical topologies and values.

:func:`run_spmd` runs a function on every rank of a gloo process group on
the CPU (the JAX package's tests use an 8-device CPU mesh instead), and
:func:`parallel_cases` is the rank body the port's distributed tests hand
it.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix, CsrMatrix
from sputnik_tpu_torch.utils.device import resolve_device

__all__ = [
    "random_csr_topology", "random_csr", "random_bsr", "random_bsr_topology",
    "bsr_from_blocks", "dense_oracle_matmul", "bf16_ulp_excess", "ATOL", "run_spmd", "parallel_cases",
    "moe_grouped_errors", "moe_grouped_inputs", "moe_grouped_launches", "moe_grouped_launch_error", "rel_max_error",
]

ATOL = 5e-2  # the reference's NanSensitiveFloatNear tolerance


def _random_topology(
    rng: np.random.Generator,
    rows: int,
    cols: int,
    nnz: int,
    *,
    pad_rows_to: int = 1,
    perfect_uniform: bool = False,
    unordered: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(offsets, indices, is_pad) of a random CSR pattern; padding entries
    duplicate a valid column id in their row and must hold zeros."""
    if perfect_uniform:
        if nnz % rows:
            raise ValueError("perfect uniform needs nnz % rows == 0")
        per_row = [nnz // rows] * rows
    else:
        flat = rng.choice(rows * cols, size=nnz, replace=False)
        per_row = np.bincount(flat // cols, minlength=rows).tolist()

    offsets, indices, pad_mask = [0], [], []
    for r in range(rows):
        k = per_row[r]
        cidx = np.sort(rng.choice(cols, size=k, replace=False))
        pad = (-k) % pad_rows_to if pad_rows_to > 1 else 0
        if k == 0 and pad:
            cidx = np.zeros(pad, np.int64)
            pm = np.ones(pad, bool)
        else:
            pm = np.zeros(k, bool)
            if pad:
                cidx = np.concatenate([cidx, np.full(pad, cidx[-1] if k else 0)])
                pm = np.concatenate([pm, np.ones(pad, bool)])
        if unordered and len(cidx) > 1:
            perm = rng.permutation(len(cidx))
            cidx, pm = cidx[perm], pm[perm]
        indices.append(cidx)
        pad_mask.append(pm)
        offsets.append(offsets[-1] + len(cidx))
    offsets = np.asarray(offsets, np.int32)
    indices = np.concatenate(indices).astype(np.int32) if indices else np.zeros(0, np.int32)
    pad_mask = np.concatenate(pad_mask) if pad_mask else np.zeros(0, bool)
    return offsets, indices, pad_mask


def bf16_ulp_excess(got: torch.Tensor, want: torch.Tensor, floor: float = 2.0 ** -8) -> float:
    """The largest ``|got - want| / ulp`` of two bf16 results, where ``ulp``
    is one bf16 ulp at ``max(|got|, |want|, floor * max|want|)``: at most 1
    when every element is within one ulp. The floor covers elements near
    zero formed by cancellation, where two fp32 sums taken in different
    orders may differ by more than a bf16 ulp of the element itself."""
    if not got.numel():
        return 0.0
    got, want = got.float(), want.float()
    mag = torch.maximum(torch.maximum(got.abs(), want.abs()), floor * want.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=torch.finfo(torch.float32).tiny))) - 7)
    return float(((got - want).abs() / ulp).max())


def moe_grouped_errors(x, w1, w2, g_y, experts: int) -> dict:
    """The grouped MoE FFN's kernels (``kernels/moe_grouped.py``) against
    their plain version on the card, for capacity slots ``x`` (E * C, d,
    bf16), weights ``w1`` / ``w2`` and the fp32 cotangent ``g_y`` of y. Each
    entry is max |got - want| / max |want| unless named otherwise:

    * ``y``, ``dx``, ``dw1``, ``dw2``: through the autograd Function against
      autograd of the fp32 ``bmm`` path. Both round h and dh to bf16, and an
      element whose fp32 value lies that close to a rounding boundary may
      round the other way on the other side: one bf16 ulp of one term,
      which in dw1 and dw2 (sums of C = 128 terms) is up to 2^-8 of the
      result's largest element;
    * ``split``: 0 when the three-term split of ``g_y`` sums to it exactly;
    * ``prod_dw2``, ``prod_dx``, ``prod_dw1``: each backward product with an
      fp32 output against fp32 ``bmm`` (TF32 off) of the same operands (the
      kernel's own g_pre for dx and dw1): fp32 summation order alone when
      the split is exact, and the tensor cores' fp32 accumulation, which
      rounds toward zero (against an fp64 oracle on the H100 a mean
      relative bias of -3e-9 x K, -1.2e-5 at K = 4096, where fp32 ``bmm``
      shows 1e-8);
    * ``prod_g_pre``: the fused dh -> gelu' product against
      ``gelu_backward(bf16(g_y w2^T), pre)``, as max of |diff| / (2^-7 |want|
      + 1e-5 max |want|): dh is rounded to bf16 on both sides, and a sum
      taken in another order may round to the neighbouring bf16 value.
    """
    from sputnik_tpu_torch.kernels import moe_grouped as mg

    out = {}
    results = []
    for fn in (mg.grouped_ffn, mg.grouped_ffn_reference):
        leaves = [t.detach().clone().requires_grad_() for t in (x, w1, w2)]
        y = fn(*leaves, experts)
        y.backward(g_y)
        results.append([y.detach()] + [t.grad for t in leaves])
    for name, got, want in zip(("y", "dx", "dw1", "dw2"), *results):
        out[name] = rel_max_error(got, want)

    c, d, f = x.shape[0] // experts, x.shape[1], w1.shape[1] // experts
    with torch.no_grad():
        _, h, pre = mg.ffn_forward(x, w1, w2, experts, save_pre=True)
        gy3 = mg.split3(g_y.contiguous())
        out["split"] = 0.0 if torch.equal(gy3.float().sum(0), g_y) else float("inf")
        dx, dw1, dw2 = mg.ffn_backward(g_y, x, w1, w2, h, pre, experts, grad_dtype=torch.float32)
        gp3 = torch.empty((3, x.shape[0], f), dtype=torch.bfloat16, device=x.device)
        mg.gemm(mg.backward_gemms(gy3, x, w1, w2, h, pre, gp3, experts)[0])
        g_pre = gp3.float().sum(0)
        gy = g_y.reshape(experts, c, d)
        w1e = w1.float().reshape(d, experts, f).permute(1, 0, 2)  # (E, d, F)
        w2e = w2.float().reshape(experts, f, d)
        dh = torch.bmm(gy, w2e.transpose(1, 2)).reshape(-1, f)
        want = torch.ops.aten.gelu_backward(dh.to(torch.bfloat16).float(), pre, approximate="tanh")
        scale = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
        out["prod_g_pre"] = float(((g_pre - want).abs() / scale.clamp(min=torch.finfo(torch.float32).tiny)).max())
        gp = g_pre.reshape(experts, c, f)
        wants = {
            "prod_dw2": torch.bmm(h.float().reshape(experts, c, f).transpose(1, 2), gy).reshape(-1, d),
            "prod_dx": torch.bmm(gp, w1e.transpose(1, 2)).reshape(-1, d),
            "prod_dw1": torch.bmm(x.float().reshape(experts, c, d).transpose(1, 2), gp).permute(1, 0, 2)
            .reshape(d, -1),
        }
        for name, got in (("prod_dw2", dw2), ("prod_dx", dx), ("prod_dw1", dw1)):
            out[name] = rel_max_error(got, wants[name])
    return out


def rel_max_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in fp32."""
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


def moe_grouped_inputs(gen: torch.Generator, e: int, c: int, d: int, f: int):
    """(x, w1, w2, g_y) of the grouped MoE FFN on ``gen``'s device at the
    LM's scales: the last quarter of every expert's ``c`` slots empty
    (dropped or never filled), expert e / 2 with no token at all, and no
    cotangent on an empty slot; x, w1, w2 bf16, g_y fp32."""
    dev = gen.device
    x = torch.randn((e, c, d), generator=gen, device=dev)
    x[:, c - c // 4:] = 0
    x[e // 2] = 0
    w1 = (torch.randn((d, e * f), generator=gen, device=dev) * d ** -0.5).to(torch.bfloat16)
    w2 = (torch.randn((e * f, d), generator=gen, device=dev) * f ** -0.5).to(torch.bfloat16)
    g_y = torch.randn((e, c, d), generator=gen, device=dev) * 1e-3 * (x.abs().amax(-1, keepdim=True) > 0)
    return x.reshape(e * c, d).to(torch.bfloat16), w1, w2, g_y.reshape(e * c, d)


def moe_grouped_launches(gen: torch.Generator, e: int = 3, c: int = 128, d: int = 256, f: int = 512) -> list:
    """[(name, Gemm)]: every launch of the grouped MoE FFN's forward and
    backward (the three layouts, the four epilogues) at E ``e``, C ``c``,
    d ``d``, F ``f`` on :func:`moe_grouped_inputs` from ``gen``, each with
    fresh outputs and the operands the kernels computed before it."""
    from sputnik_tpu_torch.kernels import moe_grouped as mg

    x, w1, w2, g_y = moe_grouped_inputs(gen, e, c, d, f)
    _, h, pre = mg.ffn_forward(x, w1, w2, e, save_pre=True)
    gy3 = mg.split3(g_y)
    gp3 = torch.empty((3, x.shape[0], f), dtype=torch.bfloat16, device=x.device)
    mg.gemm(mg.backward_gemms(gy3, x, w1, w2, h, pre, gp3, e)[0])
    grads = [torch.empty(t.shape, dtype=torch.bfloat16, device=x.device) for t in (x, w1, w2)]
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    # h and pre are the first launch's outputs and the later ones' operands:
    # moe_grouped_launch_error gives each launch fresh outputs, so the
    # operands keep the values computed above.
    gemms = (mg.forward_gemms(x, w1, w2, e, h, y, pre)
             + mg.backward_gemms(gy3, x, w1, w2, h, pre, gp3, e, *grads))
    return list(zip(("h (gelu)", "y (fp32)", "g_pre (gelu')", "dw2", "dx", "dw1"), gemms))


def moe_grouped_launch_error(g, tile, absolute: bool = False) -> float:
    """One launch of the grouped MoE kernel (a ``kernels.moe_grouped.Gemm``)
    in ``tile`` against ``gemm_reference`` on the same operands: fp32
    outputs as max |diff| / max |want|, bf16 ones in :func:`bf16_ulp_excess`,
    the gelu' epilogue's three terms summed as in
    :func:`moe_grouped_errors`'s ``prod_g_pre``; with ``absolute``, max
    |diff| of every output (the three terms summed). Outputs start as NaN,
    so an element the kernel leaves unwritten shows; raises ``ValueError``
    where ``gemm_reference``'s own output is not finite (an operand that was
    never computed, a fault of the caller and not of the kernel)."""
    import dataclasses
    import functools

    from sputnik_tpu_torch.kernels import moe_grouped as mg

    outs = [torch.full_like(g.out, float("nan")) for _ in range(2)]
    auxes = [None if g.aux is None or g.epi == mg.EPI_GELU_GRAD else torch.full_like(g.aux, float("nan"))
             for _ in range(2)]
    for out, aux, run in zip(outs, auxes, (functools.partial(mg.gemm, tile=tile), mg.gemm_reference)):
        run(dataclasses.replace(g, out=out, aux=g.aux if aux is None else aux))
    got, want = outs
    if g.epi == mg.EPI_GELU_GRAD:
        got, want = got.float().sum(0), want.float().sum(0)
    if not bool(torch.isfinite(want.float()).all()):
        raise ValueError("moe_grouped_launch_error: the plain version's output is not finite; an operand is")
    if absolute:
        err = float((got.float() - want.float()).abs().max())
        return err if auxes[0] is None else max(err, float((auxes[0] - auxes[1]).abs().max()))
    if g.epi == mg.EPI_GELU_GRAD:
        scale = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
        return float(((got - want).abs() / scale).max())
    err = rel_max_error(got, want) if got.dtype == torch.float32 else bf16_ulp_excess(got, want)
    if auxes[0] is not None:
        err = max(err, rel_max_error(auxes[0], auxes[1]))
    return err


def random_csr_topology(rng, rows, cols, nnz, **kw):
    offsets, indices, _ = _random_topology(rng, rows, cols, nnz, **kw)
    return offsets, indices


def random_csr(
    rng: np.random.Generator,
    rows: int,
    cols: int,
    nnz: int,
    *,
    dtype: torch.dtype = torch.float32,
    device=None,
    pad_rows_to: int = 1,
    unordered: bool = False,
) -> CsrMatrix:
    """Random CSR with ``nnz`` uniformly placed nonzeros (padding entries
    hold zeros), on ``device`` (``None``: the card)."""
    offsets, indices, pad = _random_topology(rng, rows, cols, nnz, pad_rows_to=pad_rows_to, unordered=unordered)
    values = rng.standard_normal(len(indices)).astype(np.float32)
    values[pad] = 0.0
    values = torch.as_tensor(values).to(device=resolve_device(device), dtype=dtype)
    return CsrMatrix.create(values, indices, offsets, (rows, cols))


def random_bsr_topology(rng, rows, cols, nnz_blocks, block_size, *, pad_rows_to=1, unordered=False):
    return _random_topology(
        rng, rows // block_size, cols // block_size, nnz_blocks,
        pad_rows_to=pad_rows_to, unordered=unordered,
    )


def random_bsr(
    rng: np.random.Generator,
    rows: int,
    cols: int,
    nnz: int,
    block_size: int,
    *,
    dtype: torch.dtype = torch.float32,
    device=None,
    pad_rows_to: int = 1,
    unordered: bool = False,
    perfect_uniform: bool = False,
) -> BlockSparseMatrix:
    """Random BSR with ``nnz`` nonzero elements rounded up to whole blocks,
    on ``device`` (``None``: the card)."""
    if rows % block_size or cols % block_size:
        raise ValueError("shape must be divisible by block_size")
    bs = block_size
    nnz_blocks = min(max(-(-nnz // (bs * bs)), 0), (rows // bs) * (cols // bs))
    if perfect_uniform:
        br = rows // bs
        nnz_blocks = min(-(-nnz_blocks // br) * br, br * (cols // bs))
        offsets, indices, pad = _random_topology(
            rng, br, cols // bs, nnz_blocks, perfect_uniform=True, unordered=unordered
        )
    else:
        offsets, indices, pad = random_bsr_topology(
            rng, rows, cols, nnz_blocks, bs, pad_rows_to=pad_rows_to, unordered=unordered
        )
    data = rng.standard_normal((len(indices), bs, bs)).astype(np.float32)
    data[pad] = 0.0
    return BlockSparseMatrix.create(
        torch.as_tensor(data).to(device=resolve_device(device), dtype=dtype), offsets, indices, (rows, cols)
    )


def bsr_from_blocks(rows, cols, block_rows, block_cols, blocks, *, dtype=torch.float32, device=None):
    """Hand-built BSR from (block_row, block_col, block) triples; ``block_rows``
    must be non-decreasing (CSR block order). ``device=None``: the card."""
    blocks = np.asarray(blocks, np.float32)
    bs = blocks.shape[-1]
    counts = np.bincount(np.asarray(block_rows, np.int64), minlength=rows // bs)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BlockSparseMatrix.create(
        torch.as_tensor(blocks).to(device=resolve_device(device), dtype=dtype),
        offsets,
        np.asarray(block_cols, np.int32),
        (rows, cols),
    )


def dense_oracle_matmul(a, b, *, transpose_a: bool = False, transpose_b: bool = False) -> np.ndarray:
    """fp64-accumulated dense matmul, the golden model."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    if transpose_a:
        a64 = a64.T
    if transpose_b:
        b64 = b64.T
    return a64 @ b64


# ------------------------------------------------------ process groups --
def _spmd_entry(rank: int, world: int, tmp: str, fn: Callable, args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # the tests hold a one-process drive to these results bitwise
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                            world_size=world)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_spmd(fn: Callable, world_size: int, *args) -> list:
    """``fn(*args)`` on each rank of a ``world_size``-rank gloo group on the
    CPU, one spawned process per rank, joined through a file store in a
    temporary directory (no TCP port); returns each rank's result, in rank
    order. Spawning pickles ``fn`` by reference: it must be a top-level
    function of an importable module (not of a test file). Results should
    be numpy or plain Python."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="sputnik_spmd_")
    try:
        mp.start_processes(_spmd_entry, args=(world_size, tmp, fn, args), nprocs=world_size, join=True,
                           start_method="spawn")
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _to_numpy(x):
    from sputnik_tpu_torch.formats import BlockSparseMatrix

    if isinstance(x, BlockSparseMatrix):
        x = x.data
    return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()


def parallel_cases(cases: Sequence[tuple]) -> list:
    """Rank body for :func:`run_spmd`: run each ``(op, args, kwargs,
    sharded)`` on this rank, where ``op`` names a function of
    ``sputnik_tpu_torch.parallel`` and ``sharded`` the positions of ``args``
    that hold a whole dense operand, of which this rank takes its row band
    (``chunk(world)[rank]``). Returns each case's local output as numpy (a
    sparse output's block data), or ``("raised", type name, message)``."""
    import torch.distributed as dist

    from sputnik_tpu_torch import parallel

    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for op, args, kwargs, sharded in cases:
        args = [x.chunk(world)[rank].contiguous() if i in sharded else x for i, x in enumerate(args)]
        try:
            out.append(_to_numpy(getattr(parallel, op)(*args, **kwargs)))
        except ValueError as e:
            out.append(("raised", type(e).__name__, str(e)))
    return out
