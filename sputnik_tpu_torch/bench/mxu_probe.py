"""Dense matrix-unit probes on the card (``sputnik_tpu/bench/mxu_probe.py``),
on the three kernels of ``csrc/mxu_probe.cu``.

Every probe computes C = A @ B from bf16 or fp32 operands with an fp32
accumulator and writes C in the operand dtype. A is (M, K), B (K, N).

* :func:`dense_stream` (``mxu_dense_stream``): the stream DSD's structure
  without sparsity. One CTA per 128-row x ``n_tile`` output; its fp32
  accumulator tile lives in shared memory and is revisited once per
  ``depth`` of contraction, as the TPU revisits ``acc_ref`` once per grid
  step: ``+=`` (``accumulate``), or ``=``, which leaves the last step's
  product ``A[:, -depth:] @ B[-depth:, :]`` (the TPU's overwrite variant,
  which isolates the read-modify-write).
* :func:`resident_stream` (``mxu_resident_stream``): the same steps with B
  resident, which on this card means held in the 50 MB L2 (B's copies
  carry an evict_last L2 policy, A's evict_first); ``mt`` rows per CTA,
  walked as 128-row tiles.
* :func:`tiled_matmul` (``mxu_tiled_matmul``): a plain tiled product at a
  CTA tile (bm, bk, bn) of :data:`SWEEP_CONFIGS`.

The plain versions (:func:`dense_stream_reference`,
:func:`product_reference`) are fp32 torch math; a CPU tensor takes them, a
CUDA tensor launches the kernel or raises.

Run:  python -m sputnik_tpu_torch.bench.mxu_probe [--m 1024 --k 4096 --n 4096]
      [--dense-sweep] [--out FILE]
Writes ``sputnik_tpu_torch/bench/results/mxu_probe.json`` (or, with
``--dense-sweep``, ``tile_sweep.json``) with the card's name and power
limit, and a markdown table to stdout. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys

import numpy as np
import torch

from sputnik_tpu_torch.bench.calibrate import RESULTS
from sputnik_tpu_torch.bench.models import PEAKS
from sputnik_tpu_torch.kernels import _build
from sputnik_tpu_torch.utils.profiling import card, device_time

__all__ = ["dense_stream", "resident_stream", "tiled_matmul", "dense_stream_reference", "product_reference",
           "run", "run_dense_sweep", "SWEEP_CONFIGS", "LAUNCHES"]

# The CTA tiles (bm, bk, bn) mxu_tiled_matmul is instantiated at: the
# H100's counterpart of the TPU sweep list, tiles whose 3-stage ring fits
# shared memory in both dtypes.
SWEEP_CONFIGS = (
    (64, 32, 64), (64, 32, 128), (128, 32, 128), (128, 64, 128), (128, 32, 256), (256, 32, 128),
)
TILE = 128  # the stream probes' CTA tile edge
CHUNK = 32  # their staged k-chunk: depth must be a multiple
KINDS = {torch.bfloat16: 0, torch.float32: 1}

# Launches of each kernel in this process.
LAUNCHES = {"mxu_dense_stream": 0, "mxu_resident_stream": 0, "mxu_tiled_matmul": 0}


@functools.cache
def _lib():
    lib = _build.load("mxu_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mxu_dense_stream.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.mxu_resident_stream.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.mxu_tiled_matmul.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    for fn in (lib.mxu_dense_stream, lib.mxu_resident_stream, lib.mxu_tiled_matmul):
        fn.restype = i
    return lib


def _shapes(kernel: str, a: torch.Tensor, b: torch.Tensor):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{kernel}: need A (M, K) and B (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in KINDS or b.dtype != a.dtype:
        raise ValueError(f"{kernel} takes bf16 or fp32 operands of one dtype, got {a.dtype} and {b.dtype}")
    return a.shape[0], a.shape[1], b.shape[1]


def _launch(kernel: str, a: torch.Tensor, b: torch.Tensor, *args) -> torch.Tensor:
    for name, t in (("A", a), ("B", b)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{kernel} needs both operands on one CUDA device; {name} is on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and 16-byte aligned")
    m, n = a.shape[0], b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = getattr(_lib(), kernel)(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, a.shape[1], *args,
                                  KINDS[a.dtype], torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1
    return c


def _check_depth(kernel: str, k: int, depth: int) -> None:
    if depth <= 0 or depth % CHUNK or k % depth:
        raise ValueError(f"{kernel}: depth {depth} must be a multiple of {CHUNK} dividing K={k}")


def product_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of every probe's product: one fp32 product, cast
    to the operand dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def dense_stream_reference(a: torch.Tensor, b: torch.Tensor, *, depth: int, accumulate: bool = True):
    """:func:`dense_stream`'s plain version: the whole product, or without
    ``accumulate`` the last step's, ``A[:, -depth:] @ B[-depth:, :]``."""
    return product_reference(a, b) if accumulate else product_reference(a[:, -depth:], b[-depth:, :])


def dense_stream(a: torch.Tensor, b: torch.Tensor, *, depth: int, n_tile: int = TILE,
                 accumulate: bool = True) -> torch.Tensor:
    """C = A @ B with the stream DSD's structure at contraction ``depth``:
    one CTA per 128-row x ``min(n_tile, N)`` output, the accumulator
    revisited once per step. The TPU's default panel width (4096) is a VMEM
    figure; here the default ``n_tile`` is the CTA tile, 128."""
    m, k, n = _shapes("mxu_dense_stream", a, b)
    bn = min(n_tile, n)
    _check_depth("mxu_dense_stream", k, depth)
    if m % TILE or bn % TILE or n % bn:
        raise ValueError(f"mxu_dense_stream: M={m} and n_tile={bn} must be multiples of {TILE}, n_tile dividing N={n}")
    if not a.is_cuda and not b.is_cuda:
        return dense_stream_reference(a, b, depth=depth, accumulate=accumulate)
    return _launch("mxu_dense_stream", a, b, depth, int(accumulate), bn // TILE)


def resident_stream(a: torch.Tensor, b: torch.Tensor, *, depth: int, mt: int = TILE) -> torch.Tensor:
    """C = A @ B with B resident (held in L2), one step of contraction
    ``depth`` after another, ``mt`` output rows per CTA."""
    m, k, n = _shapes("mxu_resident_stream", a, b)
    _check_depth("mxu_resident_stream", k, depth)
    if mt % TILE or m % mt or n % TILE:
        raise ValueError(f"mxu_resident_stream: mt={mt} must be a multiple of {TILE} dividing M={m}, "
                         f"N={n} a multiple of {TILE}")
    if not a.is_cuda and not b.is_cuda:
        return product_reference(a, b)
    return _launch("mxu_resident_stream", a, b, depth, mt // TILE)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int, bk: int, bn: int) -> torch.Tensor:
    """C = A @ B at the CTA tile (bm, bk, bn), one of :data:`SWEEP_CONFIGS`."""
    m, k, n = _shapes("mxu_tiled_matmul", a, b)
    if (bm, bk, bn) not in SWEEP_CONFIGS:
        raise ValueError(f"mxu_tiled_matmul: tile {(bm, bk, bn)} is not instantiated; (bm, bk, bn) must be one "
                         f"of {SWEEP_CONFIGS}")
    if m % bm or k % bk or n % bn:
        raise ValueError(f"mxu_tiled_matmul: (M, K, N)={(m, k, n)} must be multiples of {(bm, bk, bn)}")
    if not a.is_cuda and not b.is_cuda:
        return product_reference(a, b)
    return _launch("mxu_tiled_matmul", a, b, bm, bk, bn)


def _operands(m, k, n, dtype=torch.bfloat16):
    if not torch.cuda.is_available():
        raise RuntimeError("the mxu probes need a CUDA card: torch.cuda.is_available() is false")
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to("cuda", dtype)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to("cuda", dtype)
    return a, b


def _row(flops, meas, **fields) -> dict:
    t = meas["time_s"]
    return {**fields, "time_us": t * 1e6, "tflops": flops / t / 1e12, "frac_peak": flops / t / PEAKS["bf16_flops"],
            "timing": meas["timing"]}


def run_dense_sweep(m=1024, k=4096, n=4096, configs=SWEEP_CONFIGS, out=None):
    """``tiled_matmul`` at each tile of ``configs`` on bf16 operands; rows of
    time, TFLOP/s and the fraction of the 989 TFLOP/s data-sheet peak.
    ``out``: also write them as JSON with the card's name and power limit."""
    a, b = _operands(m, k, n)
    flops = 2.0 * m * k * n
    rows = []
    for bm, bk, bn in configs:
        if m % bm or k % bk or n % bn:
            continue
        meas = device_time(functools.partial(tiled_matmul, bm=bm, bk=bk, bn=bn), a, b)
        rows.append(_row(flops, meas, bm=bm, bk=bk, bn=bn, m=m, k=k, n=n))
        print(f"# bm{bm} bk{bk} bn{bn}: {rows[-1]['time_us']:7.1f} us  {rows[-1]['tflops']:6.1f} TF  "
              f"{rows[-1]['frac_peak']:.3f} of peak", file=sys.stderr, flush=True)
    if out:
        _write(out, rows)
    return rows


def run(m=1024, k=4096, n=4096, depths=(128, 256, 512, 1024, 2048, 4096), mt_depths=(1024, 4096),
        mts=(256, 512, 1024), overwrite_depths=(128, 256), out=None):
    """The probe rows, as the JAX package's ``run`` names them:
    ``acc_d{depth}``, ``resident_d{depth}``, ``resident_d{depth}_mt{mt}``,
    ``overwrite_d{depth}``, and ``torch_matmul`` (its ``xla_dot``: the
    library product, a yardstick the port never calls). ``out``: also write
    them as JSON with the card's name and power limit."""
    a, b = _operands(m, k, n)
    flops = 2.0 * m * k * n
    rows = []

    def add(name, fn):
        rows.append(_row(flops, device_time(fn, a, b), variant=name, m=m, k=k, n=n))
        print(f"# {name}: {rows[-1]['time_us']:.1f} us  {rows[-1]['tflops']:.1f} TF  "
              f"{rows[-1]['frac_peak']:.3f} of peak", file=sys.stderr, flush=True)

    for depth in depths:
        add(f"acc_d{depth}", functools.partial(dense_stream, depth=depth))
    for depth in depths:
        add(f"resident_d{depth}", functools.partial(resident_stream, depth=depth))
    for depth in mt_depths:
        for mt in mts:
            if mt <= m and not k % depth:
                add(f"resident_d{depth}_mt{mt}", functools.partial(resident_stream, depth=depth, mt=mt))
    for depth in overwrite_depths:
        add(f"overwrite_d{depth}", functools.partial(dense_stream, depth=depth, accumulate=False))
    add("torch_matmul", torch.matmul)
    if out:
        _write(out, rows)
    return rows


def _write(path: str, rows: list) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "card": card(), "timing": "cuda_graph",
                   "peak_bf16_tflops": PEAKS["bf16_flops"] / 1e12, "rows": rows}, f, indent=2)
    print(f"(written to {os.path.abspath(path)})", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dense-sweep", action="store_true",
                    help="run the (bm, bk, bn) tile sweep instead (writes results/tile_sweep.json unless --out)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.mxu_probe needs a CUDA card: torch.cuda.is_available() is false")
    peak = PEAKS["bf16_flops"] / 1e12
    if args.dense_sweep:
        rows = run_dense_sweep(args.m, args.k, args.n, out=args.out or os.path.join(RESULTS, "tile_sweep.json"))
        print(f"| bm | bk | bn | time (us) | TFLOP/s | frac of {peak:.0f} peak |")
        print("|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['bm']} | {r['bk']} | {r['bn']} | {r['time_us']:.1f} | {r['tflops']:.1f} | "
                  f"{r['frac_peak']:.3f} |")
        return
    rows = run(args.m, args.k, args.n, out=args.out or os.path.join(RESULTS, "mxu_probe.json"))
    print(f"| variant | time (us) | TFLOP/s | frac of {peak:.0f} peak |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['time_us']:.1f} | {r['tflops']:.1f} | {r['frac_peak']:.3f} |")


if __name__ == "__main__":
    sys.exit(main())
