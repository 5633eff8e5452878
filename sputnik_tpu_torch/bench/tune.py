"""Prime the autotune cache at chosen problems (``sputnik_tpu/bench/tune.py``).

Times every registered variant that can implement each BSR matmul problem
(``ops.autotune.benchmark_variants``: CUDA-graph device time, no plain
variant on the card) at each (d, density, op, mode) point and persists the
winner (``ops.autotune.autotune``), so that later dispatches (``bench.dsd``,
the roofline audit, user code) pick the measured-best kernel for those
signatures. The inputs are JAX's (seed 3, drawn in its order).

Run:  python -m sputnik_tpu_torch.bench.tune [--d 2048 4096] [--densities 0.25]
      [--ops dsd dds sdd] [--modes NN] [--dtype bfloat16]
Prints each problem's timings and ``WINNER``; a problem whose tuning raises
prints JAX's ``ERROR`` line on stderr, and the run then exits non-zero.
The cache is ``$SPUTNIK_TPU_TORCH_TUNE_CACHE`` (``ops/autotune.py``). Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

MODES = {"NN": (False, False), "NT": (False, True), "TN": (True, False), "TT": (True, True)}


def run(ds=(2048, 4096), densities=(0.25,), ops_=("dsd", "dds", "sdd"), modes=("NN",), dtype_name="bfloat16") -> int:
    """Tune every point; returns the number of problems that failed."""
    from sputnik_tpu_torch.ops.autotune import autotune, benchmark_variants
    from sputnik_tpu_torch.utils import testing

    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(3)
    failed = 0
    for d in ds:
        for density in densities:
            nnz = int(d * d * density)
            a = testing.random_bsr(rng, d, d, nnz, 128, dtype=dtype, device="cuda")
            b = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)).to("cuda", dtype)
            topo = testing.random_bsr(rng, d, d, nnz, 128, dtype=dtype, device="cuda")
            problems = {"dsd": (a, b), "dds": (b, a), "sdd": (b, b, topo)}
            for op in ops_:
                targs = problems[op]
                for mode in modes:
                    ta, tb = MODES[mode]
                    try:
                        times = benchmark_variants(op, *targs, transpose_a=ta, transpose_b=tb)
                        for k, v in sorted(times.items(), key=lambda kv: kv[1]):
                            print(f"{op} d={d} density={density} {mode}: {k:28s} {v * 1e6:9.1f} us", flush=True)
                        win = autotune(op, *targs, transpose_a=ta, transpose_b=tb, timings=times)
                        print(f"{op} d={d} density={density} {mode} WINNER {win}", flush=True)
                    except Exception as e:  # noqa: BLE001 - JAX's per-problem ERROR line; the exit code reports it
                        failed += 1
                        print(f"{op} d={d} density={density} {mode}: ERROR {type(e).__name__}: {str(e)[:140]}",
                              file=sys.stderr, flush=True)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, nargs="+", default=[2048, 4096])
    ap.add_argument("--densities", type=float, nargs="+", default=[0.25])
    ap.add_argument("--ops", nargs="+", default=["dsd", "dds", "sdd"])
    ap.add_argument("--modes", nargs="+", default=["NN"], choices=sorted(MODES))
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.tune needs a CUDA card: torch.cuda.is_available() is false")
    failed = run(args.d, args.densities, args.ops, args.modes, args.dtype)
    if failed:
        raise SystemExit(f"{failed} problem(s) failed to tune")


if __name__ == "__main__":
    main()
