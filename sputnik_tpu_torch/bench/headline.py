"""The headline's variant shootout (``sputnik_tpu/bench/headline.py``): every
DSD variant at the headline problem, one table.

At 4096², 25% block density, bf16 (``bench.dsd.inputs``: seed 42, the root
``bench.py``'s operands):

* every registered DSD variant that can implement the problem, timed as
  ``ops.autotune.benchmark_variants`` times them (no plain variant on the
  card) but one by one, so that a failing variant leaves the others timed;
* JAX's parameterized extras, points the registry exposes only at their
  defaults (:data:`EXTRAS`, JAX's names and knobs), but for those whose knob
  the CUDA kernel lacks (:data:`OMITTED_EXTRAS`, each with its reason);
* the fastest registry variant persisted into the autotune cache, so that
  ``bench.dsd`` and plain ``matmul_dsd`` dispatch pick it.

Each row carries the device time (``utils/profiling.py::device_time``: 100
calls replayed from a CUDA graph), the effective TFLOP/s, the fraction of
the data sheet's speed of light (``bench/models.py``) and, where
``results/machine_peak.json`` was measured on this card at this power limit,
``vs_machine_sol``. A fraction above 1.05 is impossible and raises. A
variant or extra whose launch raises is reported on stderr and the run
exits non-zero after printing the rows.

Run:  python -m sputnik_tpu_torch.bench.headline [--d 4096] [--density 0.25]
      [--out FILE] [--no-persist]
Writes ``sputnik_tpu_torch/bench/results/headline_shootout.json`` or
``--out`` (not ``docs/``, which holds the JAX package's TPU records), with
the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys

import numpy as np
import torch

from sputnik_tpu_torch.kernels import bsr_cstack, bsr_qstream

SOL_LIMIT = 1.05

# JAX's extras (sputnik_tpu/bench/headline.py), by name.
EXTRAS = {
    "qstream_q2_ref": functools.partial(bsr_qstream.dsd_q, q=2),
    "qstream_q6_ref": functools.partial(bsr_qstream.dsd_q, q=6),
    "qstream_q8_ref": functools.partial(bsr_qstream.dsd_q, q=8),
    "cstack_q4": functools.partial(bsr_cstack.dsd_cstack, q=4),
    "cstack_q8": functools.partial(bsr_cstack.dsd_cstack, q=8),
    "cstack_q16": functools.partial(bsr_cstack.dsd_cstack, q=16),
}

# JAX's extras that stay out, with the reason.
_NO_N_TILE = "bsr_cstack's n_tile has no counterpart (its CTAs own 32-column slabs): the same launch as {}"
OMITTED_EXTRAS = (
    ("qstream_q4_nt2048", "bsr_qstream takes no n_tile: its CTAs own 128-wide tiles of the output"),
    ("cstack_q8_nt4096", _NO_N_TILE.format("cstack_q8")),
    ("cstack_q4_nt2048", _NO_N_TILE.format("cstack_q4")),
    ("cstack_q8_nt1024", _NO_N_TILE.format("cstack_q8")),
)


def run(d: int = 4096, density: float = 0.25, dtype_name: str = "bfloat16", persist: bool = True):
    """(rows, failures): a row per timed variant and extra, fastest first,
    and the names whose launch raised."""
    from sputnik_tpu_torch.bench import dsd as dsd_bench
    from sputnik_tpu_torch.bench.calibrate import load_measured_peaks
    from sputnik_tpu_torch.bench.models import PEAKS, dsd_model, sol_time
    from sputnik_tpu_torch.ops import registry
    from sputnik_tpu_torch.utils import profiling

    autotune_mod = importlib.import_module("sputnik_tpu_torch.ops.autotune")
    dtype = getattr(torch, dtype_name)
    a, b = dsd_bench.inputs(d, density, dtype)
    isz = torch.empty((), dtype=dtype).element_size()
    flops, bytes_moved = dsd_model(nnz=a.nnz_blocks * 128 * 128, nnz_blocks=a.nnz_blocks, m=d, n=d, k=d, isz=isz,
                                   touched_deps=len(np.unique(a.host_indices)))
    peak_flops = PEAKS["bf16_flops"] if dtype == torch.bfloat16 else PEAKS["f32_flops"]
    sol_t = sol_time(flops, bytes_moved, peak_flops=peak_flops, hbm_bps=PEAKS["hbm_bps"])
    measured = load_measured_peaks()
    machine_t = None
    if measured is not None:
        eff = measured["mxu_efficiency" if dtype == torch.bfloat16 else "f32_efficiency"]
        machine_t = sol_time(flops, bytes_moved, peak_flops=peak_flops * eff,
                             hbm_bps=PEAKS["hbm_bps"] * measured["hbm_efficiency"])

    failures = []
    timings = {}
    # Variant by variant, so that one variant's failure leaves the others timed.
    for v in registry.variants_for("dsd"):
        if v.name in autotune_mod.PLAIN_VARIANTS or not v.can_implement(a, b):
            continue
        try:
            timings[v.name] = profiling.device_time(lambda d_, b_, _l=v.launch: _l(a.with_data(d_), b_),
                                                    a.data, b)["time_s"]
        except Exception as e:  # noqa: BLE001 - reported, and the run fails at its end
            failures.append(v.name)
            print(f"# {v.name}: FAILED {str(e)[:120]}", file=sys.stderr)
    for name, fn in EXTRAS.items():
        try:
            timings[name] = profiling.device_time(lambda d_, b_, _fn=fn: _fn(a.with_data(d_), b_), a.data,
                                                  b)["time_s"]
        except Exception as e:  # noqa: BLE001 - reported, and the run fails at its end
            failures.append(name)
            print(f"# {name}: FAILED {str(e)[:120]}", file=sys.stderr)

    rows = []
    for name, t in sorted(timings.items(), key=lambda kv: kv[1]):
        if sol_t / t > SOL_LIMIT:
            raise RuntimeError(f"impossible reading: {name} at {sol_t / t:.3f} of the speed of light "
                               f"({t * 1e6:.2f} us against a bound of {sol_t * 1e6:.2f} us)")
        row = {"variant": name, "d": d, "density": density, "time_us": t * 1e6, "eff_tflops": flops / t / 1e12,
               "frac_sol": sol_t / t}
        if machine_t is not None:
            row["vs_machine_sol"] = machine_t / t
        rows.append(row)
        print(f"# {name}: {t * 1e6:8.1f} us  {flops / t / 1e12:6.1f} TF eff  {sol_t / t:.3f} of SoL",
              file=sys.stderr, flush=True)

    if persist and timings:
        # Only registry names can be dispatched; the extras inform design.
        reg_names = {v.name for v in registry.variants_for("dsd")}
        reg_timings = {k: v for k, v in timings.items() if k in reg_names}
        if reg_timings:
            autotune_mod.clear_cache()
            winner = autotune_mod.autotune("dsd", a, b, timings=reg_timings)
            print(f"# autotune winner persisted: {winner}", file=sys.stderr)
    return rows, failures


def main(argv=None):
    from sputnik_tpu_torch.bench.calibrate import RESULTS
    from sputnik_tpu_torch.utils.profiling import card

    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--out", default=os.path.join(RESULTS, "headline_shootout.json"))
    ap.add_argument("--no-persist", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.headline needs a CUDA card: torch.cuda.is_available() is false")
    name = card()
    rows, failures = run(d=args.d, density=args.density, persist=not args.no_persist)
    print("| variant | time (us) | eff TFLOP/s | frac of SoL |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['variant']} | {r['time_us']:.1f} | {r['eff_tflops']:.1f} | {r['frac_sol']:.3f} |")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "card": name, "d": args.d, "density": args.density,
                   "omitted_extras": dict(OMITTED_EXTRAS), "failed": failures, "rows": rows}, f, indent=2)
    print(f"(written to {args.out})", file=sys.stderr)
    if failures:
        raise SystemExit(f"{len(failures)} variant(s) failed: {failures}")


if __name__ == "__main__":
    main()
