"""Headline benchmark of the port: BSR DSD SpMM on the card (the root
``bench.py`` of the JAX package).

Prints ONE JSON line, last on stdout:

  {"metric": "bsr_dsd_spmm_bf16_d4096_density0.25", "value": N,
   "unit": "GFLOP/s", "vs_baseline": N, "vs_machine_sol": N}

value           effective GFLOP/s, 2 * nnz * N / t, at the headline config
                (4096^2, 25% block density, 128-blocks, bf16: the inputs of
                ``bench.py``, ``testing.random_bsr`` from
                ``np.random.default_rng(42)``);
vs_baseline     the fraction of the speed of light on the H100 data sheet
                (``bench/models.py``: the larger of the FLOPs at 989
                TFLOP/s and ``dsd_model``'s bytes at 3.35 TB/s), the share
                of record;
vs_machine_sol  the same against the measured peaks of this card
                (``bench/calibrate.py``: the ``peaks`` a caller passes, else
                ``results/machine_peak.json`` when it was written on this
                card at this power limit); omitted otherwise.

A reading above 1.05 of the speed of light is impossible and raises; it is
not clipped. Time is ``utils/profiling.py::device_time``: 100 calls
replayed from a CUDA graph. Progress goes to stderr.

The product runs on the variant ``bench.py``'s tune pass picks
(:func:`tune_dsd`): each of ``TUNE_SHORTLIST`` that can implement the
problem is timed under the same protocol, the fastest is kept in the
autotune cache (``ops/autotune.py``), and the headline's dispatch then
picks it from there; stderr names it as ``(dispatch: <winner>)``.
``--no-tune`` measures the first fit (``cuda_stream`` at the headline), as
``bench.py --no-tune`` does.

Run:  python -m sputnik_tpu_torch.bench.dsd [--d 4096] [--density 0.25]
      [--full] [--no-tune]
``--full`` also writes ``results/bench_results.json`` over the JAX grid
(d 1024 / 2048 / 4096 / 8192 x density 1.0 / 0.5 / 0.25 / 0.1). Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.bench.calibrate import RESULTS, load_measured_peaks
from sputnik_tpu_torch.bench.models import PEAKS, dsd_model, sol_time
from sputnik_tpu_torch.ops.autotune import autotune, cached_variant
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.profiling import card, device_time

SOL_LIMIT = 1.05

# bench.py's shortlist: the variants that have won a published shootout row,
# so that a cold cache costs a few timings, not the whole registry.
TUNE_SHORTLIST = ("cuda_stream", "cuda_qstream", "cuda_qstream_q2", "cuda_gres")


def metric(d: int, density: float) -> str:
    return f"bsr_dsd_spmm_bf16_d{d}_density{density}"


def inputs(d: int, density: float, dtype=torch.bfloat16):
    """The headline's operands, drawn as ``bench.py`` draws them."""
    rng = np.random.default_rng(42)
    a = testing.random_bsr(rng, d, d, int(d * d * density), 128, dtype=dtype, device="cuda")
    b = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)).to("cuda", dtype)
    return a, b


def tune_dsd(a, b) -> str | None:
    """``bench.py``'s tune pass: the fastest of ``TUNE_SHORTLIST`` on these
    operands (each timed by ``device_time``, the measurement's own
    protocol), persisted to the autotune cache so that plain dispatch picks
    it. A cached winner is returned without measuring; None when no
    shortlisted variant takes the problem."""
    hit = cached_variant("dsd", (a, b), {})
    if hit is not None:
        return hit
    timings = {}
    for v in ops.registry.variants_for("dsd"):
        if v.name not in TUNE_SHORTLIST or not v.can_implement(a, b):
            continue
        timings[v.name] = device_time(lambda d_, b_, _launch=v.launch: _launch(a.with_data(d_), b_), a.data,
                                      b)["time_s"]
        print(f"(tune: {v.name} {timings[v.name] * 1e6:.1f} us/op)", file=sys.stderr)
    if not timings:
        return None
    return autotune("dsd", a, b, timings=timings)


def bench_dsd(d: int, density: float, dtype_name: str = "bfloat16", peaks: dict | None = None,
              tune: bool = False) -> dict:
    """One headline row at ``d`` x ``density``: the dispatched variant's
    device time, GFLOP/s and fractions of the speed of light. ``tune`` runs
    :func:`tune_dsd` first (dispatch then picks its winner from the cache);
    without it the first fit runs, whatever the cache holds. ``peaks`` is a calibration of this card
    (``calibrate.measure()``); without it the committed one is used when it
    was taken on this card."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_dsd needs a CUDA card: torch.cuda.is_available() is false")
    dtype = getattr(torch, dtype_name)
    a, b = inputs(d, density, dtype)
    if tune:
        winner = tune_dsd(a, b)
        if winner:
            print(f"(dispatch: {winner})", file=sys.stderr)
        variant = ops.registry.dispatch_name("dsd", a, b)
    else:
        variant = ops.registry.first_fit_name("dsd", a, b)
    m = device_time(lambda d_, b_: ops.matmul_dsd(a.with_data(d_), b_, variant=variant), a.data, b)
    dt = m["time_s"]
    isz = torch.empty((), dtype=dtype).element_size()
    flops, bytes_moved = dsd_model(nnz=a.nnz_blocks * 128 * 128, nnz_blocks=a.nnz_blocks, m=d, n=d, k=d, isz=isz,
                                   n_tile=d, touched_deps=len(np.unique(a.host_indices)))
    peak_flops = PEAKS["bf16_flops"] if dtype == torch.bfloat16 else PEAKS["f32_flops"]
    sol_t = sol_time(flops, bytes_moved, peak_flops=peak_flops, hbm_bps=PEAKS["hbm_bps"])
    if sol_t / dt > SOL_LIMIT:
        raise RuntimeError(f"impossible reading: {sol_t / dt:.3f} of the speed of light at d={d} density={density} "
                           f"({dt * 1e6:.2f} us against a bound of {sol_t * 1e6:.2f} us)")
    row = {"d": d, "density": density, "variant": variant, "time_s": dt, "wall_s": m["wall_s"],
           "timing": m["timing"], "gflops": flops / dt / 1e9, "sol_gflops": flops / sol_t / 1e9,
           "frac_sol": sol_t / dt, "nnz_blocks": a.nnz_blocks, "flops": flops, "bytes": bytes_moved}
    measured = peaks if peaks is not None else load_measured_peaks()
    if measured is not None:
        row["frac_machine_sol"] = sol_time(
            flops, bytes_moved,
            peak_flops=peak_flops * measured["mxu_efficiency" if dtype == torch.bfloat16 else "f32_efficiency"],
            hbm_bps=PEAKS["hbm_bps"] * measured["hbm_efficiency"]) / dt
    return row


def headline_line(r: dict) -> dict:
    line = {"metric": metric(r["d"], r["density"]), "value": round(r["gflops"], 1), "unit": "GFLOP/s",
            "vs_baseline": round(r["frac_sol"], 4)}
    if "frac_machine_sol" in r:
        line["vs_machine_sol"] = round(r["frac_machine_sol"], 4)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="also run the grid")
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--no-tune", action="store_true", help="skip the tune pass (first fit only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.dsd needs a CUDA card: torch.cuda.is_available() is false")
    name = card()
    r = bench_dsd(args.d, args.density, tune=not args.no_tune)
    print(f"headline: {r['gflops']:.0f} GFLOP/s eff ({r['variant']}, {r['timing']}), {r['frac_sol']:.3f} of the "
          f"data-sheet SoL; wall {r['wall_s'] * 1e6:.1f} us/op on {name}", file=sys.stderr)
    if args.full:
        grid = []
        for d in (1024, 2048, 4096, 8192):
            for density in (1.0, 0.5, 0.25, 0.1):
                g = bench_dsd(d, density, tune=not args.no_tune)
                grid.append(g)
                print(f"d={d} density={density}: {g['gflops']:.0f} GFLOP/s ({g['frac_sol']:.3f} of SoL, "
                      f"{g['variant']})", file=sys.stderr)
        os.makedirs(RESULTS, exist_ok=True)
        path = os.path.join(RESULTS, "bench_results.json")
        with open(path, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "card": name, "rows": grid}, f, indent=2)
        print(f"(written to {path})", file=sys.stderr)
    print(json.dumps(headline_line(r)))


if __name__ == "__main__":
    sys.exit(main())
