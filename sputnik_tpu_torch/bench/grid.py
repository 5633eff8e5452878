"""The full benchmark grid (``sputnik_tpu/bench/grid.py``): six ops x four
transpose modes x densities, against the reuse-aware roofline models of
``bench/models.py``.

Matrices are square (the reference grid's shape), drawn as JAX draws them
(seed 11); SSD / SDS / DSS run their exact pre-planned schedules where the
first fit would take the flat path (below 25% density, and a density
product below 0.1 for DSS), and the first fit otherwise. Each row has JAX's
keys: op, mode, d, density, time_us (``utils/profiling.py::device_time``:
100 calls replayed from a CUDA graph), gflops, bound, timing, the variant
dispatch picks, and ``frac_sol``, or for a time under 3 us
``frac_sol_unreliable`` with a note, as in ``bench/roofline.py``; a row whose
call raises is ``{op, mode, d, density, error}``. JAX's "epilogue sliced by
the chain" reclassification has no counterpart: a CUDA graph replays whole
calls. A fraction above 1.05 is impossible and raises.

Run:  python -m sputnik_tpu_torch.bench.grid [--d 2048] [--densities 0.5 0.25 0.1]
      [--ops dsd dds ...] [--tune] [--append] [--out FILE]
Prints the markdown table and writes ``{"device", "card", "rows"}`` to
``sputnik_tpu_torch/bench/results/bsr_grid_results.json`` or ``--out`` (not
the JAX package's root ``bsr_grid_results.json`` or ``docs/``);
``bench.grid_summary`` reads it. ``--tune`` primes the autotune cache for
DSD / DDS / SDD at each point first, so that the rows measure the tuned
dispatch. Needs a CUDA card; :func:`run` takes ``device=`` for a run
whose timer is a stand-in.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from sputnik_tpu_torch.bench.models import PEAKS, dsd_model, dss_flat_model, sdd_model, sol_time, sparse_out_flat_model

MODES = [(False, False), (False, True), (True, False), (True, True)]
SOL_LIMIT = 1.05
NOISE_FLOOR_US = 3.0


def _mode_name(ta, tb):
    return ("T" if ta else "N") + ("T" if tb else "N")


def run(d: int, densities, dtype_name="bfloat16", ops_filter=None, peaks=PEAKS, partial_path=None, tune=False,
        device=None):
    """The grid's rows at ``d``."""
    from sputnik_tpu_torch import ops
    from sputnik_tpu_torch.ops import registry
    from sputnik_tpu_torch.utils import profiling, testing
    from sputnik_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dtype = getattr(torch, dtype_name)
    isz = torch.empty((), dtype=dtype).element_size()
    peak_flops = peaks["bf16_flops"] if dtype == torch.bfloat16 else peaks["f32_flops"]
    bw = peaks["hbm_bps"]
    rng = np.random.default_rng(11)
    rows_out = []

    def add(op, ta, tb, density, fn, args, flops, bytes_moved, vargs, vkwargs):
        name = f"{op}_{_mode_name(ta, tb)}"
        try:
            m = profiling.device_time(fn, *args)
            variant = registry.dispatch_name(op, *vargs, **vkwargs)
        except Exception as e:  # noqa: BLE001 - JAX's error row; the caller checks for them
            rows_out.append({"op": op, "mode": _mode_name(ta, tb), "d": d, "density": density, "error": str(e)[:140]})
            print(f"# {name} density={density}: ERROR {str(e)[:90]}", file=sys.stderr, flush=True)
        else:
            t = m["time_s"]
            sol = sol_time(flops, bytes_moved, peak_flops=peak_flops, hbm_bps=bw)
            row = {"op": op, "mode": _mode_name(ta, tb), "d": d, "density": density, "time_us": t * 1e6,
                   "gflops": flops / t / 1e9,
                   "bound": "compute" if flops / peak_flops > bytes_moved / bw else "bandwidth",
                   "timing": m["timing"], "variant": variant}
            if t * 1e6 < NOISE_FLOOR_US:
                row["frac_sol_unreliable"] = sol / t
                row["note"] = "sub-3us: below the timing's noise floor"
            elif sol / t > SOL_LIMIT:
                raise RuntimeError(f"impossible reading: {name} density={density} at {sol / t:.3f} of the speed of "
                                   f"light ({t * 1e6:.2f} us against a bound of {sol * 1e6:.2f} us)")
            else:
                row["frac_sol"] = sol / t
            rows_out.append(row)
            print(f"# {name} density={density}: {t * 1e6:.0f} us, {flops / t / 1e9:.0f} GFLOP/s, {sol / t:.2f} SoL",
                  file=sys.stderr, flush=True)
        if partial_path:
            with open(partial_path, "w") as f:
                json.dump(rows_out, f, indent=2)

    for density in densities:
        nnz = int(d * d * density)
        a = testing.random_bsr(rng, d, d, nnz, 128, dtype=dtype, device=dev)
        b = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)).to(dev, dtype)
        topo = testing.random_bsr(rng, d, d, nnz, 128, dtype=dtype, device=dev)
        # Touched contraction strips for the dsd / dds reuse floor: the op's
        # dep axis is A's columns when not transposed, its rows when it is.
        a_tcols = int(len(np.unique(a.host_indices)))
        a_trows = int((np.diff(a.host_offsets) > 0).sum())
        a_nnz, t_nnz = a.nnz_blocks * 128 * 128, topo.nnz_blocks * 128 * 128
        for ta, tb in MODES:
            kw = dict(transpose_a=ta, transpose_b=tb)
            if tune:
                from sputnik_tpu_torch.ops.autotune import autotune

                for top, targs in (("dsd", (a, b)), ("dds", (b, a)), ("sdd", (b, b, topo))):
                    if ops_filter is None or top in ops_filter:
                        try:
                            win = autotune(top, *targs, **kw)
                            print(f"# tuned {top} {_mode_name(ta, tb)} density={density}: {win}", file=sys.stderr,
                                  flush=True)
                        except Exception as e:  # noqa: BLE001 - the rows then measure the untuned dispatch
                            print(f"# tune {top} failed: {str(e)[:90]}", file=sys.stderr, flush=True)
            if ops_filter is None or "dsd" in ops_filter:
                f, by = dsd_model(nnz=a_nnz, nnz_blocks=a.nnz_blocks, m=d, n=d, k=d, isz=isz,
                                  touched_deps=a_trows if ta else a_tcols)
                add("dsd", ta, tb, density, lambda a_, b_, kw=kw: ops.matmul_dsd(a.with_data(a_), b_, **kw),
                    (a.data, b), f, by, (a, b), kw)
            if ops_filter is None or "dds" in ops_filter:
                # dds reuses `a` as the sparse operand with transpose flag tb,
                # so its dep axis is a's columns when tb, else a's rows.
                f, by = dsd_model(nnz=a_nnz, nnz_blocks=a.nnz_blocks, m=d, n=d, k=d, isz=isz,
                                  touched_deps=a_tcols if tb else a_trows)
                add("dds", ta, tb, density, lambda b_, a_, kw=kw: ops.matmul_dds(b_, a.with_data(a_), **kw),
                    (b, a.data), f, by, (b, a), kw)
            if ops_filter is None or "sdd" in ops_filter:
                f, by = sdd_model(nnz=t_nnz, nnz_blocks=topo.nnz_blocks, m=d, n=d, k=d, isz=isz,
                                  touched_rows=int(len(np.unique(topo.host_row_indices()))),
                                  touched_cols=int(len(np.unique(topo.host_indices))))
                add("sdd", ta, tb, density, lambda x_, y_, kw=kw: ops.matmul_sdd(x_, y_, topo, **kw).data,
                    (b, b), f, by, (b, b, topo), kw)

            # The sparse-output ops: the exact flat schedule where first fit
            # takes the flat path anyway, else the dispatch as it ships; the
            # bound is the best implementable strategy's (the flat list or
            # the densify detour: a dense product and a block extract).
            def _best_bound(flat_f, flat_by):
                det_f, det_by = 2 * d * d * d, 3 * d * d * isz + 2 * t_nnz * isz
                t_flat = sol_time(flat_f, flat_by, peak_flops=peak_flops, hbm_bps=bw)
                t_det = sol_time(det_f, det_by, peak_flops=peak_flops, hbm_bps=bw)
                return (flat_f, flat_by) if t_flat <= t_det else (det_f, det_by)

            if ops_filter is None or "ssd" in ops_filter:
                sched = ops.plan_ssd(a, topo, transpose_a=ta)
                f, by = _best_bound(*sparse_out_flat_model(total_items=sched.total, nnz_out=t_nnz, isz=isz))
                skw = {**kw, "schedule": sched} if density < 0.25 else kw
                add("ssd", ta, tb, density, lambda a_, b_, skw=skw: ops.matmul_ssd(a.with_data(a_), b_, topo,
                                                                                   **skw).data,
                    (a.data, b), f, by, (a, b, topo), skw)
            if ops_filter is None or "sds" in ops_filter:
                sched = ops.plan_sds(a, topo, transpose_b=tb)
                f, by = _best_bound(*sparse_out_flat_model(total_items=sched.total, nnz_out=t_nnz, isz=isz))
                skw = {**kw, "schedule": sched} if density < 0.25 else kw
                add("sds", ta, tb, density, lambda b_, a_, skw=skw: ops.matmul_sds(b_, a.with_data(a_), topo,
                                                                                   **skw).data,
                    (b, a.data), f, by, (b, a, topo), skw)
            if ops_filter is None or "dss" in ops_filter:
                sched = ops.plan_dss(a, topo, transpose_a=ta, transpose_b=tb)
                f, by = _best_bound(*dss_flat_model(total_items=sched.total, m=d, n=d, isz=isz))
                skw = {**kw, "schedule": sched} if density * density < 0.1 else kw
                add("dss", ta, tb, density, lambda a_, t_, skw=skw: ops.matmul_dss(a.with_data(a_), topo.with_data(t_),
                                                                                   **skw),
                    (a.data, topo.data), f, by, (a, topo), skw)
    return rows_out


def load_rows(path: str) -> list:
    """The rows of a grid file: the port's ``{"rows": [...]}`` or JAX's list."""
    with open(path) as f:
        raw = json.load(f)
    return raw["rows"] if isinstance(raw, dict) else raw


def main(argv=None):
    from sputnik_tpu_torch.bench.calibrate import RESULTS
    from sputnik_tpu_torch.utils.profiling import card

    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, nargs="+", default=[2048],
                    help="square dims (the reference sweeps 512..16384)")
    ap.add_argument("--densities", type=float, nargs="+", default=[0.5, 0.25, 0.1])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ops", nargs="+", default=None, help="subset of dsd dds sdd ssd sds dss")
    ap.add_argument("--tune", action="store_true",
                    help="prime the autotune cache for dsd / dds / sdd at each grid point before measuring")
    ap.add_argument("--append", action="store_true",
                    help="merge into an existing --out file (replacing rows with the same op/mode/d/density)")
    ap.add_argument("--out", default=os.path.join(RESULTS, "bsr_grid_results.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.grid needs a CUDA card: torch.cuda.is_available() is false")
    name = card()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    for d in args.d:
        rows.extend(run(d, args.densities, args.dtype, ops_filter=args.ops,
                        partial_path=f"{args.out}.partial_d{d}", tune=args.tune))
    if args.append and os.path.exists(args.out):
        new_keys = {(r["op"], r["mode"], r["d"], r["density"]) for r in rows}
        rows = [r for r in load_rows(args.out) if (r["op"], r["mode"], r.get("d"), r["density"]) not in new_keys] + rows
    print("| op | mode | density | time (us) | GFLOP/s | frac SoL |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        if "error" in r:
            print(f"| {r['op']} | {r['mode']} | {r['density']} | ERROR {r['error'][:60]} | | |")
        else:
            frac = f"{r['frac_sol']:.2f}" if "frac_sol" in r else f"({r['frac_sol_unreliable']:.2f})"
            print(f"| {r['op']} | {r['mode']} | {r['density']} | {r['time_us']:.0f} | {r['gflops']:.0f} | {frac} |")
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "card": name, "rows": rows}, f, indent=2)
    for d in args.d:
        try:
            os.remove(f"{args.out}.partial_d{d}")
        except OSError:
            pass
    print(f"\n(written to {args.out})", file=sys.stderr)


if __name__ == "__main__":
    main()
