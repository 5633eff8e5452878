"""The tables of a grid file (``sputnik_tpu/bench/grid_summary.py``).

Prints (a) the mean fraction of the speed of light per op x density (over
modes and sizes), (b) one such table per size, (c) the worst reliable
rows, character for character as the JAX package's tool prints them. Reads
the port's ``bench.grid`` output (``{"rows": [...]}``) or the JAX
package's list of rows. Pure Python: it needs no card.

Usage: python -m sputnik_tpu_torch.bench.grid_summary
       [--in sputnik_tpu_torch/bench/results/bsr_grid_results.json] [--worst 8]
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

from sputnik_tpu_torch.bench.grid import load_rows

OPS = ["dsd", "dds", "sdd", "ssd", "sds", "dss"]
DEFAULT_IN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "bsr_grid_results.json")


def _fmt(vals):
    reliable = [v for v, r in vals if r]
    if reliable:
        return f"{sum(reliable) / len(reliable):.2f}"
    if vals:
        return "(sub-3 µs)*"
    return "—"


def table(rows, densities, title):
    cells = defaultdict(list)  # (op, density) -> [(frac, reliable)]
    for r in rows:
        if "error" in r:
            continue
        if "frac_sol" in r:
            cells[(r["op"], r["density"])].append((r["frac_sol"], True))
        elif "frac_sol_unreliable" in r:
            cells[(r["op"], r["density"])].append((r["frac_sol_unreliable"], False))
    print(f"\n### {title}\n")
    print("| op | " + " | ".join(f"{int(d * 100)}%" for d in densities) + " |")
    print("|---|" + "---|" * len(densities))
    for op in OPS:
        row = [_fmt(cells.get((op, d), [])) for d in densities]
        print(f"| {op} | " + " | ".join(row) + " |")


def summarize(rows, worst: int = 8) -> None:
    sizes = sorted({r["d"] for r in rows})
    densities = sorted({r["density"] for r in rows}, reverse=True)
    errors = [r for r in rows if "error" in r]
    print(f"{len(rows)} rows, sizes {sizes}, densities {densities}, {len(errors)} errors")
    for r in errors:
        print(f"  ERROR {r['op']}_{r['mode']} d={r['d']} density={r['density']}: {r['error'][:80]}")
    table(rows, densities, f"all sizes ({'/'.join(map(str, sizes))})")
    for d in sizes:
        table([r for r in rows if r["d"] == d], densities, f"d = {d}")
    ranked = sorted((r for r in rows if "frac_sol" in r), key=lambda r: r["frac_sol"])
    print(f"\nWorst {worst} reliable rows:")
    for r in ranked[:worst]:
        print(f"  {r['op']}_{r['mode']} d={r['d']} density={r['density']}: {r['frac_sol']:.2f} ({r['time_us']:.0f} us)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="path", default=DEFAULT_IN)
    ap.add_argument("--worst", type=int, default=8)
    args = ap.parse_args(argv)
    summarize(load_rows(args.path), args.worst)


if __name__ == "__main__":
    main()
