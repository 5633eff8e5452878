"""The SSS floor probe (``sputnik_tpu/bench/sss_floor.py``): the
exact-intersection SSS kernel (``bsr_flat``) by work-list ``group`` at the
audit's and the headline's sizes.

JAX sweeps (group, kcat): on the TPU ``group`` is the number of work items
per grid step and ``kcat`` fuses a step's dots into one deeper dot. The
CUDA flat kernel walks the items one by one, skipping the flag-0 padding
that ``group`` adds (``kernels/bsr_flat.py``), and ignores ``kcat``: the
two settings are one launch, so this probe times one row per group and
records that ``kcat`` has no counterpart. Each row: the plan's ``n_items``
(real items) and ``n_steps`` (JAX's grid steps), the device time
(``utils/profiling.py::device_time``: 100 calls replayed from a CUDA graph)
and the fraction of the data sheet's speed of light (the items' FLOPs and
bytes, JAX's model). Inputs are JAX's (seed 7 per size, 25%, bf16).

Run:  python -m sputnik_tpu_torch.bench.sss_floor [--d 2048 4096] [--density 0.25]
      [--out FILE]
Writes ``sputnik_tpu_torch/bench/results/sss_floor.json`` or ``--out``,
with the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

GROUPS = (1, 2, 4, 8, 16)
KCAT_NOTE = ("kcat has no counterpart: the CUDA flat kernel walks a step's items one by one, so kcat=False and "
             "kcat=True are the same launch, timed once")


def run(ds=(2048, 4096), density: float = 0.25, device=None):
    """One row per (d, group); a row whose call raises is ``{d, group, error}``."""
    from sputnik_tpu_torch.bench.models import PEAKS
    from sputnik_tpu_torch.kernels import bsr_flat
    from sputnik_tpu_torch.utils import profiling, testing
    from sputnik_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rows = []
    for d in ds:
        rng = np.random.default_rng(7)
        a, b, topo = (testing.random_bsr(rng, d, d, int(d * d * density), 128, dtype=torch.bfloat16, device=dev)
                      for _ in range(3))
        for group in GROUPS:
            plan = bsr_flat.plan_sss(a, b, topo, group=group)
            n_items = plan.total
            flops = 2 * n_items * 128 * 128 * 128
            byts = (2 * n_items + topo.nnz_blocks) * 128 * 128 * 2
            sol = max(flops / PEAKS["bf16_flops"], byts / PEAKS["hbm_bps"])

            def fn(da, db, _plan=plan):
                return bsr_flat.sss_flat(a.with_data(da), b.with_data(db), topo, schedule=_plan).data

            try:
                m = profiling.device_time(fn, a.data, b.data)
            except Exception as e:  # noqa: BLE001 - JAX's error row; the caller checks for them
                rows.append({"d": d, "group": group, "error": str(e)[:120]})
                continue
            t = m["time_s"]
            rows.append(dict(d=d, group=group, time_us=t * 1e6, n_items=int(n_items), n_steps=int(plan.n_steps),
                             frac_sol=sol / t, timing=m["timing"]))
            print(f"d={d} g={group}: {t * 1e6:.1f} us frac={sol / t:.2f} steps={plan.n_steps}", file=sys.stderr,
                  flush=True)
    return rows


def main(argv=None):
    from sputnik_tpu_torch.bench.calibrate import RESULTS
    from sputnik_tpu_torch.utils.profiling import card

    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, nargs="+", default=[2048, 4096])
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--out", default=os.path.join(RESULTS, "sss_floor.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.sss_floor needs a CUDA card: torch.cuda.is_available() is false")
    name = card()
    rows = run(tuple(args.d), args.density)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "card": name, "density": args.density, "kcat": KCAT_NOTE,
                   "rows": rows}, f, indent=2)
    print(f"(written to {args.out})", file=sys.stderr)
    if any("error" in r for r in rows):
        raise SystemExit("a row failed")


if __name__ == "__main__":
    main()
