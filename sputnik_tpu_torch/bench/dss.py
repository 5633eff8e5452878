"""DSS path shootout on a CUDA card (``sputnik_tpu/bench/dss.py``).

dense = sparse @ sparse at d x d, both operands at one block density, bf16,
through each of the port's DSS paths:

* ``flat_planned``    — the exact schedule planned on the host once
                        (``plan_dss``), through ``bsr_flat``;
* ``worklist_traced`` — the work list built on the card in every call, from
                        metadata built on the card (no host copy, nnz hints
                        given), through ``bsr_dss_worklist``: what a step
                        pays that never caches;
* ``worklist_cached`` — ``build_dss_worklist`` once, the list passed back in;
* ``masked_stream``   — op(A)'s rows against op(B)'s position map, built in
                        every call (``bsr_dss_masked``);
* ``densify``         — the side with fewer blocks densified, then the
                        ``bsr_dsd_stream`` kernel.

Each path is timed as device time: 100 calls replayed from one CUDA graph
between CUDA events after 10 warm-up calls (``utils/profiling.time_ms``).

Run:  python -m sputnik_tpu_torch.bench.dss [--d 2048] [--densities 0.25 0.1]
      [--out FILE]
Writes one JSON line per (density, path) to stdout (and a JSON list to
``--out``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_dss, bsr_flat, via_dense
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.profiling import time_ms

PATHS = ("flat_planned", "worklist_traced", "worklist_cached", "masked_stream", "densify")


def card_built(m: BlockSparseMatrix, hints: bool = True) -> BlockSparseMatrix:
    """``m`` with metadata as if built on the card: the same tensors, no
    host copy; the nnz hints kept (as a caller passes them) or dropped."""
    kw = dict(max_row_nnz=m.max_row_nnz, max_col_nnz=m.max_col_nnz) if hints else {}
    return BlockSparseMatrix.create(m.data, m.offsets, m.indices, m.shape, **kw)


def paths(a: BlockSparseMatrix, b: BlockSparseMatrix) -> dict:
    """{path: no-argument DSS of ``a`` and ``b`` (metadata known on the host)}."""
    plan = bsr_flat.plan_dss(a, b)
    wl = bsr_dss.build_dss_worklist(a, b)
    ac, bc = card_built(a), card_built(b)
    return {
        "flat_planned": lambda: bsr_flat.dss_flat(a, b, schedule=plan),
        "worklist_traced": lambda: bsr_dss.dss_worklist(ac, bc),
        "worklist_cached": lambda: bsr_dss.dss_worklist(a, b, worklist=wl),
        "masked_stream": lambda: bsr_dss.dss(a, b),
        "densify": lambda: via_dense.dss(a, b),
    }


def run(d: int = 2048, densities=(0.25, 0.1), dtype_name: str = "bfloat16"):
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.dss needs a CUDA card: torch.cuda.is_available() is false")
    dtype, dev = getattr(torch, dtype_name), torch.device("cuda")
    rows = []
    for density in densities:
        rng = np.random.default_rng(7)
        a = testing.random_bsr(rng, d, d, int(d * d * density), 128, dtype=dtype, device=dev)
        b = testing.random_bsr(rng, d, d, int(d * d * density), 128, dtype=dtype, device=dev)
        real = bsr_flat.plan_dss(a, b).total
        budget = bsr_dss.worklist_budget(card_built(a), card_built(b))
        for name, fn in paths(a, b).items():
            ms, _ = time_ms(fn)
            rows.append({"path": name, "d": d, "density": density, "dtype": dtype_name, "time_us": ms * 1e3,
                         "timing": "cuda_graph", "real_items": real, "budget": int(budget),
                         "device": torch.cuda.get_device_name(0)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=2048)
    ap.add_argument("--densities", type=float, nargs="+", default=[0.25, 0.1])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = run(args.d, tuple(args.densities), args.dtype)
    for r in rows:
        print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v) for k, v in r.items()}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    sys.exit(main())
