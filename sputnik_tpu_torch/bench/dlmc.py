"""DLMC sweep on a CUDA card: SpMM and SDDMM at transformer sparsities
(``sputnik_tpu/bench/dlmc.py``).

For each (matrix, sparsity): the SELL SpMM kernel, the dense-mirror path
(one fp32 matmul), and the SELL SDDMM kernel at the same pattern, each timed
as device time (100 calls replayed from one CUDA graph between CUDA events,
after 10 warm-up calls; ``utils/profiling.time_ms``). Reported as in the JAX
package: effective GFLOP/s, sustained nonzeros per second, and the fraction
of the no-reuse gather model (one dense row read per nonzero, what
upstream Sputnik's gather engine pays) at the H100 SXM data sheet's HBM
rate, 3.35 TB/s.

With a trained weights file (``data/dlmc_weights.npz``) the matrices are
the magnitude-pruned trained weights (the DLMC generation protocol);
otherwise the synthetic skewed-row generator stands in.

Run:  python -m sputnik_tpu_torch.bench.dlmc [--n 64] [--weights data/dlmc_weights.npz]
      [--out dlmc_results.json]
Writes a markdown table to stdout and JSON to --out. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

PEAK_HBM_BPS = 3.35e12  # H100 SXM data sheet
SPARSITIES = [0.70, 0.80, 0.90, 0.95, 0.98]
# DLMC transformer shapes (attention/FFN weights of the base model).
SHAPES = [(512, 512), (2048, 512), (512, 2048), (1024, 1024)]


def _configs(weights_path, device):
    """Yield (label, rows, cols, sparsity, CsrMatrix)."""
    from sputnik_tpu_torch.utils.dlmc import synthetic_dlmc

    if weights_path:
        from sputnik_tpu_torch.utils.dlmc_gen import WEIGHT_KEYS, load_weights, pruned_csr

        w = load_weights(weights_path)
        for key in WEIGHT_KEYS:
            for sp in SPARSITIES:
                c = pruned_csr(w, key, sp, device=device)
                yield key, c.shape[0], c.shape[1], sp, c
        return
    rng = np.random.default_rng(3)
    for rows, cols in SHAPES:
        for sp in SPARSITIES:
            yield f"{rows}x{cols}", rows, cols, sp, synthetic_dlmc(rng, rows, cols, sp, device=device)


def _row(op, label, rows, cols, sp, nnz, ms, sol_bytes, n):
    t = ms * 1e-3
    return {
        "op": op, "shape": [rows, cols], "sparsity": sp, "matrix": label, "nnz": nnz,
        "time_us": ms * 1e3, "gflops": 2 * nnz * n / t / 1e9, "gnnz_per_s": nnz / t / 1e9,
        "frac_gather_bound": sol_bytes / PEAK_HBM_BPS / t, "timing": "cuda_graph",
    }


def run(n: int, weights_path: str | None = None):
    """One dict per (op, matrix, sparsity), as the JAX bench's rows."""
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.dlmc needs a CUDA card: torch.cuda.is_available() is false")
    from sputnik_tpu_torch.formats import SellMatrix
    from sputnik_tpu_torch.ops import csr as csr_ops
    from sputnik_tpu_torch.utils.profiling import time_ms

    device = torch.device("cuda")
    rng = np.random.default_rng(3)
    rows_out = []
    with torch.no_grad():
        for label, rows, cols, sp, c in _configs(weights_path, device):
            nnz = int(c.nnz)
            if nnz == 0:
                continue
            # Sorted rows (the SortedRowSwizzle) and chunk "auto", as the JAX bench builds them.
            s = SellMatrix.from_csr(c, chunk="auto", sort_rows=True)
            b = torch.from_numpy(rng.standard_normal((cols, n)).astype(np.float32)).to(device)
            spmm_bytes = nnz * (n + 1) * 4 + cols * n * 4
            ms, _ = time_ms(lambda: csr_ops.spmm(s, b))
            rows_out.append(_row("spmm", label, rows, cols, sp, nnz, ms, spmm_bytes, n))
            # The dense-mirror path for static weights: one fp32 matmul.
            cm = c.with_dense_mirror()
            ms, _ = time_ms(lambda: csr_ops.spmm(cm, b))
            rows_out.append(_row("spmm_mirror", label, rows, cols, sp, nnz, ms, spmm_bytes, n))
            # SDDMM at the same pattern (attention-score shape, k = n).
            q = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(device)
            k = torch.from_numpy(rng.standard_normal((cols, n)).astype(np.float32)).to(device)
            ms, _ = time_ms(lambda: csr_ops.sddmm(q, k, s))
            rows_out.append(_row("sddmm", label, rows, cols, sp, nnz, ms, nnz * (2 * n + 1) * 4, n))
            print(f"# done {label} {rows}x{cols} @ {sp}", file=sys.stderr)
    return rows_out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--out", default="dlmc_results.json")
    ap.add_argument("--weights", default=None,
                    help="trained-weights npz -> magnitude-pruned trained matrices")
    args = ap.parse_args(argv)
    rows = run(args.n, weights_path=args.weights)
    print(f"device: {torch.cuda.get_device_name(0)}")
    print("| op | shape | sparsity | time (us) | GFLOP/s | Gnnz/s | frac of gather bound |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['op']} | {r['shape'][0]}x{r['shape'][1]} | {r['sparsity']:.2f} "
            f"| {r['time_us']:.1f} | {r['gflops']:.0f} | {r['gnnz_per_s']:.2f} "
            f"| {r['frac_gather_bound']:.2f} |"
        )
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"\n(written to {args.out})", file=sys.stderr)


if __name__ == "__main__":
    main()
