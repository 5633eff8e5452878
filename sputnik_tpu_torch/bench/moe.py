"""End-to-end MoE FFN benchmark on a CUDA card, the MegaBlocks headline
workload (``sputnik_tpu/bench/moe.py``).

Compares, at equal parameter count on one card, the forward of:
  * a dense FFN holding all experts' parameters (the "no MoE" cost);
  * the MoE with fixed capacity: ``grouped`` (batched per-expert GEMM),
    ``bsr`` (the fused group-FFN kernel) and ``bsr_unfused`` (SDD -> gelu
    -> DSD kernels);
  * the dropless MoE, whose block-diagonal topology is built on the card
    every step: ``ragged`` (grouped GEMM), ``bsr`` (SDD/DSD on the dropless
    topology) and ``bsr_fused`` (the fused dropless kernel).

Each forward is timed as device time: 100 calls replayed from one CUDA
graph between CUDA events, after 10 warm-up calls
(``utils/profiling.time_ms``); ``gflops`` counts the useful FLOP of a
top-1 MoE (each token visits one expert), ``speedup_vs_dense`` divides
the dense line's time by each line's.

Run:  python -m sputnik_tpu_torch.bench.moe [--d-model 1024] [--d-ff 2048]
      [--experts 8] [--tokens 4096] [--dtype bfloat16]
Writes one JSON line per impl to stdout. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from sputnik_tpu_torch.models import moe
from sputnik_tpu_torch.utils.profiling import time_ms

IMPLS = ("dense_equal_params", "moe_grouped", "moe_bsr", "moe_bsr_unfused", "moe_dropless",
         "moe_dropless_bsr", "moe_dropless_bsr_fused")


def forwards(cfg: moe.MoEConfig, tokens: int, device):
    """{impl: no-argument forward} at ``cfg``, random weights and tokens
    from seed 0, and the useful FLOP of one MoE forward."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = moe.init_moe_params(cfg, gen, device=device)
    topo = moe.block_diag_topology(cfg, device=device)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=device).to(cfg.dtype)
    w1 = torch.randn((cfg.d_model, cfg.ff_total), generator=gen, device=device).to(cfg.dtype)
    w2 = torch.randn((cfg.ff_total, cfg.d_model), generator=gen, device=device).to(cfg.dtype)

    def dense():
        h = F.gelu(torch.matmul(x, w1).float(), approximate="tanh").to(cfg.dtype)
        return torch.matmul(h, w2)

    fns = {
        "dense_equal_params": dense,
        "moe_grouped": lambda: moe.moe_forward(params, x, cfg, topo, impl="grouped")[0],
        "moe_bsr": lambda: moe.moe_forward(params, x, cfg, topo, impl="bsr")[0],
        "moe_bsr_unfused": lambda: moe.moe_forward(params, x, cfg, topo, impl="bsr_unfused")[0],
        "moe_dropless": lambda: moe.dropless_moe_forward(params, x, cfg)[0],
        "moe_dropless_bsr": lambda: moe.dropless_moe_forward(params, x, cfg, impl="bsr")[0],
        "moe_dropless_bsr_fused": lambda: moe.dropless_moe_forward(params, x, cfg, impl="bsr_fused")[0],
    }
    return fns, 2 * tokens * cfg.d_model * cfg.d_ff * 2


def run(d_model: int, d_ff: int, n_experts: int, tokens: int, dtype_name: str):
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.moe needs a CUDA card: torch.cuda.is_available() is false")
    dtype = getattr(torch, dtype_name)
    cfg = moe.MoEConfig(d_model=d_model, d_ff=d_ff, n_experts=n_experts,
                        capacity=tokens // n_experts, dtype=dtype)
    fns, moe_flops = forwards(cfg, tokens, torch.device("cuda"))
    results = []
    with torch.no_grad():
        for name in IMPLS:
            ms, _ = time_ms(fns[name])
            flops = moe_flops * (n_experts if name == "dense_equal_params" else 1)
            results.append({"impl": name, "time_us": ms * 1e3, "gflops": flops / ms / 1e6,
                            "timing": "cuda_graph"})
    base = results[0]["time_us"]
    for r in results:
        r["speedup_vs_dense"] = base / r["time_us"]
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--d-ff", type=int, default=2048)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    for r in run(args.d_model, args.d_ff, args.experts, args.tokens, args.dtype):
        print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v) for k, v in r.items()}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
