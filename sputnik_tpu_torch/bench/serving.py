"""Batched-decode serving benchmark: tokens/s at batch 1 / 8 / 32, band and
top-k decoding (``sputnik_tpu/bench/serving.py``).

The JAX package's two-point protocol: after one prefill per prompt, time
decode loops of ``n1`` and ``n2`` tokens on the same batch and report
``B * (n2 - n1) / (t2 - t1)``, which cancels the per-call costs (the first
pick, the loop's setup) and leaves the steady per-step rate. Each timed
loop starts from a fresh copy of the prefill's caches (the loop writes
them in place) and is timed between CUDA events; the median of ``runs``.
The model is the serving benchmark's (d_model 1024, 8 heads, seq_len
2048, window 4, 8 experts of d_ff 2048, 4 layers, vocab 8192, bf16) with
random weights from seed 0; prompts of 256 tokens; modes ``band`` and
``("topk", 4)``.

    python -m sputnik_tpu_torch.bench.serving [--batches 1 8 32] [--out FILE]

One JSON line per (batch, mode); it runs on the card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sputnik_tpu_torch.models import transformer as tr

__all__ = ["SERVE", "bench_mode", "run"]

SERVE = tr.TransformerConfig(d_model=1024, n_heads=8, seq_len=2048, window_blocks=4, n_experts=8, d_ff=2048,
                             n_layers=4, vocab=8192, dtype=torch.bfloat16)
PROMPT = 256
MODES = (("band", None), ("topk", 4))


def _fresh(caches):
    return [{name: x.clone() for name, x in layer.items()} for layer in caches]


def _decode_ms(params, first, caches, tp, cfg, n_new, mode, k_pages) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    tr.decode_tokens(params, first, caches, tp, cfg, n_new, mode=mode, k_pages=k_pages)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


@torch.no_grad()
def bench_mode(params, cfg, prompts, *, mode: str, k_pages, n1: int, n2: int, runs: int = 3) -> dict:
    """One (batch, mode) row: per-step time and tokens/s by the two-point
    protocol."""
    bsz, tp = prompts.shape
    per_seq = [tr.lm_prefill(params, prompts[i], cfg, cfg.seq_len) for i in range(bsz)]
    caches = [{name: torch.stack([c[layer][name] for c, _ in per_seq]) for name in ("k", "v")}
              for layer in range(cfg.n_layers)]
    first = torch.stack([logits for _, logits in per_seq])
    results = {}
    for n_new in (n1, n2):
        _decode_ms(params, first, _fresh(caches), tp, cfg, n_new, mode, k_pages)  # warm-up
        ts = sorted(_decode_ms(params, first, _fresh(caches), tp, cfg, n_new, mode, k_pages) for _ in range(runs))
        results[n_new] = ts[len(ts) // 2]
    t_step = (results[n2] - results[n1]) / (n2 - n1)  # ms
    return {
        "mode": mode if k_pages is None else f"{mode}-{k_pages}",
        "batch": int(bsz),
        "t_per_step_us": t_step * 1e3,
        "tokens_per_s": bsz / t_step * 1e3 if t_step > 0 else float("inf"),
        "wall_n1_ms": results[n1],
        "wall_n2_ms": results[n2],
        "n1": n1,
        "n2": n2,
        "runs": runs,
        "device": torch.cuda.get_device_name(0),
    }


def run(batches=(1, 8, 32), n1: int = 16, n2: int = 80, runs: int = 3):
    """The benchmark's rows, one per (batch, mode)."""
    if not torch.cuda.is_available():
        raise SystemExit("the serving bench needs a CUDA card")
    params = tr.init_lm_params(SERVE, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(3)
    rows = []
    for bsz in batches:
        prompts = torch.from_numpy(rng.integers(0, SERVE.vocab, (bsz, PROMPT))).cuda()
        for mode, k_pages in MODES:
            print(f"[serving] batch={bsz} mode={mode} ...", file=sys.stderr, flush=True)
            rows.append(bench_mode(params, SERVE, prompts, mode=mode, k_pages=k_pages, n1=n1, n2=n2, runs=runs))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--n1", type=int, default=16)
    ap.add_argument("--n2", type=int, default=80)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args()
    rows = run(tuple(args.batches), args.n1, args.n2, args.runs)
    for row in rows:
        print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
