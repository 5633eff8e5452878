"""The flash attention sweep (``sputnik_tpu/bench/flash_sweep.py``) on the
port's flash kernels.

JAX sweeps the TPU kernels' strip shape: ``group`` (K/V blocks per grid
step) at one head and (``rows_per_step``, ``group``) at 8 heads, because the
forward's score dot is (rows_per_step * 128, dh, group * 128) on the MXU,
whose efficiency climbs with both. The CUDA flash kernels have no strips:
one CTA owns a 64-row query tile and walks its row's K/V blocks one at a
time (``csrc/flash_mha.cu``); ``flash_mha`` validates ``rows_per_step`` and
``group`` and ignores them, and ``flash_block_attention`` takes no
``group``. Every point of JAX's grid is then the same launch, so the sweep
collapses to the distinct launches, each timed once: the forward at one
head (``flash_block_attention``), the forward at 8 heads (``flash_mha``),
and the 8-head train step (the forward, then ``torch.autograd.grad`` through
the fused dQ and dK/dV kernels). JAX's audit config: T = 2048, a causal
band of window 8, d_head 128, bf16, seed 3; its roofline terms
(``bench.roofline``'s flash rows). Time: ``utils/profiling.py::device_time``
(100 calls replayed from a CUDA graph, the train step's backward included).

Run:  python -m sputnik_tpu_torch.bench.flash_sweep [--t 2048] [--heads 8]
      [--window 8] [--out FILE]
Writes ``sputnik_tpu_torch/bench/results/flash_sweep.json`` or ``--out``,
with the card's name and power limit and the reason the grid collapses.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

COLLAPSE = ("JAX's (rows_per_step, group) grid shapes the TPU kernels' strips; the CUDA flash kernels own a "
            "64-row query tile per CTA and walk K/V blocks one at a time, so flash_mha validates and ignores "
            "rows_per_step and group and every point of the grid is the same launch: each distinct launch is "
            "timed once")


def run(t: int = 2048, heads: int = 8, dh: int = 128, window: int = 8, dtype_name: str = "bfloat16"):
    from sputnik_tpu_torch.bench.models import PEAKS, sol_time
    from sputnik_tpu_torch.kernels.flash_attention import flash_block_attention
    from sputnik_tpu_torch.kernels.flash_mha import flash_mha
    from sputnik_tpu_torch.models import attention as attn_lib
    from sputnik_tpu_torch.utils import profiling

    dtype = getattr(torch, dtype_name)
    isz = torch.empty((), dtype=dtype).element_size()
    rng = np.random.default_rng(3)
    topo = attn_lib.causal_block_topology(t, 128, window_blocks=window, dtype=dtype)
    dev = topo.device
    q1 = torch.from_numpy(rng.standard_normal((t, dh)).astype(np.float32)).to(dev, dtype)
    qh = torch.from_numpy(rng.standard_normal((heads, t, dh)).astype(np.float32)).to(dev, dtype)
    # Roofline terms (bench.roofline's flash rows).
    f_flops = 4 * topo.nnz_blocks * 128 * 128 * dh
    f_bytes = topo.nnz_blocks * 2 * 128 * dh * isz + 2 * t * dh * isz
    vpu_elems = 6 * topo.nnz_blocks * 128 * 128
    rows = []

    def add(name, fn, args, flops, bytes_, vpu):
        try:
            m = profiling.device_time(fn, *args)
        except Exception as e:  # noqa: BLE001 - JAX's error row; the caller checks for them
            rows.append({"variant": name, "t": t, "error": str(e)[:140]})
            print(f"# {name}: FAILED {str(e)[:120]}", file=sys.stderr, flush=True)
            return
        s = sol_time(flops, bytes_, peak_flops=PEAKS["bf16_flops"], hbm_bps=PEAKS["hbm_bps"], vpu_elems=vpu)
        rows.append({"variant": name, "t": t, "time_us": m["time_s"] * 1e6, "eff_tflops": flops / m["time_s"] / 1e12,
                     "frac_sol": s / m["time_s"], "timing": m["timing"]})
        print(f"# {name}: {m['time_s'] * 1e6:8.1f} us  {s / m['time_s']:.3f} of SoL", file=sys.stderr, flush=True)

    add("flash_1h", lambda q_, k_, v_: flash_block_attention(q_, k_, v_, topo, causal=True),
        (q1, q1 + 0.1, q1 - 0.1), f_flops, f_bytes, vpu_elems)
    add(f"flash_mha_{heads}h", lambda q_, k_, v_: flash_mha(q_, k_, v_, topo, causal=True), (qh, qh + 0.1, qh - 0.1),
        heads * f_flops, heads * f_bytes, heads * vpu_elems)

    def train(q_, k_, v_):
        loss = torch.sum(flash_mha(q_, k_, v_, topo, causal=True).float() ** 2)
        grads = torch.autograd.grad(loss, (q_, k_, v_))
        return grads[0] + loss.to(q_.dtype)

    leaves = tuple(x.detach().requires_grad_() for x in (qh, qh + 0.1, qh - 0.1))
    add(f"flash_mha_{heads}h_train", train, leaves, heads * f_flops * 3, 3 * heads * f_bytes, 3 * heads * vpu_elems)
    return rows


def main(argv=None):
    from sputnik_tpu_torch.bench.calibrate import RESULTS
    from sputnik_tpu_torch.utils.profiling import card

    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=2048)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(RESULTS, "flash_sweep.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.flash_sweep needs a CUDA card: torch.cuda.is_available() is false")
    name = card()
    rows = run(t=args.t, heads=args.heads, window=args.window)
    print("| variant | time (us) | frac of SoL |")
    print("|---|---|---|")
    for r in rows:
        if "error" in r:
            print(f"| {r['variant']} | ERROR {r['error'][:60]} | |")
        else:
            print(f"| {r['variant']} | {r['time_us']:.1f} | {r['frac_sol']:.3f} |")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "card": name, "t": args.t, "heads": args.heads,
                   "window": args.window, "grid": COLLAPSE, "rows": rows}, f, indent=2)
    print(f"(written to {args.out})", file=sys.stderr)
    if any("error" in r for r in rows):
        raise SystemExit("a row failed")


if __name__ == "__main__":
    main()
