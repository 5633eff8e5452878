"""Measured machine peaks of the card (``sputnik_tpu/bench/calibrate.py``).

The headline fraction of ``bench/dsd.py`` divides by the H100's data-sheet
peaks (``bench/models.py``): the denominator of record. What a program can reach is measured here with the same protocol
as every kernel time (``utils/profiling.py::device_time``: 100 calls
replayed from a CUDA graph):

* ``dense_bf16_tflops``: ``torch.matmul`` of two bf16 d x d matrices
  (cuBLAS, the most favorable product this card runs);
* ``dense_f32_tflops``: the same in fp32 with TF32 off
  (``torch.backends.cuda.matmul.allow_tf32 = False``, precision
  "highest"), set for the measurement and restored after it;
* ``hbm_gbps``: one streaming pass, read and write, over a 256 MB fp32
  buffer, five times the 50 MB L2.

``mxu_efficiency`` / ``hbm_efficiency`` are the first and last against
the data sheet; a consumer reports its fraction of the achievable peak
beside the data-sheet one, with the ceilings scaled by them. A file
written on another card (or at another power limit) is not used.

Run:  python -m sputnik_tpu_torch.bench.calibrate [--d 4096] [--out FILE]
Writes ``sputnik_tpu_torch/bench/results/machine_peak.json`` (not
``docs/``, which holds the JAX package's TPU records), with the card's
name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from sputnik_tpu_torch.bench.models import PEAKS
from sputnik_tpu_torch.utils.profiling import card, device_time

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
PEAK_FILE = os.path.join(RESULTS, "machine_peak.json")


def load_measured_peaks(path: str | None = None) -> dict | None:
    """The measured peaks, or None when the file is missing or unreadable,
    an efficiency lies outside (0, 1.05], or the file's ``card`` (name and
    power limit) is not :func:`card`, the card this process runs on: a
    stale, garbled or foreign calibration must not skew a fraction."""
    try:
        with open(path or PEAK_FILE) as f:
            peak = json.load(f)
    except (OSError, ValueError):
        return None
    if not all(0 < peak.get(key, 0) <= 1.05 for key in ("mxu_efficiency", "hbm_efficiency")):
        return None
    if peak.get("card") != card():
        return None
    return peak


def measure(d: int = 4096, stream_mb: int = 256) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("calibrate.measure needs a CUDA card: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    out: dict = {
        "device": torch.cuda.get_device_name(0),
        "card": card(),
        "protocol": {"timing": "cuda_graph", "warmup": 10, "iters": 100, "d": d, "stream_mb": stream_mb},
        "spec": {"bf16_tflops": PEAKS["bf16_flops"] / 1e12, "f32_tflops": PEAKS["f32_flops"] / 1e12,
                 "hbm_gbps": PEAKS["hbm_bps"] / 1e9},
    }
    flops = 2.0 * d * d * d

    a32 = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)).to(dev)
    b32 = torch.from_numpy(rng.standard_normal((d, d)).astype(np.float32)).to(dev)
    a16, b16 = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
    m = device_time(torch.matmul, a16, b16)
    out["dense_bf16_tflops"] = flops / m["time_s"] / 1e12
    out["dense_bf16_us"] = m["time_s"] * 1e6
    out["dense_bf16_timing"] = m["timing"]
    print(f"# dense bf16 {d}^3: {m['time_s'] * 1e6:.1f} us  {out['dense_bf16_tflops']:.1f} TF "
          f"({out['dense_bf16_tflops'] / out['spec']['bf16_tflops']:.3f} of spec, {m['timing']})",
          file=sys.stderr, flush=True)

    tf32, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        m = device_time(torch.matmul, a32, b32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
    out["dense_f32_tflops"] = flops / m["time_s"] / 1e12
    out["dense_f32_us"] = m["time_s"] * 1e6
    print(f"# dense f32 (TF32 off) {d}^3: {m['time_s'] * 1e6:.1f} us  {out['dense_f32_tflops']:.1f} TF",
          file=sys.stderr, flush=True)
    del a32, b32, a16, b16

    n_elems = (stream_mb * (1 << 20) // 4) // 1024 * 1024
    x = torch.from_numpy(rng.standard_normal(n_elems).astype(np.float32)).to(dev)
    y = torch.empty_like(x)
    m = device_time(lambda v: torch.mul(v, 1.000001, out=y), x)
    stream_bytes = 2.0 * n_elems * 4  # read + write
    out["hbm_gbps"] = stream_bytes / m["time_s"] / 1e9
    out["stream_us"] = m["time_s"] * 1e6
    print(f"# stream {stream_mb} MB: {m['time_s'] * 1e6:.1f} us  {out['hbm_gbps']:.0f} GB/s "
          f"({out['hbm_gbps'] / out['spec']['hbm_gbps']:.3f} of spec)", file=sys.stderr, flush=True)

    out["mxu_efficiency"] = out["dense_bf16_tflops"] / out["spec"]["bf16_tflops"]
    out["f32_efficiency"] = out["dense_f32_tflops"] / out["spec"]["f32_tflops"]
    out["hbm_efficiency"] = out["hbm_gbps"] / out["spec"]["hbm_gbps"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--out", default=PEAK_FILE)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sputnik_tpu_torch.bench.calibrate needs a CUDA card: torch.cuda.is_available() is false")
    res = measure(d=args.d)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({k: v for k, v in res.items() if isinstance(v, (float, str))}))
    print(f"(written to {os.path.abspath(args.out)})", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
