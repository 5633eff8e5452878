#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (sputnik_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card (nvidia-smi name and power limit) and the torch / CUDA
   versions; build the two CUDA kernels from csrc/ and print the seconds.
2. Kernel against its plain PyTorch version on the card, pointwise within
   ATOL = 5e-2: DSD, DDS and SDD in all four transpose modes at the
   attention shapes (T = 1024 and 2048, window 4, d_head 128, 8 heads), DSD at the
   4096^2 / 25% headline shape, a random BSR with empty block-rows and
   unordered column indices, a random 25% SDD topology; bf16 (fp32 and
   bf16 outputs) and fp32.
3. The serving slice: the sparse LM at the serving benchmark's width
   (d_model 1024, 8 heads, 8 experts, d_ff 2048, vocab 8192, 4 layers,
   bf16, random weights from seed 0) serves 4 requests of 1024-token
   prompts, 32 new tokens each, through lm_generate_batched. Checks the
   token ids, that a second run gives the same tokens, that every prefill
   layer launched each kernel once (16 launches each), and that parameters
   and caches live on the card.
4. The same model in fp32 (TF32 off): each request's prefill logits through
   the kernels against the plain versions (registry.forced_variant), max
   |diff| <= 1e-3;
   then four band-decode steps against the full sparse forward, <= 2e-3.
5. Kernel and plain-version times at the slice's shapes (CUDA events, 10
   warm-up and 100 timed iterations): device time from a CUDA graph of the
   100 calls, and the eager per-call time with the host's cost.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sputnik_tpu_torch.kernels import _build, bsr_dsd, bsr_sdd
from sputnik_tpu_torch.models import attention
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

MODES = [(False, False), (False, True), (True, False), (True, True)]
SERVE = tr.TransformerConfig(
    d_model=1024, n_heads=8, seq_len=2048, window_blocks=4, n_experts=8,
    d_ff=2048, n_layers=4, vocab=8192, dtype=torch.bfloat16,
)
N_REQUESTS, PROMPT, N_NEW = 4, 1024, 32
DEV = torch.device("cuda")


class PhaseError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def randn(rng, shape, dtype, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(DEV, dtype)


def rand_bsr(rng, rows, cols, density, dtype, *, unordered=False, scale=1.0):
    m = testing.random_bsr(rng, rows, cols, int(rows * cols * density), 128,
                           unordered=unordered, device=DEV)
    return m.with_data(randn(rng, tuple(m.data.shape), dtype, scale))


def band(t, dtype, rng, batch, scale):
    topo = attention.causal_block_topology(t, window_blocks=4, dtype=dtype, device=DEV)
    return topo.with_data(randn(rng, (batch,) + tuple(topo.data.shape), dtype, scale))


def stored(shape_mk, transposed):
    m, k = shape_mk[-2:]
    return shape_mk[:-2] + ((k, m) if transposed else (m, k))


# ----------------------------------------------------------------- phase 2 --
def kernel_cases(rng, errors):
    """Every case compares with out_dtype fp32 (the kernel's arithmetic) and
    with the operands' dtype (the kernel's store), inputs scaled so outputs
    are of order one."""

    def compare(name, kernel_fn, plain_fn, dtype):
        errs = []
        for out_dtype in dict.fromkeys((torch.float32, dtype)):
            got = kernel_fn(out_dtype)
            want = plain_fn(out_dtype)
            got = got.data if hasattr(got, "offsets") else got
            want = want.data if hasattr(want, "offsets") else want
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
            check(float(want.float().abs().max()) > 0, f"{name}: plain output is all zero")
            err = float((got.float() - want.float()).abs().max())
            check(err <= ATOL, f"{name} out={out_dtype}: max |kernel - plain| = {err} > {ATOL}")
            errs.append(f"{str(out_dtype).split('.')[-1]} out {err:.3e}")
            kernel = "bsr_sdd" if name.startswith("sdd") else "bsr_dsd_stream"
            errors[kernel] = max(errors.get(kernel, 0.0), err)
        print(f"  {name:<42} {str(dtype).split('.')[-1]:<9} max|kernel-plain|: {', '.join(errs)}",
              flush=True)

    def dsd_case(name, a, b, ta, tb):
        compare(name, lambda o: bsr_dsd.dsd(a, b, transpose_a=ta, transpose_b=tb, out_dtype=o),
                lambda o: bsr_dsd.dsd_reference(a, b, transpose_a=ta, transpose_b=tb, out_dtype=o), a.dtype)

    def dds_case(name, a, b, ta, tb):
        compare(name, lambda o: bsr_dsd.dds(a, b, transpose_a=ta, transpose_b=tb, out_dtype=o),
                lambda o: bsr_dsd.dds_reference(a, b, transpose_a=ta, transpose_b=tb, out_dtype=o), b.dtype)

    def sdd_case(name, a, b, topo, ta, tb):
        compare(name, lambda o: bsr_sdd.sdd(a, b, topo, transpose_a=ta, transpose_b=tb, out_dtype=o),
                lambda o: bsr_sdd.sdd_reference(a, b, topo, transpose_a=ta, transpose_b=tb, out_dtype=o), a.dtype)

    h, dh = SERVE.n_heads, SERVE.d_head
    # Attention shapes: probs (8 heads) @ v, scores q @ k^T, at the slice's
    # prompt (26 blocks) and at the full sequence (58 blocks).
    for t, nnz in ((PROMPT, 26), (SERVE.seq_len, 58)):
        for dtype in (torch.bfloat16, torch.float32):
            probs = band(t, dtype, rng, h, 1.0 / 16)
            check(probs.nnz_blocks == nnz, f"T={t} topology has {probs.nnz_blocks} blocks, not {nnz}")
            for ta, tb in MODES:
                v = randn(rng, stored((h, t, dh), tb), dtype)
                dsd_case(f"dsd attention T={t} ta={ta:d} tb={tb:d}", probs, v, ta, tb)
                x = randn(rng, stored((h, dh, t), ta), dtype)
                dds_case(f"dds attention T={t} ta={ta:d} tb={tb:d}", x, probs, ta, tb)
                q = randn(rng, stored((h, t, dh), ta), dtype, dh ** -0.5)
                k = randn(rng, stored((h, dh, t), tb), dtype)
                sdd_case(f"sdd attention T={t} ta={ta:d} tb={tb:d}", q, k, probs, ta, tb)
    dtype = torch.bfloat16
    # The bench.py headline shape: 4096^2 at 25% block density, N = 4096.
    a = rand_bsr(rng, 4096, 4096, 0.25, dtype, scale=1024 ** -0.5)
    dsd_case("dsd 4096^2 25% N=4096", a, randn(rng, (4096, 4096), dtype), False, False)
    # Six blocks over eight block-rows: empty rows, unordered indices.
    a = rand_bsr(rng, 1024, 1024, 6 / 64, dtype, unordered=True, scale=1 / 16)
    check(a.min_row_nnz == 0, "the empty-row case has no empty row")
    for ta, tb in MODES:
        b = randn(rng, stored((1024, 256), tb), dtype)
        dsd_case(f"dsd empty rows unordered ta={ta:d} tb={tb:d}", a, b, ta, tb)
    # SDD on a random 25% topology, K = 512.
    topo = rand_bsr(rng, 1024, 1024, 0.25, dtype, unordered=True)
    for ta, tb in MODES:
        x = randn(rng, stored((1024, 512), ta), dtype, 512 ** -0.5)
        y = randn(rng, stored((512, 1024), tb), dtype)
        sdd_case(f"sdd random 25% K=512 ta={ta:d} tb={tb:d}", x, y, topo, ta, tb)


# ----------------------------------------------------------------- phase 5 --
def time_ms(fn, warmup=10, iters=100):
    """(device, call): milliseconds per call. ``device`` replays the ``iters``
    calls captured in one CUDA graph between two CUDA events, so the host's
    launch cost is left out; ``call`` times ``iters`` eager calls the same
    way, the host's cost included (a small kernel can wait on its host)."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    call = start.elapsed_time(stop) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, call


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()

    print("== phase 1: card and build", flush=True)
    print(f"card: {name_limit}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    start = time.perf_counter()
    bsr_dsd._kernel()
    bsr_sdd._kernel()
    print(f"kernels built and loaded in {time.perf_counter() - start:.1f} s "
          f"(per library: {_build.build_seconds})", flush=True)

    print("== phase 2: kernels against their plain versions", flush=True)
    errors: dict = {}
    kernel_cases(np.random.default_rng(0), errors)

    print("== phase 3: serving slice", flush=True)
    lm = tr.init_lm_params(SERVE, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    check(all(p.is_cuda for p in lm.parameters()), "a parameter is not on the card")
    n_params = sum(p.numel() for p in lm.parameters())
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, SERVE.vocab, (N_REQUESTS, PROMPT))
    ).to(DEV)
    caches, _ = tr.lm_prefill(lm, prompts[0], SERVE, SERVE.seq_len)
    check(all(c[k].is_cuda for c in caches for k in ("k", "v")), "a cache is not on the card")
    del caches
    torch.cuda.synchronize()
    bsr_dsd.LAUNCHES = bsr_sdd.LAUNCHES = 0
    tokens = tr.lm_generate_batched(lm, prompts, SERVE, N_NEW)
    torch.cuda.synchronize()
    launches = {"bsr_dsd_stream": bsr_dsd.LAUNCHES, "bsr_sdd": bsr_sdd.LAUNCHES}
    expected = SERVE.n_layers * N_REQUESTS
    check(launches == {"bsr_dsd_stream": expected, "bsr_sdd": expected},
          f"kernel launches {launches}, expected {expected} of each")
    check(tuple(tokens.shape) == (N_REQUESTS, N_NEW), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < SERVE.vocab)).all()), "token id out of range")
    start = time.perf_counter()
    again = tr.lm_generate_batched(lm, prompts, SERVE, N_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    check(torch.equal(tokens, again), "a second run gave other tokens")
    start = time.perf_counter()
    for i in range(N_REQUESTS):
        tr.lm_prefill(lm, prompts[i], SERVE, SERVE.seq_len)
    torch.cuda.synchronize()
    prefill = time.perf_counter() - start
    print(f"{n_params / 1e6:.1f} M parameters; {N_REQUESTS} requests x {N_NEW} tokens; "
          f"launches {launches}", flush=True)
    print(f"first tokens: {tokens[:, :8].tolist()}", flush=True)
    print(f"served in {wall:.3f} s wall: {N_REQUESTS * N_NEW / wall:.1f} generated tokens/s "
          f"(prefill included; informational) on {name_limit}", flush=True)
    print(f"  of which {N_REQUESTS} prefills of {PROMPT} tokens {prefill:.3f} s, "
          f"{N_NEW - 1} batched decode steps {wall - prefill:.3f} s "
          f"({(wall - prefill) / (N_NEW - 1) * 1e3:.2f} ms per step)", flush=True)
    del lm

    print("== phase 4: fp32 slice, kernels against plain versions", flush=True)
    cfg32 = dataclasses.replace(SERVE, dtype=torch.float32)
    lm32 = tr.init_lm_params(cfg32, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    # Every request's prompt: the greedy tokens of phase 3 are degenerate
    # with random weights, so these logits are the slice's real check.
    for i in range(N_REQUESTS):
        before = (bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES)
        _, logits_kernel = tr.lm_prefill(lm32, prompts[i], cfg32, cfg32.seq_len)
        check((bsr_dsd.LAUNCHES - before[0], bsr_sdd.LAUNCHES - before[1]) == (cfg32.n_layers,) * 2,
              "the fp32 prefill did not run each kernel once per layer")
        before = (bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES)
        with registry.forced_variant("torch_reference"):
            _, logits_plain = tr.lm_prefill(lm32, prompts[i], cfg32, cfg32.seq_len)
        torch.cuda.synchronize()
        check((bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES) == before, "the plain prefill launched a kernel")
        slice_err = float((logits_kernel - logits_plain).abs().max())
        print(f"request {i}: prefill logits max |kernels - plain| = {slice_err:.3e} "
              f"(|logits| max {float(logits_plain.abs().max()):.2f})", flush=True)
        check(bool(torch.isfinite(logits_kernel).all()), "non-finite fp32 logits")
        check(slice_err <= 1e-3, f"fp32 slice differs from the plain path by {slice_err} > 1e-3")
    # Band decoding reproduces the full sparse forward (the JAX package's
    # decode == forward contract), with a capacity that drops no token.
    full_cfg = dataclasses.replace(cfg32, capacity=cfg32.seq_len)
    seq = torch.from_numpy(np.random.default_rng(2).integers(0, SERVE.vocab, cfg32.seq_len)).to(DEV)
    full, _ = tr.lm_forward(lm32, seq, full_cfg)
    caches, _ = tr.lm_prefill(lm32, seq[:PROMPT], full_cfg, cfg32.seq_len)
    decode_err = 0.0
    for pos in range(PROMPT, PROMPT + 4):
        logits, caches = tr.lm_decode_step(lm32, seq[pos], caches, pos, full_cfg)
        decode_err = max(decode_err, float((logits - full[pos]).abs().max()))
    print(f"decode logits max |decode - full forward| over 4 steps = {decode_err:.3e}", flush=True)
    check(decode_err <= 2e-3, f"decoding differs from the full forward by {decode_err} > 2e-3")
    del lm32, caches

    print(f"== phase 5: times at the slice's shapes on {name_limit} "
          "(CUDA events, 10 warm-up + 100 timed; device = CUDA-graph replay, "
          "call = eager calls with their host cost)", flush=True)
    rng = np.random.default_rng(1)
    h, dh, bf16 = SERVE.n_heads, SERVE.d_head, torch.bfloat16
    topo = attention.causal_block_topology(PROMPT, window_blocks=SERVE.window_blocks, dtype=bf16, device=DEV)
    q, k, v = (randn(rng, (h, PROMPT, dh), bf16) for _ in range(3))
    probs = topo.with_data(randn(rng, (h,) + tuple(topo.data.shape), bf16))
    times = {
        "bsr_sdd": (time_ms(lambda: bsr_sdd.sdd(q, k, topo, transpose_b=True)),
                    time_ms(lambda: bsr_sdd.sdd_reference(q, k, topo, transpose_b=True))),
        "bsr_dsd_stream": (time_ms(lambda: bsr_dsd.dsd(probs, v)),
                           time_ms(lambda: bsr_dsd.dsd_reference(probs, v))),
    }
    for kname, (kern, plain) in times.items():
        print(f"  {kname:<15} T={PROMPT} {topo.nnz_blocks} blocks x {h} heads, bf16: "
              f"kernel {kern[0] * 1e3:.2f} us device / {kern[1] * 1e3:.2f} us call, "
              f"plain {plain[0] * 1e3:.2f} us device / {plain[1] * 1e3:.2f} us call", flush=True)
    a = rand_bsr(rng, 4096, 4096, 0.25, bf16)
    b = randn(rng, (4096, 4096), bf16)
    (ms, _), (plain, _) = time_ms(lambda: bsr_dsd.dsd(a, b)), time_ms(lambda: bsr_dsd.dsd_reference(a, b))
    flop = 2 * a.nnz_blocks * 128 * 128 * 4096
    print(f"  bsr_dsd_stream  4096^2 25% N=4096 bf16: kernel {ms * 1e3:.2f} us device "
          f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain * 1e3:.2f} us device", flush=True)

    sources = {
        "bsr_dsd_stream": ("sputnik_tpu_torch/csrc/bsr_dsd.cu", "sputnik_tpu/kernels/bsr_dsd.py:76"),
        "bsr_sdd": ("sputnik_tpu_torch/csrc/bsr_sdd.cu", "sputnik_tpu/kernels/bsr_sdd.py:229"),
    }
    print(name_limit, flush=True)
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[kname], "max_abs_err": errors[kname],
         "ms": times[kname][0][0], "plain_ms": times[kname][1][0]}
        for kname, (src, rep) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
