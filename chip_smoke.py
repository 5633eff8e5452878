#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (sputnik_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card (nvidia-smi name and power limit) and the torch / CUDA
   versions; build the four CUDA libraries from csrc/ (one nvcc each, all
   started together) and print the seconds.
2. Kernel against its plain PyTorch version on the card, pointwise within
   ATOL = 5e-2: DSD, DDS and SDD in all four transpose modes at the
   attention shapes (T = 1024 and 2048, window 4, d_head 128, 8 heads), DSD at the
   4096^2 / 25% headline shape, a random BSR with empty block-rows and
   unordered column indices, a random 25% SDD topology; the three flash
   kernels (forward with lse, dQ, dK/dV) at the training slice's shape
   (8 heads, T = 2048, causal band of window 4), on a random non-causal
   topology with an empty block-row and an empty block-column, and with
   rectangular K/V (T = 1024, Tk = 2048); the fused FFN kernels at the MoE
   bench shape (d_model 1024, 8 experts of d_ff 2048, 4096 rows): the group
   kernel on the block-diagonal plan, a permuted group layout and one
   block-row per group, with gelu, relu and identity, and the dropless
   kernel on ragged groups with an empty expert and dead tiles, tile_rows
   128 and 256 (live rows only); bf16 (fp32 and bf16 outputs) and fp32.
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
5. Kernel and plain-version times at the slices' shapes (CUDA events, 10
   warm-up and 100 timed iterations): device time from a CUDA graph of the
   100 calls, and the eager per-call time with the host's cost; the flash
   kernels at 8 heads, T = 2048, d_head 128, bf16, through their wrappers.
6. The training slice, bf16, the same model: 5 Adam steps (lr 3e-3) on a
   fixed batch of 4 sequences of 2048 tokens (loss = mean of the 4
   lm_loss), once with fused_attention (flash kernels) and once without
   (SDD -> softmax -> DSD and their VJPs). Checks finite losses, the last
   below the first, parameters, gradients and Adam state on the card, and
   the exact launches per step: fused 16 of each flash kernel and no
   sparse kernel; unfused 64 bsr_dsd_stream and 32 bsr_sdd and no flash
   kernel. Prints the wall time per step (informational).
7. The same model in fp32 (TF32 off), both routes: one backward of the
   batch loss through the kernels against the plain versions
   (registry.forced_variant), every parameter's gradient within
   1e-3 * max|g|; prints the worst parameter.

8. The MoE slice at bench/moe.py's default width (d_model 1024, 8 experts
   of d_ff 2048, 4096 tokens, capacity 512): (a) fp32, TF32 off: the
   forwards that reach a kernel (bsr, bsr_unfused, dropless bsr and
   bsr_fused) against themselves on the plain versions within 1e-3; the
   capacity impls agree, and the dropless impls agree with each other and
   with grouped at a capacity that drops nothing; (b) the exact launches of
   each forward; (c) all six bf16 forwards under
   torch.cuda.set_sync_debug_mode("error"); (d) fp32 gradients of
   mean(y^2) + 0.01 aux through bsr and dropless bsr_fused against the plain
   path within 1e-3 * max|g|, with the backward's exact launches; (e) 5 bf16
   Adam steps (lr 3e-3) on each, losses finite and falling; (f) the
   bench/moe.py lines; (g) both FFN kernels' device times against their
   plain versions.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sputnik_tpu_torch.bench import moe as moe_bench
from sputnik_tpu_torch.kernels import _build, bsr_dsd, bsr_ffn, bsr_sdd
from sputnik_tpu_torch.kernels import flash_mha as fm
from sputnik_tpu_torch.models import attention, moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.profiling import time_ms
from sputnik_tpu_torch.utils.testing import ATOL

MODES = [(False, False), (False, True), (True, False), (True, True)]
SERVE = tr.TransformerConfig(
    d_model=1024, n_heads=8, seq_len=2048, window_blocks=4, n_experts=8,
    d_ff=2048, n_layers=4, vocab=8192, dtype=torch.bfloat16,
)
N_REQUESTS, PROMPT, N_NEW = 4, 1024, 32
TRAIN_BATCH, TRAIN_STEPS, LR = 4, 5, 3e-3
FLASH = tuple(fm.LAUNCHES)  # flash_mha_fwd, flash_mha_dq, flash_mha_dkv
FFN = tuple(bsr_ffn.LAUNCHES)  # bsr_ffn_group, bsr_ffn_dropless
KERNELS = ("bsr_dsd_stream", "bsr_sdd") + FLASH + FFN
# The MoE slice: bench/moe.py's default config (the serving LM's MoE layer).
MOE = moe.MoEConfig(d_model=1024, d_ff=2048, n_experts=8, capacity=512, dtype=torch.bfloat16)
# lr 3e-3, as the LM's training phase: at this width lr 1e-2 (examples/
# moe_training.py's, for d_model 256) overshoots on the second step through
# every impl and on the plain path alike (PERF.md, Findings).
MOE_TOKENS, MOE_STEPS, MOE_LR = 4096, 5, 3e-3
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


def flash_cases(rng, errors):
    """The flash forward (out and lse), dQ and dK/dV kernels against their
    plain versions on the same inputs; the backward passes of both read the
    plain forward's lse and dvec. v and dO are scaled by 1/2 so that every
    output is of order one."""

    def case(name, topo, h, t, tk, causal, dtype):
        q, k = randn(rng, (h, t, 128), dtype), randn(rng, (h, tk, 128), dtype)
        v, do = randn(rng, (h, tk, 128), dtype, 0.5), randn(rng, (h, t, 128), dtype, 0.5)
        kw = dict(causal=causal, scale=128 ** -0.5)
        errs = []
        for out_dtype in dict.fromkeys((torch.float32, dtype)):
            out, lse = fm.fwd(q, k, v, topo, out_dtype=out_dtype, **kw)
            ref_out, ref_lse = fm.fwd_reference(q, k, v, topo, out_dtype=out_dtype, **kw)
            dvec = (do.float() * ref_out.float()).sum(-1)
            args = (q, k, v, do, ref_lse, dvec, topo)
            pairs = {
                "flash_mha_fwd": [(out, ref_out), (lse, ref_lse)],
                "flash_mha_dq": [(fm.dq(*args, out_dtype=out_dtype, **kw),
                                  fm.dq_reference(*args, out_dtype=out_dtype, **kw))],
                "flash_mha_dkv": list(zip(fm.dkv(*args, out_dtype=out_dtype, **kw),
                                          fm.dkv_reference(*args, out_dtype=out_dtype, **kw))),
            }
            torch.cuda.synchronize()
            for kname, results in pairs.items():
                err = 0.0
                for got, want in results:
                    check(got.shape == want.shape, f"{name} {kname}: shape {tuple(got.shape)}")
                    check(bool(torch.isfinite(got.float()).all()), f"{name} {kname}: non-finite output")
                    check(float(want.float().abs().max()) > 0, f"{name} {kname}: plain output is all zero")
                    err = max(err, float((got.float() - want.float()).abs().max()))
                check(err <= ATOL, f"{name} {kname} out={out_dtype}: max |kernel - plain| = {err} > {ATOL}")
                errors[kname] = max(errors.get(kname, 0.0), err)
                errs.append(f"{kname[10:]} {err:.3e}")
            errs[-3] = f"{str(out_dtype).split('.')[-1]} out: {errs[-3]}"
        print(f"  flash {name:<36} {str(dtype).split('.')[-1]:<9} max|kernel-plain|: {', '.join(errs)}",
              flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        h = SERVE.n_heads
        topo = attention.causal_block_topology(SERVE.seq_len, window_blocks=SERVE.window_blocks,
                                               dtype=dtype, device=DEV)
        case(f"slice H={h} T={SERVE.seq_len} causal band", topo, h, SERVE.seq_len, SERVE.seq_len, True, dtype)
        # 8 x 8 blocks at ~40%, unordered within rows; block-row 2 and
        # block-column 5 empty.
        mask = rng.random((8, 8)) < 0.4
        mask[2, :] = False
        mask[:, 5] = False
        rows, cols = np.nonzero(mask)
        cols = np.concatenate([rng.permutation(cols[rows == r]) for r in range(8)])
        topo = testing.bsr_from_blocks(1024, 1024, rows, cols, np.zeros((len(rows), 128, 128)),
                                       dtype=dtype, device=DEV)
        check(topo.min_row_nnz == 0 and topo.min_col_nnz == 0, "the random topology lost its empty row/column")
        case("random non-causal empty row+col T=1024", topo, 4, 1024, 1024, False, dtype)
        topo = rand_bsr(rng, 1024, 2048, 0.3, dtype, unordered=True)
        case("rectangular T=1024 Tk=2048", topo, 4, 1024, 2048, False, dtype)


def ffn_cases(rng, errors):
    """The fused FFN kernels against their plain versions at the MoE bench
    shape (d_model 1024, 8 experts of d_ff 2048, 4096 routed rows): the
    group kernel on the block-diagonal plan (4 block-rows per group), on a
    permuted group layout (expert runs and the column ids inside each run
    out of order) and with one block-row per group; gelu, relu and
    identity; the dropless kernel on ragged groups with one expert routed
    no tile and live tiles below the tile count, at tile_rows 128 and 256,
    compared on the live rows only. W2 is scaled so outputs stay below 8,
    where one bf16 ulp is within ATOL."""
    d, d_ff, n_exp = MOE.d_model, MOE.d_ff, MOE.n_experts
    f_blocks = d_ff // 128
    diag = np.arange(n_exp * f_blocks)
    runs = diag.reshape(n_exp, f_blocks)
    permuted = np.concatenate([rng.permutation(r) for r in runs[rng.permutation(n_exp)]])
    one_row = np.tile(runs, (4, 1)).reshape(-1)  # 32 groups of one block-row
    # Tiles of 256 rows: expert 1 routed none; 18 of 24 tiles live.
    tiles = np.array([0] * 5 + [2] * 3 + [3] * 4 + [4] * 2 + [5] * 2 + [6] * 1 + [7] * 1 + [7] * 6, np.int32)
    live = 18

    def case(name, dtype, got_fn, want_fn, n_rows, kernel):
        errs = []
        for out_dtype in dict.fromkeys((torch.float32, dtype)):
            got, want = got_fn(out_dtype)[:n_rows], want_fn(out_dtype)[:n_rows]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
            check(float(want.float().abs().max()) > 0.1, f"{name}: plain output is about zero")
            err = float((got.float() - want.float()).abs().max())
            check(err <= ATOL, f"{name} out={out_dtype}: max |kernel - plain| = {err} > {ATOL}")
            errors[kernel] = max(errors.get(kernel, 0.0), err)
            errs.append(f"{str(out_dtype).split('.')[-1]} out {err:.3e}")
        print(f"  {name:<42} {str(dtype).split('.')[-1]:<9} max|kernel-plain|: {', '.join(errs)}", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        x = randn(rng, (MOE_TOKENS, d), dtype)
        w1 = randn(rng, (d, n_exp * d_ff), dtype, d ** -0.5)
        w2 = randn(rng, (n_exp * d_ff, d), dtype, 0.5 * d_ff ** -0.5)
        layouts = [("block_diag", diag, 4), ("permuted", permuted, 4), ("one block-row per group", one_row, 1)]
        for layout, cols, rows_per_group in layouts:
            cols = torch.from_numpy(cols.astype(np.int32)).to(DEV)
            acts = ("gelu", "relu", "identity") if layout == "block_diag" else ("gelu",)
            for act in acts:
                kw = dict(activation=act)
                case(f"bsr_ffn_group {layout} {act}", dtype,
                     lambda o: bsr_ffn.group_ffn(x, w1, w2, cols, rows_per_group, out_dtype=o, **kw),
                     lambda o: bsr_ffn.fused_group_ffn_reference(x, w1, w2, cols, rows_per_group,
                                                                 out_dtype=o, **kw),
                     MOE_TOKENS, "bsr_ffn_group")
        xt = randn(rng, (len(tiles) * 256, d), dtype)
        for tile_rows in (128, 256):
            per = 256 // tile_rows
            e_row = torch.from_numpy(np.repeat(tiles, per)).to(DEV)
            lv = torch.tensor(live * per, dtype=torch.int32, device=DEV)
            kw = dict(tile_rows=tile_rows, live_rows=lv)
            case(f"bsr_ffn_dropless tile_rows={tile_rows} live {live * per}/{len(tiles) * per}", dtype,
                 lambda o: bsr_ffn.dropless_ffn(xt, w1, w2, e_row, d_ff, out_dtype=o, **kw),
                 lambda o: bsr_ffn.fused_dropless_ffn_reference(xt, w1, w2, e_row, d_ff, out_dtype=o, **kw),
                 live * 256, "bsr_ffn_dropless")


# ------------------------------------------------------------- phases 6, 7 --
def reset_launches() -> None:
    bsr_dsd.LAUNCHES = bsr_sdd.LAUNCHES = 0
    fm.LAUNCHES.update(dict.fromkeys(FLASH, 0))
    bsr_ffn.LAUNCHES.update(dict.fromkeys(FFN, 0))


def launch_counts() -> dict:
    return {"bsr_dsd_stream": bsr_dsd.LAUNCHES, "bsr_sdd": bsr_sdd.LAUNCHES, **fm.LAUNCHES,
            **bsr_ffn.LAUNCHES}


def launches(**nonzero) -> dict:
    """Every kernel's count: the given ones, 0 for the rest."""
    return {**dict.fromkeys(KERNELS, 0), **nonzero}


def expected_train_launches(fused: bool, n_seq: int) -> dict:
    """Launches of one loss backward over ``n_seq`` sequences. Fused: one of
    each flash kernel per layer and sequence. Unfused, by ops/autodiff.py:
    the forward runs 1 SDD + 1 DSD, the backward 3 DSD/DDS launches (DSD's
    dB, SDD's dA and dB) + 1 SDD (DSD's dA) per layer and sequence."""
    per = SERVE.n_layers * n_seq
    if fused:
        return launches(**dict.fromkeys(FLASH, per))
    return launches(bsr_dsd_stream=4 * per, bsr_sdd=2 * per)


def batch_loss(lm, batch, cfg, topos):
    return sum(tr.lm_loss(lm, seq, cfg, topos) for seq in batch) / len(batch)


def train_steps(fused: bool, batch, name_limit: str) -> dict:
    """TRAIN_STEPS Adam steps of the bf16 model on ``batch``; returns the
    launch counts of all steps together."""
    cfg = dataclasses.replace(SERVE, fused_attention=fused)
    lm = tr.init_lm_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    topos = tr.lm_topologies(cfg, device=DEV)
    opt = torch.optim.Adam(lm.parameters(), lr=LR)
    losses, walls = [], []
    total = dict.fromkeys(launch_counts(), 0)
    want = expected_train_launches(fused, len(batch))
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = batch_loss(lm, batch, cfg, topos)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        counts = launch_counts()
        check(counts == want, f"fused={fused}: launches per step {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        losses.append(loss.item())
    check(all(np.isfinite(losses)), f"fused={fused}: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"fused={fused}: the loss did not fall: {losses}")
    check(all(p.is_cuda and p.grad is not None and p.grad.is_cuda for p in lm.parameters()),
          "a parameter or gradient is not on the card")
    check(all(v.is_cuda for st in opt.state.values() for v in st.values() if torch.is_tensor(v) and v.ndim),
          "an Adam state tensor is not on the card")
    print(f"fused_attention={fused}: losses {[round(x, 4) for x in losses]}; launches per step "
          f"{ {k: v for k, v in want.items() if v} }; wall per step "
          f"{[round(w, 3) for w in walls]} s (first includes warm-up; informational) on {name_limit}",
          flush=True)
    return total


def fp32_grads_against_plain(fused: bool, batch) -> None:
    """One backward of the fp32 model through the kernels and one through
    the plain versions; every parameter's gradient within 1e-3 * max|g|."""
    cfg = dataclasses.replace(SERVE, dtype=torch.float32, fused_attention=fused)
    lm = tr.init_lm_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    topos = tr.lm_topologies(cfg, device=DEV)
    grads, losses = [], []
    for plain in (False, True):
        lm.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        reset_launches()
        with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
            loss = batch_loss(lm, batch, cfg, topos)
            loss.backward()
        torch.cuda.synchronize()
        want = launches() if plain else expected_train_launches(fused, len(batch))
        check(launch_counts() == want, f"fp32 fused={fused} plain={plain}: launches {launch_counts()}")
        losses.append(loss.item())
        grads.append({n: p.grad.detach().clone() for n, p in lm.named_parameters()})
    worst = max((float((grads[0][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30), n)
                for n, g in grads[1].items())
    print(f"fp32 fused_attention={fused}: loss kernels {losses[0]:.6f} plain {losses[1]:.6f}; "
          f"worst parameter {worst[1]}: max |kernels - plain| = {worst[0]:.3e} * max|g|", flush=True)
    check(all(torch.isfinite(g).all() for g in grads[0].values()), "non-finite fp32 gradient")
    check(worst[0] <= 1e-3, f"fp32 gradients of {worst[1]} differ by {worst[0]:.3e} * max|g| > 1e-3")


# ----------------------------------------------------------------- phase 8 --
# Launches of one forward of each MoE impl (none for grouped and ragged).
FORWARD_LAUNCHES = {
    "bsr": launches(bsr_ffn_group=1),
    "bsr_unfused": launches(bsr_sdd=1, bsr_dsd_stream=1),
    "dropless_bsr": launches(bsr_sdd=1, bsr_dsd_stream=1),
    "dropless_bsr_fused": launches(bsr_ffn_dropless=1),
}
# A fused impl's backward: the unfused chain's recompute (1 SDD + 1 DSD) and
# its VJPs (DSD's dA by SDD and dB, SDD's dB by DDS, and SDD's dA, the
# gradient of the tokens, when they need one).
BACKWARD_LAUNCHES = {True: launches(bsr_dsd_stream=4, bsr_sdd=2),
                     False: launches(bsr_dsd_stream=3, bsr_sdd=2)}


def moe_setup(cfg):
    """Parameters (seed 0), tokens (seed 1) and the block-diagonal topology
    of the MoE slice in ``cfg``'s dtype."""
    params = moe.init_moe_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(1)
    x = torch.randn((MOE_TOKENS, cfg.d_model), generator=gen, device=DEV).to(cfg.dtype)
    return params, x, moe.block_diag_topology(cfg, device=DEV)


def moe_forward_fn(impl, params, cfg, topo):
    """The forward of ``impl``, (x) -> (y, aux): the capacity impls
    grouped, bsr, bsr_unfused, and dropless_{ragged, bsr, bsr_fused}."""
    if impl.startswith("dropless_"):
        return lambda x: moe.dropless_moe_forward(params, x, cfg, impl=impl[len("dropless_"):])
    return lambda x: moe.moe_forward(params, x, cfg, topo, impl=impl)


MOE_IMPLS = ("grouped", "bsr", "bsr_unfused", "dropless_ragged", "dropless_bsr", "dropless_bsr_fused")


def moe_fp32_against_plain() -> None:
    """(a) and (b): fp32 at bench width, TF32 off. Each forward that reaches
    a kernel against itself on the plain versions, within 1e-3, with its
    exact launches; the capacity impls agree with each other, the dropless
    impls with each other and with grouped when the capacity holds every
    token."""
    cfg = dataclasses.replace(MOE, dtype=torch.float32)
    params, x, topo = moe_setup(cfg)
    ys = {}
    with torch.no_grad():
        for impl in MOE_IMPLS:
            fwd = moe_forward_fn(impl, params, cfg, topo)
            torch.cuda.synchronize()
            reset_launches()
            ys[impl] = fwd(x)[0]
            torch.cuda.synchronize()
            want = FORWARD_LAUNCHES.get(impl, launches())
            check(launch_counts() == want, f"fp32 {impl}: launches {launch_counts()}, expected {want}")
            check(bool(torch.isfinite(ys[impl]).all()), f"fp32 {impl}: non-finite output")
            line = f"  fp32 {impl:<19} max|y| {float(ys[impl].abs().max()):.4f}"
            if impl in FORWARD_LAUNCHES:
                with registry.forced_variant("torch_reference"):
                    plain = fwd(x)[0]
                torch.cuda.synchronize()
                check(launch_counts() == want, f"fp32 {impl}: the plain forward launched a kernel")
                err = float((ys[impl] - plain).abs().max())
                check(err <= 1e-3, f"fp32 {impl}: max |kernels - plain| = {err} > 1e-3")
                line += f"; max |kernels - plain| = {err:.3e}; launches { {k: v for k, v in want.items() if v} }"
            print(line, flush=True)
        full = dataclasses.replace(cfg, capacity=MOE_TOKENS)  # drops no token
        ys["grouped_no_drop"] = moe.moe_forward(params, x, full, impl="grouped")[0]
    for group in (("grouped", "bsr", "bsr_unfused"),
                  ("grouped_no_drop", "dropless_ragged", "dropless_bsr", "dropless_bsr_fused")):
        err = max(float((ys[group[0]] - ys[g]).abs().max()) for g in group[1:])
        print(f"  fp32 {' / '.join(group)} agree: max |diff| = {err:.3e}", flush=True)
        check(err <= 1e-3, f"fp32 impls {group} differ by {err} > 1e-3")
    dropped = int((ys["grouped"].abs().amax(dim=1) == 0).sum())
    print(f"  capacity {cfg.capacity}: {dropped} of {MOE_TOKENS} tokens dropped; dropless drops none",
          flush=True)


def moe_no_host_reads() -> None:
    """(c): all six bf16 forwards at bench width under
    ``torch.cuda.set_sync_debug_mode("error")``: a device read raises."""
    params, x, topo = moe_setup(MOE)
    torch.cuda.synchronize()
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            for impl in MOE_IMPLS:
                moe_forward_fn(impl, params, MOE, topo)(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  bf16: {', '.join(MOE_IMPLS)} ran with no synchronizing call", flush=True)


def moe_fp32_grads() -> None:
    """(d): fp32 gradients of mean(y^2) + 0.01 aux through bsr and dropless
    bsr_fused against the plain path: every parameter's and the tokens'
    within 1e-3 * max|g|, and the backward's exact launches."""
    cfg = dataclasses.replace(MOE, dtype=torch.float32)
    params, x, topo = moe_setup(cfg)
    for impl in ("bsr", "dropless_bsr_fused"):
        fwd = moe_forward_fn(impl, params, cfg, topo)
        grads = []
        for plain in (False, True):
            params.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_()
            with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
                y, aux = fwd(xg)
                loss = torch.mean(y.float() ** 2) + cfg.router_aux_weight * aux
                torch.cuda.synchronize()
                reset_launches()
                loss.backward()
            torch.cuda.synchronize()
            want = launches() if plain else BACKWARD_LAUNCHES[True]
            check(launch_counts() == want, f"fp32 {impl} plain={plain}: backward launches {launch_counts()}")
            grads.append({**{n: p.grad.detach().clone() for n, p in params.named_parameters()},
                          "x": xg.grad.detach().clone()})
        check(all(bool(torch.isfinite(g).all()) for g in grads[0].values()), f"{impl}: non-finite gradient")
        worst = max((float((grads[0][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30), n)
                    for n, g in grads[1].items())
        print(f"  fp32 {impl}: worst gradient {worst[1]}: max |kernels - plain| = {worst[0]:.3e} * max|g|; "
              f"backward launches { {k: v for k, v in BACKWARD_LAUNCHES[True].items() if v} }", flush=True)
        check(worst[0] <= 1e-3, f"fp32 {impl} gradient of {worst[1]} differs by {worst[0]:.3e} * max|g|")


def moe_train(impl: str, name_limit: str) -> dict:
    """(e): MOE_STEPS bf16 Adam steps (lr MOE_LR) on the MSE against a fixed
    target plus the aux loss; returns the launches of all steps."""
    params, x, topo = moe_setup(MOE)
    target = torch.randn(x.shape, generator=torch.Generator(device=DEV).manual_seed(2), device=DEV)
    fwd = moe_forward_fn(impl, params, MOE, topo)
    opt = torch.optim.Adam(params.parameters(), lr=MOE_LR)
    kernel = "bsr_ffn_group" if impl == "bsr" else "bsr_ffn_dropless"
    want = {k: v + (k == kernel) for k, v in BACKWARD_LAUNCHES[False].items()}
    total, losses = launches(), []
    for _ in range(MOE_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        opt.zero_grad(set_to_none=True)
        y, aux = fwd(x)
        loss = torch.mean((y.float() - target) ** 2) + MOE.router_aux_weight * aux
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        check(launch_counts() == want, f"bf16 {impl}: launches per step {launch_counts()}, expected {want}")
        total = {k: total[k] + v for k, v in launch_counts().items()}
        losses.append(loss.item())
    check(all(np.isfinite(losses)), f"bf16 {impl}: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"bf16 {impl}: the loss did not fall: {losses}")
    print(f"  bf16 {impl}: losses {[round(v, 5) for v in losses]}; launches per step "
          f"{ {k: v for k, v in want.items() if v} } on {name_limit}", flush=True)
    return total


def moe_kernel_times(name_limit: str) -> dict:
    """(g): device times of the two FFN kernels and their plain versions at
    the bench shape, bf16: the group kernel on the block-diagonal plan, the
    dropless kernel on the bench tokens' own routing (tile_rows 256)."""
    params, x, topo = moe_setup(MOE)
    w1, w2 = params.w1.detach(), params.w2.detach()
    plan = bsr_ffn.plan_group_ffn(topo)
    cols = bsr_ffn.plan_cols(topo, plan, DEV)
    x_perm = torch.randn((MOE.padded_tokens, MOE.d_model), device=DEV).to(MOE.dtype)
    times = {"bsr_ffn_group": (
        time_ms(lambda: bsr_ffn.group_ffn(x_perm, w1, w2, cols, plan[1])),
        time_ms(lambda: bsr_ffn.fused_group_ffn_reference(x_perm, w1, w2, cols, plan[1])))}
    with torch.no_grad():
        logits = moe.router_logits(params, x, MOE)
        mbr, _, _, _, _, expert_rows, _, src = moe._dropless_route(logits, MOE_TOKENS, MOE, 2)
        xd = x[src]
        bounds = torch.cumsum(expert_rows, 0)
        e_row = torch.searchsorted(bounds, torch.arange(0, mbr, 2, device=DEV), right=True)
        e_row = e_row.clamp(max=MOE.n_experts - 1).to(torch.int32)
        live = ((expert_rows.sum() * 128) // 256).to(torch.int32)
    kw = dict(tile_rows=256, live_rows=live)
    times["bsr_ffn_dropless"] = (
        time_ms(lambda: bsr_ffn.dropless_ffn(xd, w1, w2, e_row, MOE.d_ff, **kw)),
        time_ms(lambda: bsr_ffn.fused_dropless_ffn_reference(xd, w1, w2, e_row, MOE.d_ff, **kw)))
    n_live = int(live)
    useful = {"bsr_ffn_group": 4 * MOE.padded_tokens * MOE.d_model * MOE.d_ff,
              "bsr_ffn_dropless": 4 * n_live * 256 * MOE.d_model * MOE.d_ff}
    recompute = (MOE.d_model // 256 + 1) / 2  # executed / useful FLOP of the two-tile CTA
    for kname, ((kern, kcall), (plain, pcall)) in times.items():
        rows = f"{MOE.padded_tokens} rows" if kname == "bsr_ffn_group" else f"{n_live}/{len(e_row)} live tiles of 256 rows"
        print(f"  {kname:<16} {rows}, bf16: kernel {kern * 1e3:.2f} us device "
              f"({useful[kname] / kern / 1e9:.1f} useful TFLOP/s, {useful[kname] * recompute / kern / 1e9:.1f} "
              f"executed) / {kcall * 1e3:.2f} us call, plain {plain * 1e3:.2f} us device / "
              f"{pcall * 1e3:.2f} us call on {name_limit}", flush=True)
    return times


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
    with concurrent.futures.ThreadPoolExecutor(4) as pool:  # one nvcc per source, together
        for built in [pool.submit(f) for f in (bsr_dsd._kernel, bsr_sdd._kernel, fm._lib, bsr_ffn._lib)]:
            built.result()
    print(f"kernels built and loaded in {time.perf_counter() - start:.1f} s "
          f"(per library: {_build.build_seconds})", flush=True)

    print("== phase 2: kernels against their plain versions", flush=True)
    errors: dict = {}
    kernel_cases(np.random.default_rng(0), errors)
    flash_cases(np.random.default_rng(3), errors)
    ffn_cases(np.random.default_rng(5), errors)

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
    reset_launches()
    tokens = tr.lm_generate_batched(lm, prompts, SERVE, N_NEW)
    torch.cuda.synchronize()
    main_launches = launch_counts()
    expected = SERVE.n_layers * N_REQUESTS
    check(main_launches == launches(bsr_dsd_stream=expected, bsr_sdd=expected),
          f"kernel launches {main_launches}, expected {expected} of each sparse kernel and no other")
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
          f"launches { {k: v for k, v in main_launches.items() if v} }", flush=True)
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
    with torch.no_grad():
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
    # The flash kernels at the training slice's attention shape, through
    # their wrappers (not autograd); the backward reads the kernel's lse.
    t = SERVE.seq_len
    topo = attention.causal_block_topology(t, window_blocks=SERVE.window_blocks, dtype=bf16,
                                           device=DEV).with_transpose_metadata()
    q, k, v, do = (randn(rng, (h, t, dh), bf16) for _ in range(4))
    kw = dict(causal=True, scale=dh ** -0.5)
    out, lse = fm.fwd(q, k, v, topo, **kw)
    dvec = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, dvec, topo)
    times.update({
        "flash_mha_fwd": (time_ms(lambda: fm.fwd(q, k, v, topo, **kw)),
                          time_ms(lambda: fm.fwd_reference(q, k, v, topo, **kw))),
        "flash_mha_dq": (time_ms(lambda: fm.dq(*bwd, **kw)), time_ms(lambda: fm.dq_reference(*bwd, **kw))),
        "flash_mha_dkv": (time_ms(lambda: fm.dkv(*bwd, **kw)), time_ms(lambda: fm.dkv_reference(*bwd, **kw))),
    })
    # Per CTA tile and block: 2 products of 64 x 128 x 128 forward, 3 in
    # dQ (dP, S, dS K) and 4 in dK/dV (S, dP, P^T dO, dS^T Q).
    flops = {"flash_mha_fwd": 4, "flash_mha_dq": 6, "flash_mha_dkv": 8}
    for kname in FLASH:
        (kern, kcall), (plain, pcall) = times[kname]
        rate = flops[kname] * h * topo.nnz_blocks * 128 ** 3 / kern / 1e9
        print(f"  {kname:<15} H={h} T={t} {topo.nnz_blocks} blocks, bf16: kernel {kern * 1e3:.2f} us device "
              f"({rate:.1f} TFLOP/s) / {kcall * 1e3:.2f} us call, plain {plain * 1e3:.2f} us device / "
              f"{pcall * 1e3:.2f} us call", flush=True)
    del q, k, v, do, out, lse, dvec, bwd

    print("== phase 6: training slice, bf16: 5 Adam steps per attention route", flush=True)
    batch = torch.from_numpy(
        np.random.default_rng(4).integers(0, SERVE.vocab, (TRAIN_BATCH, SERVE.seq_len))
    ).to(DEV)
    train_launches = {}
    for fused in (True, False):
        train_launches[fused] = train_steps(fused, batch, name_limit)
        torch.cuda.empty_cache()
    main_launches.update({k: train_launches[True][k] for k in FLASH})

    print("== phase 7: training slice, fp32: gradients through the kernels against plain versions",
          flush=True)
    for fused in (True, False):
        fp32_grads_against_plain(fused, batch)
        torch.cuda.empty_cache()

    print(f"== phase 8: the MoE slice at bench width (d_model {MOE.d_model}, {MOE.n_experts} experts "
          f"of d_ff {MOE.d_ff}, {MOE_TOKENS} tokens, capacity {MOE.capacity})", flush=True)
    print("(a, b) fp32, kernels against plain versions, launches per forward", flush=True)
    moe_fp32_against_plain()
    torch.cuda.empty_cache()
    print("(c) no host reads", flush=True)
    moe_no_host_reads()
    print("(d) fp32 gradients against plain versions", flush=True)
    moe_fp32_grads()
    torch.cuda.empty_cache()
    print(f"(e) bf16 training: {MOE_STEPS} Adam steps, lr {MOE_LR}", flush=True)
    for impl in ("bsr", "dropless_bsr_fused"):
        moe_launches = moe_train(impl, name_limit)
        main_launches.update({k: moe_launches[k] for k in FFN if moe_launches[k]})
    torch.cuda.empty_cache()
    print(f"(f) python -m sputnik_tpu_torch.bench.moe, default config, on {name_limit}", flush=True)
    for line in moe_bench.run(MOE.d_model, MOE.d_ff, MOE.n_experts, MOE_TOKENS, "bfloat16"):
        print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v) for k, v in line.items()}),
              flush=True)
    print("(g) FFN kernel times (CUDA-graph device time, 10 warm-up + 100 timed)", flush=True)
    times.update(moe_kernel_times(name_limit))

    # launches: the serving run of phase 3 for the sparse kernels, the fused
    # training run of phase 6 for the flash kernels, the bf16 MoE training
    # runs of phase 8 for the FFN kernels.
    sources = {
        "bsr_dsd_stream": ("sputnik_tpu_torch/csrc/bsr_dsd.cu", "sputnik_tpu/kernels/bsr_dsd.py:76"),
        "bsr_sdd": ("sputnik_tpu_torch/csrc/bsr_sdd.cu", "sputnik_tpu/kernels/bsr_sdd.py:229"),
        "flash_mha_fwd": ("sputnik_tpu_torch/csrc/flash_mha.cu", "sputnik_tpu/kernels/flash_mha.py:103"),
        "flash_mha_dq": ("sputnik_tpu_torch/csrc/flash_mha.cu", "sputnik_tpu/kernels/flash_mha.py:262"),
        "flash_mha_dkv": ("sputnik_tpu_torch/csrc/flash_mha.cu", "sputnik_tpu/kernels/flash_mha.py:317"),
        "bsr_ffn_group": ("sputnik_tpu_torch/csrc/bsr_ffn.cu", "sputnik_tpu/kernels/bsr_ffn.py:83"),
        "bsr_ffn_dropless": ("sputnik_tpu_torch/csrc/bsr_ffn.cu", "sputnik_tpu/kernels/bsr_ffn.py:199"),
    }
    check(all(main_launches[k] > 0 for k in sources), f"a kernel of the main path never launched: {main_launches}")
    print(name_limit, flush=True)
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[kname], "max_abs_err": errors[kname],
         "ms": times[kname][0][0], "plain_ms": times[kname][1][0]}
        for kname, (src, rep) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
