#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (sputnik_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card (nvidia-smi name and power limit) and the torch / CUDA
   versions; build the nineteen CUDA libraries from csrc/ (one nvcc each,
   all started together) and print the seconds; beside them, nvcc -Xptxas
   -v of bsr_dsd.cu prints the registers, spills and shared memory of the
   sixteen bf16 TMA + wgmma kernels (a spill fails). The run's autotune cache
   (SPUTNIK_TPU_TORCH_TUNE_CACHE) is a file in a temporary directory of
   its own, removed at the end, so that no dispatch reads a winner tuned
   elsewhere.
2. Kernel against its plain PyTorch version on the card, pointwise within
   ATOL = 5e-2: DSD, DDS and SDD in all four transpose modes at the
   attention shapes (T = 1024 and 2048, window 4, d_head 128, 8 heads), DSD
   and DDS in all four modes at the 4096^2 / 25% headline shape, a random
   BSR with empty block-rows and unordered column indices at N 256 and 384,
   a random 25% SDD topology (every bsr_dsd_stream case twice, bitwise
   equal); the three flash
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
   layer launched SDD, the two softmax kernels and DSD once (16 launches
   each), and that parameters and caches live on the card.
4. The same model in fp32 (TF32 off): each request's prefill logits through
   the kernels against the plain versions (registry.forced_variant), max
   |diff| <= 1e-3;
   then four band-decode steps against the full sparse forward, <= 2e-3.
5. Kernel and plain-version times at the slices' shapes (CUDA events, 10
   warm-up and 100 timed iterations): device time from a CUDA graph of the
   100 calls, and the eager per-call time with the host's cost; DSD at the
   4096^2 / 25% headline beside bsr_dsd_pipelined, PyTorch's BSR matmul and
   its bound; the flash kernels at 8 heads, T = 2048, d_head 128, bf16,
   through their wrappers.
6. The training slice, bf16, the same model: 5 Adam steps (lr 3e-3) on a
   fixed batch of 4 sequences of 2048 tokens (loss = mean of the 4
   lm_loss), once with fused_attention (flash kernels) and once without
   (SDD -> softmax -> DSD and their VJPs). Checks finite losses, the last
   below the first, parameters, gradients and Adam state on the card, and
   the exact launches per step: fused 16 of each flash kernel and no
   sparse kernel; unfused 64 bsr_dsd_stream, 32 bsr_sdd, 16 of each
   softmax kernel and no flash kernel. Prints the wall time per step (informational).
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
9. The CSR slice on the trained DLMC-protocol weights (data/dlmc_weights.npz,
   d_model 512, d_ff 2048): (a) the four SELL kernels (spmm, spmm_t, sddmm,
   softmax with both validity sources) against their plain versions on the
   four matrices at the five DLMC sparsities (chunk "auto", sorted rows, as
   bench/dlmc.py builds them; n = 64), chunk 128 and 256 unsorted at 90% in
   fp32 and bf16, and chunk 256 sorted in fp32: fp32 within 1e-4 *
   max|plain|, bf16 within one bf16 ulp, two runs bitwise equal; (b) the sparse fine-tune of examples/sparse_finetune.py
   part 1 at full width: ffn_w1 pruned at 90%, 2048 tokens, a dense
   teacher, 5 fp32 SGD steps at lr 0.5 through ops.csr.spmm: the loss falls
   at every step, the pattern holds, fp32 gradients within 1e-4 * max|g| of
   the plain path, one sell_spmm forward and one sell_sddmm + one
   sell_spmm_t backward per step, and one step under
   set_sync_debug_mode("error"); (c) the attention chain sddmm ->
   sparse_softmax -> spmm in SELL at 8 heads, T = 2048, d_head 128 on the
   element-level causal band of window 4, fp32, against the plain chain
   and the block-sparse attention within 1e-4; (d) the bench/dlmc.py rows
   and each SELL kernel's device time beside its plain version, one
   PyTorch library call computing the same function (a yardstick the port
   never calls) and its bound, and the bytes sell_spmm_t's gather reads
   from L2.
10. The sparse-output slice (SSD / SDS / DSS / SSS) at the JAX grid's
   headline width d = 4096: (a) the four kernels (bsr_flat,
   bsr_sparse_out, bsr_dss_masked, bsr_dss_worklist) against their plain
   versions in all four modes, bf16 and fp32, block densities 0.01 and 0.1,
   unordered indices with empty block-rows and -columns, an empty DSS
   intersection and a slab schedule: fp32 within 1e-4 * max|plain|, bf16
   within one bf16 ulp, two runs bitwise equal; (b) the first-fit routes
   (host-built metadata at 10% takes cuda_flat, at 50% the dense detours
   on bsr_dsd_stream, metadata built on the card at 1% the
   output-stationary, work-list (with nnz hints) and masked (without)
   kernels) with their exact launches, and every forward again with warm
   plans under set_sync_debug_mode("error"); (c) fp32 gradients of
   ops.ssd / sds / dss / sss, NN and TT, density 0.1, against the plain
   path within 1e-4 * max|g|, two bsr_flat launches per backward; (d) the
   bench/dss.py rows; (e) each kernel's device time at d = 4096 and
   16384, density 0.1, NN, bf16, beside its plain version, its bound and
   torch.sparse.mm of the CSR operands where it computes the same product.

11. The rest of attention at the serving model's width (8 heads, T = 2048,
   d_head 128, window 4): (a) the two BSR softmax kernels (stats, normalize)
   and the score pass of ops.sdd_softmax against their plain versions, bf16
   and fp32, causal and not, on metadata built on the card with no
   max_row_nnz hint, with an empty block-row and a duplicated block; fp32
   within 1e-4 * max|plain|, bf16 within one bf16 ulp, every kernel twice
   bitwise equal; flash_block_attention (the flash kernels at H = 1) and
   the gradients of both backward routes against the plain path; lm_loss
   and backward() at TransformerConfig() (d_head 64) on both attention
   routes against the plain path, with exact launches; (b) content-routed
   attention: per head, topk_block_topology(q, k, 4) built on the card,
   attention over it fused (flash_block_attention) and unfused and the
   probabilities by ops.sdd_softmax against the plain path, with exact
   launches, the topology build and the fused forward under
   set_sync_debug_mode("error"); (c) top-k serving,
   lm_generate_batched(mode="topk", k_pages=4), 4 requests x 1024-token
   prompts x 32 new tokens, greedy and at temperature 0.8 from a seeded
   generator; (d) the bench/serving.py rows (batch 1 / 8 / 32, band and
   top-4); (e) the device times of the three new kernels and of
   flash_block_attention's passes at H = 1, beside their plain versions,
   bounds and library yardsticks.

12. Small-block sparse training and int8 quantized serving: (a)
   bsr_small_dsd and bsr_small_sdd at bs 16 / 32 / 64 in all four modes, bf16
   and fp32, at d = 4096, density 0.25 (SDD: K = 4096), and a ragged case
   (unordered columns, rows not a multiple of pack, an empty super-row);
   bsr_dsd_stream on int8 operands, DSD and DDS in all four modes (int32
   sums equal, fp32 / bf16 outputs scaled); bsr_bres in bf16, fp32 and int8
   at q 8 and 4 in all four modes, and its DDS on metadata built on the
   card (the plan built there): fp32 within 1e-4 * max|plain|, bf16 within
   one bf16 ulp, every kernel twice bitwise equal; (b) the first-fit routes
   at bs 32 and 64: host-known DSD / DDS / SDD / SSD / SDS / DSS on
   cuda_smallblock with exact launches, card-built metadata on jnp_fallback
   without a raise, the host-known forwards again under
   set_sync_debug_mode("error"); (c) block_rigl_demo at full width: the
   trained ffn_w1 pruned at bs 32 to 25% (prune.block_magnitude_prune),
   2048 tokens of x ~ N(0, 16) (the demo's step size relative to the
   loss's curvature), a dense teacher, 10 fp32 SGD steps at lr 0.5 with one
   rigl_block_update (drop 0.2) after step 5: the loss falls over steps
   0-5, the last below the first, the budget and the host copy kept, one
   bsr_small_dsd and one bsr_small_sdd per step, fp32 gradients within
   1e-4 * max|g| of the plain path, step 7 under set_sync_debug_mode
   ("error"); a bs 64 forward and backward; (d) examples/quantized_serving.py's
   recipe on ffn_w1 (block-pruned at 128 to 25%, 2048 tokens) through
   matmul_dds_q8 with both kernels and the per-block-row matmul_dsd_q8: the
   int8 error against the pruned fp32 layer below 0.03, the int32 sums
   equal to plain; (e) the four kernels' device times at d = 4096, 25%,
   NN, beside their plain versions, bounds and library yardsticks.

13. The benchmark entry points and the pipelined DSD / DDS kernel: (a) the
   three mxu probes at m 1024, k = n 4096 (dense_stream at depths 128 / 512
   / 4096 with and without accumulate, resident_stream at mt 128 and 512,
   tiled_matmul at every tile of its sweep list) and bsr_dsd_pipelined (DSD
   and DDS in all four modes at the 4096^2 / 25% headline, at the attention
   shape T 1024 x 8 heads batched, on a BSR with empty block-rows and an
   empty block-column with unordered indices, and on its metadata rebuilt
   on the card), bf16 and fp32, against their plain versions: fp32 within
   1e-4 * max|plain|, bf16 within one bf16 ulp, every kernel twice bitwise
   equal; (b) variant="cuda_pipelined" and forced_variant launch it exactly
   (the path whose launches the kernels line reports for it), and the first
   fit still names and launches cuda_stream; (c) calibrate.measure(), every
   efficiency in (0, 1.05]; (d) the mxu_probe rows (a cut of the depth
   sweep) and the tile sweep; (e) the bench.dsd line on the first fit,
   its fraction of the machine's speed of light against (c)'s peaks;
   (c)-(e) are the benchmark path whose launches the kernels line reports
   for the three probes; (f) the four kernels' device times beside their
   plain versions, bounds and library yardsticks, and the pipelined and
   stream kernels in turns (pipelined, stream, stream, pipelined), DSD and
   DDS at d = 1024 / 2048 / 4096, 25%, and DDS again with the transpose
   metadata attached beside the time of building it.

14. bench.py's tune pass, the roofline audit and the autotune cache, on the
   q-stream, C-resident, group-resident and input-resident SDD kernels: (a)
   bsr_qstream (dsd_q at q 1 / 2 / 4 / 8, every accum at q 4, dds_q,
   dds_ct), bsr_cres and bsr_gres (DSD and DDS) and bsr_sdd_bres (pack 1
   and 4) against their plain versions in all four modes, bf16 and fp32, at
   the audit's d = 2048, 25%, at JAX's cres / gres test shape (m 640, k
   384, n 512) and on a BSR with empty block-rows and an empty
   block-column, its metadata rebuilt on the card for bsr_qstream and
   bsr_cres: fp32 within 1e-4 * max|plain|, bf16 within one bf16 ulp, every
   kernel twice bitwise equal; (b) every new variant= name launches its
   kernel exactly, the first fits of DSD and SDD are unchanged and DDS's is
   DDS_FIRST_FIT; (c) ops.benchmark_variants("dsd") at d = 2048, the winner
   persisted by ops.autotune and dispatched, ops.clear_cache; (d) the
   bench.dsd line tuned (the winner on stderr) and with --no-tune (the first
   fit); (e) the roofline audit at d = 2048: 22 rows, no error, every
   fraction at most 1.05, each row's variant; (c)-(e) are the benchmark
   path whose launches the kernels line reports for the four kernels; (f)
   the four kernels' device times beside their plain versions, bounds and
   library yardsticks, and the other schedules beside the stream kernel.

15. The panel-resident and column-stacked schedules and the variant tools:
   (a) bsr_panel (DSD and DDS, all four modes) and bsr_cstack (q 4 / 8, NN
   / NT, n_tile 256 and the default) against their plain versions, bf16 and
   fp32, at the audit's d = 2048, 25% (unordered indices), at JAX's test
   shapes (panel m 512, k 384, n 256; cstack m 640, k 384, n 512), on a BSR
   with empty block-rows and an empty block-column, and for cstack on its
   metadata rebuilt on the card: fp32 within 1e-4 * max|plain|, bf16 within
   one bf16 ulp, every kernel twice bitwise equal; (b) cuda_panel,
   cuda_cstack, cuda_cstack_q4, cuda_stream_at and xla_gather_bmm launch
   their kernels exactly (xla_gather_bmm none), the first fits unchanged;
   (c) python -m sputnik_tpu_torch.bench.tune at d = 2048 (dsd, dds, sdd,
   NN) into the run's cache: no ERROR, three winners persisted; (d)
   bench.headline at 4096^2, 25%: every registered DSD variant and every
   kept extra timed, none failed, the rows written; (e) bench.grid at d =
   2048, densities 0.25 / 0.1 (48 rows, no error row, every fraction at
   most 1.05) and bench.grid_summary on its output, bench.sss_floor at d =
   2048 and bench.flash_sweep; (c)-(e) are the benchmark path whose
   launches the kernels line reports for the two kernels; (f) their device
   times beside their plain versions, bounds and library yardsticks, and
   panel / cstack / cres / stream / pipelined / xla_gather_bmm side by side,
   DSD at d = 2048 and 4096, 25%.

16. The distributed slice on one card (one card cannot hold a multi-rank
   NCCL group, so the S = 4 ranks' bodies run in turn in this process, each
   ring step handed the band the rotation delivers): (a) flash_band_fold
   against its plain version on every (rank, step) fold, with the state
   carried, of ring attention over causal_block_topology(32768, window 4)
   (9 of 16 cells padding-only), causal_block_topology(8192) and a
   non-causal band of 8192, bf16 and fp32, d_head 128 and 64: fp32 within
   1e-4 * max|plain|, bf16 within ATOL (p is rounded to bf16 before P V, as
   in the flash kernels), lanes 1-127 of m / l bitwise
   the input's, every run bitwise equal to the next; (b)
   ring_block_sparse_attention on those rings, fused (each fold under
   set_sync_debug_mode("error")) and unfused on the non-causal one, and
   (c) sharded_block_sparse_attention at S = 4, fused and unfused, causal
   and not, against single-device flash_block_attention within ATOL (the
   fold's launches in the kernels line are (b)-(c)'s); (d) sharded_dsd,
   sharded_dsd_ring and sharded_sdd at 4096^2, 25%, bf16, N 4096 and
   sharded_spmm_sell, sharded_spmm_kshard and sharded_spmm on ffn_w1 at
   90%, n 64, against the same op on one device (fp32 within 1e-4 *
   max|ref|, bf16 within one ulp; which are bitwise equal); (e) an NCCL
   group of one rank: every sharded op and both attention entry points
   through the real collectives on S = 1 partitions against one device;
   (f) the fold kernel's device time for all folds of one ring beside its
   plain version and bound.

The line before the last is {"kernels": [...]} (thirty-three kernels, each
with its launches on the main path, max error, time, plain time, bound and
library time); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from sputnik_tpu_torch import ops, parallel, prune
from sputnik_tpu_torch.bench import calibrate, flash_sweep, grid_summary, mxu_probe, roofline, sss_floor
from sputnik_tpu_torch.bench import dlmc as dlmc_bench
from sputnik_tpu_torch.bench import dsd as dsd_bench
from sputnik_tpu_torch.bench import dss as dss_bench
from sputnik_tpu_torch.bench import grid as grid_bench
from sputnik_tpu_torch.bench import headline as headline_bench
from sputnik_tpu_torch.bench import moe as moe_bench
from sputnik_tpu_torch.bench import serving as serving_bench
from sputnik_tpu_torch.bench import tune as tune_bench
from sputnik_tpu_torch.bench.models import PEAKS
from sputnik_tpu_torch.formats import BlockSparseMatrix, SellMatrix, csr_from_dense
from sputnik_tpu_torch.kernels import (_build, bsr_cres, bsr_cstack, bsr_dsd, bsr_dss, bsr_ffn, bsr_flat, bsr_panel,
                                       bsr_qstream, bsr_sdd, bsr_small, bsr_ssd, reference, sell, xla_gather)
from sputnik_tpu_torch.kernels import bsr_dsd_pipelined as bsr_pipe
from sputnik_tpu_torch.kernels import bsr_softmax as bsm
from sputnik_tpu_torch.kernels import flash_attention as fa
from sputnik_tpu_torch.kernels import flash_mha as fm
from sputnik_tpu_torch.models import attention, moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.ops import csr as csr_ops
from sputnik_tpu_torch.ops import quant, registry
from sputnik_tpu_torch.parallel import attention as par_attn
from sputnik_tpu_torch.parallel import ring_attention as par_ring
from sputnik_tpu_torch.parallel import sharding as par_shard
from sputnik_tpu_torch.utils import dlmc_gen, testing
from sputnik_tpu_torch.utils.profiling import card, time_ms
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
SOFTMAX = tuple(bsm.LAUNCHES)  # bsr_softmax_stats, bsr_softmax_normalize, sdd_softmax
KERNELS = ("bsr_dsd_stream", "bsr_sdd") + FLASH + FFN + SOFTMAX
# The MoE slice: bench/moe.py's default config (the serving LM's MoE layer).
MOE = moe.MoEConfig(d_model=1024, d_ff=2048, n_experts=8, capacity=512, dtype=torch.bfloat16)
# lr 3e-3, as the LM's training phase: at this width lr 1e-2 (examples/
# moe_training.py's, for d_model 256) overshoots on the second step through
# every impl and on the plain path alike (PERF.md, Findings).
MOE_TOKENS, MOE_STEPS, MOE_LR = 4096, 5, 3e-3
SELL = tuple(sell.LAUNCHES)  # sell_spmm, sell_spmm_t, sell_sddmm, sell_softmax
# The CSR slice: the trained DLMC-protocol weights (d_model 512, d_ff 2048),
# bench/dlmc.py's n = 64; the fine-tune of examples/sparse_finetune.py part 1
# on the whole ffn_w1 with the DLMC model's training batch, 8 x SEQ 256
# tokens; the attention chain at the serving LM's attention width.
WEIGHTS = "data/dlmc_weights.npz"
CSR_N = 64
FT_TOKENS, FT_STEPS, FT_LR = 8 * dlmc_gen.SEQ, 5, 0.5
CHAIN_H, CHAIN_T, CHAIN_DH, CHAIN_WINDOW = 8, 2048, 128, 4
# H100 SXM data sheet (bench/models.py): HBM, fp32 without tensor cores, bf16 dense.
HBM_BPS, FP32_FLOPS, BF16_FLOPS = PEAKS["hbm_bps"], PEAKS["f32_flops"], PEAKS["bf16_flops"]
f32 = torch.float32
DEV = torch.device("cuda")
autotune_mod = importlib.import_module("sputnik_tpu_torch.ops.autotune")


class PhaseError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


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


# ----------------------------------------------------------------- phase 1 --
def wgmma_resources(report) -> None:
    """-Xptxas -v of the bf16 bsr_dsd_stream kernels (TMA + wgmma), one line
    per (BM, BN, transpose_a, transpose_b) instantiation: registers, spill
    bytes and static shared memory; a spill fails the phase."""
    rows = []
    for name, regs, spill_st, spill_ld, smem in report:
        found = re.search(r"wgmma_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", name)
        if found:
            rows.append((tuple(int(v) for v in found.groups()), regs, spill_st, spill_ld, smem))
    check(len(rows) == 16, f"-Xptxas -v found {len(rows)} wgmma kernels in bsr_dsd.cu, not 16")
    for (bm, bn, ta, tb), regs, spill_st, spill_ld, smem in sorted(rows):
        print(f"  ptxas bsr_dsd_wgmma BM {bm:>3} BN {bn} ta={ta} tb={tb}: {regs} registers, spill stores "
              f"{spill_st} B, spill loads {spill_ld} B, {smem} B static smem", flush=True)
    check(all(r[2] == r[3] == 0 for r in rows), "a wgmma kernel of bsr_dsd.cu spills")


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
            if not name.startswith("sdd"):  # bsr_dsd_stream: every case twice bitwise equal
                again = kernel_fn(out_dtype)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"{name} out={out_dtype}: two runs differ")
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
    # The bench.py headline shape: 4096^2 at 25% block density, N = 4096
    # (the bf16 kernel's 128 x 256 tiles), in every mode.
    a = rand_bsr(rng, 4096, 4096, 0.25, dtype, scale=1024 ** -0.5)
    for ta, tb in MODES:
        b = randn(rng, stored((4096, 4096), tb), dtype)
        dsd_case(f"dsd 4096^2 25% N=4096 ta={ta:d} tb={tb:d}", a, b, ta, tb)
        dds_case(f"dds 4096^2 25% N=4096 ta={tb:d} tb={ta:d}", b, a, tb, ta)
    # Six blocks over eight block-rows: empty rows, unordered indices; N 256
    # and 384 (no multiple of 256).
    a = rand_bsr(rng, 1024, 1024, 6 / 64, dtype, unordered=True, scale=1 / 16)
    check(a.min_row_nnz == 0, "the empty-row case has no empty row")
    for n in (256, 384):
        for ta, tb in MODES:
            b = randn(rng, stored((1024, n), tb), dtype)
            dsd_case(f"dsd empty rows unordered N={n} ta={ta:d} tb={tb:d}", a, b, ta, tb)
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
    bsr_dsd.LAUNCHES = bsr_dsd.LAUNCHES_Q8 = bsr_sdd.LAUNCHES = bsr_flat.LAUNCHES = bsr_ssd.LAUNCHES = 0
    bsr_qstream.LAUNCHES = 0
    bsr_small.LAUNCHES.update(dict.fromkeys(bsr_small.LAUNCHES, 0))
    bsr_dss.LAUNCHES.update(dict.fromkeys(bsr_dss.LAUNCHES, 0))
    fm.LAUNCHES.update(dict.fromkeys(FLASH, 0))
    bsr_ffn.LAUNCHES.update(dict.fromkeys(FFN, 0))
    sell.LAUNCHES.update(dict.fromkeys(SELL, 0))
    bsm.LAUNCHES.update(dict.fromkeys(SOFTMAX, 0))
    mxu_probe.LAUNCHES.update(dict.fromkeys(mxu_probe.LAUNCHES, 0))
    bsr_pipe.LAUNCHES = 0
    bsr_qstream.QSTREAM_LAUNCHES = bsr_sdd.BRES_LAUNCHES = 0
    bsr_cres.LAUNCHES.update(dict.fromkeys(bsr_cres.LAUNCHES, 0))
    bsr_panel.LAUNCHES = bsr_cstack.LAUNCHES = 0
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))


def launch_counts() -> dict:
    """The counts of the kernels of phases 1-8 and 11 (the CSR kernels have
    their own, ``sell.LAUNCHES``)."""
    return {"bsr_dsd_stream": bsr_dsd.LAUNCHES, "bsr_sdd": bsr_sdd.LAUNCHES, **fm.LAUNCHES,
            **bsr_ffn.LAUNCHES, **bsm.LAUNCHES}


def launches(**nonzero) -> dict:
    """Every kernel's count: the given ones, 0 for the rest."""
    return {**dict.fromkeys(KERNELS, 0), **nonzero}


def expected_train_launches(fused: bool, n_seq: int) -> dict:
    """Launches of one loss backward over ``n_seq`` sequences. Fused: one of
    each flash kernel per layer and sequence. Unfused, by ops/autodiff.py:
    the forward runs 1 SDD + the two softmax kernels + 1 DSD, the backward
    3 DSD/DDS launches (DSD's dB, SDD's dA and dB) + 1 SDD (DSD's dA) per
    layer and sequence (the softmax's VJP is plain torch, as JAX's)."""
    per = SERVE.n_layers * n_seq
    if fused:
        return launches(**dict.fromkeys(FLASH, per))
    return launches(bsr_dsd_stream=4 * per, bsr_sdd=2 * per, bsr_softmax_stats=per, bsr_softmax_normalize=per)


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


def moe_kernel_times(name_limit: str, yard: dict) -> dict:
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
    weights = 2 * MOE.d_model * MOE.ff_total * 2  # w1 and w2, bf16
    io_rows = {"bsr_ffn_group": MOE.padded_tokens, "bsr_ffn_dropless": n_live * 256}
    for kname, rows in io_rows.items():  # no single PyTorch call computes either FFN
        yard[kname] = (*bound_ms(weights + 2 * rows * MOE.d_model * 2, useful[kname], BF16_FLOPS), None)
    for kname, ((kern, kcall), (plain, pcall)) in times.items():
        rows = f"{MOE.padded_tokens} rows" if kname == "bsr_ffn_group" else f"{n_live}/{len(e_row)} live tiles of 256 rows"
        print(f"  {kname:<16} {rows}, bf16: kernel {kern * 1e3:.2f} us device "
              f"({useful[kname] / kern / 1e9:.1f} useful TFLOP/s, {useful[kname] * recompute / kern / 1e9:.1f} "
              f"executed) / {kcall * 1e3:.2f} us call, plain {plain * 1e3:.2f} us device / "
              f"{pcall * 1e3:.2f} us call on {name_limit}; bound {yard[kname][0] * 1e3:.2f} us "
              f"({yard[kname][1]})", flush=True)
    return times


# ------------------------------------------------- bounds and library calls --
def library_call(kname: str, fn):
    """Device ms of one PyTorch call computing the kernel's function on the
    kernel's inputs, or None where PyTorch refuses those inputs."""
    try:
        fn()
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - PyTorch has no call for these inputs
        print(f"  {kname}: no library call takes these inputs ({type(e).__name__}: {str(e)[:120]})", flush=True)
        return None
    ms, how = _library_time(fn)
    print(f"  {kname}: library call {ms * 1e3:.2f} us ({how})", flush=True)
    return ms


def attention_yardsticks(topo, q, k, v, probs) -> dict:
    """{kernel: (bound ms, bound by, library ms)} of SDD and DSD at phase 5's
    shape: torch.sparse.sampled_addmm on the element pattern of the block
    topology (batched CSR), and one BSR tensor holding the heads'
    probabilities on its block diagonal times the heads' v stacked (the
    batched product in one call: PyTorch's BSR matmul takes no batch)."""
    h, t, dh = q.shape
    nb, bt = topo.nnz_blocks, t // 128
    blk = nb * 128 * 128
    bm = np.zeros((bt, bt), bool)
    bm[topo.row_indices.cpu().numpy(), topo.indices.cpu().numpy()] = True
    el = torch.from_numpy(np.kron(bm, np.ones((128, 128), bool))).to(DEV).to(q.dtype).to_sparse_csr()
    crow, col = el.crow_indices(), el.col_indices()
    pattern = torch.sparse_csr_tensor(crow.expand(h, -1).contiguous(), col.expand(h, -1).contiguous(),
                                      torch.zeros((h, col.numel()), dtype=q.dtype, device=DEV), (h, t, t))
    heads = torch.arange(h, device=DEV, dtype=topo.offsets.dtype)[:, None]
    bsr = torch.sparse_bsr_tensor(
        torch.cat([(topo.offsets[None, :-1] + heads * nb).reshape(-1), topo.offsets[-1:] + (h - 1) * nb]),
        (topo.indices[None] + heads * bt).reshape(-1), probs.data.reshape(h * nb, 128, 128), (h * t, h * t))
    v_stacked = v.reshape(h * t, dh)
    kt = k.transpose(1, 2)
    return {
        "bsr_sdd": (*bound_ms(2 * h * t * dh * 2 + h * blk * 2, 2 * h * blk * dh, BF16_FLOPS),
                    library_call("bsr_sdd", lambda: torch.sparse.sampled_addmm(pattern, q, kt, beta=0.0))),
        "bsr_dsd_stream": (*bound_ms(h * blk * 2 + 2 * h * t * dh * 2, 2 * h * blk * dh, BF16_FLOPS),
                           library_call("bsr_dsd_stream", lambda: torch.matmul(bsr, v_stacked))),
    }


def flash_yardsticks(topo, q, k, v, flops) -> dict:
    """{kernel: (bound ms, bound by, library ms)} of the flash kernels at
    phase 5's shape. The forward's yardstick is scaled_dot_product_attention
    with the band as a boolean mask; no single call computes dQ or dK/dV
    alone."""
    h, t, dh = q.shape
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    band = torch.from_numpy((j <= i) & (i // 128 - j // 128 < SERVE.window_blocks)).to(DEV)
    tile = h * topo.nnz_blocks * 128 ** 3
    operand, stats = h * t * dh * 2, h * t * 4
    sdpa = library_call("flash_mha_fwd", lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                                                scale=dh ** -0.5))
    return {
        "flash_mha_fwd": (*bound_ms(4 * operand + stats, flops["flash_mha_fwd"] * tile, BF16_FLOPS), sdpa),
        "flash_mha_dq": (*bound_ms(5 * operand + 2 * stats, flops["flash_mha_dq"] * tile, BF16_FLOPS), None),
        "flash_mha_dkv": (*bound_ms(6 * operand + 2 * stats, flops["flash_mha_dkv"] * tile, BF16_FLOPS), None),
    }


# ----------------------------------------------------------------- phase 9 --
def csr_kernel_cases(rng, errors) -> None:
    """(a): the four SELL kernels against their plain versions on the four
    trained DLMC matrices at the five sparsities, built as bench/dlmc.py
    builds them (chunk "auto", sorted rows): spmm and sddmm at n = 64,
    spmm_t, and the softmax with both validity sources; plus chunk 128 and
    256 unsorted at 90%, fp32 and bf16, and chunk 256 sorted in fp32 (the
    gather over the transposed plan takes any chunk). fp32 within 1e-4 *
    max|plain|, bf16 within one bf16 ulp (``testing.bf16_ulp_excess``: the
    ulp of the larger of the two, floored at 2^-8 * max|plain|); every
    kernel run twice, bitwise equal."""
    weights = dlmc_gen.load_weights(WEIGHTS)
    cases = [(key, sp, "auto", True, f32) for key in dlmc_gen.WEIGHT_KEYS for sp in dlmc_gen.SPARSITIES]
    cases += [("ffn_w1", 0.9, chunk, False, dtype) for chunk in (128, 256) for dtype in (f32, torch.bfloat16)]
    cases += [("ffn_w1", 0.9, 256, True, f32)]
    for key, sp, chunk, sort_rows, dtype in cases:
        c = dlmc_gen.pruned_csr(weights, key, sp, device=DEV).astype(dtype)
        s = SellMatrix.from_csr(c, chunk=chunk, sort_rows=sort_rows)
        rows, cols = s.shape
        b, x = randn(rng, (cols, CSR_N), dtype), randn(rng, (rows, CSR_N), dtype, 0.5)
        q, k = randn(rng, (rows, CSR_N), dtype, CSR_N ** -0.5), randn(rng, (cols, CSR_N), dtype)
        sentinel = dataclasses.replace(s, slot_counts=None)
        pairs = {
            "sell_spmm": [(lambda: sell.spmm(s, b), lambda: sell.spmm_reference(s, b))],
            "sell_spmm_t": [(lambda: sell.spmm_t(s, x), lambda: sell.spmm_t_reference(s, x))],
            "sell_sddmm": [(lambda: sell.sddmm(q, k, s).values, lambda: sell.sddmm_reference(q, k, s).values)],
            "sell_softmax": [(lambda m=m: sell.sparse_softmax(m, scale=0.5).values,
                              lambda m=m: sell.sparse_softmax_reference(m, scale=0.5).values)
                             for m in (s, sentinel)],
        }
        errs = []
        for kname, fns in pairs.items():
            worst = 0.0
            for kernel_fn, plain_fn in fns:
                got, again, want = kernel_fn(), kernel_fn(), plain_fn()
                torch.cuda.synchronize()
                check(got.shape == want.shape, f"{key} {sp} {kname}: shape {tuple(got.shape)} != {tuple(want.shape)}")
                check(torch.equal(got, again), f"{key} {sp} {kname}: two runs differ")
                check(bool(torch.isfinite(got.float()).all()), f"{key} {sp} {kname}: non-finite output")
                scale = float(want.float().abs().max())
                check(scale > 0, f"{key} {sp} {kname}: plain output is all zero")
                diff = (got.float() - want.float()).abs()
                if dtype == f32:
                    check(float(diff.max()) <= 1e-4 * scale,
                          f"{key} {sp} {kname}: max |kernel - plain| = {float(diff.max())} > 1e-4 * {scale}")
                else:
                    ulps = testing.bf16_ulp_excess(got, want)
                    check(ulps <= 1, f"{key} {sp} {kname}: bf16 {ulps:.2f} ulp from the plain version")
                worst = max(worst, float(diff.max()))
            errors[kname] = max(errors.get(kname, 0.0), worst) if dtype == f32 else errors.get(kname, 0.0)
            errs.append(f"{kname[5:]} {worst:.2e}")
        print(f"  {key:<6} {rows}x{cols} {sp:.2f} chunk {s.chunk:>3} {'sorted' if sort_rows else 'unsorted':<8} "
              f"{str(dtype).split('.')[-1]:<8} width {s.width:>3} nnz {c.nnz:>6}: max|kernel-plain| {', '.join(errs)}",
              flush=True)


def csr_finetune(name_limit: str) -> dict:
    """(b): examples/sparse_finetune.py part 1 at full width: the whole
    trained ffn_w1 (512 x 2048 as (out, in)) pruned at 90%, x (in, tokens)
    of 2048 tokens, a dense teacher, 5 SGD steps at lr 0.5 on the values
    through ops.csr.spmm (x carries a gradient too, as in a deeper network:
    dx is the transposed SpMM). Returns the launches of all steps."""
    w = dlmc_gen.load_weights(WEIGHTS)["ffn_w1"]
    pruned = dlmc_gen.magnitude_prune(w, 0.9)
    s = SellMatrix.from_csr(csr_from_dense(pruned, device=DEV), chunk="auto", sort_rows=True)
    rng = np.random.default_rng(6)
    x = randn(rng, (w.shape[1], FT_TOKENS), f32)
    teacher = torch.from_numpy(w).to(DEV) @ x
    values = s.values.clone().requires_grad_()
    xg = x.clone().requires_grad_()

    def loss_fn():
        return torch.mean((csr_ops.spmm(s.with_values(values), xg) - teacher) ** 2)

    # fp32 gradients through the kernels against the plain path.
    grads = []
    for plain in (False, True):
        with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
            loss_fn().backward()
        grads.append((values.grad.clone(), xg.grad.clone()))
        values.grad = xg.grad = None
    torch.cuda.synchronize()
    for name, got, want in zip(("values", "x"), grads[0], grads[1]):
        rel = float((got - want).abs().max()) / float(want.abs().max())
        print(f"  fp32 gradient of {name}: max |kernels - plain| = {rel:.3e} * max|g|", flush=True)
        check(rel <= 1e-4, f"fine-tune gradient of {name} differs by {rel:.3e} * max|g| > 1e-4")
    check(not bool(grads[0][0][~s.valid_mask()].any()), "a padding slot got a gradient")
    # One forward and backward with no host read.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss_fn().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    values.grad = xg.grad = None
    torch.cuda.synchronize()
    losses, walls, total = [], [], dict.fromkeys(SELL, 0)
    want = {"sell_spmm": 1, "sell_spmm_t": 1, "sell_sddmm": 1, "sell_softmax": 0}
    for _ in range(FT_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        start = time.perf_counter()
        loss = loss_fn()
        loss.backward()
        with torch.no_grad():
            values -= FT_LR * values.grad
        values.grad = xg.grad = None
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        counts = dict(sell.LAUNCHES)
        check(counts == want, f"fine-tune launches per step {counts}, expected {want}")
        total = {k: total[k] + counts[k] for k in total}
        losses.append(loss.item())
    check(all(np.isfinite(losses)), f"fine-tune: non-finite loss in {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])), f"fine-tune: the loss did not fall at every step: {losses}")
    final = s.with_values(values.detach()).to_dense().cpu().numpy()
    check(bool(((final != 0) == (pruned != 0)).all()), "fine-tune: the sparsity pattern drifted")
    print(f"  {int((pruned != 0).sum())} survivors, chunk {s.chunk}, width {s.width}; losses "
          f"{[round(v, 6) for v in losses]}; pattern preserved; launches per step "
          f"{ {k: v for k, v in want.items() if v} }; one step ran with no synchronizing call; wall per step "
          f"{[round(v * 1e3, 2) for v in walls]} ms (informational) on {name_limit}", flush=True)
    return total


def chain_setup(rng):
    """(c)'s inputs: the element-level causal band of
    causal_block_topology(T, window_blocks=4) in SELL (chunk 128), the
    block topology, and fp32 q, k, v of (H, T, d_head)."""
    btopo = attention.causal_block_topology(CHAIN_T, window_blocks=CHAIN_WINDOW, dtype=f32, device=DEV)
    i, j = np.arange(CHAIN_T)[:, None], np.arange(CHAIN_T)[None, :]
    band = (j <= i) & (i // 128 - j // 128 < CHAIN_WINDOW)
    s = SellMatrix.from_csr(csr_from_dense(band.astype(np.float32), device=DEV))
    q, k, v = (randn(rng, (CHAIN_H, CHAIN_T, CHAIN_DH), f32) for _ in range(3))
    return s, btopo, q, k, v


def csr_chain(s, q, k, v):
    """sddmm -> sparse_softmax -> spmm per head, staying in SELL."""
    out = []
    for h in range(q.shape[0]):
        probs = csr_ops.sparse_softmax(csr_ops.sddmm(q[h], k[h], s), scale=CHAIN_DH ** -0.5)
        out.append(csr_ops.spmm(probs, v[h]))
    return torch.stack(out)


def csr_attention_chain() -> dict:
    """(c): the Sputnik attention chain at the serving LM's attention width
    (8 heads, T = 2048, d_head 128), fp32, against the port's plain chain
    and its block-sparse attention on the block topology (the same
    function), both within 1e-4. Returns the chain's launches."""
    s, btopo, q, k, v = chain_setup(np.random.default_rng(7))
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        got = csr_chain(s, q, k, v)
        torch.cuda.synchronize()
        counts = dict(sell.LAUNCHES)
        with registry.forced_variant("torch_reference"):
            plain = csr_chain(s, q, k, v)
        bsa = attention.multihead_block_sparse_attention(q, k, v, btopo, causal=True, scale=CHAIN_DH ** -0.5)
    torch.cuda.synchronize()
    want = dict.fromkeys(("sell_sddmm", "sell_softmax", "sell_spmm"), CHAIN_H)
    check(counts == {**want, "sell_spmm_t": 0}, f"chain launches {counts}, expected {want}")
    check(bool(torch.isfinite(got).all()), "non-finite attention output")
    err_plain, err_bsa = float((got - plain).abs().max()), float((got - bsa).abs().max())
    print(f"  H={CHAIN_H} T={CHAIN_T} d_head {CHAIN_DH}, SELL chunk {s.chunk} width {s.width}, "
          f"{int(s.slot_counts.sum())} slots: max |chain - plain chain| = {err_plain:.3e}, "
          f"max |chain - block-sparse attention| = {err_bsa:.3e} (|out| max {float(bsa.abs().max()):.3f}); "
          f"launches {counts}", flush=True)
    check(err_plain <= 1e-4, f"attention chain differs from the plain chain by {err_plain} > 1e-4")
    check(err_bsa <= 1e-4, f"attention chain differs from block-sparse attention by {err_bsa} > 1e-4")
    return counts


def _library_time(fn):
    """(device ms, how) of one PyTorch library call: CUDA-graph replay when
    the call can be captured, else eager calls between CUDA events (which
    include the host's cost)."""
    try:
        return time_ms(fn)[0], "graph"
    except Exception:  # noqa: BLE001 - a library call that cannot be captured
        torch.cuda.synchronize()
        return time_ms_eager(fn), "eager"


def time_ms_eager(fn, warmup: int = 10, iters: int = 100) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(bytes_moved: float, flops: float, flop_rate: float) -> tuple:
    """(ms, "bytes" | "operations"): the larger of bytes at the H100 SXM
    data sheet's 3.35 TB/s and FLOPs at ``flop_rate``."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sell_bytes(s: SellMatrix) -> int:
    """Bytes of a SELL operand a kernel must read: each valid slot's value
    and index, the slot counts and the row permutation."""
    nnz = int(s.slot_counts.sum())
    perm = 0 if s.row_perm is None else s.rows_padded * 4
    return nnz * (s.values.element_size() + 4) + s.slot_counts.numel() * 4 + perm


def _softmax_bytes(s: SellMatrix) -> int:
    """Bytes the softmax must move: each valid slot's value and the slot
    counts read, the whole (n_chunks, width, rows_padded) output written."""
    return int(s.slot_counts.sum()) * s.values.element_size() + s.slot_counts.numel() * 4 \
        + s.values.numel() * s.values.element_size()


def csr_kernel_times(name_limit: str) -> dict:
    """(d): each SELL kernel at the slice's shapes (CUDA-graph device time,
    10 warm-up + 100 timed) beside its plain version, one PyTorch library
    call computing the same function (a yardstick the port never calls),
    and its bound. Returns {kernel: (ms, plain ms, library ms or None,
    bound ms, bound by)} at the main path's shapes: the fine-tune's for
    spmm / spmm_t / sddmm, one head of the attention chain for softmax
    (the chain's sddmm and spmm are timed there too)."""
    rng = np.random.default_rng(8)
    weights = dlmc_gen.load_weights(WEIGHTS)
    w90 = dlmc_gen.magnitude_prune(weights["ffn_w1"], 0.9)
    s = SellMatrix.from_csr(csr_from_dense(w90, device=DEV), chunk="auto", sort_rows=True)
    rows, cols = s.shape
    nnz = int(s.slot_counts.sum())
    a_csr = torch.from_numpy(w90).to(DEV).to_sparse_csr()
    at_csr = torch.from_numpy(np.ascontiguousarray(w90.T)).to(DEV).to_sparse_csr()
    chain_s, _, q, k, _ = chain_setup(np.random.default_rng(7))
    scores = sell.sddmm(q[0], k[0], chain_s)
    chain_nnz = int(chain_s.slot_counts.sum())
    mask = torch.from_numpy(chain_s.to_dense().cpu().numpy() != 0).to(DEV)
    coo = torch.sparse_coo_tensor(mask.nonzero().T, scores.to_dense()[mask] * CHAIN_DH ** -0.5,
                                  mask.shape).coalesce()
    a_coo = a_csr.to_sparse_coo().coalesce()
    results = {}
    for label, n in (("ffn_w1 90% n=64", CSR_N), (f"fine-tune n={FT_TOKENS}", FT_TOKENS)):
        b, x = randn(rng, (cols, n), f32), randn(rng, (rows, n), f32)
        qq, kk = randn(rng, (rows, n), f32), randn(rng, (cols, n), f32)
        dense_out = rows * n * 4
        specs = {
            "sell_spmm": (lambda: sell.spmm(s, b), lambda: sell.spmm_reference(s, b),
                          lambda: torch.sparse.mm(a_csr, b),
                          _sell_bytes(s) + cols * n * 4 + dense_out, 2 * nnz * n),
            "sell_spmm_t": (lambda: sell.spmm_t(s, x), lambda: sell.spmm_t_reference(s, x),
                            lambda: torch.sparse.mm(at_csr, x),
                            _sell_bytes(s) + rows * n * 4 + cols * n * 4, 2 * nnz * n),
            "sell_sddmm": (lambda: sell.sddmm(qq, kk, s), lambda: sell.sddmm_reference(qq, kk, s),
                           lambda: torch.sparse.sampled_addmm(a_csr, qq, kk.T, beta=0.0),
                           _sell_bytes(s) - nnz * 4 + (rows + cols) * n * 4 + s.values.numel() * 4, 2 * nnz * n),
        }
        if n == CSR_N:
            specs["sell_softmax"] = (lambda: sell.sparse_softmax(s), lambda: sell.sparse_softmax_reference(s),
                                     lambda: torch.sparse.softmax(a_coo, 1), _softmax_bytes(s), 5 * nnz)
        for kname, (kern, plain, lib, nbytes, flops) in specs.items():
            results[(kname, label)] = _kernel_timing(kname, label, kern, plain, lib, nbytes, flops, name_limit)
    io = 2 * CHAIN_T * CHAIN_DH * 4  # the chain's dense operands of one head
    specs = {
        "sell_sddmm": (lambda: sell.sddmm(q[0], k[0], chain_s), lambda: sell.sddmm_reference(q[0], k[0], chain_s),
                       None, _sell_bytes(chain_s) - chain_nnz * 4 + io + chain_s.values.numel() * 4,
                       2 * chain_nnz * CHAIN_DH),
        "sell_softmax": (lambda: sell.sparse_softmax(scores, scale=CHAIN_DH ** -0.5),
                         lambda: sell.sparse_softmax_reference(scores, scale=CHAIN_DH ** -0.5),
                         lambda: torch.sparse.softmax(coo, 1), _softmax_bytes(chain_s), 5 * chain_nnz),
        "sell_spmm": (lambda: sell.spmm(scores, q[1]), lambda: sell.spmm_reference(scores, q[1]), None,
                      _sell_bytes(chain_s) + io, 2 * chain_nnz * CHAIN_DH),
    }
    label = f"chain head T={CHAIN_T} d={CHAIN_DH}"
    for kname, (kern, plain, lib, nbytes, flops) in specs.items():
        results[(kname, label)] = _kernel_timing(kname, label, kern, plain, lib, nbytes, flops, name_limit)
    # The transposed SpMM's real traffic: every slot gathers one X row from
    # L2 (the bound counts X once).
    ms = results[("sell_spmm_t", f"fine-tune n={FT_TOKENS}")][0]
    gather = nnz * FT_TOKENS * 4
    print(f"  sell_spmm_t gather at n={FT_TOKENS}: {nnz} slots x {FT_TOKENS} x 4 B = {gather / 1e9:.3f} GB of X rows "
          f"read from L2, {gather / ms / 1e9:.2f} TB/s on {name_limit}", flush=True)
    main_shape = {"sell_spmm": f"fine-tune n={FT_TOKENS}", "sell_spmm_t": f"fine-tune n={FT_TOKENS}",
                  "sell_sddmm": f"fine-tune n={FT_TOKENS}", "sell_softmax": label}
    return {kname: results[(kname, shape)] for kname, shape in main_shape.items()}


def _kernel_timing(kname, label, kern, plain, lib, nbytes, flops, name_limit):
    (ms, call), (plain_ms, _) = time_ms(kern), time_ms(plain)
    lib_ms, how = _library_time(lib) if lib is not None else (None, "")
    bound, by = bound_ms(nbytes, flops, FP32_FLOPS)
    lib_text = f"library {lib_ms * 1e3:.2f} us ({how})" if lib_ms is not None else "library: none"
    print(f"  {kname:<13} {label:<24} fp32: kernel {ms * 1e3:.2f} us device / {call * 1e3:.2f} us call, "
          f"plain {plain_ms * 1e3:.2f} us, {lib_text}, bound {bound * 1e3:.2f} us ({by}; "
          f"{bound / ms:.3f} of it) on {name_limit}", flush=True)
    return ms, plain_ms, lib_ms, bound, by


# ---------------------------------------------------------------- phase 10 --
# The sparse-output slice: SSD / SDS / DSS / SSS at the JAX grid's width
# (bsr_grid_results.json: d up to 16384, headline d = 4096).
SO_D, SO_D_LARGE = 4096, 16384
SPARSE_OUT = ("bsr_flat", "bsr_sparse_out", "bsr_dss_masked", "bsr_dss_worklist")


def so_counts() -> dict:
    """Launches of the sparse-output kernels and of bsr_dsd_stream (the
    dense detours' kernel)."""
    return {"bsr_flat": bsr_flat.LAUNCHES, "bsr_sparse_out": bsr_ssd.LAUNCHES, **bsr_dss.LAUNCHES,
            "bsr_dsd_stream": bsr_dsd.LAUNCHES}


def so_launches(**nonzero) -> dict:
    return {**dict.fromkeys(SPARSE_OUT + ("bsr_dsd_stream",), 0), **nonzero}


def card_bsr(gen, d, density, dtype, *, hints: bool) -> BlockSparseMatrix:
    """A random BSR whose metadata torch ops build on the card from a random
    block mask (the size of the pattern is read back once, as construction;
    the hints too when ``hints``)."""
    nb = d // 128
    mask = torch.rand((nb, nb), generator=gen, device=DEV) < density
    counts = mask.sum(1, dtype=torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=DEV), torch.cumsum(counts, 0, dtype=torch.int32)])
    indices = mask.nonzero()[:, 1].to(torch.int32)
    data = torch.randn((indices.numel(), 128, 128), generator=gen, device=DEV).to(dtype)
    kw = {}
    if hints:
        kw = dict(max_row_nnz=int(counts.max()), max_col_nnz=int(mask.sum(0).max()))
    return BlockSparseMatrix.create(data, offsets, indices, (d, d), **kw)


def _ulp_or_rel(name, got, want, dtype):
    """fp32 within 1e-4 * max|plain|, bf16 within one bf16 ulp; returns
    max |kernel - plain|."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite output")
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    if dtype == f32:
        check(err <= 1e-4 * scale, f"{name}: max |kernel - plain| = {err} > 1e-4 * {scale}")
    else:
        ulps = testing.bf16_ulp_excess(got, want)
        check(ulps <= 1, f"{name}: bf16 {ulps:.2f} ulp from the plain version")
    return err


def so_kernel_cases(rng, errors) -> None:
    """(a): the four kernels against their plain versions at d = 4096 in all
    four modes, bf16 and fp32, block densities 0.01 and 0.1, unordered
    indices (0.01 leaves empty block-rows and block-columns), plus an
    empty DSS intersection and a slab schedule; every kernel run twice,
    bitwise equal. The work-list kernel runs on card-built metadata with
    hints: its list keeps the static budget, dead slots included."""
    d = SO_D
    nb = d // 128

    def case(name, kname, kernel_fn, plain_fn, dtype):
        got, again, want = kernel_fn(), kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name}: two runs differ")
        err = _ulp_or_rel(name, got, want, dtype)
        if dtype == f32:
            errors[kname] = max(errors.get(kname, 0.0), err)
        return err

    for density in (0.01, 0.1):
        for dtype in (f32, torch.bfloat16):
            for ta, tb in MODES:
                a = rand_bsr(rng, d, d, density, dtype, unordered=True)
                b = rand_bsr(rng, d, d, density, dtype, unordered=True)
                t = rand_bsr(rng, d, d, density, dtype, unordered=True)
                x = randn(rng, (d, d), dtype)
                kw = dict(transpose_a=ta, transpose_b=tb)
                plans = {"ssd": ops.plan_ssd(a, t, transpose_a=ta), "sds": ops.plan_sds(b, t, transpose_b=tb),
                         "dss": ops.plan_dss(a, b, transpose_a=ta, transpose_b=tb),
                         "sss": ops.plan_sss(a, b, t, transpose_a=ta, transpose_b=tb)}
                pos = b.position_map()
                ac, bc = dss_bench.card_built(a, True), dss_bench.card_built(b, True)
                wl = bsr_dss.build_dss_worklist(ac, bc, **kw)
                steps_a = bsr_ssd._max_steps(a, ta, None)
                steps_b = bsr_ssd._max_steps(b, not tb, None)
                cases = {
                    "bsr_flat ssd": ("bsr_flat", lambda: bsr_flat.ssd_flat(a, x, t, schedule=plans["ssd"], **kw).data,
                                     lambda: bsr_flat.flat_reference(plans["ssd"], a.data, x, t.nnz_blocks, **kw)),
                    "bsr_flat sds": ("bsr_flat", lambda: bsr_flat.sds_flat(x, b, t, schedule=plans["sds"], **kw).data,
                                     lambda: bsr_flat.flat_reference(plans["sds"], b.data, x, t.nnz_blocks, **kw)),
                    "bsr_flat dss": ("bsr_flat", lambda: bsr_flat.dss_flat(a, b, schedule=plans["dss"], **kw),
                                     lambda: bsr_flat.tiles_to_dense(bsr_flat.flat_reference(
                                         plans["dss"], a.data, b.data, nb * nb, **kw), nb, nb)),
                    "bsr_flat sss": ("bsr_flat", lambda: bsr_flat.sss_flat(a, b, t, schedule=plans["sss"], **kw).data,
                                     lambda: bsr_flat.flat_reference(plans["sss"], a.data, b.data, t.nnz_blocks, **kw)),
                    "bsr_sparse_out ssd": ("bsr_sparse_out", lambda: bsr_ssd.ssd(a, x, t, **kw).data,
                                           lambda: bsr_ssd.sparse_out_reference(
                                               bsr_flat.KIND_SSD, a, x, t, stream_transposed=ta, max_steps=steps_a, **kw)),
                    "bsr_sparse_out sds": ("bsr_sparse_out", lambda: bsr_ssd.sds(x, b, t, **kw).data,
                                           lambda: bsr_ssd.sparse_out_reference(
                                               bsr_flat.KIND_SDS, b, x, t, stream_transposed=not tb, max_steps=steps_b,
                                               **kw)),
                    "bsr_dss_masked": ("bsr_dss_masked", lambda: bsr_dss.dss(a, b, pos_map=pos, **kw),
                                       lambda: bsr_flat.tiles_to_dense(bsr_dss.masked_reference(
                                           a, b, pos, max_steps=steps_a, m_blocks=nb, n_blocks=nb, **kw), nb, nb)),
                    "bsr_dss_worklist": ("bsr_dss_worklist", lambda: bsr_dss.dss_worklist(ac, bc, worklist=wl, **kw),
                                         lambda: bsr_flat.tiles_to_dense(bsr_dss.worklist_reference(
                                             ac, bc, wl, n_tiles=nb * nb, **kw), nb, nb)),
                }
                errs = []
                for name, (kname, kernel_fn, plain_fn) in cases.items():
                    plain = (lambda f=plain_fn: f().to(dtype)) if dtype != f32 else plain_fn
                    err = case(f"{name} {density} ta={ta:d} tb={tb:d}", kname, kernel_fn, plain, dtype)
                    errs.append(f"{name[4:]} {err:.1e}")
                print(f"  d={d} density {density} {str(dtype).split('.')[-1]:<8} ta={ta:d} tb={tb:d} "
                      f"items ssd {plans['ssd'].total} dss {plans['dss'].total} (list {wl.out_sorted.numel()}); "
                      f"min row/col nnz {a.min_row_nnz}/{a.min_col_nnz}: max|kernel-plain| {', '.join(errs)}",
                      flush=True)
    # An empty intersection: A touches only k-block 0, B only k-blocks >= 1.
    for dtype in (f32, torch.bfloat16):
        ones = np.ones((nb, 128, 128), np.float32)
        a = testing.bsr_from_blocks(d, d, np.arange(nb), np.zeros(nb, np.int64), ones, dtype=dtype, device=DEV)
        b = testing.bsr_from_blocks(d, d, np.arange(1, nb), np.arange(1, nb), ones[1:], dtype=dtype, device=DEV)
        plan = ops.plan_dss(a, b)
        check(plan.n_steps == 0, "the disjoint DSS has work")
        ac, bc = dss_bench.card_built(a, True), dss_bench.card_built(b, True)
        wl = bsr_dss.build_dss_worklist(ac, bc)
        zero = torch.zeros((d, d), dtype=dtype, device=DEV)
        for name, fn in (("bsr_flat", lambda: bsr_flat.dss_flat(a, b, schedule=plan)),
                         ("bsr_dss_masked", lambda: bsr_dss.dss(a, b)),
                         ("bsr_dss_worklist", lambda: bsr_dss.dss_worklist(ac, bc, worklist=wl))):
            torch.cuda.synchronize()
            check(torch.equal(fn(), zero), f"{name}: the empty intersection is not zero")
        print(f"  empty DSS intersection {str(dtype).split('.')[-1]}: flat (0 steps), masked and work list "
              f"({wl.out_sorted.numel()} dead slots) all zero", flush=True)
    # A slab schedule (natural-order stream), bf16 and fp32.
    for dtype in (f32, torch.bfloat16):
        a = rand_bsr(rng, d, d, 0.1, dtype, unordered=True)
        t = rand_bsr(rng, d, d, 0.1, dtype, unordered=True)
        x = randn(rng, (d, d), dtype)
        plan = bsr_flat.plan_sparse_out(a, t, kind="ssd", stream_transposed=False, slab=True)
        check(plan.slab and int(plan.flags.sum()) < plan.flags.size, "the slab schedule has no padding slot")
        err = case(f"bsr_flat slab {dtype}", "bsr_flat", lambda: bsr_flat.ssd_flat(a, x, t, schedule=plan).data,
                   lambda: bsr_flat.flat_reference(plan, a.data, x, t.nnz_blocks, transpose_a=False,
                                                   transpose_b=False).to(dtype), dtype)
        print(f"  slab schedule {str(dtype).split('.')[-1]}: {plan.n_steps} steps of {plan.group}, "
              f"{plan.total} real items: max|kernel-plain| {err:.1e}", flush=True)


def _so_call(op, args, kw):
    fn = {"ssd": ops.matmul_ssd, "sds": ops.matmul_sds, "dss": ops.matmul_dss, "sss": ops.matmul_sss}[op]
    return fn(*args, **kw)


def so_routes(rng) -> None:
    """(b): first-fit routes, by registry.dispatch_name and the launches of
    one call each; then every forward again, with warm plans, under
    torch.cuda.set_sync_debug_mode("error"). Host-built metadata at 10%
    takes cuda_flat for all four ops; at 50% SSD / SDS / DSS take the dense
    detours (bsr_dsd_stream); metadata built on the card at 1% takes
    cuda_output_stationary for SSD / SDS, and DSS takes cuda_worklist with
    the nnz hints and cuda_masked_stream without them."""
    d, bf16 = SO_D, torch.bfloat16
    gen = torch.Generator(device=DEV).manual_seed(11)
    x = randn(rng, (d, d), bf16)
    host10 = [rand_bsr(rng, d, d, 0.1, bf16, unordered=True) for _ in range(3)]
    host50 = [rand_bsr(rng, d, d, 0.5, bf16, unordered=True) for _ in range(3)]
    card = [card_bsr(gen, d, 0.01, bf16, hints=True) for _ in range(3)]
    no_hints = [dss_bench.card_built(m, False) for m in card]
    for m in card + no_hints:
        check(not m.host_known, "card-built metadata has a host copy")
    cases = []
    for label, (a, b, t) in (("host 10%", host10), ("host 50%", host50)):
        dense = label == "host 50%"
        cases += [
            (label, "ssd", (a, x, t), "dense_extract" if dense else "cuda_flat",
             so_launches(bsr_dsd_stream=1) if dense else so_launches(bsr_flat=1)),
            (label, "sds", (x, b, t), "dense_extract" if dense else "cuda_flat",
             so_launches(bsr_dsd_stream=1) if dense else so_launches(bsr_flat=1)),
            (label, "dss", (a, b), "densify" if dense else "cuda_flat",
             so_launches(bsr_dsd_stream=1) if dense else so_launches(bsr_flat=1)),
        ]
    a, b, t = host10
    cases.append(("host 10%", "sss", (a, b, t), "cuda_flat", so_launches(bsr_flat=1)))
    a, b, t = card
    cases += [
        ("card 1%", "ssd", (a, x, t), "cuda_output_stationary", so_launches(bsr_sparse_out=1)),
        ("card 1%", "sds", (x, b, t), "cuda_output_stationary", so_launches(bsr_sparse_out=1)),
        ("card 1% hints", "dss", (a, b), "cuda_worklist", so_launches(bsr_dss_worklist=1)),
        ("card 1% no hints", "dss", tuple(no_hints[:2]), "cuda_masked_stream", so_launches(bsr_dss_masked=1)),
    ]
    for label, op, args, route, want in cases:
        name = registry.dispatch_name(op, *args)
        check(name == route, f"{label} {op}: first fit is {name}, expected {route}")
        torch.cuda.synchronize()
        before = so_counts()
        out = _so_call(op, args, {})
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in so_counts().items()}
        check(delta == want, f"{label} {op}: launches {delta}, expected {want}")
        out = out if op == "dss" else out.data
        check(bool(torch.isfinite(out.float()).all()), f"{label} {op}: non-finite output")
        with registry.forced_variant("torch_reference"):
            plain = _so_call(op, args, {})
        plain = plain if op == "dss" else plain.data
        ulps = testing.bf16_ulp_excess(out, plain)
        check(ulps <= 1, f"{label} {op}: {ulps:.2f} bf16 ulp from torch_reference")
        print(f"  {label:<17} {op}: {name:<23} launches { {k: v for k, v in delta.items() if v} }; "
              f"{ulps:.2f} ulp from torch_reference", flush=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _, op, args, _, _ in cases:
            _so_call(op, args, {})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  all {len(cases)} forwards ran again with warm plans and no synchronizing call", flush=True)


# Launches of one backward at 10% with host-built metadata (ops/autodiff.py):
# each of the four ops' two gradients is one flat-route product.
SO_BACKWARD = so_launches(bsr_flat=2)


def so_grads(rng) -> None:
    """(c): fp32 (TF32 off) gradients of sum(out * w) through ops.ssd / sds
    / dss / sss at d = 4096, density 0.1, NN and TT, against the same
    forward and backward on the plain path (registry.forced_variant around
    both): within 1e-4 * max|g|, with the exact launches of the backward."""
    d = SO_D
    for op in ("ssd", "sds", "dss", "sss"):
        for ta, tb in ((False, False), (True, True)):
            a = rand_bsr(rng, d, d, 0.1, f32, unordered=True) if op != "sds" else randn(rng, (d, d), f32)
            b = rand_bsr(rng, d, d, 0.1, f32, unordered=True) if op != "ssd" else randn(rng, (d, d), f32)
            t = rand_bsr(rng, d, d, 0.1, f32, unordered=True)
            w = randn(rng, (d, d) if op == "dss" else tuple(t.data.shape), f32)
            grads = []
            for plain in (False, True):
                la = (a.data if op != "sds" else a).clone().requires_grad_()
                lb = (b.data if op != "ssd" else b).clone().requires_grad_()
                sa = a.with_data(la) if op != "sds" else la
                sb = b.with_data(lb) if op != "ssd" else lb
                args = (sa, sb) if op == "dss" else (sa, sb, t)
                with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
                    out = getattr(ops, op)(*args, transpose_a=ta, transpose_b=tb)
                    loss = ((out if op == "dss" else out.data) * w).sum()
                    torch.cuda.synchronize()
                    before = so_counts()
                    loss.backward()
                    torch.cuda.synchronize()
                delta = {k: v - before[k] for k, v in so_counts().items()}
                want = so_launches() if plain else SO_BACKWARD
                check(delta == want, f"{op} ta={ta:d} tb={tb:d} plain={plain}: backward launches {delta}, "
                                     f"expected {want}")
                grads.append((la.grad, lb.grad))
            worst = 0.0
            for got, ref in zip(*grads):
                check(bool(torch.isfinite(got).all()), f"{op}: non-finite gradient")
                worst = max(worst, float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
            print(f"  fp32 {op} ta={ta:d} tb={tb:d}: max |kernels - plain| = {worst:.3e} * max|g|; backward "
                  f"launches { {k: v for k, v in SO_BACKWARD.items() if v} }", flush=True)
            check(worst <= 1e-4, f"{op} ta={ta:d} tb={tb:d}: gradients differ by {worst:.3e} * max|g| > 1e-4")


def _distinct_bytes(*id_sets_and_sizes) -> int:
    """Bytes of the distinct tiles a product must read: (ids, bytes per id)
    pairs."""
    return sum(len(np.unique(ids)) * size for ids, size in id_sets_and_sizes)


def so_kernel_times(rng, name_limit: str) -> dict:
    """(e): each kernel at d = 4096 and d = 16384, density 0.1, NN, bf16:
    CUDA-graph device time (10 warm-up + 100 timed) beside its plain
    version (eager where it reads the card back), its bound (distinct bytes
    at 3.35 TB/s or 2 * items * 128^3 FLOP at 989 TFLOP/s, the larger) and
    one PyTorch library call computing the same function where one exists.
    bsr_flat is timed on SSD, SDS, DSS and SSS, bsr_sparse_out on SSD.
    Returns {kernel: (ms, plain ms, library ms, bound ms, bound by)} at
    d = 4096, bsr_flat's for SSD."""
    bf16, tile = torch.bfloat16, 128 * 128 * 2
    results = {}
    for d in (SO_D, SO_D_LARGE):
        nb = d // 128
        a, b, t = (rand_bsr(rng, d, d, 0.1, bf16) for _ in range(3))
        x = randn(rng, (d, d), bf16)
        plans = {"ssd": ops.plan_ssd(a, t), "sds": ops.plan_sds(b, t), "dss": ops.plan_dss(a, b),
                 "sss": ops.plan_sss(a, b, t)}
        pos = b.position_map()
        wl = bsr_dss.build_dss_worklist(a, b)

        def items(p):
            live = p.flags > 0
            return p.data_ids[live], p.dep_ids[live], p.other_ids[live], np.repeat(p.out_ids, p.group)[live]

        def sparse_out_bytes(p, dense_ids):
            data, dep, other, out = items(p)
            return _distinct_bytes((data, tile), (dense_ids(dep, other), tile), (out, tile)) + 20 * len(data)

        ssd_bytes = sparse_out_bytes(plans["ssd"], lambda k, n: k * nb + n)
        dss_data, dss_dep, _, _ = items(plans["dss"])
        dss_bytes = _distinct_bytes((dss_data, tile), (dss_dep, tile)) + d * d * 2
        specs = {
            ("bsr_flat", "ssd"): (lambda: bsr_flat.ssd_flat(a, x, t, schedule=plans["ssd"]),
                                  lambda: bsr_flat.flat_reference(plans["ssd"], a.data, x, t.nnz_blocks,
                                                                  transpose_a=False, transpose_b=False),
                                  plans["ssd"].total, ssd_bytes, None),
            ("bsr_flat", "sds"): (lambda: bsr_flat.sds_flat(x, b, t, schedule=plans["sds"]),
                                  lambda: bsr_flat.flat_reference(plans["sds"], b.data, x, t.nnz_blocks,
                                                                  transpose_a=False, transpose_b=False),
                                  plans["sds"].total, sparse_out_bytes(plans["sds"], lambda k, m: m * nb + k), None),
            ("bsr_flat", "dss"): (lambda: bsr_flat.dss_flat(a, b, schedule=plans["dss"]),
                                  lambda: bsr_flat.flat_reference(plans["dss"], a.data, b.data, nb * nb,
                                                                  transpose_a=False, transpose_b=False),
                                  plans["dss"].total, dss_bytes, "csr"),
            ("bsr_flat", "sss"): (lambda: bsr_flat.sss_flat(a, b, t, schedule=plans["sss"]),
                                  lambda: bsr_flat.flat_reference(plans["sss"], a.data, b.data, t.nnz_blocks,
                                                                  transpose_a=False, transpose_b=False),
                                  plans["sss"].total,
                                  _distinct_bytes(*((ids, tile) for ids in items(plans["sss"])[:2]),
                                                  (np.arange(t.nnz_blocks), tile)), None),
            ("bsr_sparse_out", "ssd"): (lambda: bsr_ssd.ssd(a, x, t),
                                        lambda: bsr_ssd.sparse_out_reference(
                                            bsr_flat.KIND_SSD, a, x, t, stream_transposed=False,
                                            max_steps=a.max_row_nnz, transpose_a=False, transpose_b=False),
                                        plans["ssd"].total, ssd_bytes, None),
            ("bsr_dss_masked", "dss"): (lambda: bsr_dss.dss(a, b, pos_map=pos),
                                        lambda: bsr_dss.masked_reference(a, b, pos, transpose_a=False,
                                                                         transpose_b=False, max_steps=a.max_row_nnz,
                                                                         m_blocks=nb, n_blocks=nb),
                                        plans["dss"].total, dss_bytes + nb * nb * 4, "csr"),
            ("bsr_dss_worklist", "dss"): (lambda: bsr_dss.dss_worklist(a, b, worklist=wl),
                                          lambda: bsr_dss.worklist_reference(a, b, wl, transpose_a=False,
                                                                             transpose_b=False, n_tiles=nb * nb),
                                          plans["dss"].total, dss_bytes + 16 * wl.out_sorted.numel() + nb * nb,
                                          "csr"),
        }
        # The one PyTorch call computing DSS: torch.sparse.mm of the operands
        # as element CSR (cuSPARSE SpGEMM, a sparse result), timed once per d,
        # eagerly: SpGEMM reads its result's size back, so no graph holds it.
        a_csr, b_csr = a.to_dense().to_sparse_csr(), b.to_dense().to_sparse_csr()
        library = {"csr": None}
        try:
            torch.sparse.mm(a_csr, b_csr)
            torch.cuda.synchronize()
            library["csr"] = time_ms_eager(lambda: torch.sparse.mm(a_csr, b_csr))
            print(f"  DSS d={d} torch.sparse.mm(csr, csr): library call {library['csr'] * 1e3:.2f} us (eager)",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - PyTorch has no call for these inputs
            print(f"  DSS d={d} torch.sparse.mm(csr, csr): no library call takes these inputs "
                  f"({type(e).__name__}: {str(e)[:120]})", flush=True)
        del a_csr, b_csr
        for (kname, op), (kern, plain, n_items, nbytes, lib) in specs.items():
            ms, call = time_ms(kern)
            plain_ms, how = _library_time(plain)
            lib_ms = library.get(lib)
            bound, by = bound_ms(nbytes, 2 * n_items * 128 ** 3, BF16_FLOPS)
            lib_text = f"library {lib_ms * 1e3:.2f} us" if lib_ms is not None else \
                "library: none (tried: torch.sparse.sampled_addmm takes a dense A, torch.sparse.mm(bsr, dense) " \
                "gives the whole product; no call masks a product to a block topology)" \
                if op in ("ssd", "sds", "sss") else "library: none (torch.sparse.mm(csr, csr) refused above)"
            print(f"  {kname:<16} {op} d={d} 10% NN bf16, {n_items} items: kernel {ms * 1e3:.2f} us device "
                  f"({2 * n_items * 128 ** 3 / ms / 1e9:.1f} TFLOP/s) / {call * 1e3:.2f} us call, plain "
                  f"{plain_ms * 1e3:.2f} us ({how}), {lib_text}, bound {bound * 1e3:.2f} us ({by}; "
                  f"{bound / ms:.3f} of it) on {name_limit}", flush=True)
            if d == SO_D and (kname != "bsr_flat" or op == "ssd"):
                results[kname] = (ms, plain_ms, lib_ms, bound, by)
        del a, b, t, x, plans, pos, wl, library
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 11 --
# The rest of attention at the serving model's width: the BSR softmax
# kernels, the fused SDD + softmax, flash_block_attention, content-routed
# top-k attention and top-k / sampled serving.
TOPK_PAGES = 4


def card_band(dtype) -> BlockSparseMatrix:
    """The serving band (T = 2048, window 4, 58 blocks) as metadata built on
    the card holds it: no host copy and no max_row_nnz hint."""
    topo = attention.causal_block_topology(SERVE.seq_len, window_blocks=SERVE.window_blocks, dtype=dtype, device=DEV)
    return dss_bench.card_built(topo, False)


def irregular_band(dtype) -> BlockSparseMatrix:
    """The serving band with block-row 3 emptied and block (10, 9) stored
    twice, metadata as built on the card with no hint."""
    band = attention.causal_block_topology(SERVE.seq_len, window_blocks=SERVE.window_blocks, device="cpu")
    rows, cols = band.row_indices.numpy(), band.indices.numpy()
    rows, cols = rows[rows != 3], cols[rows != 3]
    at = int(np.nonzero((rows == 10) & (cols == 9))[0][0])
    rows, cols = np.insert(rows, at, 10), np.insert(cols, at, 9)
    topo = testing.bsr_from_blocks(SERVE.seq_len, SERVE.seq_len, rows, cols, np.zeros((len(rows), 128, 128)),
                                   dtype=dtype, device=DEV)
    return dss_bench.card_built(topo, False)


def _twice(fn):
    """``fn()`` run twice, checked bitwise equal; returns the first result."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    for x, y in zip(first if isinstance(first, tuple) else (first,), again if isinstance(again, tuple) else (again,)):
        check(torch.equal(x, y), "two runs of a kernel differ")
    return first


def softmax_kernel_cases(rng, errors) -> None:
    """(a): the two softmax kernels (stats against their plain version on
    live rows, normalize against its plain version on the kernel's stats)
    and the score pass of ops.sdd_softmax, 8 heads, bf16 / fp32, causal and
    not, metadata built on the card with no hint; an empty block-row (the
    empty-row stats) and a duplicated block; every kernel twice, bitwise
    equal. fp32 within 1e-4 * max|plain|, bf16 within one bf16 ulp."""
    h, t, dh = SERVE.n_heads, SERVE.seq_len, SERVE.d_head
    for dtype in (f32, torch.bfloat16):
        topos = {"band": card_band(dtype), "empty row + duplicate": irregular_band(dtype)}
        for label, topo in topos.items():
            check(topo.max_row_nnz is None and not topo.host_known, "the card-built topology has a hint")
            for causal in (True, False):
                kw = dict(scale=0.3, causal=causal)
                data = randn(rng, (h,) + tuple(topo.data.shape), dtype, 4.0)
                m, l = _twice(lambda: bsm.stats(data, topo, **kw))
                m_ref, l_ref = bsm.stats_reference(data, topo, **kw)
                empty = m_ref < -5e29
                check(torch.equal(m < -5e29, empty) and not bool(l[empty].any()), f"{label}: empty-row stats differ")
                err = max(_ulp_or_rel(f"stats m {label}", m[~empty], m_ref[~empty], f32),
                          _ulp_or_rel(f"stats l {label}", l[~empty], l_ref[~empty], f32))
                errors["bsr_softmax_stats"] = max(errors.get("bsr_softmax_stats", 0.0), err)
                p = _twice(lambda: bsm.normalize(data, m, l, topo, **kw))
                want = bsm.normalize_reference(data, m, l, topo, out_dtype=dtype, **kw)
                err_p = _ulp_or_rel(f"normalize {label}", p, want, dtype)
                if dtype == f32:
                    errors["bsr_softmax_normalize"] = max(errors.get("bsr_softmax_normalize", 0.0), err_p)
                if label != "band":
                    check(bool((m[:, 384:512] == bsm.NEG_INF).all()), "block-row 3 is not empty")
                print(f"  bsr_softmax {label:<22} {str(dtype).split('.')[-1]:<8} causal={causal:d} H={h}: stats "
                      f"max|kernel-plain| {err:.2e}, normalize {err_p:.2e}; twice bitwise equal", flush=True)
        topo = topos["band"]
        for d in (dh, 64):
            q, k = randn(rng, (h, t, d), dtype, d ** -0.25), randn(rng, (h, t, d), dtype, d ** -0.25)
            for causal in (True, False):
                kw = dict(scale=d ** -0.5, causal=causal)
                got = _twice(lambda: bsm.scores(q, k, topo, **kw))
                want = bsm.scores_reference(q, k, topo, **kw)
                live = want[0] > -5e29
                check(torch.equal(got[0] > -5e29, live), "sdd_softmax: the masks differ")
                err = max(_ulp_or_rel("sdd_softmax scores", got[0][live], want[0][live], f32),
                          *(_ulp_or_rel("sdd_softmax stats", g, w, f32) for g, w in zip(got[1:], want[1:])))
                errors["sdd_softmax"] = max(errors.get("sdd_softmax", 0.0), err)
                probs = ops.sdd_softmax(q, k, topo, **kw)
                with registry.forced_variant("torch_reference"):
                    plain = ops.sdd_softmax(q, k, topo, **kw)
                err_p = _ulp_or_rel("ops.sdd_softmax", probs.data, plain.data, dtype)
                print(f"  sdd_softmax d_head {d:<3} {str(dtype).split('.')[-1]:<8} causal={causal:d} H={h}: scores "
                      f"and stats max|kernel-plain| {err:.2e}, probabilities {err_p:.2e}; twice bitwise equal",
                      flush=True)


def flash_block_cases(rng, errors) -> None:
    """(a): flash_block_attention (the flash kernels at H = 1) on the band
    built on the card, T = 2048, d_head 128: output and the gradients of
    both backward routes against the plain path (registry.forced_variant
    around forward and backward); fp32 within 1e-4 * max|plain|, bf16
    within ATOL (the flash kernels' bound since their port: P is rounded
    to bf16 before P V); the kernel path twice, bitwise equal."""
    t, dh = SERVE.seq_len, SERVE.d_head
    for dtype in (f32, torch.bfloat16):
        topo = card_band(dtype).with_transpose_metadata()
        xs0 = [randn(rng, (t, dh), dtype, s) for s in (1.0, 1.0, 0.5)]
        g = randn(rng, (t, dh), dtype, 0.5)
        for fused_backward in (True, False):

            def run():
                xs = [x.clone().requires_grad_() for x in xs0]
                out = attention.flash_block_attention(*xs, topo, causal=True, fused_backward=fused_backward)
                (out.float() * g.float()).sum().backward()
                return (out.detach(), *(x.grad for x in xs))

            got = _twice(run)
            with registry.forced_variant("torch_reference"):
                want = run()
            errs = []
            for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
                check(bool(torch.isfinite(x.float()).all()) and float(y.float().abs().max()) > 0, f"flash {name}")
                err = float((x.float() - y.float()).abs().max())
                bound = 1e-4 * float(y.float().abs().max()) if dtype == f32 else ATOL
                check(err <= bound, f"flash_block_attention {name} fused_backward={fused_backward}: {err} > {bound}")
                errs.append(f"{name} {err:.2e}")
                kname = {"out": "flash_mha_fwd", "dq": "flash_mha_dq"}.get(name, "flash_mha_dkv")
                if dtype == f32 and (fused_backward or name == "out"):
                    errors[kname] = max(errors.get(kname, 0.0), err)
            print(f"  flash_block_attention H=1 T={t} {str(dtype).split('.')[-1]:<8} fused_backward="
                  f"{fused_backward:d}: max|kernels-plain| {', '.join(errs)}; twice bitwise equal", flush=True)


def default_config_lm() -> None:
    """(a), fault 1: TransformerConfig() (d_head 64) on both attention
    routes: lm_loss + backward() through the kernels against the plain
    path on the card. fp32: loss within 1e-5 relative, every gradient
    within 1e-3 * max|g|; bf16 (the defaults): finite, loss within 1e-2."""
    for dtype in (f32, torch.bfloat16):
        for fused in (False, True):
            cfg = dataclasses.replace(tr.TransformerConfig(), fused_attention=fused, dtype=dtype)
            lm = tr.init_lm_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
            tokens = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab, cfg.seq_len)).to(DEV)
            losses, grads = [], []
            for plain in (False, True):
                lm.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                reset_launches()
                with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
                    loss = tr.lm_loss(lm, tokens, cfg)
                    loss.backward()
                torch.cuda.synchronize()
                n = 0 if plain else cfg.n_layers
                want = launches(**dict.fromkeys(FLASH, n)) if fused else \
                    launches(bsr_softmax_stats=n, bsr_softmax_normalize=n)
                check(launch_counts() == want, f"default config fused={fused} plain={plain}: launches "
                                               f"{launch_counts()}, expected {want}")
                losses.append(loss.item())
                grads.append({name: p.grad.detach().float().clone() for name, p in lm.named_parameters()})
            check(all(np.isfinite(losses)), f"default config: non-finite loss {losses}")
            check(all(bool(torch.isfinite(g).all()) for g in grads[0].values()), "default config: non-finite gradient")
            rel = abs(losses[0] - losses[1]) / abs(losses[1])
            worst = max((float((grads[0][n] - g).abs().max()) / max(float(g.abs().max()), 1e-30), n)
                        for n, g in grads[1].items())
            print(f"  TransformerConfig() d_head {cfg.d_head} {str(dtype).split('.')[-1]:<8} fused={fused:d}: loss "
                  f"kernels {losses[0]:.6f} plain {losses[1]:.6f} (rel {rel:.2e}); worst gradient {worst[1]} "
                  f"{worst[0]:.2e} * max|g|; launches { {k: v for k, v in want.items() if v} }", flush=True)
            check(rel <= (1e-5 if dtype == f32 else 1e-2), f"default config loss differs by {rel:.2e}")
            if dtype == f32:
                check(worst[0] <= 1e-3, f"default config gradient of {worst[1]} differs by {worst[0]:.2e}")
            del lm


def topk_attention(rng, errors) -> dict:
    """(b): content-routed attention at the serving width. Per head,
    topk_block_topology(q, k, 4) on the card; attention over it fused
    (flash_block_attention: the metadata has no host copy) and unfused (SDD
    -> softmax kernels -> DSD), and the probabilities by ops.sdd_softmax,
    against the plain path; the topology build and the fused forward under
    set_sync_debug_mode("error"). fp32 within 1e-4 * max|plain| (bf16
    ATOL; probabilities one ulp). Returns the launches of the bf16 run
    (counts set to 0 just before it)."""
    h, t, dh = SERVE.n_heads, SERVE.seq_len, SERVE.d_head
    scale = dh ** -0.5
    counts = {}
    for dtype in (f32, torch.bfloat16):
        q, k, v = (randn(rng, (h, t, dh), dtype) for _ in range(3))
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            topos = [attention.topk_block_topology(q[i], k[i], TOPK_PAGES) for i in range(h)]
            fused = torch.stack([attention.block_sparse_attention(q[i], k[i], v[i], topos[i], causal=True, fused=True)
                                 for i in range(h)])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        unfused = torch.stack([attention.block_sparse_attention(q[i], k[i], v[i], topos[i], causal=True)
                               for i in range(h)])
        probs = [ops.sdd_softmax(q[i], k[i], topos[i], scale=scale, causal=True) for i in range(h)]
        torch.cuda.synchronize()
        counts = launch_counts()
        want = launches(flash_mha_fwd=h, bsr_sdd=h, bsr_dsd_stream=h, bsr_softmax_stats=h,
                        bsr_softmax_normalize=2 * h, sdd_softmax=h)
        check(counts == want, f"top-k {dtype}: launches {counts}, expected {want}")
        check(all(not tp.host_known and tp.max_row_nnz == TOPK_PAGES and tp.nnz_blocks == t // 128 * TOPK_PAGES
                  for tp in topos), "top-k topologies: host copies or hints")
        with registry.forced_variant("torch_reference"):
            plain = torch.stack([attention.block_sparse_attention(q[i], k[i], v[i], topos[i], causal=True)
                                 for i in range(h)])
            plain_probs = [ops.sdd_softmax(q[i], k[i], topos[i], scale=scale, causal=True) for i in range(h)]
        errs = []
        for name, got in (("fused", fused), ("unfused", unfused)):
            err = float((got.float() - plain.float()).abs().max())
            bound = 1e-4 * float(plain.float().abs().max()) if dtype == f32 else ATOL
            check(bool(torch.isfinite(got.float()).all()) and err <= bound, f"top-k {name} {dtype}: {err} > {bound}")
            errs.append(f"{name} {err:.2e}")
        err_p = max(_ulp_or_rel("top-k sdd_softmax", p.data, w.data, dtype) for p, w in zip(probs, plain_probs))
        if dtype == f32:
            cpu = attention.topk_block_topology(q[0].cpu(), k[0].cpu(), TOPK_PAGES)
            check(all(torch.equal(getattr(topos[0], n).cpu(), getattr(cpu, n)) for n in ("offsets", "indices",
                                                                                     "row_indices")),
                  "the card's top-k metadata differs from the CPU build")
        print(f"  top-k {TOPK_PAGES} of {t // 128} blocks per row, H={h} {str(dtype).split('.')[-1]:<8}: "
              f"max|kernels-plain| {', '.join(errs)}, sdd_softmax probabilities {err_p:.2e}; topology build and "
              f"fused forward with no synchronizing call; launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
    return counts


def topk_serving(name_limit: str) -> None:
    """(c): lm_generate_batched(mode="topk", k_pages=4) at the serving model,
    4 requests x 1024-token prompts x 32 new tokens, greedy (twice, equal)
    and at temperature 0.8 from a seeded generator (twice, equal); each
    prefill layer launches SDD, the two softmax kernels and DSD once, the
    top-k decode steps no kernel."""
    lm = tr.init_lm_params(SERVE, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, SERVE.vocab, (N_REQUESTS, PROMPT))).to(DEV)
    kw = dict(mode="topk", k_pages=TOPK_PAGES)
    n = SERVE.n_layers * N_REQUESTS
    want = launches(bsr_sdd=n, bsr_dsd_stream=n, bsr_softmax_stats=n, bsr_softmax_normalize=n)
    for label, extra in (("greedy", {}), ("temperature 0.8", dict(temperature=0.8))):
        runs, walls = [], []
        for _ in range(2):
            gen = torch.Generator(device=DEV).manual_seed(7) if extra else None
            torch.cuda.synchronize()
            reset_launches()
            start = time.perf_counter()
            runs.append(tr.lm_generate_batched(lm, prompts, SERVE, N_NEW, generator=gen, **kw, **extra))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            check(launch_counts() == want, f"top-k serving {label}: launches {launch_counts()}, expected {want}")
        check(torch.equal(*runs), f"top-k serving {label}: two runs differ")
        check(tuple(runs[0].shape) == (N_REQUESTS, N_NEW) and bool(((runs[0] >= 0) & (runs[0] < SERVE.vocab)).all()),
              f"top-k serving {label}: bad tokens")
        print(f"  top-k serving {label}: first tokens {runs[0][:, :6].tolist()}; {N_REQUESTS * N_NEW / walls[1]:.1f} "
              f"generated tokens/s ({walls[1]:.3f} s wall, prefill included; informational) on {name_limit}",
              flush=True)
    del lm


def attn_kernel_times(rng, name_limit: str, yard: dict) -> dict:
    """(e): device times (CUDA graph, 10 warm-up + 100 timed) of the two
    softmax kernels (8 heads, the serving band built on the card, bf16) and
    the score pass of sdd_softmax (8 heads, d_head 128), beside their plain
    versions, bounds and library yardsticks; and flash_block_attention's
    three passes at H = 1 (printed; the flash kernels' JSON rows keep phase
    5's 8-head times). Returns {kernel: ((ms, call), (plain ms, how))}."""
    h, t, dh, bf16 = SERVE.n_heads, SERVE.seq_len, SERVE.d_head, torch.bfloat16
    topo = card_band(bf16)
    nnz, elems = topo.nnz_blocks, h * topo.nnz_blocks * 128 * 128
    scale = dh ** -0.5
    data = randn(rng, (h,) + tuple(topo.data.shape), bf16, 4.0)
    m, l = bsm.stats(data, topo, scale=scale, causal=True)
    q, k = randn(rng, (h, t, dh), bf16), randn(rng, (h, t, dh), bf16)
    kw = dict(scale=scale, causal=True)
    specs = {
        "bsr_softmax_stats": (lambda: bsm.stats(data, topo, **kw), lambda: bsm.stats_reference(data, topo, **kw)),
        "bsr_softmax_normalize": (lambda: bsm.normalize(data, m, l, topo, **kw),
                                  lambda: bsm.normalize_reference(data, m, l, topo, out_dtype=bf16, **kw)),
        "sdd_softmax": (lambda: bsm.scores(q, k, topo, **kw), lambda: bsm.scores_reference(q, k, topo, **kw)),
    }
    times = {kname: (time_ms(kern), _library_time(plain)) for kname, (kern, plain) in specs.items()}
    stats_bytes = 2 * h * t * 4
    # Library: torch.sparse.softmax over the COO of the same causal band
    # pattern, the same scaled scores (all heads, one call); it computes
    # the whole softmax, stats and normalize together.
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    mask = torch.from_numpy((j <= i) & (i // 128 - j // 128 < SERVE.window_blocks)).to(DEV)
    dense = topo.with_data(data).to_dense()
    idx = mask.expand(h, t, t).nonzero().T
    coo = torch.sparse_coo_tensor(idx, dense[mask.expand(h, t, t)].float() * scale, (h, t, t)).coalesce()
    library = library_call("bsr_softmax_normalize", lambda: torch.sparse.softmax(coo, 2))
    del dense, idx, coo
    yard["bsr_softmax_stats"] = (*bound_ms(elems * 2 + stats_bytes, 4 * elems, FP32_FLOPS), None)
    yard["bsr_softmax_normalize"] = (*bound_ms(2 * elems * 2 + stats_bytes, 4 * elems, FP32_FLOPS), library)
    yard["sdd_softmax"] = (*bound_ms(2 * h * t * dh * 2 + elems * 4 + stats_bytes, 2 * elems * dh, BF16_FLOPS), None)
    notes = {"bsr_softmax_stats": "library: none (no call computes the row stats alone)",
             "sdd_softmax": "library: none (sampled_addmm takes no bf16 and computes no row stats)"}
    for kname, ((ms, call), (plain, how)) in times.items():
        lib = yard[kname][2]
        lib_text = f"library {lib * 1e3:.2f} us (torch.sparse.softmax, COO, the whole softmax)" if lib else notes[kname]
        print(f"  {kname:<22} H={h} T={t} {nnz} blocks bf16: kernel {ms * 1e3:.2f} us device / {call * 1e3:.2f} us "
              f"call, plain {plain * 1e3:.2f} us ({how}), {lib_text}, bound {yard[kname][0] * 1e3:.2f} us "
              f"({yard[kname][1]}; {yard[kname][0] / ms:.3f} of it) on {name_limit}", flush=True)
    # flash_block_attention at H = 1: the flash kernels with one head.
    topo1 = card_band(bf16).with_transpose_metadata()
    q1, k1, v1, do1 = (randn(rng, (1, t, dh), bf16) for _ in range(4))
    out, lse = fm.fwd(q1, k1, v1, topo1, **kw)
    dvec = (do1.float() * out.float()).sum(-1)
    bwd = (q1, k1, v1, do1, lse, dvec, topo1)
    passes = {"flash_mha_fwd": (lambda: fm.fwd(q1, k1, v1, topo1, **kw), lambda: fm.fwd_reference(q1, k1, v1, topo1, **kw)),
              "flash_mha_dq": (lambda: fm.dq(*bwd, **kw), lambda: fm.dq_reference(*bwd, **kw)),
              "flash_mha_dkv": (lambda: fm.dkv(*bwd, **kw), lambda: fm.dkv_reference(*bwd, **kw))}
    flops = {"flash_mha_fwd": 4, "flash_mha_dq": 6, "flash_mha_dkv": 8}
    one = flash_yardsticks(topo1, q1, k1, v1, flops)
    for kname, (kern, plain) in passes.items():
        (ms, call), (plain_ms, _) = time_ms(kern), time_ms(plain)
        lib = one[kname][2]
        print(f"  flash_block_attention ({kname}) H=1 T={t} {nnz} blocks bf16: kernel {ms * 1e3:.2f} us device / "
              f"{call * 1e3:.2f} us call, plain {plain_ms * 1e3:.2f} us, "
              f"{'library %.2f us (SDPA, boolean band mask)' % (lib * 1e3) if lib else 'library: none'}, bound "
              f"{one[kname][0] * 1e3:.2f} us ({one[kname][1]}; {one[kname][0] / ms:.3f} of it) on {name_limit}",
              flush=True)
    return times


# ---------------------------------------------------------------- phase 12 --
# Small-block (16 / 32 / 64) sparse training and int8 quantized serving, at
# the JAX bench's headline shape (4096^2, density 0.25) and on the trained
# DLMC-protocol weights.
SB_D, SB_DENSITY = 4096, 0.25
SMALL = tuple(bsr_small.LAUNCHES)  # bsr_small_dsd, bsr_small_sdd
# examples/sparse_finetune.py::block_rigl_demo at full width: ffn_w1, bs 32,
# 75% of the blocks pruned, fp32 SGD at lr 0.5, one refresh (drop 0.2).
RIGL_BS, RIGL_SPARSITY, RIGL_STEPS, RIGL_REFRESH, RIGL_DROP = 32, 0.75, 10, 5, 0.2
# x ~ N(0, 4^2): lr times the loss's mean curvature, 2 * E[x^2] / rows,
# is then ~0.03 per step, the demo's own (its batch of 64 against a width
# of 512); at N(0, 1) and 2048 tokens it is ~0.002, too slow for the
# blocks regrown at zero to recover the dropped ones' share within 4 steps.
RIGL_X_SCALE = 4.0
INT8_OPS = PEAKS["int8_ops"]  # H100 SXM data sheet, int8 dense
Q8_SCALE = 0.0123  # an out_scale that is not a power of two


def p12_counts() -> dict:
    """Launches of phase 12's kernels and of bsr_dsd_stream on floats."""
    return {**bsr_small.LAUNCHES, "bsr_bres": bsr_qstream.LAUNCHES, "bsr_dsd_stream_q8": bsr_dsd.LAUNCHES_Q8,
            "bsr_dsd_stream": bsr_dsd.LAUNCHES}


def p12_launches(**nonzero) -> dict:
    return {**dict.fromkeys(p12_counts(), 0), **nonzero}


def small_bsr(rng, rows, cols, bs, density, dtype, *, unordered=True, scale=1.0) -> BlockSparseMatrix:
    m = testing.random_bsr(rng, rows, cols, int(rows * cols * density), bs, unordered=unordered, device=DEV)
    return m.with_data(randn(rng, tuple(m.data.shape), dtype, scale))


def int8_bsr(rng, d, density, *, unordered=True) -> BlockSparseMatrix:
    m = testing.random_bsr(rng, d, d, int(d * d * density), 128, unordered=unordered, device=DEV)
    return m.with_data(torch.from_numpy(rng.integers(-127, 128, tuple(m.data.shape), dtype=np.int8)).to(DEV))


def int8_dense(rng, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(DEV)


def _p12_case(name, kname, kernel_fn, plain_fn, dtype, errors):
    """A kernel twice (bitwise equal) against its plain version: int32
    equal, fp32 within 1e-4 * max|plain|, bf16 within one bf16 ulp."""
    got, again, want = kernel_fn(), kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{name}: two runs differ")
    if dtype == torch.int32:
        check(got.dtype == torch.int32 and torch.equal(got, want), f"{name}: int32 sums differ from the plain version")
        err = 0.0
    else:
        err = _ulp_or_rel(name, got, want, dtype)
    if dtype in (f32, torch.int32):
        errors[kname] = max(errors.get(kname, 0.0), err)
    return err


def small_kernel_cases(rng, errors) -> None:
    """(a): bsr_small_dsd and bsr_small_sdd against their plain versions on
    the same plans at d = 4096, density 0.25 (SDD: K = 4096), bs 16 / 32 /
    64, all four modes, bf16 and fp32; and a ragged case (unordered columns,
    block-rows whose count is not a multiple of pack, an empty super-row)."""
    d = SB_D
    for bs in (16, 32, 64):
        # One set of square operands per block size serves every mode and dtype.
        a32 = small_bsr(rng, d, d, bs, SB_DENSITY, f32)
        dense32 = [randn(rng, (d, d), f32) for _ in range(3)]
        splan = bsr_small.plan_sdd_smallblock(a32)
        for dtype in (f32, torch.bfloat16):
            errs = []
            a = a32.astype(dtype)
            b, x, y = (t.to(dtype) for t in dense32)
            for ta, tb in MODES:
                kw = dict(transpose_a=ta, transpose_b=tb)
                plan = bsr_small.plan_smallblock(a, transposed=ta)
                errs.append(_p12_case(
                    f"bsr_small_dsd bs {bs} {dtype} ta={ta:d} tb={tb:d}", "bsr_small_dsd",
                    lambda: bsr_small.dsd_smallblock(a, b, schedule=plan, **kw),
                    lambda: bsr_small.dsd_small_reference(plan, a.data, b, n_rows=d // bs, out_dtype=dtype, **kw),
                    dtype, errors))
                errs.append(_p12_case(
                    f"bsr_small_sdd bs {bs} {dtype} ta={ta:d} tb={tb:d}", "bsr_small_sdd",
                    lambda: bsr_small.sdd_smallblock(x, y, a, schedule=splan, **kw).data,
                    lambda: bsr_small.sdd_small_reference(splan, x, y, out_dtype=dtype, **kw), dtype, errors))
            print(f"  bs {bs} {str(dtype).split('.')[-1]:<8} d={d} 25%, 4 modes: max|kernel-plain| dsd "
                  f"{max(errs[0::2]):.2e}, sdd {max(errs[1::2]):.2e}", flush=True)
    # Ragged: bs 32 (pack 4), rows of 3, 5 and 1 blocks in unordered
    # columns, super-row 1 (block-rows 4..7) empty.
    rows = [0, 0, 0, 1, 1, 1, 1, 1, 2, 9, 9]
    cols = [7, 2, 5, 0, 6, 1, 4, 3, 5, 2, 0]
    for dtype in (f32, torch.bfloat16):
        a = testing.bsr_from_blocks(512, 256, rows, cols, rng.standard_normal((len(rows), 32, 32)), dtype=dtype,
                                    device=DEV)
        b = randn(rng, (256, 384), dtype)
        for ta in (False, True):
            bb = b if not ta else randn(rng, (512, 384), dtype)
            plan = bsr_small.plan_smallblock(a, transposed=ta)
            n_rows = (a.cols if ta else a.rows) // 32
            err = _p12_case(f"bsr_small_dsd ragged {dtype} ta={ta:d}", "bsr_small_dsd",
                            lambda: bsr_small.dsd_smallblock(a, bb, transpose_a=ta, schedule=plan),
                            lambda: bsr_small.dsd_small_reference(plan, a.data, bb, n_rows=n_rows, transpose_a=ta,
                                                                  transpose_b=False, out_dtype=dtype), dtype, errors)
            out = bsr_small.dsd_smallblock(a, bb, transpose_a=ta, schedule=plan)
            torch.cuda.synchronize()
            if not ta:
                check(not bool(out[128:256].any()), "the empty super-row is not zero")
        splan = bsr_small.plan_sdd_smallblock(a)
        x, y = randn(rng, (512, 64), dtype), randn(rng, (64, 256), dtype)
        err2 = _p12_case(f"bsr_small_sdd ragged {dtype}", "bsr_small_sdd",
                         lambda: bsr_small.sdd_smallblock(x, y, a, schedule=splan).data,
                         lambda: bsr_small.sdd_small_reference(splan, x, y, transpose_a=False, transpose_b=False,
                                                               out_dtype=dtype), dtype, errors)
        print(f"  ragged bs 32 {str(dtype).split('.')[-1]}: {plan.n_steps} steps, "
              f"{int((plan.datas == a.nnz_blocks).sum())} padding slots, empty super-row zero; max|kernel-plain| "
              f"dsd {err:.2e}, sdd {err2:.2e}", flush=True)


def q8_kernel_cases(rng, errors) -> None:
    """(a): bsr_dsd_stream on int8 operands, DSD and DDS in all four modes
    (int32 sums equal, fp32 / bf16 outputs scaled), and bsr_bres in bf16,
    fp32 and int8 at q 8 and 4 in all four modes, at d = 4096, density
    0.25, against their plain versions."""
    d = SB_D
    errs = {"q8": 0.0, "bres": 0.0}
    aq, bq, xq = int8_bsr(rng, d, SB_DENSITY), int8_dense(rng, (d, d)), int8_dense(rng, (d, d))
    a32, b32 = rand_bsr(rng, d, d, SB_DENSITY, f32, unordered=True), randn(rng, (d, d), f32)
    for ta, tb in MODES:
        kw = dict(transpose_a=ta, transpose_b=tb)
        for od in (torch.int32, f32, torch.bfloat16):
            sc = None if od == torch.int32 else Q8_SCALE
            errs["q8"] = max(errs["q8"], _p12_case(
                f"q8 dsd ta={ta:d} tb={tb:d} {od}", "bsr_dsd_stream_q8",
                lambda: bsr_dsd.dsd(aq, bq, out_dtype=od, out_scale=sc, **kw),
                lambda: bsr_dsd.dsd_reference(aq, bq, out_dtype=od, out_scale=sc, **kw), od, errors))
            errs["q8"] = max(errs["q8"], _p12_case(
                f"q8 dds ta={ta:d} tb={tb:d} {od}", "bsr_dsd_stream_q8",
                lambda: bsr_dsd.dds(xq, aq, out_dtype=od, out_scale=sc, **kw),
                lambda: bsr_dsd.dds_reference(xq, aq, out_dtype=od, out_scale=sc, **kw), od, errors))
            for q in (8, 4):
                plan = bsr_qstream.sparse_plan(aq, ta, q)
                errs["bres"] = max(errs["bres"], _p12_case(
                    f"bres int8 q{q} ta={ta:d} tb={tb:d} {od}", "bsr_bres",
                    lambda: bsr_qstream.dsd_bres(aq, bq, out_dtype=od, out_scale=sc, q=q, **kw),
                    lambda: bsr_qstream.bres_reference(plan, aq.data, bq, n_groups=d // 128, transpose_sparse=ta,
                                                       transpose_dense=tb, out_dtype=od, out_scale=sc), od, errors))
        for dtype in (f32, torch.bfloat16):
            a, b = a32.astype(dtype), b32.to(dtype)
            for q in (8, 4):
                plan = bsr_qstream.sparse_plan(a, ta, q)
                errs["bres"] = max(errs["bres"], _p12_case(
                    f"bres {dtype} q{q} ta={ta:d} tb={tb:d}", "bsr_bres",
                    lambda: bsr_qstream.dsd_bres(a, b, q=q, **kw),
                    lambda: bsr_qstream.bres_reference(plan, a.data, b, n_groups=d // 128, transpose_sparse=ta,
                                                       transpose_dense=tb, out_dtype=dtype), dtype, errors))
        print(f"  ta={ta:d} tb={tb:d} d={d} 25%: q8 stream DSD / DDS int32 equal, scaled fp32 / bf16; bres int8 / "
              f"fp32 / bf16 at q 8 and 4: max|kernel-plain| q8 {errs['q8']:.2e}, bres {errs['bres']:.2e}", flush=True)
    # DDS through bres, and the plan built on the card for card-built metadata.
    a = dss_bench.card_built(rand_bsr(rng, d, d, SB_DENSITY, f32, unordered=True), False)
    x = randn(rng, (d, d), f32)
    for ta, tb in ((False, False), (True, True)):
        kw = dict(transpose_a=ta, transpose_b=tb)
        err = _p12_case(f"bres dds card-built ta={ta:d} tb={tb:d}", "bsr_bres",
                        lambda: bsr_qstream.dds_bres(x, a, **kw), lambda: bsr_dsd.dds_reference(x, a, **kw), f32,
                        errors)
        print(f"  bres DDS on card-built metadata (plan built on the card) ta={ta:d} tb={tb:d}: "
              f"max|kernel-plain| {err:.2e}", flush=True)


def _p12_call(op, args):
    return getattr(ops, f"matmul_{op}")(*args)


def small_routes(rng) -> None:
    """(b): at bs 32 and 64, host-known DSD / DDS / SDD / SSD / SDS / DSS
    take cuda_smallblock with exact launches and match torch_reference
    within one bf16 ulp; metadata built on the card takes jnp_fallback
    (with SSS) and raises nothing; every host-known forward runs
    again with warm plans under set_sync_debug_mode("error")."""
    d, bf16 = SB_D // 2, torch.bfloat16
    x = randn(rng, (d, d), bf16, d ** -0.5)
    warm = []
    for bs in (32, 64):
        a, b, t = (small_bsr(rng, d, d, bs, SB_DENSITY, bf16) for _ in range(3))
        one_dsd, one_sdd = p12_launches(bsr_small_dsd=1), p12_launches(bsr_small_sdd=1)
        cases = [("dsd", (a, x), one_dsd), ("dds", (x, b), one_dsd), ("sdd", (x, x, t), one_sdd),
                 ("ssd", (a, x, t), one_dsd), ("sds", (x, b, t), one_dsd), ("dss", (a, b), one_dsd)]
        for op, args, want in cases:
            name = registry.dispatch_name(op, *args)
            check(name == "cuda_smallblock", f"bs {bs} host {op}: first fit is {name}")
            torch.cuda.synchronize()
            before = p12_counts()
            out = _p12_call(op, args)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in p12_counts().items()}
            check(delta == want, f"bs {bs} {op}: launches {delta}, expected {want}")
            with registry.forced_variant("torch_reference"):
                plain = _p12_call(op, args)
            out, plain = (o.data if isinstance(o, BlockSparseMatrix) else o for o in (out, plain))
            ulps = testing.bf16_ulp_excess(out, plain)
            check(ulps <= 1, f"bs {bs} {op}: {ulps:.2f} bf16 ulp from torch_reference")
            warm.append((op, args))
        card = [dss_bench.card_built(m, False) for m in (a, b, t)]
        ac, bc, tc = card
        for op, args in (("dsd", (ac, x)), ("dds", (x, bc)), ("sdd", (x, x, tc)), ("ssd", (ac, x, tc)),
                         ("sds", (x, bc, tc)), ("dss", (ac, bc)), ("sss", (ac, bc, tc))):
            name = registry.dispatch_name(op, *args)
            check(name == ("dss_extract" if op == "sss" else "jnp_fallback"), f"bs {bs} card {op}: first fit {name}")
            before = p12_counts()
            out = _p12_call(op, args)
            out = out.data if isinstance(out, BlockSparseMatrix) else out
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.float()).all()), f"bs {bs} card {op}: non-finite output")
            check(p12_counts() == before, f"bs {bs} card {op}: a kernel launched on the densify detour")
        print(f"  bs {bs}: host-known dsd / dds / sdd / ssd / sds / dss on cuda_smallblock, one launch each, "
              f"within one bf16 ulp of torch_reference; card-built: jnp_fallback (sss: dss_extract), no raise",
              flush=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for op, args in warm:
            _p12_call(op, args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  all {len(warm)} host-known forwards ran again with warm plans and no synchronizing call", flush=True)


def rigl_finetune(name_limit: str) -> dict:
    """(c): examples/sparse_finetune.py::block_rigl_demo at full width: the
    whole trained ffn_w1 (512 x 2048 as (out, in)) pruned at bs 32 to 25%
    of its blocks, x (in, 2048 tokens) ~ N(0, RIGL_X_SCALE^2), a dense teacher, 10 fp32 SGD steps
    at lr 0.5 through ops.dsd with one RigL refresh (drop 0.2) after step
    5. Returns the launches of the 10 steps."""
    w = torch.from_numpy(dlmc_gen.load_weights(WEIGHTS)["ffn_w1"]).to(DEV)
    rng = np.random.default_rng(22)
    x = randn(rng, (w.shape[1], FT_TOKENS), f32, RIGL_X_SCALE)
    teacher = w @ x
    m = prune.block_magnitude_prune(w, RIGL_BS, sparsity=RIGL_SPARSITY)
    budget = m.nnz_blocks
    check(m.host_known and budget == int(round(0.25 * m.block_rows * m.block_cols)), "the prune's budget")

    def step_loss(topo, leaf):
        return torch.mean((ops.dsd(topo.with_data(leaf), x) - teacher) ** 2)

    def grads(topo, data):
        out = []
        for plain in (False, True):
            leaf = data.clone().requires_grad_()
            with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
                step_loss(topo, leaf).backward()
            out.append(leaf.grad)
        torch.cuda.synchronize()
        return float((out[0] - out[1]).abs().max()) / float(out[1].abs().max())

    rel = grads(m, m.data)
    print(f"  fp32 gradient of the blocks: max |kernels - plain| = {rel:.3e} * max|g|", flush=True)
    check(rel <= 1e-4, f"fine-tune gradient differs by {rel:.3e} * max|g| > 1e-4")
    data = m.data.clone()
    losses, walls, total = [], [], dict.fromkeys(SMALL, 0)
    one_each = p12_launches(bsr_small_dsd=1, bsr_small_sdd=1)
    no_sync = RIGL_REFRESH + 2  # a step after the refresh, its plans warm
    for step in range(RIGL_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        for op, args, kw in (("dsd", (m, x), {}), ("sdd", (teacher, x, m), dict(transpose_b=True))):
            name = registry.dispatch_name(op, *args, **kw)
            check(name == "cuda_smallblock", f"step {step}: {op} routes to {name}")
        start = time.perf_counter()
        leaf = data.clone().requires_grad_()
        if step == no_sync:
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = step_loss(m, leaf)
            loss.backward()
            with torch.no_grad():
                data = leaf - FT_LR * leaf.grad
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        counts = p12_counts()
        check(counts == one_each, f"step {step}: launches {counts}, expected {one_each}")
        total = {k: total[k] + counts[k] for k in total}
        losses.append(loss.item())
        if step == RIGL_REFRESH:
            wd = m.with_data(data).to_dense().requires_grad_()
            torch.mean((wd @ x - teacher) ** 2).backward()
            before = set(zip(m.row_indices.tolist(), m.indices.tolist()))
            m = prune.rigl_block_update(m.with_data(data), wd.grad, drop_fraction=RIGL_DROP)
            data = m.data.clone()
            swapped = len(set(zip(m.row_indices.tolist(), m.indices.tolist())) - before)
            check(m.nnz_blocks == budget and m.host_known, "the refresh changed the budget or lost the host copy")
            check(swapped > 0, "the refresh swapped no block")
    check(all(np.isfinite(losses)), f"fine-tune: non-finite loss in {losses}")
    check(all(b < a for a, b in zip(losses[:RIGL_REFRESH + 1], losses[1:RIGL_REFRESH + 1])),
          f"the loss did not fall over steps 0-{RIGL_REFRESH}: {losses}")
    check(losses[-1] < losses[0], f"the last loss is not below the first: {losses}")
    rel_after = grads(m, data)
    check(rel_after <= 1e-4, f"gradient after the refresh differs by {rel_after:.3e} * max|g|")
    print(f"  {budget} blocks of {RIGL_BS} kept; losses {[round(v, 6) for v in losses]}; refresh after step "
          f"{RIGL_REFRESH} swapped {swapped} blocks, budget and host copy kept, gradient then within "
          f"{rel_after:.3e} * max|g| of plain; launches per step {dict((k, v) for k, v in one_each.items() if v)}; "
          f"step {no_sync} ran with no synchronizing call; wall per step {[round(v * 1e3, 2) for v in walls]} ms "
          f"(informational) on {name_limit}", flush=True)
    # bs 64: one forward and backward.
    m64 = prune.block_magnitude_prune(w, 64, sparsity=RIGL_SPARSITY)
    torch.cuda.synchronize()
    reset_launches()
    leaf = m64.data.clone().requires_grad_()
    step_loss(m64, leaf).backward()
    torch.cuda.synchronize()
    check(p12_counts() == one_each, f"bs 64 step: launches {p12_counts()}")
    rel64 = grads(m64, m64.data)
    check(rel64 <= 1e-4, f"bs 64 gradient differs by {rel64:.3e} * max|g|")
    print(f"  bs 64: one forward and backward, one launch of each kernel, gradient within {rel64:.3e} * max|g| "
          "of plain", flush=True)
    return total


def int8_serving(name_limit: str) -> dict:
    """(d): examples/quantized_serving.py's recipe on the trained ffn_w1
    (d_model 512 x d_ff 2048): block-pruned at 128 to 25% of its blocks by
    norm, 2048 tokens, int8 weights and activations through matmul_dds_q8
    with both kernels, and the per-block-row path through matmul_dsd_q8 on
    the transposed weight. Returns the launches."""
    w1 = torch.from_numpy(dlmc_gen.load_weights(WEIGHTS)["ffn_w1"]).to(DEV)
    rng = np.random.default_rng(23)
    x = randn(rng, (FT_TOKENS, w1.shape[0]), f32)
    pruned = prune.block_magnitude_prune(w1, 128, sparsity=0.75)
    dense_out, pruned_out = x @ w1, x @ pruned.to_dense()

    def rel(a, b):
        return float(torch.linalg.norm((a.float() - b).flatten()) / torch.linalg.norm(b.flatten()))

    w_q, sw = quant.quantize_bsr(pruned)
    x_q, sx = quant.quantize(x)
    wt_q, swt = quant.quantize_bsr(pruned.transpose(), per="block_row")
    xt_q = x_q.T.contiguous()
    torch.cuda.synchronize()
    reset_launches()
    outs = {}
    for kernel in ("stream", "bres"):
        for od in (f32, torch.bfloat16):
            outs[(kernel, od)] = quant.matmul_dds_q8(x_q, w_q, scale_a=sx, scale_b=sw, out_dtype=od, kernel=kernel)
        outs[(kernel, "row")] = quant.matmul_dsd_q8(wt_q, xt_q, scale_a=swt, scale_b=sx, out_dtype=f32,
                                                    kernel=kernel)
    torch.cuda.synchronize()
    counts = p12_counts()
    check(counts == p12_launches(bsr_dsd_stream_q8=3, bsr_bres=3), f"int8 serving launches {counts}")
    errs = {}
    for (kernel, od), y in outs.items():
        want = pruned_out.T if od == "row" else pruned_out
        check(bool(torch.isfinite(y.float()).all()), f"{kernel} {od}: non-finite output")
        errs[(kernel, od)] = rel(y, want)
        check(errs[(kernel, od)] < 0.03, f"int8 {kernel} {od}: error {errs[(kernel, od)]:.4f} >= 0.03")
    for kernel, fn in (("stream", bsr_dsd.dds), ("bres", bsr_qstream.dds_bres)):
        raw = fn(x_q, w_q, out_dtype=torch.int32)
        torch.cuda.synchronize()
        check(torch.equal(raw, bsr_dsd.dds_reference(x_q, w_q, out_dtype=torch.int32)),
              f"{kernel}: int32 sums differ from the plain version")
    print(f"  {pruned.nnz_blocks}/{pruned.block_rows * pruned.block_cols} blocks kept; pruning error vs dense fp32 "
          f"{rel(pruned_out, dense_out):.4f}; int8 error vs pruned fp32: "
          + ", ".join(f"{k} {str(od).split('.')[-1]} {e:.4f}" for (k, od), e in errs.items())
          + "; int32 sums of both kernels equal to plain", flush=True)
    return counts


def p12_kernel_times(rng, name_limit: str) -> dict:
    """(e): the four kernels at d = 4096, density 0.25, NN: CUDA-graph
    device time (10 warm-up + 100 timed) beside the plain version, the bound
    and one PyTorch library call computing the same function where one
    exists. The small-block kernels at bs 16 / 32 / 64 in bf16 (JSON rows:
    bs 32, the fine-tune's); bres and the int8 stream on int8 operands
    with a bf16 output (the serving path; bres also printed in bf16).
    Returns {kernel: (ms, plain ms, library ms, bound ms, bound by)}."""
    d, bf16 = SB_D, torch.bfloat16
    results = {}

    def row(kname, label, kern, plain, lib, nbytes, flops, rate, lib_note="refused, above"):
        (ms, call) = time_ms(kern)
        plain_ms, how = _library_time(plain)
        lib_ms = library_call(kname, lib) if lib is not None else None
        bound, by = bound_ms(nbytes, flops, rate)
        lib_text = f"library {lib_ms * 1e3:.2f} us" if lib_ms is not None else f"library: none ({lib_note})"
        print(f"  {kname:<18} {label}: kernel {ms * 1e3:.2f} us device ({flops / ms / 1e9:.1f} T(FL)OP/s) / "
              f"{call * 1e3:.2f} us call, plain {plain_ms * 1e3:.2f} us ({how}), {lib_text}, bound "
              f"{bound * 1e3:.2f} us ({by}; {bound / ms:.3f} of it) on {name_limit}", flush=True)
        return ms, plain_ms, lib_ms, bound, by

    for bs in (16, 32, 64):
        a = small_bsr(rng, d, d, bs, SB_DENSITY, bf16, unordered=False)
        b, x, y = (randn(rng, (d, d), bf16) for _ in range(3))
        plan, splan = bsr_small.plan_smallblock(a), bsr_small.plan_sdd_smallblock(a)
        nnz = a.nnz_blocks * bs * bs
        # The yardsticks: A as a (bs, bs)-block BSR tensor times B, and
        # sampled_addmm on the topology's element pattern as CSR.
        bsr_t = torch.sparse_bsr_tensor(a.offsets, a.indices, a.data, (d, d))
        try:
            pattern = a.with_data(torch.ones_like(a.data)).to_dense().to_sparse_csr()
        except RuntimeError as e:  # PyTorch has no bf16 CSR here: no yardstick
            print(f"  bsr_small_sdd: no CSR pattern in bf16 ({str(e)[:120]})", flush=True)
            pattern = None
        kw = dict(transpose_a=False, transpose_b=False, out_dtype=bf16)
        dsd_row = row("bsr_small_dsd", f"bs {bs} d={d} 25% NN bf16",
                      lambda: bsr_small.dsd_smallblock(a, b, schedule=plan),
                      lambda: bsr_small.dsd_small_reference(plan, a.data, b, n_rows=d // bs, **kw),
                      lambda: torch.matmul(bsr_t, b), nnz * 2 + 2 * d * d * 2, 2 * nnz * d, BF16_FLOPS)
        sdd_row = row("bsr_small_sdd", f"bs {bs} d={d} 25% K={d} NN bf16",
                      lambda: bsr_small.sdd_smallblock(x, y, a, schedule=splan),
                      lambda: bsr_small.sdd_small_reference(splan, x, y, **kw),
                      None if pattern is None else lambda: torch.sparse.sampled_addmm(pattern, x, y, beta=0.0),
                      2 * d * d * 2 + nnz * 2, 2 * nnz * d, BF16_FLOPS, "no CSR pattern in bf16")
        if bs == RIGL_BS:
            results["bsr_small_dsd"], results["bsr_small_sdd"] = dsd_row, sdd_row
        del a, b, x, y, bsr_t, pattern
    aq, bq = int8_bsr(rng, d, SB_DENSITY, unordered=False), int8_dense(rng, (d, d))
    plan = bsr_qstream.sparse_plan(aq, False, 8)
    dense_aq = aq.to_dense()
    nnz = aq.nnz_blocks * 128 * 128
    q8_bytes, q8_ops = nnz + d * d + d * d * 2, 2 * nnz * d
    results["bsr_bres"] = row(
        "bsr_bres", f"int8 q8 d={d} 25% NN, bf16 out", lambda: bsr_qstream.dsd_bres(aq, bq, out_dtype=bf16,
                                                                                    out_scale=Q8_SCALE),
        lambda: bsr_qstream.bres_reference(plan, aq.data, bq, n_groups=d // 128, transpose_sparse=False,
                                           transpose_dense=False, out_dtype=bf16, out_scale=Q8_SCALE),
        lambda: torch._int_mm(dense_aq, bq), q8_bytes, q8_ops, INT8_OPS)
    results["bsr_dsd_stream_q8"] = row(
        "bsr_dsd_stream_q8", f"int8 d={d} 25% NN, bf16 out",
        lambda: bsr_dsd.dsd(aq, bq, out_dtype=bf16, out_scale=Q8_SCALE),
        lambda: bsr_dsd.dsd_reference(aq, bq, out_dtype=bf16, out_scale=Q8_SCALE),
        lambda: torch._int_mm(dense_aq, bq), q8_bytes, q8_ops, INT8_OPS)
    a = rand_bsr(rng, d, d, SB_DENSITY, bf16)
    b = randn(rng, (d, d), bf16)
    bplan = bsr_qstream.sparse_plan(a, False, 8)
    row("bsr_bres", f"bf16 q8 d={d} 25% NN (printed only)", lambda: bsr_qstream.dsd_bres(a, b),
        lambda: bsr_qstream.bres_reference(bplan, a.data, b, n_groups=d // 128, transpose_sparse=False,
                                           transpose_dense=False, out_dtype=bf16),
        None, a.nnz_blocks * 128 * 128 * 2 + 2 * d * d * 2, 2 * a.nnz_blocks * 128 * 128 * d, BF16_FLOPS,
        "see bsr_dsd_stream's torch.matmul on a BSR tensor")
    return results


# ---------------------------------------------------------------- phase 13 --
# The benchmark entry points (bench/dsd.py, bench/calibrate.py,
# bench/mxu_probe.py) and the pipelined DSD / DDS kernel.
PROBES = tuple(mxu_probe.LAUNCHES)  # mxu_dense_stream, mxu_resident_stream, mxu_tiled_matmul
PIPE_DSD = functools.partial(bsr_dsd.dsd, launch=bsr_pipe.pipelined)
PIPE_DDS = functools.partial(bsr_dsd.dds, launch=bsr_pipe.pipelined)
# The JAX probe's default shape (m 1024, k = n 4096); phase 13 (a) and (d)
# take a cut of its depth sweep (128 .. 4096).
PROBE_M, PROBE_K, PROBE_DEPTHS = 1024, 4096, (128, 512, 4096)


def probe_cases(rng, errors) -> None:
    """(a): the three probes at m 1024, k = n 4096, bf16 and fp32, against
    their plain versions and twice bitwise equal: dense_stream at depths
    128 / 512 / 4096 with and without accumulate, resident_stream at mt 128
    and 512, tiled_matmul at every tile of its sweep list."""
    n_cases = 0
    for dtype in (torch.bfloat16, f32):
        a, b = randn(rng, (PROBE_M, PROBE_K), dtype), randn(rng, (PROBE_K, PROBE_K), dtype)
        full = mxu_probe.product_reference(a, b)
        for depth in PROBE_DEPTHS:
            for acc in (True, False):
                _p12_case(f"mxu_dense_stream depth {depth} accumulate={acc} {dtype}", "mxu_dense_stream",
                          lambda: mxu_probe.dense_stream(a, b, depth=depth, accumulate=acc),
                          lambda: full if acc else mxu_probe.dense_stream_reference(a, b, depth=depth,
                                                                                    accumulate=False),
                          dtype, errors)
                n_cases += 1
        for mt in (128, 512):
            _p12_case(f"mxu_resident_stream mt {mt} {dtype}", "mxu_resident_stream",
                      lambda: mxu_probe.resident_stream(a, b, depth=512, mt=mt), lambda: full, dtype, errors)
            n_cases += 1
        for bm, bk, bn in mxu_probe.SWEEP_CONFIGS:
            _p12_case(f"mxu_tiled_matmul {(bm, bk, bn)} {dtype}", "mxu_tiled_matmul",
                      lambda: mxu_probe.tiled_matmul(a, b, bm=bm, bk=bk, bn=bn), lambda: full, dtype, errors)
            n_cases += 1
        del a, b, full
    print(f"  probes: {n_cases} cases within tolerance, each twice bitwise equal; max |kernel - plain| in fp32: "
          f"{ {k: errors[k] for k in PROBES} }", flush=True)


def pipelined_cases(rng, errors) -> None:
    """(a): bsr_dsd_pipelined, DSD and DDS in all four modes, bf16 and fp32,
    twice bitwise equal, against the plain versions: at the headline
    (4096^2, 25%, N 4096, unordered indices), at the attention shape (T
    1024, window 4, 8 heads batched, N = d_head 128), on a BSR with empty
    block-rows and an empty block-column, unordered, and on that BSR's
    metadata rebuilt on the card (no host copy)."""
    n_cases = 0

    def case(name, sparse, n_dense, ta, tb, dtype):
        nonlocal n_cases
        k_dsd = sparse.rows if ta else sparse.cols
        x = randn(rng, sparse.batch_shape + ((n_dense, k_dsd) if tb else (k_dsd, n_dense)), dtype)
        _p12_case(f"bsr_dsd_pipelined DSD {name} ta={ta} tb={tb} {dtype}", "bsr_dsd_pipelined",
                  lambda: PIPE_DSD(sparse, x, transpose_a=ta, transpose_b=tb),
                  lambda: bsr_dsd.dsd_reference(sparse, x, transpose_a=ta, transpose_b=tb), dtype, errors)
        k_dds = sparse.cols if tb else sparse.rows
        y = randn(rng, sparse.batch_shape + ((k_dds, n_dense) if ta else (n_dense, k_dds)), dtype)
        _p12_case(f"bsr_dsd_pipelined DDS {name} ta={ta} tb={tb} {dtype}", "bsr_dsd_pipelined",
                  lambda: PIPE_DDS(y, sparse, transpose_a=ta, transpose_b=tb),
                  lambda: bsr_dsd.dds_reference(y, sparse, transpose_a=ta, transpose_b=tb), dtype, errors)
        n_cases += 2

    # Block-rows 1, 3 and 4 and block-column 2 empty; columns out of order.
    rows, cols = (0, 0, 0, 2, 2, 5, 5, 5), (3, 0, 5, 1, 4, 0, 4, 1)
    for dtype in (torch.bfloat16, f32):
        head = rand_bsr(rng, 4096, 4096, 0.25, dtype, unordered=True)
        att = band(1024, dtype, rng, SERVE.n_heads, 1.0)
        ragged = testing.bsr_from_blocks(768, 768, rows, cols, np.zeros((len(rows), 128, 128), np.float32),
                                         dtype=dtype, device=DEV)
        ragged = ragged.with_data(randn(rng, tuple(ragged.data.shape), dtype))
        for ta, tb in MODES:
            case("4096^2 25%", head, 4096, ta, tb, dtype)
            case(f"T 1024 x {SERVE.n_heads} heads", att, SERVE.d_head, ta, tb, dtype)
            case("ragged", ragged, 256, ta, tb, dtype)
            case("ragged, card-built metadata", dss_bench.card_built(ragged, False), 256, ta, tb, dtype)
        del head, att
    print(f"  bsr_dsd_pipelined: {n_cases} cases within tolerance, each twice bitwise equal; max |kernel - plain| "
          f"in fp32 {errors['bsr_dsd_pipelined']:.3e}", flush=True)


def pipelined_routes(rng) -> int:
    """(b): variant="cuda_pipelined" and forced_variant("cuda_pipelined")
    launch the kernel, exactly once per product; the first fit still names
    cuda_stream and launches it. Returns the launches of bsr_dsd_pipelined
    on the two routes."""
    a = rand_bsr(rng, 2048, 2048, 0.25, torch.bfloat16)
    b = randn(rng, (2048, 2048), torch.bfloat16)
    for op, args in (("dsd", (a, b)), ("dds", (b, a))):
        name = registry.dispatch_name(op, *args)
        check(name == "cuda_stream", f"{op} first fit is {name}, not cuda_stream")
    torch.cuda.synchronize()
    reset_launches()
    ops.matmul_dsd(a, b, variant="cuda_pipelined")
    ops.matmul_dds(b, a, variant="cuda_pipelined")
    with registry.forced_variant("cuda_pipelined"):
        ops.matmul_dsd(a, b)
        ops.matmul_dds(b, a)
    torch.cuda.synchronize()
    routed = bsr_pipe.LAUNCHES
    check(routed == 4 and bsr_dsd.LAUNCHES == 0,
          f"variant= / forced_variant launched bsr_dsd_pipelined {routed} and bsr_dsd_stream "
          f"{bsr_dsd.LAUNCHES} times, expected 4 and 0")
    ops.matmul_dsd(a, b)
    ops.matmul_dds(b, a)
    torch.cuda.synchronize()
    check(bsr_pipe.LAUNCHES == 4 and bsr_dsd.LAUNCHES == 2, "the first fit did not launch bsr_dsd_stream alone")
    print("  variant= and forced_variant: 4 launches of bsr_dsd_pipelined; first fit: cuda_stream, 2 launches",
          flush=True)
    return routed


def calibration(name_limit: str) -> dict:
    """(c): calibrate.measure(); every efficiency in (0, 1.05]."""
    peaks = calibrate.measure()
    for key in ("mxu_efficiency", "f32_efficiency", "hbm_efficiency"):
        check(0 < peaks[key] <= 1.05, f"calibration: {key} = {peaks[key]} outside (0, 1.05]")
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v) for k, v in peaks.items()
                      if not isinstance(v, dict)}), flush=True)
    print(f"  dense bf16 {peaks['dense_bf16_tflops']:.1f} TFLOP/s ({peaks['mxu_efficiency']:.3f} of 989), fp32 "
          f"{peaks['dense_f32_tflops']:.1f} ({peaks['f32_efficiency']:.3f} of 67), stream {peaks['hbm_gbps']:.0f} "
          f"GB/s ({peaks['hbm_efficiency']:.3f} of 3350) on {name_limit}", flush=True)
    return peaks


def probe_rows() -> None:
    """(d): the bench.mxu_probe rows, a cut of the depth and m-tile sweeps,
    and the whole tile sweep; every fraction of the peak at most 1.05."""
    rows = mxu_probe.run(PROBE_M, PROBE_K, PROBE_K, depths=PROBE_DEPTHS, mt_depths=(4096,), mts=(512,),
                         overwrite_depths=(128,))
    rows += mxu_probe.run_dense_sweep(PROBE_M, PROBE_K, PROBE_K)
    for r in rows:
        check(0 < r["frac_peak"] <= 1.05, f"mxu_probe row {r} above the peak")
        print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v) for k, v in r.items()}), flush=True)


def headline(name_limit: str, peaks: dict) -> None:
    """(e): python -m sputnik_tpu_torch.bench.dsd's line on the first fit
    (cuda_stream), its machine fraction against (c)'s peaks."""
    r = dsd_bench.bench_dsd(4096, 0.25, peaks=peaks)
    check(r["variant"] == "cuda_stream", f"the headline ran {r['variant']}, not the first fit cuda_stream")
    check("frac_machine_sol" in r and 0 < r["frac_machine_sol"] <= 1.05,
          f"headline machine fraction {r.get('frac_machine_sol')} outside (0, 1.05]")
    print(f"  {r['variant']} {r['time_s'] * 1e6:.2f} us: {r['gflops']:.0f} GFLOP/s, {r['frac_sol']:.4f} of the "
          f"data-sheet SoL, {r['frac_machine_sol']:.4f} of the measured one on {name_limit}", flush=True)
    print(json.dumps(dsd_bench.headline_line(r)), flush=True)


def p13_kernel_times(rng, name_limit: str) -> dict:
    """(f): the four kernels' device times (CUDA graph, 10 warm-up + 100
    timed) beside their plain versions, bounds and library yardsticks. The
    probes at m 1024, k = n 4096, bf16, on the CTA tile they share (128 x
    128, depth 128 for the stream probes, tiled 128 x 32 x 128; the library
    call torch.matmul); bsr_dsd_pipelined at phase 5's attention shape (T
    1024, 8 heads; the library call torch.matmul on a BSR tensor, as for
    bsr_dsd_stream), and beside the stream kernel, DSD and DDS at d = 1024
    / 2048 / 4096, 25%. Returns {kernel: (ms, plain ms, library ms, bound
    ms, bound by)}."""
    bf16 = torch.bfloat16
    results = {}

    def row(kname, label, kern, plain, lib_ms, nbytes, flops):
        (ms, call) = time_ms(kern)
        plain_ms, how = _library_time(plain)
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        lib_text = f"library {lib_ms * 1e3:.2f} us" if lib_ms is not None else "library: none"
        print(f"  {kname:<19} {label}: kernel {ms * 1e3:.2f} us device ({flops / ms / 1e9:.1f} TFLOP/s) / "
              f"{call * 1e3:.2f} us call, plain {plain_ms * 1e3:.2f} us ({how}), {lib_text}, bound "
              f"{bound * 1e3:.2f} us ({by}; {bound / ms:.3f} of it) on {name_limit}", flush=True)
        return ms, plain_ms, lib_ms, bound, by

    a, b = randn(rng, (PROBE_M, PROBE_K), bf16), randn(rng, (PROBE_K, PROBE_K), bf16)
    flops = 2 * PROBE_M * PROBE_K * PROBE_K
    nbytes = (PROBE_M * PROBE_K + PROBE_K * PROBE_K + PROBE_M * PROBE_K) * 2
    lib = library_call("torch.matmul", lambda: torch.matmul(a, b))
    plain = lambda: mxu_probe.product_reference(a, b)  # noqa: E731
    shape = f"m {PROBE_M} k = n {PROBE_K} bf16"
    results["mxu_dense_stream"] = row("mxu_dense_stream", f"{shape} depth 128",
                                      lambda: mxu_probe.dense_stream(a, b, depth=128), plain, lib, nbytes, flops)
    results["mxu_resident_stream"] = row("mxu_resident_stream", f"{shape} depth 128 mt 128",
                                         lambda: mxu_probe.resident_stream(a, b, depth=128), plain, lib, nbytes,
                                         flops)
    results["mxu_tiled_matmul"] = row("mxu_tiled_matmul", f"{shape} tile (128, 32, 128)",
                                      lambda: mxu_probe.tiled_matmul(a, b, bm=128, bk=32, bn=128), plain, lib,
                                      nbytes, flops)
    del a, b
    h, dh = SERVE.n_heads, SERVE.d_head
    topo = attention.causal_block_topology(PROMPT, window_blocks=SERVE.window_blocks, dtype=bf16, device=DEV)
    q, k, v = (randn(rng, (h, PROMPT, dh), bf16) for _ in range(3))
    probs = topo.with_data(randn(rng, (h,) + tuple(topo.data.shape), bf16))
    bound, by, lib = attention_yardsticks(topo, q, k, v, probs)["bsr_dsd_stream"]
    blk = h * topo.nnz_blocks * 128 * 128
    results["bsr_dsd_pipelined"] = row(
        "bsr_dsd_pipelined", f"T={PROMPT} {topo.nnz_blocks} blocks x {h} heads", lambda: PIPE_DSD(probs, v),
        lambda: bsr_dsd.dsd_reference(probs, v), lib, blk * 2 + 2 * h * PROMPT * dh * 2, 2 * blk * dh)
    check(abs(results["bsr_dsd_pipelined"][3] - bound) < 1e-9 and results["bsr_dsd_pipelined"][4] == by,
          "the pipelined and stream kernels' bounds differ at one shape")
    stream_ms, _ = time_ms(lambda: bsr_dsd.dsd(probs, v))
    print(f"  bsr_dsd_stream at the same shape: {stream_ms * 1e3:.2f} us device", flush=True)
    # The measurement that bears on which of the two takes the first fit:
    # DSD and DDS, NN, 25%, N = d, at three sizes up to the headline.
    for d in (1024, 2048, 4096):
        a = rand_bsr(rng, d, d, 0.25, bf16)
        b = randn(rng, (d, d), bf16)
        hflops = 2 * a.nnz_blocks * 128 * 128 * d
        for op, pipe, stream in (("DSD", lambda: PIPE_DSD(a, b), lambda: bsr_dsd.dsd(a, b)),
                                 ("DDS", lambda: PIPE_DDS(b, a), lambda: bsr_dsd.dds(b, a))):
            # In turns: pipelined, stream, stream, pipelined.
            turns = [time_ms(fn)[0] for fn in (pipe, stream, stream, pipe)]
            pipe_ms, stream_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            print(f"  {op} {d}^2 25% N {d} bf16: bsr_dsd_pipelined {pipe_ms * 1e3:.2f} us "
                  f"({hflops / pipe_ms / 1e9:.1f} TFLOP/s), bsr_dsd_stream {stream_ms * 1e3:.2f} us "
                  f"({hflops / stream_ms / 1e9:.1f} TFLOP/s), ratio {stream_ms / pipe_ms:.3f}; turns (us) "
                  f"{[round(t * 1e3, 2) for t in turns]}", flush=True)
        # DDS reads A through its transpose metadata: built in every call for
        # a matrix that does not carry it (as above), once for one that does.
        at = a.with_transpose_metadata()
        attached = time_ms(lambda: bsr_dsd.dds(b, at))[0]
        build = time_ms(lambda: a.with_transpose_metadata())[0]
        print(f"  DDS {d}^2 25% N {d} bf16, transpose metadata attached: bsr_dsd_stream {attached * 1e3:.2f} us "
              f"({hflops / attached / 1e9:.1f} TFLOP/s); the metadata build alone {build * 1e3:.2f} us", flush=True)
        del a, b, at
    return results



# ---------------------------------------------------------------- phase 14 --
# bench.py's tune pass, the roofline audit and the autotune cache, on the
# q-stream, C-resident, group-resident and input-resident SDD kernels.
RESIDENT = ("bsr_qstream", "bsr_cres", "bsr_gres", "bsr_sdd_bres")
AUDIT_D = 2048  # the roofline audit's width (sputnik_tpu/bench/roofline.py)
DSD_Q = ("cuda_qstream", "cuda_qstream_q2", "cuda_qstream_vacc", "cuda_qstream_kcat", "cuda_qstream_kcat_q8")
DDS_Q = ("cuda_qstream", "cuda_ct", "cuda_qstream_vacc", "cuda_qstream_kcat", "cuda_qstream_kcat_q8")
# DDS's first fit (ops/matmul.py): see ROADMAP.md, "Differences by design".
DDS_FIRST_FIT = "cuda_stream"


def p14_counts() -> dict:
    return {"bsr_qstream": bsr_qstream.QSTREAM_LAUNCHES, "bsr_cres": bsr_cres.LAUNCHES["bsr_cres"],
            "bsr_gres": bsr_cres.LAUNCHES["bsr_gres"], "bsr_sdd_bres": bsr_sdd.BRES_LAUNCHES}


def stored_bsr(m: BlockSparseMatrix, transposed: bool) -> BlockSparseMatrix:
    """``m``, or with ``transposed`` its transpose stored as a BSR of its own
    (contiguous blocks): the operand whose op() is ``m``."""
    if not transposed:
        return m
    t = m.transpose()
    return t.with_data(t.data.contiguous())


def resident_cases(rng, errors) -> None:
    """(a): the four kernels against their plain versions, bf16 and fp32,
    all four modes, each twice bitwise equal: at the audit's d = 2048, 25%
    (bsr_qstream at q 1 / 2 / 4 / 8, every accum at q 4, dds_q and dds_ct;
    bsr_cres and bsr_gres, DSD and DDS; bsr_sdd_bres at pack 1 and 4), at
    JAX's cres / gres test shape (m 640, k 384, n 512; gres also at
    group_rows 2), and on a BSR with empty block-rows and an empty
    block-column, unordered: its metadata rebuilt on the card for bsr_qstream
    and bsr_cres (JAX: traced), host-known for bsr_gres and bsr_sdd_bres."""
    n_cases = 0

    def case(name, kname, kern, plain, dtype):
        nonlocal n_cases
        _p12_case(name, kname, kern, plain, dtype, errors)
        n_cases += 1

    def dsd_cases(tag, a, n, ta, tb, dtype, variants):
        k = a.rows if ta else a.cols
        x = randn(rng, (n, k) if tb else (k, n), dtype)
        kw = dict(transpose_a=ta, transpose_b=tb)
        plain = lambda: bsr_dsd.dsd_reference(a, x, **kw)  # noqa: E731
        for kname, label, fn in variants:
            case(f"{kname} DSD {label} {tag} ta={ta} tb={tb} {dtype}", kname, lambda: fn(a, x, **kw), plain, dtype)

    def dds_cases(tag, b, m, ta, tb, dtype, variants):
        k = b.cols if tb else b.rows
        y = randn(rng, (k, m) if ta else (m, k), dtype)
        kw = dict(transpose_a=ta, transpose_b=tb)
        plain = lambda: bsr_dsd.dds_reference(y, b, **kw)  # noqa: E731
        for kname, label, fn in variants:
            case(f"{kname} DDS {label} {tag} ta={ta} tb={tb} {dtype}", kname, lambda: fn(y, b, **kw), plain, dtype)

    def sdd_cases(tag, t, k, ta, tb, dtype, packs):
        x = randn(rng, (k, t.rows) if ta else (t.rows, k), dtype)
        y = randn(rng, (t.cols, k) if tb else (k, t.cols), dtype)
        kw = dict(transpose_a=ta, transpose_b=tb)
        for pack in packs:
            case(f"bsr_sdd_bres pack {pack} {tag} ta={ta} tb={tb} {dtype}", "bsr_sdd_bres",
                 lambda: bsr_sdd.sdd_bres(x, y, t, pack=pack, **kw).data, lambda: reference.sdd(x, y, t, **kw).data,
                 dtype)

    q_dsd = [("bsr_qstream", f"q {q} {acc}", functools.partial(bsr_qstream.dsd_q, q=q, accum=acc))
             for q, acc in ((1, "ref"), (2, "ref"), (4, "ref"), (4, "value"), (4, "kcat"), (8, "kcat"))]
    q_dds = [("bsr_qstream", "dds_q", bsr_qstream.dds_q), ("bsr_qstream", "dds_ct", bsr_qstream.dds_ct)]
    res_dsd = [("bsr_cres", "", bsr_cres.dsd_cres), ("bsr_gres", "", bsr_cres.dsd_gres)]
    res_dds = [("bsr_cres", "", bsr_cres.dds_cres), ("bsr_gres", "", bsr_cres.dds_gres)]
    gres2 = [("bsr_gres", "group_rows 2", functools.partial(bsr_cres.dsd_gres, group_rows=2))]
    rows, cols = (0, 0, 0, 2, 2, 5, 5, 5), (3, 0, 5, 1, 4, 0, 4, 1)  # block-rows 1, 3, 4 and column 2 empty
    for dtype in (torch.bfloat16, f32):
        head = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, dtype, unordered=True)
        jax_a = rand_bsr(rng, 640, 384, 0.3, dtype, unordered=True)
        jax_b = rand_bsr(rng, 384, 512, 0.3, dtype, unordered=True)
        ragged = testing.bsr_from_blocks(768, 768, rows, cols, np.zeros((len(rows), 128, 128), np.float32),
                                         dtype=dtype, device=DEV)
        ragged = ragged.with_data(randn(rng, tuple(ragged.data.shape), dtype))
        card = dss_bench.card_built(ragged, False)
        topo = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, dtype, unordered=True)
        for ta, tb in MODES:
            tag = f"{AUDIT_D}^2 25%"
            dsd_cases(tag, head, AUDIT_D, ta, tb, dtype, q_dsd + res_dsd)
            dds_cases(tag, head, AUDIT_D, ta, tb, dtype, q_dds + res_dds)
            sdd_cases(tag, topo, AUDIT_D, ta, tb, dtype, (1, 4))
            dsd_cases("640 x 384, n 512", stored_bsr(jax_a, ta), 512, ta, tb, dtype, res_dsd + gres2)
            dds_cases("k 384, n 512, m 640", stored_bsr(jax_b, tb), 640, ta, tb, dtype, res_dds)
            dsd_cases("ragged, card-built", card, 256, ta, tb, dtype, q_dsd[2:3] + res_dsd[:1])
            dds_cases("ragged, card-built", card, 256, ta, tb, dtype, q_dds[1:] + res_dds[:1])
            dsd_cases("ragged", ragged, 256, ta, tb, dtype, res_dsd[1:])
            sdd_cases("ragged", ragged, 256, ta, tb, dtype, (4,))
        del head, topo
    print(f"  {n_cases} cases within tolerance, each twice bitwise equal; max |kernel - plain| in fp32: "
          f"{ {k: errors.get(k) for k in RESIDENT} }", flush=True)


def resident_routes(rng) -> None:
    """(b): every new ``variant=`` name launches its kernel, exactly once per
    product; DSD's and SDD's first fit are unchanged (cuda_stream,
    cuda_output_stationary), DDS's is DDS_FIRST_FIT."""
    bf16 = torch.bfloat16
    a = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, bf16)
    b = randn(rng, (AUDIT_D, AUDIT_D), bf16)
    t = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, bf16)
    torch.cuda.synchronize()
    reset_launches()
    for name in DSD_Q + ("cuda_cres", "cuda_gres"):
        ops.matmul_dsd(a, b, variant=name)
    for name in DDS_Q + ("cuda_cres", "cuda_gres"):
        ops.matmul_dds(b, a, variant=name)
    ops.matmul_sdd(b, b, t, transpose_b=True, variant="cuda_bres")
    torch.cuda.synchronize()
    want = {"bsr_qstream": 10, "bsr_cres": 2, "bsr_gres": 2, "bsr_sdd_bres": 1}
    check(p14_counts() == want and bsr_dsd.LAUNCHES == 0 and bsr_sdd.LAUNCHES == 0,
          f"variant= launched {p14_counts()}, stream {bsr_dsd.LAUNCHES}, sdd {bsr_sdd.LAUNCHES}; expected {want}")
    names = (registry.dispatch_name("dsd", a, b), registry.dispatch_name("dds", b, a),
             registry.dispatch_name("sdd", b, b, t, transpose_b=True))
    check(names == ("cuda_stream", DDS_FIRST_FIT, "cuda_output_stationary"), f"first fit {names}")
    reset_launches()
    ops.matmul_dsd(a, b)
    ops.matmul_dds(b, a)
    ops.matmul_sdd(b, b, t, transpose_b=True)
    torch.cuda.synchronize()
    dds_cres = DDS_FIRST_FIT == "cuda_cres"
    check((bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES, bsr_cres.LAUNCHES["bsr_cres"]) == (2 - dds_cres, 1, int(dds_cres)),
          f"first fit launched stream {bsr_dsd.LAUNCHES}, sdd {bsr_sdd.LAUNCHES}, {p14_counts()}")
    print(f"  variant=: launches {want}; first fit DSD cuda_stream, DDS {DDS_FIRST_FIT}, SDD cuda_output_stationary",
          flush=True)


def autotune_round_trip(rng) -> None:
    """(c): ops.benchmark_variants("dsd") at the audit's width, the winner
    persisted by ops.autotune and picked by dispatch (launching its kernel),
    then ops.clear_cache: dispatch is back on first fit."""
    bf16 = torch.bfloat16
    a = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, bf16)
    b = randn(rng, (AUDIT_D, AUDIT_D), bf16)
    timings = ops.benchmark_variants("dsd", a, b)
    print("  benchmark_variants: " + ", ".join(f"{k} {v * 1e6:.2f} us" for k, v in sorted(timings.items(),
                                                                                       key=lambda kv: kv[1])),
          flush=True)
    check({"cuda_stream", "cuda_cres", "cuda_gres"} | set(DSD_Q) <= set(timings), f"untimed variants: {timings}")
    check(not autotune_mod.PLAIN_VARIANTS & set(timings), f"plain variants timed on the card: {timings}")
    winner = ops.autotune("dsd", a, b, timings=timings)
    check(winner == min(timings, key=timings.get) and autotune_mod.cached_variant("dsd", (a, b), {}) == winner,
          f"autotune kept {winner}")
    check(registry.dispatch_name("dsd", a, b) == winner, "dispatch did not pick the tuned winner")
    ops.clear_cache()
    check(autotune_mod.cached_variant("dsd", (a, b), {}) is None and registry.dispatch_name("dsd", a, b)
          == "cuda_stream", "clear_cache left the winner in place")
    print(f"  autotune kept {winner}; dispatch picked it; clear_cache: first fit cuda_stream again", flush=True)


def tuned_headline(name_limit: str, peaks: dict) -> None:
    """(d): python -m sputnik_tpu_torch.bench.dsd's line with its tune pass
    (the winner printed on stderr), then with --no-tune (the first fit)."""
    tuned = dsd_bench.bench_dsd(4096, 0.25, peaks=peaks, tune=True)
    check(tuned["variant"] in dsd_bench.TUNE_SHORTLIST, f"the tuned headline ran {tuned['variant']}")
    first = dsd_bench.bench_dsd(4096, 0.25, peaks=peaks, tune=False)
    check(first["variant"] == "cuda_stream", f"--no-tune ran {first['variant']}")
    for r, how in ((tuned, "tuned"), (first, "--no-tune")):
        print(f"  {how}: {r['variant']} {r['time_s'] * 1e6:.2f} us, {r['gflops']:.0f} GFLOP/s, {r['frac_sol']:.4f} "
              f"of the data-sheet SoL on {name_limit}", flush=True)
        print(json.dumps(dsd_bench.headline_line(r)), flush=True)
    ops.clear_cache()


def audit_rows(name_limit: str) -> None:
    """(e): the roofline audit at d = 2048: 22 rows in JAX's order, no error,
    every fraction of the speed of light at most 1.05 (the audit raises
    above it), each row's variant."""
    rows = roofline.audit(AUDIT_D, 0.25)
    errors = [r for r in rows if "error" in r]
    check(len(rows) == 22 and not errors, f"the audit gave {len(rows)} rows, errors {errors}")
    check(all(r.get("frac_sol", 0) <= roofline.SOL_LIMIT for r in rows), "a fraction above 1.05")
    print(roofline.table(rows, AUDIT_D, 0.25, "bfloat16", name_limit), flush=True)


def p14_kernel_times(rng, name_limit: str) -> dict:
    """(f): the four kernels at the audit's shape (d = 2048, 25%, bf16, NN;
    SDD's row with transpose_b, as the audit's): CUDA-graph device time
    beside the plain version, the bound and one PyTorch call computing the
    same function (torch.matmul on a BSR tensor for DSD, and for DDS on the
    BSR tensor of B^T times A^T, its transpose; none for SDD:
    sampled_addmm takes no bf16). Returns {kernel: (ms, plain ms, library
    ms, bound ms, bound by)}."""
    d, bf16 = AUDIT_D, torch.bfloat16
    a = rand_bsr(rng, d, d, 0.25, bf16)
    b, x = randn(rng, (d, d), bf16), randn(rng, (d, d), bf16)
    t = rand_bsr(rng, d, d, 0.25, bf16)
    nnz = a.nnz_blocks * 128 * 128
    nbytes, flops = nnz * 2 + 2 * d * d * 2, 2 * nnz * d
    bsr_a = torch.sparse_bsr_tensor(a.offsets, a.indices, a.data, (d, d))
    at = a.transpose()
    bsr_at = torch.sparse_bsr_tensor(at.offsets, at.indices, at.data, (d, d))
    bt = b.t().contiguous()
    dsd_lib = library_call("bsr_qstream", lambda: torch.matmul(bsr_a, b))
    dds_lib = library_call("bsr_cres", lambda: torch.matmul(bsr_at, bt))
    results = {}

    def row(kname, label, kern, plain, lib_ms, nbytes, flops):
        (ms, call) = time_ms(kern)
        plain_ms, how = _library_time(plain)
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        lib_text = f"library {lib_ms * 1e3:.2f} us" if lib_ms is not None else "library: none"
        print(f"  {kname:<13} {label}: kernel {ms * 1e3:.2f} us device ({flops / ms / 1e9:.1f} TFLOP/s) / "
              f"{call * 1e3:.2f} us call, plain {plain_ms * 1e3:.2f} us ({how}), {lib_text}, bound "
              f"{bound * 1e3:.2f} us ({by}; {bound / ms:.3f} of it) on {name_limit}", flush=True)
        results[kname] = (ms, plain_ms, lib_ms, bound, by)

    shape = f"d={d} 25% NN bf16"
    row("bsr_qstream", f"DSD q 4 {shape}", lambda: bsr_qstream.dsd_q(a, b), lambda: bsr_dsd.dsd_reference(a, b),
        dsd_lib, nbytes, flops)
    row("bsr_cres", f"DDS {shape}", lambda: bsr_cres.dds_cres(b, a), lambda: bsr_dsd.dds_reference(b, a), dds_lib,
        nbytes, flops)
    row("bsr_gres", f"DSD {shape}", lambda: bsr_cres.dsd_gres(a, b), lambda: bsr_dsd.dsd_reference(a, b), dsd_lib,
        nbytes, flops)
    tn = t.nnz_blocks * 128 * 128
    row("bsr_sdd_bres", f"SDD pack 4, K = {d}, transpose_b {shape}",
        lambda: bsr_sdd.sdd_bres(b, x, t, transpose_b=True), lambda: reference.sdd(b, x, t, transpose_b=True),
        None, 2 * d * d * 2 + tn * 2, 2 * tn * d)
    # The other schedules beside the stream kernel at the same shape.
    for label, fn in (("DSD stream", lambda: bsr_dsd.dsd(a, b)), ("DDS stream", lambda: bsr_dsd.dds(b, a)),
                      ("DSD cres", lambda: bsr_cres.dsd_cres(a, b)), ("DDS gres", lambda: bsr_cres.dds_gres(b, a)),
                      ("DDS dds_q", lambda: bsr_qstream.dds_q(b, a)), ("DDS dds_ct", lambda: bsr_qstream.dds_ct(b, a)),
                      ("SDD output-stationary", lambda: bsr_sdd.sdd(b, x, t, transpose_b=True))):
        print(f"  {label} {shape}: {time_ms(fn)[0] * 1e3:.2f} us device", flush=True)
    return results


def dds_first_fit_times(rng, name_limit: str) -> None:
    """(f): the times that decide DDS's first fit (DDS_FIRST_FIT): cuda_cres
    and cuda_gres beside cuda_stream at the audit's bsr_dds (d = 2048, 25%,
    bf16) and on each DDS problem of one bf16 MoE backward (phase 8's
    width, bsr and dropless_bsr_fused). Phase 6's attention training step
    runs no DDS: its VJPs are DSD and SDD."""
    a = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, torch.bfloat16)
    b = randn(rng, (AUDIT_D, AUDIT_D), torch.bfloat16)
    problems = [(f"audit bsr_dds d={AUDIT_D} 25%", (b, a), {})]
    seen, real = set(), registry.dispatch

    def spy(op, *args, **kw):
        if op == "dds":
            key = tuple((tuple(x.shape), getattr(x, "nnz_blocks", None)) for x in args) + (str(sorted(kw.items())),)
            if key not in seen:
                seen.add(key)
                problems.append((f"MoE {impl} backward DDS {tuple(args[0].shape)} x {tuple(args[1].shape)} "
                                 f"{args[1].nnz_blocks} blocks {kw}", args, kw))
        return real(op, *args, **kw)

    params, x, topo = moe_setup(MOE)
    registry.dispatch = spy
    try:
        for impl in ("bsr", "dropless_bsr_fused"):
            y, aux = moe_forward_fn(impl, params, MOE, topo)(x.clone().requires_grad_())
            (torch.mean(y.float() ** 2) + MOE.router_aux_weight * aux).backward()
            params.zero_grad(set_to_none=True)
    finally:
        registry.dispatch = real
    torch.cuda.synchronize()
    for label, args, kw in problems:
        times = []
        for name in ("cuda_stream", "cuda_cres", "cuda_gres"):
            v = next(v for v in registry.variants_for("dds") if v.name == name)
            if v.can_implement(*args, **kw):
                times.append(f"{name} {time_ms(lambda: v.launch(*args, **kw))[0] * 1e3:.2f} us")
            else:
                times.append(f"{name} cannot take it")
        print(f"  DDS first fit, {label}: {', '.join(times)} device on {name_limit}", flush=True)
    print(f"  DDS first fit registered: {DDS_FIRST_FIT}", flush=True)


# ---------------------------------------------------------------- phase 15 --
# The panel-resident and column-stacked DSD / DDS schedules and the variant
# tools (bench.tune, bench.headline, bench.grid, bench.grid_summary,
# bench.sss_floor, bench.flash_sweep).
SCHEDULES = ("bsr_panel", "bsr_cstack")
# JAX's test shapes (tests/test_bsr_matmul.py): the panel's m 512, k 384,
# n 256; the cstack's and cres's m 640, k 384, n 512.
PANEL_SHAPE, CSTACK_SHAPE = (512, 384, 256), (640, 384, 512)


def p15_counts() -> dict:
    return {"bsr_panel": bsr_panel.LAUNCHES, "bsr_cstack": bsr_cstack.LAUNCHES}


def schedule_cases(rng, errors) -> None:
    """(a): bsr_panel (DSD and DDS, all four modes) and bsr_cstack (q 4 / 8,
    NN / NT, n_tile 256 and the default) against their plain versions, bf16
    and fp32, each twice bitwise equal: at the audit's d = 2048, 25%
    (unordered indices), at JAX's test shapes, on a BSR with empty
    block-rows and an empty block-column, and for cstack on that BSR's
    metadata rebuilt on the card (the plan built there); then at the
    contractions that reach every panel width the kernel instantiates, in
    both dtypes (bf16: 64 at K = 384, 32 at 2048, 16 at the headline's
    4096^2, where cstack runs too, 8 at 8192; fp32: 64 at 384, 32 at 1024,
    16 at 2048, 8 at 4096), and fails unless each (dtype, width) was
    launched."""
    n_cases = 0
    widths = set()
    real_width = bsr_panel._panel_width

    def width(in_kind, *args):
        w = real_width(in_kind, *args)
        widths.add((in_kind, w))
        return w

    def case(name, kname, kern, plain, dtype):
        nonlocal n_cases
        _p12_case(name, kname, kern, plain, dtype, errors)
        n_cases += 1

    def dsd(tag, a, n, ta, tb, dtype, variants):
        k = a.rows if ta else a.cols
        x = randn(rng, (n, k) if tb else (k, n), dtype)
        kw = dict(transpose_a=ta, transpose_b=tb)
        for kname, label, fn in variants:
            case(f"{kname} DSD {label} {tag} ta={ta} tb={tb} {dtype}", kname, lambda: fn(a, x, **kw),
                 lambda: bsr_dsd.dsd_reference(a, x, **kw), dtype)

    def dds(tag, b, m, ta, tb, dtype):
        k = b.cols if tb else b.rows
        y = randn(rng, (k, m) if ta else (m, k), dtype)
        kw = dict(transpose_a=ta, transpose_b=tb)
        case(f"bsr_panel DDS {tag} ta={ta} tb={tb} {dtype}", "bsr_panel", lambda: bsr_panel.dds_panel(y, b, **kw),
             lambda: bsr_dsd.dds_reference(y, b, **kw), dtype)

    panel = [("bsr_panel", "", bsr_panel.dsd_panel)]
    cstack = [("bsr_cstack", f"q {q} n_tile {nt}", functools.partial(bsr_cstack.dsd_cstack, q=q, n_tile=nt))
              for q in (4, 8) for nt in (256, 8192)]

    def wide(m, k, n, dtype, with_cstack):
        """Every mode at (m, k, n), 25%: DSD (with cstack, q 4 / 8) and DDS."""
        square = rand_bsr(rng, m, k, 0.25, dtype, unordered=True) if m == k == n else None
        for ta, tb in MODES:
            a = square if square is not None else rand_bsr(rng, *((k, m) if ta else (m, k)), 0.25, dtype,
                                                           unordered=True)
            dsd(f"{m} x {k}, n {n}", a, n, ta, tb, dtype, panel + (cstack[1::2] if with_cstack and not ta else []))
            b = square if square is not None else rand_bsr(rng, *((n, k) if tb else (k, n)), 0.25, dtype,
                                                           unordered=True)
            dds(f"k {k}, n {n}, m {m}", b, m, ta, tb, dtype)

    bsr_panel._panel_width = width
    try:
        rows, cols = (0, 0, 0, 2, 2, 5, 5, 5), (3, 0, 5, 1, 4, 0, 4, 1)  # block-rows 1, 3, 4 and column 2 empty
        pm, pk, pn = PANEL_SHAPE
        cm, ck, cn = CSTACK_SHAPE
        for dtype in (torch.bfloat16, f32):
            head = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, dtype, unordered=True)
            ragged = testing.bsr_from_blocks(768, 768, rows, cols, np.zeros((len(rows), 128, 128), np.float32),
                                             dtype=dtype, device=DEV)
            ragged = ragged.with_data(randn(rng, tuple(ragged.data.shape), dtype))
            card = dss_bench.card_built(ragged, False)
            jax_c = rand_bsr(rng, cm, ck, 0.3, dtype, unordered=True)
            for ta, tb in MODES:
                tag = f"{AUDIT_D}^2 25%"
                dsd(tag, head, AUDIT_D, ta, tb, dtype, panel + ([] if ta else cstack[1:2] + cstack[3:]))
                dds(tag, head, AUDIT_D, ta, tb, dtype)
                jax_a = rand_bsr(rng, *((pk, pm) if ta else (pm, pk)), 0.3, dtype, unordered=True)
                jax_b = rand_bsr(rng, *((pn, pk) if tb else (pk, pn)), 0.3, dtype, unordered=True)
                dsd(f"{pm} x {pk}, n {pn}", jax_a, pn, ta, tb, dtype, panel)
                dds(f"k {pk}, n {pn}, m {pm}", jax_b, pm, ta, tb, dtype)
                dsd("ragged", ragged, 256, ta, tb, dtype, panel + ([] if ta else cstack[:1] + cstack[2:3]))
                dds("ragged", ragged, 256, ta, tb, dtype)
                if not ta:
                    dsd(f"{cm} x {ck}, n {cn}", jax_c, cn, ta, tb, dtype, cstack)
                    dsd("ragged, card-built", card, 256, ta, tb, dtype, cstack[::3])
            del head
        wide(4096, 4096, 4096, torch.bfloat16, True)
        wide(1024, 8192, 512, torch.bfloat16, False)
        wide(512, 1024, 256, f32, False)
        wide(1024, 4096, 512, f32, False)
    finally:
        bsr_panel._panel_width = real_width
    want = {(kind, w) for kind in (0, 1) for w in bsr_panel._WIDTHS}
    check(widths == want, f"panel widths launched {sorted(widths)}, expected {sorted(want)} (0 bf16, 1 fp32)")
    print(f"  {n_cases} cases within tolerance, each twice bitwise equal, at every panel width (dtype kind, W) "
          f"{sorted(widths)}; max |kernel - plain| in fp32: { {k: errors.get(k) for k in SCHEDULES} }", flush=True)


def schedule_routes(rng) -> None:
    """(b): each new variant= name launches its kernel exactly once per
    product (cuda_panel bsr_panel, cuda_cstack / cuda_cstack_q4 bsr_cstack,
    cuda_stream_at bsr_dsd_stream, xla_gather_bmm no counted kernel), within
    tolerance of the plain product; the first fits are unchanged."""
    bf16 = torch.bfloat16
    a = rand_bsr(rng, AUDIT_D, AUDIT_D, 0.25, bf16)
    b = randn(rng, (AUDIT_D, AUDIT_D), bf16)

    def counts():
        return {**p15_counts(), "bsr_dsd_stream": bsr_dsd.LAUNCHES, **p14_counts(), "bsr_dsd_pipelined": bsr_pipe.LAUNCHES}

    for op, args, name, kname in (("dsd", (a, b), "cuda_panel", "bsr_panel"), ("dds", (b, a), "cuda_panel", "bsr_panel"),
                                  ("dsd", (a, b), "cuda_cstack", "bsr_cstack"),
                                  ("dsd", (a, b), "cuda_cstack_q4", "bsr_cstack"),
                                  ("dds", (b, a), "cuda_stream_at", "bsr_dsd_stream"),
                                  ("dsd", (a, b), "xla_gather_bmm", None)):
        torch.cuda.synchronize()
        before = counts()
        got = registry.dispatch(op, *args, variant=name)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        check(moved == ({kname: 1} if kname else {}), f"variant={name} launched {moved}")
        want = (reference.dsd if op == "dsd" else reference.dds)(*args)
        check(testing.bf16_ulp_excess(got, want) <= 1, f"variant={name}: more than one bf16 ulp from plain")
    names = (registry.dispatch_name("dsd", a, b), registry.dispatch_name("dds", b, a))
    check(names == ("cuda_stream", DDS_FIRST_FIT), f"first fit {names}")
    print(f"  variant=: cuda_panel (DSD, DDS) -> bsr_panel, cuda_cstack / cuda_cstack_q4 -> bsr_cstack, "
          f"cuda_stream_at -> bsr_dsd_stream, xla_gather_bmm -> no kernel; first fits {names}", flush=True)


def variant_tools(name_limit: str, out_dir: str) -> None:
    """(c)-(e): python -m sputnik_tpu_torch.bench.tune (d = 2048; dsd, dds,
    sdd; NN), bench.headline (4096^2, 25%), a cut of bench.grid (d = 2048,
    densities 0.25 / 0.1, six ops x four modes) and bench.grid_summary on
    its output, bench.sss_floor (d = 2048) and bench.flash_sweep, each
    through its entry point, writing under ``out_dir``; the run's tune cache
    is cleared after tune and after headline, so that the grid measures
    the first fit."""
    start = time.perf_counter()
    print(f"(c) python -m sputnik_tpu_torch.bench.tune --d {AUDIT_D} (dsd, dds, sdd, NN) on {name_limit}", flush=True)
    tune_bench.main(["--d", str(AUDIT_D)])
    entries = json.load(open(os.environ["SPUTNIK_TPU_TORCH_TUNE_CACHE"]))["entries"]
    check(len(entries) == 3, f"tune persisted {entries}")
    print(f"  winners persisted: {sorted(entries.values())} ({time.perf_counter() - start:.1f} s)", flush=True)
    ops.clear_cache()
    print(f"(d) python -m sputnik_tpu_torch.bench.headline (4096^2, 25%, bf16) on {name_limit}", flush=True)
    path = os.path.join(out_dir, "headline_shootout.json")
    headline_bench.main(["--out", path])
    shoot = json.load(open(path))
    a, b = dsd_bench.inputs(4096, 0.25)
    takes = {v.name for v in registry.variants_for("dsd") if v.can_implement(a, b)} - autotune_mod.PLAIN_VARIANTS
    timed = {r["variant"] for r in shoot["rows"]}
    check(not shoot["failed"] and takes | set(headline_bench.EXTRAS) <= timed,
          f"headline failed {shoot['failed']}, untimed {takes | set(headline_bench.EXTRAS) - timed}")
    check(shoot["card"] == name_limit, f"headline names {shoot['card']}")
    del a, b
    ops.clear_cache()
    print(f"  {len(timed)} rows, {len(takes)} registry variants ({time.perf_counter() - start:.1f} s)", flush=True)
    print(f"(e) python -m sputnik_tpu_torch.bench.grid --d {AUDIT_D} --densities 0.25 0.1, then grid_summary",
          flush=True)
    path = os.path.join(out_dir, "bsr_grid_results.json")
    grid_bench.main(["--d", str(AUDIT_D), "--densities", "0.25", "0.1", "--out", path])
    rows = grid_bench.load_rows(path)
    check(len(rows) == 48 and not [r for r in rows if "error" in r], f"grid rows {len(rows)}, errors "
          f"{[r for r in rows if 'error' in r]}")
    check(all(r.get("frac_sol", 0) <= grid_bench.SOL_LIMIT for r in rows), "a grid fraction above 1.05")
    grid_summary.main(["--in", path])
    print(f"  python -m sputnik_tpu_torch.bench.sss_floor --d {AUDIT_D}", flush=True)
    sss_floor.main(["--d", str(AUDIT_D), "--out", os.path.join(out_dir, "sss_floor.json")])
    print("  python -m sputnik_tpu_torch.bench.flash_sweep", flush=True)
    flash_sweep.main(["--out", os.path.join(out_dir, "flash_sweep.json")])
    print(f"  the tools took {time.perf_counter() - start:.1f} s", flush=True)


def p15_kernel_times(rng, name_limit: str) -> dict:
    """(f): the two kernels at the audit's shape (d = 2048, 25%, bf16, NN):
    CUDA-graph device time beside the plain version, the bound and one
    PyTorch call computing the same function (torch.matmul on a BSR
    tensor); then panel / cstack / cres / stream / pipelined side by side,
    DSD at d = 2048 and 4096, 25%. Returns {kernel: (ms, plain ms, library
    ms, bound ms, bound by)}."""
    d, bf16 = AUDIT_D, torch.bfloat16
    a = rand_bsr(rng, d, d, 0.25, bf16)
    b = randn(rng, (d, d), bf16)
    nnz = a.nnz_blocks * 128 * 128
    nbytes, flops = nnz * 2 + 2 * d * d * 2, 2 * nnz * d
    bsr_a = torch.sparse_bsr_tensor(a.offsets, a.indices, a.data, (d, d))
    lib = library_call("bsr_panel", lambda: torch.matmul(bsr_a, b))
    results = {}
    for kname, fn in (("bsr_panel", lambda: bsr_panel.dsd_panel(a, b)), ("bsr_cstack", lambda: bsr_cstack.dsd_cstack(a, b))):
        ms, call = time_ms(fn)
        plain_ms, how = _library_time(lambda: bsr_dsd.dsd_reference(a, b))
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        print(f"  {kname:<10} DSD d={d} 25% NN bf16: kernel {ms * 1e3:.2f} us device ({flops / ms / 1e9:.1f} "
              f"TFLOP/s) / {call * 1e3:.2f} us call, plain {plain_ms * 1e3:.2f} us ({how}), library "
              f"{lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by}; {bound / ms:.3f} of it) on {name_limit}",
              flush=True)
        results[kname] = (ms, plain_ms, lib, bound, by)
    for dd in (AUDIT_D, 4096):
        a = rand_bsr(rng, dd, dd, 0.25, bf16)
        b = randn(rng, (dd, dd), bf16)
        times = [f"{label} {time_ms(fn)[0] * 1e3:.2f}" for label, fn in (
            ("panel", lambda: bsr_panel.dsd_panel(a, b)), ("panel DDS", lambda: bsr_panel.dds_panel(b, a)),
            ("cstack q 8", lambda: bsr_cstack.dsd_cstack(a, b)),
            ("cstack q 4", lambda: bsr_cstack.dsd_cstack(a, b, q=4)), ("cres", lambda: bsr_cres.dsd_cres(a, b)),
            ("stream", lambda: bsr_dsd.dsd(a, b)), ("pipelined", lambda: PIPE_DSD(a, b)),
            ("xla_gather_bmm", lambda: xla_gather.dsd_gather_bmm(a, b)))]
        print(f"  DSD d={dd} 25% NN bf16, us device: {', '.join(times)} on {name_limit}", flush=True)
    return results


# ---------------------------------------------------------------- phase 16 --
# The distributed slice on one card: ring attention and sequence-parallel
# attention at one head of the serving model's attention (d_head 128, bf16)
# over S = 4 bands, their band fold on the fold kernel, and the sharded
# ops. One card cannot hold a multi-rank NCCL group (NCCL refuses two ranks
# on one device), so the S ranks' bodies run in turn in this process, each
# ring step handed the band the rotation delivers (the *_sequential
# drives), and the real collective path runs at world size 1.
RING_S, RING_DH = 4, 128
# name: (T, window_blocks); causal. Window 4 at T 32768 leaves 10 of the 16
# (rank, step) cells empty (padding-only folds); T 8192 full causal fills
# every lower cell.
RING_TOPOS = {"causal window 4, T 32768": (32768, 4), "full causal, T 8192": (8192, None)}
RING_BAND_T = 8192  # a non-causal band (window 4) for the non-causal folds


@contextlib.contextmanager
def no_device_reads():
    """A device read back to the host raises inside."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def ring_topologies(dtype) -> dict:
    """{name: (topology, ring topology, causal)} at S = RING_S, built on the card."""
    out = {}
    for name, (t, window) in RING_TOPOS.items():
        topo = attention.causal_block_topology(t, window_blocks=window, dtype=dtype, device=DEV)
        out[name] = (topo, parallel.partition_topology_ring(topo, RING_S), True)
    band = attention.band_topology(RING_BAND_T, 4, dtype=dtype, device=DEV)
    out[f"band window 4, T {RING_BAND_T}"] = (band, parallel.partition_topology_ring(band, RING_S), False)
    return out


def ring_folds(rt, q, k, v, causal, fold):
    """Every (rank, step) fold of one ring in order, each rank's state
    carried from its previous step: [(i, j, inputs, state in, state out)]."""
    s, band = rt.n_shards, rt.band_blocks
    qs, ks, vs = (x.chunk(s) for x in (q, k, v))
    folds = []
    for i in range(s):
        q_l = qs[i].contiguous()
        state = par_attn.initial_state(q_l.shape[0], q_l.shape[1], q_l.device)
        for r in range(s):
            j = (i - r) % s
            rows, cols = rt.rows[i, j], rt.cols[i, j]
            flags = (torch.arange(rows.shape[0], dtype=torch.int32, device=DEV) < rt.valid[i, j]).to(torch.int32)
            inputs = (q_l, ks[j].contiguous(), vs[j].contiguous(), rows, cols, flags)
            kw = dict(bs=128, scale=q.shape[1] ** -0.5, causal=causal, row_offset_blocks=i * band,
                      col_offset_blocks=j * band)
            out = fold(*inputs, state, **kw)
            folds.append((i, j, inputs, kw, state, out))
            state = out
    return folds


def _fold_errors(got, want, dtype) -> tuple:
    """(max |kernel - plain|, within bounds) over acc and lane 0 of m / l (m
    on the rows that saw a score). fp32 within 1e-4 * max|plain|. bf16
    inputs within ATOL, the flash kernels' bound: p is rounded to bf16
    before P V, and where the two fp32 score sums (tensor cores against
    torch) round a p to neighbouring bf16 values, the fp32 state differs by
    that ulp of p times v, more than one bf16 ulp of a small state entry."""
    (acc, m, l), (acc_p, m_p, l_p) = got, want
    live = m_p[:, 0] > -5e29
    pairs = [(acc, acc_p), (l[:, 0], l_p[:, 0]), (m[live, 0], m_p[live, 0])]
    err, ok = 0.0, True
    for x, y in pairs:
        if not y.numel():
            continue
        d = float((x - y).abs().max())
        err = max(err, d)
        ok &= d <= (1e-4 * max(float(y.abs().max()), 1e-30) if dtype == f32 else ATOL)
    ok &= torch.equal(m[~live, 0], m_p[~live, 0])  # rows no real score reached keep their input
    return err, ok


def fold_kernel_cases(rng, errors) -> None:
    """(a): every (rank, step) fold of the two causal rings and of the
    non-causal band ring against the plain version on the same inputs and
    carried state (nonzero block offsets, padding-only cells); bf16 and
    fp32, d_head 128 and 64 (bounds: _fold_errors); lanes 1-127 of m / l bitwise the input's,
    every kernel run bitwise equal to the next."""
    n, n_empty, worst, ulps = 0, 0, {}, 0.0
    for dtype in (torch.bfloat16, f32):
        topos = ring_topologies(dtype)
        for name, (topo, rt, causal) in topos.items():
            for dh in (RING_DH, 64):
                if name.startswith("causal window") and (dtype == f32 or dh == 64):
                    continue  # the 32768 ring once, in bf16 at d_head 128
                t = topo.rows
                q, k, v = (randn(rng, (t, dh), dtype) for _ in range(3))
                for i, j, inputs, kw, state, out in ring_folds(rt, q, k, v, causal, fa.flash_band_fold):
                    again = fa.flash_band_fold(*inputs, state, **kw)
                    plain = fa.flash_band_fold_reference(*inputs, state, **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(x, y) for x, y in zip(out, again)), f"{name}: two fold runs differ")
                    for x, x0 in zip(out[1:], state[1:]):
                        check(torch.equal(x[:, 1:], x0[:, 1:]), f"{name} ({i}, {j}): lanes 1-127 of m / l changed")
                    err, ok = _fold_errors(out, plain, dtype)
                    check(ok, f"fold {name} {dtype} dh {dh} rank {i} band {j}: kernel outside its bound of plain "
                              f"(max |d| {err})")
                    if dtype == f32:
                        errors["flash_band_fold"] = max(errors.get("flash_band_fold", 0.0), err)
                    else:
                        ulps = max(ulps, testing.bf16_ulp_excess(out[0], plain[0]))
                    key = f"{str(dtype).split('.')[-1]} dh {dh} {name}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    n += 1
                    n_empty += int(not bool((inputs[5] > 0).any()))
    print(f"  {n} folds within tolerance ({n_empty} padding-only), each twice bitwise equal, lanes 1-127 "
          f"passed through; max |kernel - plain|: { {k: f'{v:.2e}' for k, v in worst.items()} }; bf16 acc at most "
          f"{ulps:.1f} bf16 ulps (testing.bf16_ulp_excess) from plain", flush=True)


def ring_attention_runs(rng) -> None:
    """(b): ring_block_sparse_attention through the per-rank bodies for all
    S ranks, fused on the three rings (each fold under
    set_sync_debug_mode("error")) and unfused on the non-causal one, against
    single-device flash_block_attention within ATOL."""
    for name, (topo, rt, causal) in ring_topologies(torch.bfloat16).items():
        q, k, v = (randn(rng, (topo.rows, RING_DH), torch.bfloat16) for _ in range(3))
        want = attention.flash_block_attention(q, k, v, topo, causal=causal)
        routes = [True] if causal else [True, False]
        for fused in routes:
            start = time.perf_counter()
            with no_device_reads() if fused else contextlib.nullcontext():
                outs = par_ring.ring_block_sparse_attention_sequential(q, k, v, rt, causal=causal, fused=fused)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            got = torch.cat(outs)
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()) and err <= ATOL,
                  f"ring attention {name} fused={fused}: max |ring - single device| {err} > {ATOL}")
            print(f"  ring {name:<26} fused={fused:d}: max |ring - flash_block_attention| {err:.2e}; one ring's "
                  f"{RING_S * RING_S} folds {wall * 1e3:.1f} ms wall (informational)", flush=True)


def sharded_attention_runs(rng) -> None:
    """(c): sharded_block_sparse_attention at S = 4 through the per-rank
    bodies, fused and unfused, causal (full causal T 8192) and not (the
    band), against single-device flash_block_attention within ATOL. The
    sequential drive hands every rank the whole K / V, which both
    kv_replicated settings deliver; the gather itself runs in (e)."""
    cases = {True: attention.causal_block_topology(8192, dtype=torch.bfloat16, device=DEV),
             False: attention.band_topology(RING_BAND_T, 4, dtype=torch.bfloat16, device=DEV)}
    for causal, topo in cases.items():
        st = parallel.partition_topology_rows(topo, RING_S)
        q, k, v = (randn(rng, (topo.rows, RING_DH), torch.bfloat16) for _ in range(3))
        want = attention.flash_block_attention(q, k, v, topo, causal=causal)
        for fused in (True, False):
            with no_device_reads() if fused else contextlib.nullcontext():
                got = torch.cat(par_attn.sharded_block_sparse_attention_sequential(q, k, v, st, causal=causal,
                                                                                   fused=fused))
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()) and err <= ATOL,
                  f"sharded attention causal={causal} fused={fused}: {err} > {ATOL}")
            print(f"  sharded attention S={RING_S} causal={causal:d} fused={fused:d}: max |sharded - single| "
                  f"{err:.2e}", flush=True)


def _agree(name, got, want, dtype) -> bool:
    """Within fp32 1e-4 * max|want| or one bf16 ulp; returns whether bitwise equal."""
    check(got.shape == want.shape and bool(torch.isfinite(got.float()).all()), f"{name}: shape or non-finite")
    if dtype == f32:
        err = float((got - want).abs().max())
        check(err <= 1e-4 * float(want.abs().max()), f"{name}: {err} > 1e-4 * max|single device|")
    else:
        check(testing.bf16_ulp_excess(got, want) <= 1, f"{name}: more than one bf16 ulp from single device")
    return torch.equal(got, want)


def _real_blocks(outs, st) -> torch.Tensor:
    """The shards' SDD blocks without their padding slots, in global order."""
    return torch.cat([o.data[:n] for o, n in zip(outs, st.valid_counts.tolist())])


def sharded_op_runs(rng) -> None:
    """(d): the sharded ops at S = 4 through the per-rank bodies against the
    same op on one device: the BSR ops at the headline (4096^2, 25%, bf16,
    N = 4096), the SELL / CSR ops on the trained ffn_w1 at 90%, n = 64,
    fp32."""
    bf16 = torch.bfloat16
    a = rand_bsr(rng, 4096, 4096, 0.25, bf16)
    b = randn(rng, (4096, 4096), bf16)
    single = bsr_dsd.dsd(a, b)
    x = randn(rng, (4096, 4096), bf16)
    st = parallel.partition_bsr_rows(a, RING_S)
    bitwise = {}
    runs = {
        "sharded_dsd": (lambda: torch.cat(par_shard.sharded_dsd_sequential(parallel.partition_bsr_rows(a, RING_S), b)),
                        single, bf16),
        "sharded_dsd_ring": (lambda: torch.cat(par_shard.sharded_dsd_ring_sequential(
            parallel.partition_bsr_rows_kbands(a, RING_S), b)), single, bf16),
        "sharded_sdd": (lambda: _real_blocks(par_shard.sharded_sdd_sequential(x, b, st), st),
                        bsr_sdd.sdd(x, b, a).data, bf16),
    }
    w90 = dlmc_gen.magnitude_prune(dlmc_gen.load_weights(WEIGHTS)["ffn_w1"], 0.9)
    c = csr_from_dense(w90, device=DEV)
    bc = randn(rng, (c.cols, CSR_N), f32)
    sell_single = sell.spmm(SellMatrix.from_csr(c), bc)
    runs.update({
        "sharded_spmm_sell": (lambda: torch.cat(par_shard.sharded_spmm_sell_sequential(
            parallel.partition_sell_rows(c, RING_S), bc)), sell_single, f32),
        "sharded_spmm_kshard": (lambda: torch.cat(par_shard.sharded_spmm_kshard_sequential(
            parallel.partition_sell_cols(c, RING_S), bc)), sell_single, f32),
        "sharded_spmm": (lambda: torch.cat(par_shard.sharded_spmm_sequential(
            parallel.partition_csr_rows(c, RING_S), bc)), csr_ops.spmm(c, bc), f32),
    })
    for name, (run, want, dtype) in runs.items():
        bitwise[name] = _agree(name, run(), want, dtype)
    print(f"  the six sharded ops at S={RING_S} agree with one device; bitwise equal: {bitwise}", flush=True)


def world_size_one(rng) -> None:
    """(e): every sharded op and both attention entry points through a real
    NCCL group of one rank (a FileStore in a temporary directory) on S = 1
    partitions, against the same op on one device; the group is destroyed
    at the end."""
    import torch.distributed as dist

    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one process on one host
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}", rank=0, world_size=1)
    try:
        bf16 = torch.bfloat16
        a = rand_bsr(rng, 2048, 2048, 0.25, bf16)
        b = randn(rng, (2048, 1024), bf16)
        xs, ys = randn(rng, (2048, 512), bf16), randn(rng, (512, 2048), bf16)
        c = csr_from_dense(dlmc_gen.magnitude_prune(dlmc_gen.load_weights(WEIGHTS)["ffn_w1"], 0.9), device=DEV)
        bc = randn(rng, (c.cols, CSR_N), f32)
        topo = attention.causal_block_topology(8192, window_blocks=4, dtype=bf16, device=DEV)
        band = attention.band_topology(RING_BAND_T, 4, dtype=bf16, device=DEV)
        q, k, v = (randn(rng, (8192, RING_DH), bf16) for _ in range(3))
        sell_single = sell.spmm(SellMatrix.from_csr(c), bc)
        ops_ = {
            "sharded_dsd": (lambda: parallel.sharded_dsd(parallel.partition_bsr_rows(a, 1), b), bsr_dsd.dsd(a, b),
                            bf16),
            "sharded_dsd(b_sharded_k)": (lambda: parallel.sharded_dsd(parallel.partition_bsr_rows(a, 1), b,
                                                                      b_sharded_k=True), bsr_dsd.dsd(a, b), bf16),
            "sharded_dsd_ring": (lambda: parallel.sharded_dsd_ring(parallel.partition_bsr_rows_kbands(a, 1), b),
                                 bsr_dsd.dsd(a, b), bf16),
            "sharded_sdd": (lambda: parallel.sharded_sdd(xs, ys, parallel.partition_bsr_rows(a, 1)).data,
                            bsr_sdd.sdd(xs, ys, a).data, bf16),
            "sharded_spmm_sell": (lambda: parallel.sharded_spmm_sell(parallel.partition_sell_rows(c, 1), bc),
                                  sell_single, f32),
            "sharded_spmm_sell(b_sharded_k)": (lambda: parallel.sharded_spmm_sell(
                parallel.partition_sell_rows(c, 1), bc, b_sharded_k=True), sell_single, f32),
            "sharded_spmm_kshard": (lambda: parallel.sharded_spmm_kshard(parallel.partition_sell_cols(c, 1), bc),
                                    sell_single, f32),
            "sharded_spmm": (lambda: parallel.sharded_spmm(parallel.partition_csr_rows(c, 1), bc),
                             csr_ops.spmm(c, bc), f32),
        }
        bitwise = {name: _agree(name, run(), want, dtype) for name, (run, want, dtype) in ops_.items()}
        attn_err = {}
        for tname, t_, causal in (("causal", topo, True), ("band", band, False)):
            want = attention.flash_block_attention(q, k, v, t_, causal=causal)
            st, rt = parallel.partition_topology_rows(t_, 1), parallel.partition_topology_ring(t_, 1)
            runs = {f"ring fused {tname}": lambda: parallel.ring_block_sparse_attention(q, k, v, rt, causal=causal)}
            if not causal:
                runs[f"ring unfused {tname}"] = lambda: parallel.ring_block_sparse_attention(q, k, v, rt, fused=False)
            for fused in (True, False):
                for rep in (True, False):
                    runs[f"sharded fused={fused:d} kv_replicated={rep:d} {tname}"] = functools.partial(
                        parallel.sharded_block_sparse_attention, q, k, v, st, kv_replicated=rep, causal=causal,
                        fused=fused)
            for name, run in runs.items():
                err = float((run().float() - want.float()).abs().max())
                check(err <= ATOL, f"world size 1: {name} differs from single-device attention by {err}")
                attn_err[name] = f"{err:.1e}"
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print(f"  NCCL world size 1: the sharded ops agree with one device (bitwise: {bitwise}); attention max |d| "
          f"against flash_block_attention: {attn_err}", flush=True)


def fold_kernel_times(rng, name_limit: str) -> dict:
    """(f): the fold kernel's CUDA-graph device time for all S x S folds of
    one ring, beside the plain version and the bound (the bytes of q, the
    distinct K and V blocks the real slots touch, acc read and written in
    fp32 and lane 0 of m and l read and written, against 4 * real slots *
    bs^2 * dh operations at the bf16 rate); no library call computes the
    unnormalized state. Returns the 32768-token ring's numbers."""
    result = None
    for name, (topo, rt, causal) in ring_topologies(torch.bfloat16).items():
        if not causal:
            continue
        q, k, v = (randn(rng, (topo.rows, RING_DH), torch.bfloat16) for _ in range(3))
        folds = ring_folds(rt, q, k, v, causal, fa.flash_band_fold)
        nbytes = flops = 0
        for _, _, (q_l, _, _, rows, cols, flags), _, _, _ in folds:
            real = flags > 0
            t_l, dh = q_l.shape
            n_real = int(real.sum())
            kv_blocks = int(torch.unique(cols[real]).numel())
            nbytes += t_l * dh * 2 + 2 * kv_blocks * 128 * dh * 2 + 2 * t_l * dh * 4 + 2 * 2 * t_l * 4
            flops += 4 * n_real * 128 * 128 * dh

        def run(fn):
            return lambda: [fn(*inputs, state, **kw) for _, _, inputs, kw, state, _ in folds]

        ms, call = time_ms(run(fa.flash_band_fold))
        plain_ms = time_ms_eager(run(fa.flash_band_fold_reference))  # it reads the slot count back
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        print(f"  flash_band_fold {name:<26} {len(folds)} folds, bf16, d_head {RING_DH}: kernel {ms * 1e3:.2f} us "
              f"device ({flops / ms / 1e9:.1f} TFLOP/s) / {call * 1e3:.2f} us call, plain {plain_ms * 1e3:.2f} us "
              f"(eager), bound {bound * 1e3:.2f} us ({by}; {bound / ms:.3f} of it), library: none on {name_limit}",
              flush=True)
        if result is None:
            result = (ms, plain_ms, None, bound, by)
    return {"flash_band_fold": result}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    # The autotune cache of this run: a file of its own, so that no dispatch
    # reads a winner tuned elsewhere, removed at the end.
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["SPUTNIK_TPU_TORCH_TUNE_CACHE"] = os.path.join(tune_dir, "autotune.json")
    autotune_mod._reset()  # read once per process: read it from here
    try:
        return run_phases(name_limit, tune_dir)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run_phases(name_limit: str, tune_dir: str) -> int:

    print("== phase 1: card and build", flush=True)
    print(f"card: {name_limit}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    start = time.perf_counter()
    builds = (bsr_dsd._kernel, bsr_sdd._kernel, fm._lib, bsr_ffn._lib, sell._lib, bsr_flat._kernel,
              bsr_ssd._kernel, bsr_dss._lib, bsm._lib, bsr_small._lib, bsr_qstream._kernel, bsr_pipe._kernel,
              mxu_probe._lib, bsr_qstream._qkernel, bsr_cres._lib, bsr_sdd._bres_kernel, bsr_panel._lib,
              bsr_cstack._kernel, fa._fold_lib)
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:  # one nvcc per source, together
        report = pool.submit(_build.ptxas_report, "bsr_dsd")
        for built in [pool.submit(f) for f in builds]:
            built.result()
        wgmma_resources(report.result())
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
    check(main_launches == launches(bsr_dsd_stream=expected, bsr_sdd=expected, bsr_softmax_stats=expected,
                                    bsr_softmax_normalize=expected),
          f"kernel launches {main_launches}, expected {expected} of SDD, DSD and the softmax kernels and no other")
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
    yard = attention_yardsticks(topo, q, k, v, probs)
    a = rand_bsr(rng, 4096, 4096, 0.25, bf16)
    b = randn(rng, (4096, 4096), bf16)
    (ms, _), (plain, _) = time_ms(lambda: bsr_dsd.dsd(a, b)), time_ms(lambda: bsr_dsd.dsd_reference(a, b))
    pipe_ms = time_ms(lambda: PIPE_DSD(a, b))[0]
    bsr = torch.sparse_bsr_tensor(a.offsets, a.indices, a.data, (4096, 4096))
    lib = library_call("bsr_dsd_stream 4096^2", lambda: torch.matmul(bsr, b))
    flop = 2 * a.nnz_blocks * 128 * 128 * 4096
    bound, by = bound_ms(a.data.numel() * 2 + 2 * b.numel() * 2, flop, BF16_FLOPS)
    lib_text = f"{lib * 1e3:.2f} us" if lib is not None else "none"
    print(f"  bsr_dsd_stream  4096^2 25% N=4096 bf16: kernel {ms * 1e3:.2f} us device "
          f"({flop / ms / 1e9:.1f} TFLOP/s; {bound / ms:.3f} of its {bound * 1e3:.2f} us {by} bound), "
          f"bsr_dsd_pipelined {pipe_ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us device, library {lib_text} "
          f"on {name_limit}", flush=True)
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
    yard.update(flash_yardsticks(topo, q, k, v, flops))
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
    times.update(moe_kernel_times(name_limit, yard))
    torch.cuda.empty_cache()

    print(f"== phase 9: the CSR slice on the trained DLMC-protocol weights ({WEIGHTS}: d_model "
          f"{dlmc_gen.D_MODEL}, d_ff {dlmc_gen.D_FF})", flush=True)
    print("(a) SELL kernels against their plain versions, 4 matrices x 5 sparsities, n = 64", flush=True)
    csr_kernel_cases(np.random.default_rng(9), errors)
    print(f"(b) sparse fine-tune: ffn_w1 pruned at 90%, {FT_TOKENS} tokens, {FT_STEPS} SGD steps at lr {FT_LR}",
          flush=True)
    csr_launches = csr_finetune(name_limit)
    torch.cuda.empty_cache()
    print("(c) the attention chain sddmm -> sparse_softmax -> spmm in SELL, fp32", flush=True)
    chain_launches = csr_attention_chain()
    main_launches.update({k: csr_launches[k] + chain_launches[k] for k in SELL})
    torch.cuda.empty_cache()
    print(f"(d) python -m sputnik_tpu_torch.bench.dlmc --weights {WEIGHTS} (n = {CSR_N}) on {name_limit}",
          flush=True)
    for line in dlmc_bench.run(CSR_N, weights_path=WEIGHTS):
        print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v) for k, v in line.items()}), flush=True)
    print("    kernel times (CUDA-graph device time, 10 warm-up + 100 timed; library calls are yardsticks "
          "the port never calls)", flush=True)
    csr_times = csr_kernel_times(name_limit)
    torch.cuda.empty_cache()

    print(f"== phase 10: the sparse-output slice (SSD / SDS / DSS / SSS) at d = {SO_D}, the JAX grid's "
          "headline width", flush=True)
    print("(a) the four kernels against their plain versions: 4 modes x bf16 / fp32 x densities 0.01 / 0.1",
          flush=True)
    so_kernel_cases(np.random.default_rng(12), errors)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(13)
    torch.cuda.synchronize()
    reset_launches()
    print("(b) first-fit routes and launches; warm forwards under set_sync_debug_mode(\"error\")", flush=True)
    so_routes(rng)
    print(f"(c) fp32 gradients at d={SO_D}, density 0.1, against the plain path", flush=True)
    so_grads(rng)
    torch.cuda.synchronize()
    so_main = so_counts()
    main_launches.update({k: so_main[k] for k in SPARSE_OUT})
    torch.cuda.empty_cache()
    print(f"(d) python -m sputnik_tpu_torch.bench.dss (d 2048, densities 0.25 / 0.1, bf16) on {name_limit}",
          flush=True)
    for line in dss_bench.run():
        print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v) for k, v in line.items()}), flush=True)
    print(f"(e) kernel times at d = {SO_D} and {SO_D_LARGE}, density 0.1, NN, bf16 (CUDA-graph device time, "
          "10 warm-up + 100 timed; library calls are yardsticks the port never calls)", flush=True)
    so_times = so_kernel_times(rng, name_limit)
    torch.cuda.empty_cache()

    print(f"== phase 11: the rest of attention at the serving width (H {SERVE.n_heads}, T {SERVE.seq_len}, d_head "
          f"{SERVE.d_head}, window {SERVE.window_blocks}, bf16 / fp32)", flush=True)
    print("(a) kernels against their plain versions; flash_block_attention; TransformerConfig() (d_head 64) "
          "on both attention routes", flush=True)
    softmax_kernel_cases(np.random.default_rng(15), errors)
    flash_block_cases(np.random.default_rng(16), errors)
    torch.cuda.empty_cache()
    default_config_lm()
    print(f"(b) content-routed attention: topk_block_topology(q, k, {TOPK_PAGES}) per head, built on the card",
          flush=True)
    topk_launches = topk_attention(np.random.default_rng(17), errors)
    main_launches["sdd_softmax"] = topk_launches["sdd_softmax"]
    torch.cuda.empty_cache()
    print(f"(c) top-k serving: lm_generate_batched(mode=\"topk\", k_pages={TOPK_PAGES}), {N_REQUESTS} requests x "
          f"{PROMPT}-token prompts x {N_NEW} new tokens", flush=True)
    topk_serving(name_limit)
    torch.cuda.empty_cache()
    print(f"(d) python -m sputnik_tpu_torch.bench.serving (batch 1 / 8 / 32 x band / topk-4; n1 16, n2 80, 3 runs: "
          f"the JAX bench's protocol, not cut) on {name_limit}", flush=True)
    for line in serving_bench.run():
        print(json.dumps({k: (round(v, 2) if isinstance(v, float) else v) for k, v in line.items()}), flush=True)
    torch.cuda.empty_cache()
    print("(e) kernel times (CUDA-graph device time, 10 warm-up + 100 timed; library calls are yardsticks the "
          "port never calls)", flush=True)
    times.update(attn_kernel_times(np.random.default_rng(18), name_limit, yard))
    torch.cuda.empty_cache()

    print(f"== phase 12: small-block (16 / 32 / 64) sparse training and int8 quantized serving, d = {SB_D}, "
          f"density {SB_DENSITY}", flush=True)
    print("(a) bsr_small_dsd / bsr_small_sdd, bsr_dsd_stream_q8 and bsr_bres against their plain versions",
          flush=True)
    small_kernel_cases(np.random.default_rng(19), errors)
    torch.cuda.empty_cache()
    q8_kernel_cases(np.random.default_rng(20), errors)
    torch.cuda.empty_cache()
    print("(b) first-fit routes at bs 32 / 64: host-known metadata on cuda_smallblock, card-built on jnp_fallback",
          flush=True)
    small_routes(np.random.default_rng(21))
    torch.cuda.empty_cache()
    print(f"(c) block-RigL fine-tune: ffn_w1 at bs {RIGL_BS}, sparsity {RIGL_SPARSITY}, {FT_TOKENS} tokens, "
          f"{RIGL_STEPS} SGD steps at lr {FT_LR}, refresh after step {RIGL_REFRESH}", flush=True)
    torch.cuda.synchronize()
    reset_launches()
    main_launches.update(rigl_finetune(name_limit))
    torch.cuda.empty_cache()
    print(f"(d) int8 quantized serving (examples/quantized_serving.py's recipe) on ffn_w1, {FT_TOKENS} tokens",
          flush=True)
    q8_counts = int8_serving(name_limit)
    main_launches.update({k: q8_counts[k] for k in ("bsr_bres", "bsr_dsd_stream_q8")})
    torch.cuda.empty_cache()
    print(f"(e) kernel times at d = {SB_D}, density {SB_DENSITY}, NN (CUDA-graph device time, 10 warm-up + 100 "
          "timed; library calls are yardsticks the port never calls)", flush=True)
    p12_times = p12_kernel_times(np.random.default_rng(24), name_limit)
    torch.cuda.empty_cache()

    print("== phase 13: the benchmark entry points (bench.dsd, calibrate, mxu_probe) and the pipelined DSD / DDS "
          "kernel", flush=True)
    print(f"(a) the three probes (m {PROBE_M}, k = n {PROBE_K}) and bsr_dsd_pipelined against their plain versions",
          flush=True)
    probe_cases(np.random.default_rng(25), errors)
    pipelined_cases(np.random.default_rng(26), errors)
    torch.cuda.empty_cache()
    print("(b) routes: variant= and forced_variant take cuda_pipelined; first fit keeps cuda_stream", flush=True)
    main_launches["bsr_dsd_pipelined"] = pipelined_routes(np.random.default_rng(27))
    # The benchmark path, (c)-(e), as a user runs it: the counts are zero
    # before it and read after it.
    torch.cuda.synchronize()
    reset_launches()
    print(f"(c) python -m sputnik_tpu_torch.bench.calibrate (measure only) on {name_limit}", flush=True)
    peaks = calibration(name_limit)
    print("(d) python -m sputnik_tpu_torch.bench.mxu_probe rows (depths 128 / 512 / 4096, mt 512, overwrite at "
          "128) and --dense-sweep", flush=True)
    probe_rows()
    print(f"(e) python -m sputnik_tpu_torch.bench.dsd (4096^2, 25%, bf16, first fit) on {name_limit}", flush=True)
    headline(name_limit, peaks)
    torch.cuda.synchronize()
    main_launches.update(mxu_probe.LAUNCHES)
    print(f"  launches on the benchmark path: {dict(mxu_probe.LAUNCHES)}", flush=True)
    torch.cuda.empty_cache()
    print("(f) kernel times (CUDA-graph device time, 10 warm-up + 100 timed; library calls are yardsticks the "
          "port never calls)", flush=True)
    p13_times = p13_kernel_times(np.random.default_rng(28), name_limit)
    torch.cuda.empty_cache()

    print("== phase 14: bench.py's tune pass, the roofline audit and the autotune cache, on bsr_qstream, bsr_cres, "
          "bsr_gres and bsr_sdd_bres", flush=True)
    print(f"(a) the four kernels against their plain versions (d = {AUDIT_D}, JAX's 640 x 384 x 512, a ragged BSR)",
          flush=True)
    resident_cases(np.random.default_rng(29), errors)
    torch.cuda.empty_cache()
    print("(b) routes: every new variant= name; the first fits", flush=True)
    resident_routes(np.random.default_rng(30))
    # The benchmark path, (c)-(e), as a user runs it: the counts are zero
    # before it and read after it.
    torch.cuda.synchronize()
    reset_launches()
    print(f"(c) ops.benchmark_variants / autotune / clear_cache, DSD at d = {AUDIT_D}, 25%, bf16 (cache: "
          f"{os.environ['SPUTNIK_TPU_TORCH_TUNE_CACHE']})", flush=True)
    autotune_round_trip(np.random.default_rng(31))
    print(f"(d) python -m sputnik_tpu_torch.bench.dsd (tuned), then --no-tune, on {name_limit}", flush=True)
    tuned_headline(name_limit, peaks)
    print(f"(e) python -m sputnik_tpu_torch.bench.roofline (d = {AUDIT_D}, 25%, bf16) on {name_limit}", flush=True)
    audit_rows(name_limit)
    torch.cuda.synchronize()
    main_launches.update(p14_counts())
    print(f"  launches on the benchmark path: {p14_counts()}", flush=True)
    torch.cuda.empty_cache()
    print("(f) kernel times (CUDA-graph device time, 10 warm-up + 100 timed; library calls are yardsticks the "
          "port never calls)", flush=True)
    p14_times = p14_kernel_times(np.random.default_rng(32), name_limit)
    dds_first_fit_times(np.random.default_rng(33), name_limit)
    torch.cuda.empty_cache()

    print("== phase 15: the panel-resident and column-stacked schedules (bsr_panel, bsr_cstack) and the variant "
          "tools", flush=True)
    print(f"(a) the two kernels against their plain versions (d = {AUDIT_D}, JAX's test shapes, a ragged BSR, "
          "card-built metadata)", flush=True)
    schedule_cases(np.random.default_rng(40), errors)
    torch.cuda.empty_cache()
    print("(b) routes: every new variant= name; the first fits", flush=True)
    schedule_routes(np.random.default_rng(42))
    # The benchmark path, (c)-(e), as a user runs it: the counts are zero
    # before it and read after it.
    torch.cuda.synchronize()
    reset_launches()
    variant_tools(name_limit, tune_dir)
    torch.cuda.synchronize()
    main_launches.update(p15_counts())
    print(f"  launches on the benchmark path: {p15_counts()}", flush=True)
    torch.cuda.empty_cache()
    print("(f) kernel times (CUDA-graph device time, 10 warm-up + 100 timed; library calls are yardsticks the "
          "port never calls)", flush=True)
    p15_times = p15_kernel_times(np.random.default_rng(41), name_limit)
    torch.cuda.empty_cache()

    print(f"== phase 16: the distributed slice on one card: ring and sequence-parallel attention (one head, "
          f"d_head {RING_DH}, bf16, S = {RING_S}) and the sharded ops", flush=True)
    print("(a) flash_band_fold against its plain version: every (rank, step) fold of the rings", flush=True)
    fold_kernel_cases(np.random.default_rng(50), errors)
    torch.cuda.empty_cache()
    # The distributed path, (b)-(c), through the per-rank bodies: the counts
    # are zero before it and read after it.
    torch.cuda.synchronize()
    reset_launches()
    print("(b) ring_block_sparse_attention, all ranks' bodies in turn, against flash_block_attention", flush=True)
    ring_attention_runs(np.random.default_rng(51))
    print("(c) sharded_block_sparse_attention at S = 4, against flash_block_attention", flush=True)
    sharded_attention_runs(np.random.default_rng(52))
    torch.cuda.synchronize()
    main_launches["flash_band_fold"] = fa.LAUNCHES["flash_band_fold"]
    print(f"  launches on the distributed path: {dict(fa.LAUNCHES)}", flush=True)
    torch.cuda.empty_cache()
    print(f"(d) the sharded ops at S = {RING_S} against one device (4096^2, 25%, bf16, N 4096; ffn_w1 at 90%, "
          f"n {CSR_N}, fp32)", flush=True)
    sharded_op_runs(np.random.default_rng(53))
    torch.cuda.empty_cache()
    print("(e) the collective path: an NCCL group of one rank, S = 1 partitions", flush=True)
    world_size_one(np.random.default_rng(54))
    torch.cuda.empty_cache()
    print("(f) fold kernel times (CUDA-graph device time, 10 warm-up + 100 timed, all folds of one ring)",
          flush=True)
    p16_times = fold_kernel_times(np.random.default_rng(55), name_limit)
    torch.cuda.empty_cache()

    # launches: the serving run of phase 3 for the sparse kernels, the fused
    # training run of phase 6 for the flash kernels, the bf16 MoE training
    # runs of phase 8 for the FFN kernels, the fine-tune and the attention
    # chain of phase 9 for the SELL kernels, the routes and gradients of
    # phase 10 for the sparse-output kernels, the serving run of phase 3 for
    # the softmax kernels and the content-routed attention of phase 11 (b)
    # for sdd_softmax, the block-RigL fine-tune of phase 12 (c) for the
    # small-block kernels and the int8 serving of phase 12 (d) for bsr_bres
    # and bsr_dsd_stream_q8, the benchmark path of phase 13 (c)-(e) for the
    # probes, and the variant= / forced_variant routes of phase 13 (b) for
    # bsr_dsd_pipelined (no serving or training path reaches it: the first
    # fit keeps cuda_stream), and the benchmark path of phase 14 (c)-(e)
    # for bsr_qstream, bsr_cres, bsr_gres and bsr_sdd_bres, and the
    # benchmark path of phase 15 (c)-(e) for bsr_panel and bsr_cstack, and
    # the ring and sequence-parallel attention of phase 16 (b)-(c) for
    # flash_band_fold.
    sources = {
        "bsr_dsd_stream": ("sputnik_tpu_torch/csrc/bsr_dsd.cu", "sputnik_tpu/kernels/bsr_dsd.py:76"),
        "bsr_sdd": ("sputnik_tpu_torch/csrc/bsr_sdd.cu", "sputnik_tpu/kernels/bsr_sdd.py:229"),
        "flash_mha_fwd": ("sputnik_tpu_torch/csrc/flash_mha.cu", "sputnik_tpu/kernels/flash_mha.py:103"),
        "flash_mha_dq": ("sputnik_tpu_torch/csrc/flash_mha.cu", "sputnik_tpu/kernels/flash_mha.py:262"),
        "flash_mha_dkv": ("sputnik_tpu_torch/csrc/flash_mha.cu", "sputnik_tpu/kernels/flash_mha.py:317"),
        "bsr_ffn_group": ("sputnik_tpu_torch/csrc/bsr_ffn.cu", "sputnik_tpu/kernels/bsr_ffn.py:83"),
        "bsr_ffn_dropless": ("sputnik_tpu_torch/csrc/bsr_ffn.cu", "sputnik_tpu/kernels/bsr_ffn.py:199"),
        "sell_spmm": ("sputnik_tpu_torch/csrc/sell.cu", "sputnik_tpu/kernels/sell.py:265,294"),
        "sell_spmm_t": ("sputnik_tpu_torch/csrc/sell.cu", "sputnik_tpu/kernels/sell.py:364"),
        "sell_sddmm": ("sputnik_tpu_torch/csrc/sell.cu", "sputnik_tpu/kernels/sell.py:492,517"),
        "sell_softmax": ("sputnik_tpu_torch/csrc/sell.cu", "sputnik_tpu/kernels/sell.py:593,606"),
        "bsr_flat": ("sputnik_tpu_torch/csrc/bsr_flat.cu", "sputnik_tpu/kernels/bsr_flat.py:490"),
        "bsr_sparse_out": ("sputnik_tpu_torch/csrc/bsr_ssd.cu", "sputnik_tpu/kernels/bsr_ssd.py:130"),
        "bsr_dss_masked": ("sputnik_tpu_torch/csrc/bsr_dss.cu", "sputnik_tpu/kernels/bsr_dss.py:200"),
        "bsr_dss_worklist": ("sputnik_tpu_torch/csrc/bsr_dss.cu", "sputnik_tpu/kernels/bsr_dss.py:498"),
        "bsr_softmax_stats": ("sputnik_tpu_torch/csrc/bsr_softmax.cu", "sputnik_tpu/kernels/bsr_softmax.py:56"),
        "bsr_softmax_normalize": ("sputnik_tpu_torch/csrc/bsr_softmax.cu", "sputnik_tpu/kernels/bsr_softmax.py:86"),
        "sdd_softmax": ("sputnik_tpu_torch/csrc/bsr_softmax.cu", "sputnik_tpu/kernels/flash_attention.py:262"),
        "bsr_small_dsd": ("sputnik_tpu_torch/csrc/bsr_small.cu", "sputnik_tpu/kernels/bsr_small.py:217"),
        "bsr_small_sdd": ("sputnik_tpu_torch/csrc/bsr_small.cu", "sputnik_tpu/kernels/bsr_small.py:348"),
        "bsr_bres": ("sputnik_tpu_torch/csrc/bsr_bres.cu", "sputnik_tpu/kernels/bsr_qstream.py:696"),
        "bsr_dsd_stream_q8": ("sputnik_tpu_torch/csrc/bsr_dsd.cu", "sputnik_tpu/kernels/bsr_dsd.py:165"),
        "mxu_dense_stream": ("sputnik_tpu_torch/csrc/mxu_probe.cu", "sputnik_tpu/bench/mxu_probe.py:43"),
        "mxu_resident_stream": ("sputnik_tpu_torch/csrc/mxu_probe.cu", "sputnik_tpu/bench/mxu_probe.py:104"),
        "mxu_tiled_matmul": ("sputnik_tpu_torch/csrc/mxu_probe.cu", "sputnik_tpu/bench/mxu_probe.py:157"),
        "bsr_dsd_pipelined": ("sputnik_tpu_torch/csrc/bsr_dsd_pipelined.cu",
                              "sputnik_tpu/kernels/bsr_dsd_pipelined.py:39"),
        "bsr_qstream": ("sputnik_tpu_torch/csrc/bsr_qstream.cu", "sputnik_tpu/kernels/bsr_qstream.py:164"),
        "bsr_cres": ("sputnik_tpu_torch/csrc/bsr_cres.cu", "sputnik_tpu/kernels/bsr_cres.py:58"),
        "bsr_gres": ("sputnik_tpu_torch/csrc/bsr_cres.cu", "sputnik_tpu/kernels/bsr_cres.py:367"),
        "bsr_sdd_bres": ("sputnik_tpu_torch/csrc/bsr_sdd_bres.cu", "sputnik_tpu/kernels/bsr_sdd.py:349"),
        "bsr_panel": ("sputnik_tpu_torch/csrc/bsr_panel.cu", "sputnik_tpu/kernels/bsr_panel.py:108"),
        "bsr_cstack": ("sputnik_tpu_torch/csrc/bsr_cstack.cu", "sputnik_tpu/kernels/bsr_cstack.py:52"),
        "flash_band_fold": ("sputnik_tpu_torch/csrc/flash_fold.cu", "sputnik_tpu/kernels/flash_attention.py:418"),
    }
    check(all(main_launches[k] > 0 for k in sources), f"a kernel of the main path never launched: {main_launches}")
    # (ms, plain ms, library ms, bound ms, bound by) of every kernel.
    measured = {k: (times[k][0][0], times[k][1][0], yard[k][2], yard[k][0], yard[k][1]) for k in times}
    measured.update(csr_times)
    measured.update(so_times)
    measured.update(p12_times)
    measured.update(p13_times)
    measured.update(p14_times)
    measured.update(p15_times)
    measured.update(p16_times)
    print(name_limit, flush=True)
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[kname], "max_abs_err": errors[kname],
         "ms": measured[kname][0], "plain_ms": measured[kname][1], "bound_ms": measured[kname][3],
         "bound_by": measured[kname][4], "library_ms": measured[kname][2]}
        for kname, (src, rep) in sources.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
