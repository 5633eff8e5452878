"""The port on a CUDA card: the Hopper kernels against their plain versions,
the registry's CUDA routing, the small LM through the kernels against
the same LM on the CPU (serving logits, and training gradients on both
attention routes), the MoE paths (the fused FFN kernels, metadata
built on the card without a device read, and every MoE forward and the
fused paths' gradients against the CPU), the CSR engine's SELL
kernels (against their plain versions, run to run, and with no host read
in the ops' forwards and backwards), and the sparse-output kernels
(bsr_flat, bsr_sparse_out, bsr_dss_masked, bsr_dss_worklist: against their
plain versions, run to run, their first-fit routes, and no host read with
warm plans), and the rest of attention (the BSR softmax kernels on
metadata built on the card with no hint, the fused SDD + softmax,
flash_block_attention on both backward routes, the small LM at the default
config's head dim 64 on both attention routes, content-routed top-k
attention with no host read, and top-k / sampled serving), and the
small-block and int8 kernels (bsr_small_dsd, bsr_small_sdd,
bsr_dsd_stream on int8, bsr_bres: against their plain versions, the
sparse-output ops at bs 32 on both kinds of metadata, a small-block
training step, int8 serving against the CPU, and what they refuse), and
the pipelined DSD / DDS kernel and the three mxu probes (against their
plain versions, run to run, and cuda_pipelined's routes), and the
q-stream, C-resident, group-resident and input-resident SDD kernels
(against their plain versions, run to run, their variant= routes and a
tuned winner dispatched from a cache under tmp_path), and the
panel-resident and column-stacked kernels (against their plain versions,
run to run, the new variant= routes, bench.tune and bench.headline), and
the distributed slice (the band fold kernel on every fold of a ring against
its plain version, ring and sequence-parallel attention through the
per-rank bodies, and the raw-CSR softmax of a transpose built on the card).

Every test here is marked ``gpu`` and skips without a card. The file imports
no jax, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import contextlib
import dataclasses
import functools
import importlib
import json

import numpy as np
import pytest
import torch

from sputnik_tpu_torch import ops, prune
from sputnik_tpu_torch.formats import BlockSparseMatrix, SellMatrix, csr_from_dense
from sputnik_tpu_torch.bench import dss as dss_bench
from sputnik_tpu_torch.bench import headline, mxu_probe, tune
from sputnik_tpu_torch.kernels import (bsr_cres, bsr_cstack, bsr_dsd, bsr_dss, bsr_ffn, bsr_flat, bsr_panel, bsr_qstream,
                                       bsr_sdd, bsr_small, bsr_ssd, reference, sell)
from sputnik_tpu_torch.kernels import bsr_dsd_pipelined as bsr_pipe
from sputnik_tpu_torch.kernels import bsr_softmax as bsm
from sputnik_tpu_torch.kernels import flash_attention as fa
from sputnik_tpu_torch.kernels import flash_mha as fm
from sputnik_tpu_torch.models import attention, moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.models.convert import grads_to_numpy
from sputnik_tpu_torch.ops import csr as csr_ops
from sputnik_tpu_torch.ops import quant, registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

autotune = importlib.import_module("sputnik_tpu_torch.ops.autotune")

pytestmark = pytest.mark.gpu

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
pipe_dsd = functools.partial(bsr_dsd.dsd, launch=bsr_pipe.pipelined)
pipe_dds = functools.partial(bsr_dsd.dds, launch=bsr_pipe.pipelined)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dims(m, k, n, ta, tb):
    return ((k, m) if ta else (m, k)), ((n, k) if tb else (k, n))


def _randn(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ta,tb", MODES)
def test_kernels_match_plain(cuda, dtype, ta, tb):
    """DSD, DDS and SDD in every mode, fp32 outputs, unordered indices and a
    batch of 2 sharing one topology, within the reference ATOL."""
    rng = np.random.default_rng(0)
    m, k, n = 512, 512, 256
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    a = testing.random_bsr(rng, *a_shape, m * k // 4, BS, unordered=True, dtype=dtype, device=cuda)
    a = a.with_data(_randn(rng, (2,) + tuple(a.data.shape), cuda, dtype))
    b = _randn(rng, (2,) + b_shape, cuda, dtype)
    f32 = torch.float32
    launches = bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES
    out = ops.dsd(a, b, transpose_a=ta, transpose_b=tb, out_dtype=f32)
    ref = reference.dsd(a, b, transpose_a=ta, transpose_b=tb, out_dtype=f32)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    # DDS: C = op(b') @ op(a) with the roles swapped.
    out = ops.dds(b, a, transpose_a=not tb, transpose_b=not ta, out_dtype=f32)
    ref = reference.dds(b, a, transpose_a=not tb, transpose_b=not ta, out_dtype=f32)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    topo = testing.random_bsr(rng, m, n, m * n // 4, BS, unordered=True, dtype=dtype, device=cuda)
    dense_a = _randn(rng, (2,) + a_shape, cuda, dtype)
    out = ops.sdd(dense_a, b, topo, transpose_a=ta, transpose_b=tb, out_dtype=f32)
    ref = reference.sdd(dense_a, b, topo, transpose_a=ta, transpose_b=tb, out_dtype=f32)
    torch.testing.assert_close(out.data, ref.data, atol=ATOL, rtol=0)
    assert (bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES) == (launches[0] + 2, launches[1] + 1)


def test_empty_rows_are_zero(cuda):
    """Block-rows without blocks come out as zeros from the kernel itself,
    whatever the output buffer held."""
    m = testing.bsr_from_blocks(512, 256, [1, 1, 3], [1, 0, 1], np.ones((3, BS, BS)),
                                dtype=torch.bfloat16, device=cuda)
    b = torch.ones(256, 128, dtype=torch.bfloat16, device=cuda)
    out = torch.full((512, 128), float("nan"), dtype=torch.float32, device=cuda)
    bsr_dsd.stream(m, b, out, transpose_sparse=False, transpose_dense=False, out_transposed=False)
    torch.testing.assert_close(out, reference.dsd(m, b, out_dtype=torch.float32), atol=0, rtol=0)
    assert float(out[:128].abs().max()) == 0.0 and float(out[256:384].abs().max()) == 0.0


@pytest.mark.parametrize("n", [128, 384, 4096])
@pytest.mark.parametrize("ta,tb", MODES)
def test_stream_bf16_matches_plain(cuda, n, ta, tb):
    """The bf16 bsr_dsd_stream (TMA + wgmma) against its plain version, DSD
    and DDS in every mode, bf16 -> bf16 within one bf16 ulp and -> fp32
    within 1e-4 * max|plain|, a batch of 2 sharing one topology with an
    empty block-row and block-column and unordered indices; every call twice
    bitwise equal and one launch."""
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    a = testing.random_bsr(rng, 512, 512, 6 * BS * BS, BS, unordered=True, device=cuda)
    assert a.min_row_nnz == 0 and a.min_col_nnz == 0
    a = a.with_data(_randn(rng, (2,) + tuple(a.data.shape), cuda, bf) / 16)
    b = _randn(rng, (2,) + ((n, 512) if tb else (512, n)), cuda, bf)
    x = _randn(rng, (2,) + ((512, n) if ta else (n, 512)), cuda, bf)
    cases = {
        "dsd": (lambda o: bsr_dsd.dsd(a, b, transpose_a=ta, transpose_b=tb, out_dtype=o),
                lambda o: bsr_dsd.dsd_reference(a, b, transpose_a=ta, transpose_b=tb, out_dtype=o)),
        "dds": (lambda o: bsr_dsd.dds(x, a, transpose_a=ta, transpose_b=tb, out_dtype=o),
                lambda o: bsr_dsd.dds_reference(x, a, transpose_a=ta, transpose_b=tb, out_dtype=o)),
    }
    for name, (kernel, plain) in cases.items():
        for out_dtype in (bf, torch.float32):
            before = bsr_dsd.LAUNCHES
            got = kernel(out_dtype)
            assert bsr_dsd.LAUNCHES == before + 1, name
            again, want = kernel(out_dtype), plain(out_dtype)
            torch.cuda.synchronize()
            assert torch.equal(got, again), f"{name} {out_dtype}: two runs differ"
            if out_dtype == bf:
                assert testing.bf16_ulp_excess(got, want) <= 1, name
            else:
                assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


def test_registry_routes_cuda_to_kernels(cuda):
    rng = np.random.default_rng(1)
    a = testing.random_bsr(rng, 512, 512, 512 * 512 // 4, BS, dtype=torch.bfloat16, device=cuda)
    b = _randn(rng, (512, 256), cuda, torch.bfloat16)
    assert registry.dispatch_name("dsd", a, b) == "cuda_stream"
    assert registry.dispatch_name("dds", b.T.contiguous(), a) == "cuda_stream"
    assert registry.dispatch_name("sdd", b.T.contiguous(), b.T.contiguous(), a, transpose_b=True) \
        == "cuda_output_stationary"
    # What the JAX package's Pallas predicates refuse (N = 64) takes the
    # densify detour, JAX's jnp_fallback; what they accept and the kernel
    # does not take raises, it never falls back.
    narrow = b[:, :64].contiguous()
    assert registry.dispatch_name("dsd", a, narrow) == "jnp_fallback"
    launches = bsr_dsd.LAUNCHES
    torch.testing.assert_close(ops.dsd(a, narrow), reference.dsd(a, narrow), atol=0, rtol=0)
    assert bsr_dsd.LAUNCHES == launches
    with pytest.raises(ValueError, match="one dtype"):
        ops.dsd(a, b.float())


def test_small_lm_on_card_matches_cpu(cuda):
    """The small LM through the kernels on the card against the same weights
    through the plain versions on the CPU, fp32: logits and greedy tokens."""
    cfg = tr.TransformerConfig(d_model=256, n_heads=2, seq_len=512, window_blocks=2, n_experts=2,
                               d_ff=128, n_layers=2, vocab=128, dtype=torch.float32)
    cpu = tr.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tr.SparseLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 256)))
    launches = bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES
    _, logits = tr.lm_prefill(gpu, tokens[0].to(cuda), cfg, cfg.seq_len)
    assert (bsr_dsd.LAUNCHES - launches[0], bsr_sdd.LAUNCHES - launches[1]) == (2, 2)
    _, want = tr.lm_prefill(cpu, tokens[0], cfg, cfg.seq_len)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-3, rtol=0)
    got = tr.lm_generate_batched(gpu, tokens.to(cuda), cfg, 8)
    assert torch.equal(got.cpu(), tr.lm_generate_batched(cpu, tokens, cfg, 8))
    full_cfg = dataclasses.replace(cfg, capacity=cfg.seq_len)
    full, _ = tr.lm_forward(gpu, torch.cat([tokens[0], tokens[1]]).to(cuda), full_cfg)
    assert bool(torch.isfinite(full).all())


def _flash_topology(kind, device):
    """(topology, T, Tk, causal) at small sizes."""
    ones = np.ones((3, BS, BS), np.float32)
    if kind == "band":
        return attention.causal_block_topology(512, window_blocks=2, device=device), 512, 512, True
    if kind == "empty_row_col":
        return testing.bsr_from_blocks(384, 512, [0, 0, 2], [3, 0, 0], ones, device=device), 384, 512, False
    topo = testing.random_bsr(np.random.default_rng(3), 256, 512, 256 * 512 // 3, BS, unordered=True,
                              device=device)
    return topo, 256, 512, False


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["band", "empty_row_col", "rectangular"])
def test_flash_kernels_match_plain(cuda, kind, dtype):
    """Forward (out and lse), dQ and dK/dV against their plain versions,
    fp32 outputs, within the reference ATOL; the kernel's lse is the one
    the backward kernels read."""
    topo, t, tk, causal = _flash_topology(kind, cuda)
    rng = np.random.default_rng(4)
    q, do = (_randn(rng, (2, t, 128), cuda, dtype) for _ in range(2))
    k, v = (_randn(rng, (2, tk, 128), cuda, dtype) for _ in range(2))
    kw = dict(causal=causal, scale=128 ** -0.5, out_dtype=torch.float32)
    before = dict(fm.LAUNCHES)
    out, lse = fm.fwd(q, k, v, topo, **kw)
    ref_out, ref_lse = fm.fwd_reference(q, k, v, topo, **kw)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    dvec = (do.float() * ref_out).sum(-1)
    args = (q, k, v, do, lse, dvec, topo)
    torch.testing.assert_close(fm.dq(*args, **kw), fm.dq_reference(*args, **kw), atol=ATOL, rtol=0)
    for got, want in zip(fm.dkv(*args, **kw), fm.dkv_reference(*args, **kw)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    assert {n: fm.LAUNCHES[n] - before[n] for n in before} == dict.fromkeys(before, 1)
    if kind == "empty_row_col":
        assert not out[:, 128:256].any() and not fm.dkv(*args, **kw)[0][:, 128:384].any()


def test_flash_wrappers_raise_on_cuda(cuda):
    """A problem the kernels do not take raises ValueError on the card; it
    never falls back to the plain version."""
    topo = attention.causal_block_topology(256, window_blocks=2, device=cuda)
    q = torch.zeros(2, 256, 40, device=cuda, dtype=torch.bfloat16)  # not an instantiated head dim
    with pytest.raises(ValueError, match="head dim"):
        fm.flash_mha(q, q, q, topo, causal=True)
    q = torch.zeros(2, 256, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fm.flash_mha(q, q, q, topo, causal=True)
    q = torch.zeros(2, 256, 128, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        fm.flash_mha(q, q.bfloat16(), q, topo, causal=True)
    assert registry.dispatch_name("flash_mha", q, q, q, topo) == "cuda_flash"


@pytest.mark.parametrize("fused", [False, True])
def test_small_lm_grads_on_card_match_cpu(cuda, fused):
    """One lm_loss backward through the kernels on the card against the
    same weights through the plain versions on the CPU, fp32: the loss and
    every parameter's gradient within 1e-3 * max|g|."""
    cfg = tr.TransformerConfig(d_model=256, n_heads=2, seq_len=512, window_blocks=2, n_experts=2,
                               d_ff=128, n_layers=2, vocab=128, dtype=torch.float32, fused_attention=fused)
    cpu = tr.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tr.SparseLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, cfg.seq_len))
    launches = bsr_dsd.LAUNCHES, bsr_sdd.LAUNCHES, dict(fm.LAUNCHES)
    loss = tr.lm_loss(gpu, tokens.to(cuda), cfg)
    loss.backward()
    torch.cuda.synchronize()
    flash = {n: fm.LAUNCHES[n] - launches[2][n] for n in fm.LAUNCHES}
    sparse = (bsr_dsd.LAUNCHES - launches[0], bsr_sdd.LAUNCHES - launches[1])
    if fused:
        assert flash == dict.fromkeys(flash, cfg.n_layers) and sparse == (0, 0)
    else:
        assert flash == dict.fromkeys(flash, 0) and sparse == (4 * cfg.n_layers, 2 * cfg.n_layers)
    want_loss = tr.lm_loss(cpu, tokens, cfg)
    want_loss.backward()
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    got, want = grads_to_numpy(gpu), grads_to_numpy(cpu)
    for name, g in want.items():
        assert float(np.abs(got[name] - g).max()) <= 1e-3 * float(np.abs(g).max()) + 1e-6, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ffn_kernels_match_plain(cuda, dtype):
    """Both FFN kernels against their plain versions, fp32 outputs, within
    the reference ATOL: the group kernel on a permuted two-row-per-group
    layout and d_model 384 (one 128-column accumulator per CTA), the
    dropless kernel on dead tiles (live rows only)."""
    rng = np.random.default_rng(6)
    d, d_ff, n_exp = 384, 256, 3
    x = _randn(rng, (6 * BS, d), cuda, dtype)
    w1 = _randn(rng, (d, n_exp * d_ff), cuda, dtype) * d ** -0.5
    w2 = _randn(rng, (n_exp * d_ff, d), cuda, dtype) * d_ff ** -0.5
    cols = torch.tensor([5, 4, 0, 1, 3, 2], dtype=torch.int32, device=cuda)
    before = dict(bsr_ffn.LAUNCHES)
    for act in ("gelu", "relu", "identity"):
        got = bsr_ffn.group_ffn(x, w1, w2, cols, 2, activation=act, out_dtype=torch.float32)
        want = bsr_ffn.fused_group_ffn_reference(x, w1, w2, cols, 2, activation=act, out_dtype=torch.float32)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    e_row = torch.tensor([2, 0, 0], dtype=torch.int32, device=cuda)
    live = torch.tensor(2, dtype=torch.int32, device=cuda)
    kw = dict(tile_rows=2 * BS, live_rows=live, out_dtype=torch.float32)
    got = bsr_ffn.dropless_ffn(x, w1, w2, e_row, d_ff, **kw)
    want = bsr_ffn.fused_dropless_ffn_reference(x, w1, w2, e_row, d_ff, **kw)
    torch.testing.assert_close(got[:4 * BS], want[:4 * BS], atol=ATOL, rtol=0)
    assert bsr_ffn.LAUNCHES == {"bsr_ffn_group": before["bsr_ffn_group"] + 3,
                                "bsr_ffn_dropless": before["bsr_ffn_dropless"] + 1}
    with pytest.raises(ValueError, match="one dtype"):
        bsr_ffn.group_ffn(x, w1.float() if dtype == torch.bfloat16 else w1.bfloat16(), w2, cols, 2)
    with pytest.raises(ValueError, match="multiples of 128"):
        bsr_ffn.group_ffn(x[:, :200].contiguous(), w1[:200].contiguous(), w2[:, :200].contiguous(), cols, 2)
    assert registry.dispatch_name("fused_group_ffn", x, w1, w2, cols, 2) == "cuda_ffn"


def test_metadata_built_on_card_reads_nothing_back(cuda):
    """create() on CUDA metadata and dropless_topology() run under
    torch.cuda.set_sync_debug_mode("error"): no device read. The hints are
    the caller's or None; the metadata equals the CPU build's."""
    cfg = moe.MoEConfig(d_model=256, d_ff=256, n_experts=4, capacity=128, dtype=torch.float32)
    rows = torch.tensor([2, 0, 1, 3], device=cuda)
    offsets = torch.arange(4, dtype=torch.int32, device=cuda) * 2
    indices = torch.tensor([0, 1, 1, 2, 0, 3], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = BlockSparseMatrix.create(torch.zeros(6, BS, BS, device=cuda), offsets, indices, (3 * BS, 4 * BS),
                                     max_row_nnz=2)
        topo = moe.dropless_topology(rows, cfg, 9)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (m.max_row_nnz, m.max_col_nnz, m.min_row_nnz, m.min_col_nnz) == (2, None, None, None)
    assert topo.max_row_nnz == 2 and topo.max_col_nnz is None
    want = moe.dropless_topology(rows.cpu(), cfg, 9)
    for name in ("offsets", "indices", "row_indices"):
        assert torch.equal(getattr(topo, name).cpu(), getattr(want, name)), name


@pytest.mark.parametrize("impl", ["grouped", "bsr", "bsr_unfused", "dropless_ragged", "dropless_bsr",
                                  "dropless_bsr_fused"])
def test_moe_forwards_on_card_match_cpu(cuda, impl):
    """Each MoE forward on the card against the same weights on the CPU,
    fp32: y within 1e-4, the exact aux loss up to rounding; the fused
    impls' gradients within 1e-3 * max|g|."""
    cfg = moe.MoEConfig(d_model=256, d_ff=256, n_experts=4, capacity=128, dtype=torch.float32)
    cpu = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = moe.MoE(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((600, 256)).astype(np.float32))
    outs = []
    for params, device in ((gpu, cuda), (cpu, torch.device("cpu"))):
        xd = x.to(device).requires_grad_()
        topo = moe.block_diag_topology(cfg, device=device)
        if impl.startswith("dropless_"):
            y, aux = moe.dropless_moe_forward(params, xd, cfg, impl=impl[len("dropless_"):])
        else:
            y, aux = moe.moe_forward(params, xd, cfg, topo, impl=impl)
        (torch.mean(y ** 2) + 0.01 * aux).backward()
        outs.append((y.detach().cpu(), aux.item(), grads_to_numpy(params), xd.grad.cpu().numpy()))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=1e-4, rtol=0)
    assert abs(outs[0][1] - outs[1][1]) <= 1e-5
    if impl in ("bsr", "dropless_bsr_fused"):
        for name, g in [*outs[1][2].items(), ("x", outs[1][3])]:
            got = outs[0][2][name] if name != "x" else outs[0][3]
            assert float(np.abs(got - g).max()) <= 1e-3 * float(np.abs(g).max()) + 1e-6, name


# ------------------------------------------------------------ CSR engine --
def _sell_on_card(rng, rows, cols, density, cuda, dtype, **kw):
    c = testing.random_csr(rng, rows, cols, int(rows * cols * density), dtype=dtype, device=cuda)
    return SellMatrix.from_csr(c, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk,sort_rows", [(128, False), ("auto", True), (64, True), (64, False), (128, True),
                                             (256, False), (256, True)])
def test_sell_kernels_match_plain(cuda, dtype, chunk, sort_rows):
    """Each SELL kernel against its plain version on the same card tensors,
    on a matrix with an empty column (an output row of spmm_t with no slot):
    fp32 within 1e-4 * max|plain|, bf16 within one bf16 ulp (floored at
    2^-8 * max|plain|, testing.bf16_ulp_excess); two runs of a
    kernel bitwise equal; one launch each."""
    rng = np.random.default_rng(11)
    c = testing.random_csr(rng, 300, 520, int(300 * 520 * 0.08), dtype=dtype, device=cuda)
    dense = c.to_dense()
    dense[:, 7] = 0
    s = SellMatrix.from_csr(csr_from_dense(dense), chunk=chunk, sort_rows=sort_rows)
    b, x = _randn(rng, (520, 96), cuda, dtype), _randn(rng, (300, 96), cuda, dtype)
    q, k = _randn(rng, (300, 64), cuda, dtype), _randn(rng, (520, 64), cuda, dtype)
    sentinel = dataclasses.replace(s, slot_counts=None)
    pairs = {
        "sell_spmm": (lambda: sell.spmm(s, b), lambda: sell.spmm_reference(s, b)),
        "sell_spmm_t": (lambda: sell.spmm_t(s, x), lambda: sell.spmm_t_reference(s, x)),
        "sell_sddmm": (lambda: sell.sddmm(q, k, s).values, lambda: sell.sddmm_reference(q, k, s).values),
        "sell_softmax": (lambda: sell.sparse_softmax(s, scale=0.5).values,
                         lambda: sell.sparse_softmax_reference(s, scale=0.5).values),
        "sell_softmax_sentinel": (lambda: sell.sparse_softmax(sentinel, scale=0.5).values,
                                  lambda: sell.sparse_softmax_reference(sentinel, scale=0.5).values),
    }
    for name, (kernel, plain) in pairs.items():
        before = dict(sell.LAUNCHES)
        got = kernel()
        kname = name.replace("_sentinel", "")
        assert sell.LAUNCHES[kname] == before[kname] + 1, name
        again, want = kernel(), plain()
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: two runs differ"
        diff = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-4 * float(want.abs().max()), name
        else:
            assert testing.bf16_ulp_excess(got, want) <= 1, name


def test_sell_ops_read_nothing_back(cuda):
    """spmm on a weight and the chain sddmm -> softmax -> spmm on the
    kernels, forward and backward (the transposed SpMM over the plans that
    from_csr built on the card), under set_sync_debug_mode("error"); fp32
    gradients within 1e-4 * max|g| of the plain path, padding slots with
    zero gradient. A matrix built without a plan reads its indices once, at
    its first transposed SpMM, and never again."""
    rng = np.random.default_rng(12)
    w = _sell_on_card(rng, 256, 384, 0.1, cuda, torch.float32, chunk="auto", sort_rows=True)
    topo = _sell_on_card(rng, 256, 256, 0.1, cuda, torch.float32, sort_rows=True)
    assert w.transpose_plan.positions.is_cuda and topo.transpose_plan.indices.is_cuda
    bare = dataclasses.replace(w, transpose_plan=None)
    x = _randn(rng, (256, 64), cuda, torch.float32)
    first = sell.spmm_t(bare, x)  # builds and keeps the plan: one read
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = sell.spmm_t(bare, x)
        planned = sell.spmm_t(w, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again) and torch.equal(first, planned)
    b = _randn(rng, (384, 64), cuda, torch.float32)
    q, k, v = (_randn(rng, (256, 64), cuda, torch.float32) for _ in range(3))
    grads = []
    for plain in (False, True):
        values = w.values.clone().requires_grad_()
        inputs = [t.clone().requires_grad_() for t in (b, q, k, v)]
        bb, qq, kk, vv = inputs
        torch.cuda.synchronize()
        if not plain:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
                y = csr_ops.spmm(w.with_values(values), bb)
                p = csr_ops.sparse_softmax(csr_ops.sddmm(qq, kk, topo), scale=0.125)
                z = csr_ops.spmm(p, vv)
                (y.square().mean() + z.square().mean()).backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        grads.append([values.grad] + [t.grad for t in inputs])
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-6
    assert not grads[0][0][~w.valid_mask()].any()


def test_sell_wrappers_raise_on_cuda(cuda):
    """A CUDA problem the kernels do not take raises; it never falls back."""
    rng = np.random.default_rng(13)
    s = _sell_on_card(rng, 256, 256, 0.1, cuda, torch.float32)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        sell.spmm(s, torch.zeros(256, 64, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sell.spmm(s, torch.zeros(256, 64))
    assert registry.dispatch_name("sell_spmm", s, torch.zeros(256, 64, device=cuda)) == "cuda_sell"


def _sparse_out_problem(rng, cuda, dtype, density=0.2, d=768):
    mats = [testing.random_bsr(rng, d, d, int(d * d * density), BS, unordered=True, dtype=dtype, device=cuda)
            for _ in range(3)]
    return (*mats, _randn(rng, (d, d), cuda, dtype))


def _sparse_out_cases(a, b, t, x, ta, tb):
    """{kernel case: (kernel call, plain call)} of the four sparse-output
    kernels on one problem; the plain calls return fp32 sums."""
    nb = a.rows // BS
    kw = dict(transpose_a=ta, transpose_b=tb)
    plans = {"ssd": ops.plan_ssd(a, t, transpose_a=ta), "sds": ops.plan_sds(b, t, transpose_b=tb),
             "dss": ops.plan_dss(a, b, **kw), "sss": ops.plan_sss(a, b, t, **kw)}
    ac, bc = dss_bench.card_built(a), dss_bench.card_built(b)
    wl = bsr_dss.build_dss_worklist(ac, bc, **kw)
    pos = b.position_map()
    steps = a.max_col_nnz if ta else a.max_row_nnz
    dense = lambda tiles: bsr_flat.tiles_to_dense(tiles, nb, nb)  # noqa: E731
    return {
        "flat ssd": (lambda: bsr_flat.ssd_flat(a, x, t, schedule=plans["ssd"], **kw).data,
                     lambda: bsr_flat.flat_reference(plans["ssd"], a.data, x, t.nnz_blocks, **kw)),
        "flat sds": (lambda: bsr_flat.sds_flat(x, b, t, schedule=plans["sds"], **kw).data,
                     lambda: bsr_flat.flat_reference(plans["sds"], b.data, x, t.nnz_blocks, **kw)),
        "flat dss": (lambda: bsr_flat.dss_flat(a, b, schedule=plans["dss"], **kw),
                     lambda: dense(bsr_flat.flat_reference(plans["dss"], a.data, b.data, nb * nb, **kw))),
        "flat sss": (lambda: bsr_flat.sss_flat(a, b, t, schedule=plans["sss"], **kw).data,
                     lambda: bsr_flat.flat_reference(plans["sss"], a.data, b.data, t.nnz_blocks, **kw)),
        "sparse_out ssd": (lambda: bsr_ssd.ssd(a, x, t, **kw).data,
                           lambda: bsr_ssd.sparse_out_reference(bsr_flat.KIND_SSD, a, x, t, stream_transposed=ta,
                                                                max_steps=steps, **kw)),
        "sparse_out sds": (lambda: bsr_ssd.sds(x, b, t, **kw).data,
                           lambda: bsr_ssd.sparse_out_reference(
                               bsr_flat.KIND_SDS, b, x, t, stream_transposed=not tb,
                               max_steps=b.max_row_nnz if tb else b.max_col_nnz, **kw)),
        "dss_masked": (lambda: bsr_dss.dss(a, b, pos_map=pos, **kw),
                       lambda: dense(bsr_dss.masked_reference(a, b, pos, max_steps=steps, m_blocks=nb, n_blocks=nb,
                                                              **kw))),
        "dss_worklist": (lambda: bsr_dss.dss_worklist(ac, bc, worklist=wl, **kw),
                         lambda: dense(bsr_dss.worklist_reference(ac, bc, wl, n_tiles=nb * nb, **kw))),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ta,tb", MODES)
def test_sparse_out_kernels_match_plain(cuda, dtype, ta, tb):
    """The four sparse-output kernels in every mode against their plain
    versions on the same plan, work list or position map: fp32 within
    1e-4 * max|plain|, bf16 within one bf16 ulp; two runs bitwise equal."""
    rng = np.random.default_rng(20)
    launches = bsr_flat.LAUNCHES, bsr_ssd.LAUNCHES, dict(bsr_dss.LAUNCHES)
    for name, (kernel, plain) in _sparse_out_cases(*_sparse_out_problem(rng, cuda, dtype), ta, tb).items():
        got, again, want = kernel(), kernel(), plain().to(dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, again), name
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
        else:
            assert testing.bf16_ulp_excess(got, want) <= 1, name
    assert bsr_flat.LAUNCHES == launches[0] + 8 and bsr_ssd.LAUNCHES == launches[1] + 4
    assert all(bsr_dss.LAUNCHES[k] == launches[2][k] + 2 for k in launches[2])


def test_sparse_out_empty_work_is_zero(cuda):
    """An empty DSS intersection through all three DSS kernels, and output
    blocks with no work, come out as exact zeros."""
    ones = np.ones((3, BS, BS), np.float32)
    a = testing.bsr_from_blocks(384, 384, [0, 1, 2], [0, 0, 0], ones, device=cuda)
    b = testing.bsr_from_blocks(384, 384, [2, 2, 2], [0, 1, 2], ones, device=cuda)
    zero = torch.zeros(384, 384, device=cuda)
    ac, bc = dss_bench.card_built(a), dss_bench.card_built(b)
    assert torch.equal(bsr_flat.dss_flat(a, b), zero)
    assert torch.equal(bsr_dss.dss(a, b), zero)
    assert torch.equal(bsr_dss.dss_worklist(ac, bc), zero)
    x = torch.ones(384, 384, device=cuda)
    for fn in (bsr_flat.ssd_flat, bsr_ssd.ssd):
        out = fn(b, x, a).data  # b's row 0 is empty: a's blocks in row 0 get no work
        assert float(out[0].abs().max()) == 0.0 and float(out[2].abs().min()) == 3 * BS


def test_sparse_out_routes_and_no_host_reads(cuda):
    """Host-built metadata takes cuda_flat (10%) and the dense detours (50%);
    metadata built on the card takes the output-stationary, work-list (nnz
    hints) and masked (no hints) kernels; every forward runs again with
    warm plans under set_sync_debug_mode("error")."""
    rng = np.random.default_rng(21)
    d, bf16 = 1024, torch.bfloat16
    x = _randn(rng, (d, d), cuda, bf16)
    host10 = [testing.random_bsr(rng, d, d, d * d // 10, BS, dtype=bf16, device=cuda) for _ in range(3)]
    host50 = [testing.random_bsr(rng, d, d, d * d // 2, BS, dtype=bf16, device=cuda) for _ in range(3)]
    sparse = [testing.random_bsr(rng, d, d, d * d // 64, BS, dtype=bf16, device=cuda) for _ in range(3)]
    card = [dss_bench.card_built(m) for m in sparse]
    calls = []
    for (a, b, t), flat in ((host10, True), (host50, False)):
        calls += [("ssd", (a, x, t), "cuda_flat" if flat else "dense_extract"),
                  ("sds", (x, b, t), "cuda_flat" if flat else "dense_extract"),
                  ("dss", (a, b), "cuda_flat" if flat else "densify")]
    a, b, t = card
    calls += [("sss", tuple(host10), "cuda_flat"), ("ssd", (a, x, t), "cuda_output_stationary"),
              ("sds", (x, b, t), "cuda_output_stationary"), ("dss", (a, b), "cuda_worklist"),
              ("dss", (dss_bench.card_built(a, False), b), "cuda_masked_stream")]
    for op, args, route in calls:
        assert registry.dispatch_name(op, *args) == route, (op, route)
        getattr(ops, f"matmul_{op}")(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for op, args, _ in calls:
            getattr(ops, f"matmul_{op}")(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_sparse_out_wrappers_raise_on_cuda(cuda):
    """A CUDA problem the kernels do not take raises; it never falls back."""
    rng = np.random.default_rng(22)
    a, b, t, x = _sparse_out_problem(rng, cuda, torch.float32, d=256)
    with pytest.raises(ValueError, match="one dtype"):
        ops.matmul_ssd(a, x.to(torch.bfloat16), t, variant="cuda_flat")
    with pytest.raises(ValueError, match="batch axis"):
        bsr_dss.dss(a.with_data(a.data[None]), b)
    small = testing.random_bsr(rng, 256, 256, 256 * 256 // 4, 64, device=cuda)
    with pytest.raises(ValueError, match="block size"):
        bsr_ssd.ssd(small, x, small)


def _close(got, want, dtype):
    """fp32 within 1e-4 * max|plain|, bf16 within one bf16 ulp."""
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    else:
        assert testing.bf16_ulp_excess(got, want) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_softmax_kernels_match_plain(cuda, dtype, causal):
    """The two BSR softmax kernels on metadata built on the card with no
    hint (3 heads, unordered columns, an empty block-row, a duplicated
    block, a block above the diagonal) against their plain versions and
    the torch chain; two runs bitwise equal; the gradient against the
    chain's."""
    topo = testing.bsr_from_blocks(512, 512, [0, 0, 2, 2, 2, 3, 3], [1, 0, 2, 0, 2, 3, 0],
                                   np.zeros((7, BS, BS)), dtype=dtype, device=cuda)
    card = dss_bench.card_built(topo, False)
    assert card.max_row_nnz is None and not card.host_known
    data = _randn(np.random.default_rng(30), (3,) + tuple(topo.data.shape), cuda, dtype) * 4
    before = dict(bsm.LAUNCHES)
    m, l = bsm.stats(data, card, scale=0.5, causal=causal)
    m_ref, l_ref = bsm.stats_reference(data, card, scale=0.5, causal=causal)
    assert torch.equal(m_ref < -1e29, m < -1e29) and torch.equal(l[m < -1e29], l_ref[m < -1e29])
    live = m_ref > -1e29
    _close(m[live], m_ref[live], torch.float32)
    _close(l[live], l_ref[live], torch.float32)
    p = ops.bsr_softmax(card.with_data(data), scale=0.5, causal=causal)
    _close(p.data.float(), ops.bsr_softmax(card.with_data(data), scale=0.5, causal=causal,
                                           variant="jnp").data.float(), dtype)
    assert torch.equal(p.data, ops.bsr_softmax(card.with_data(data), scale=0.5, causal=causal).data)
    assert {k: bsm.LAUNCHES[k] - before[k] for k in before} == \
        {"bsr_softmax_stats": 3, "bsr_softmax_normalize": 2, "sdd_softmax": 0}
    if dtype == torch.float32:
        w = _randn(np.random.default_rng(31), tuple(data.shape), cuda, dtype)
        grads = []
        for variant in ("pallas", "jnp"):
            x = data.clone().requires_grad_()
            (ops.bsr_softmax(card.with_data(x), scale=0.5, causal=causal, variant=variant).data * w).sum().backward()
            grads.append(x.grad)
        _close(*grads, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
def test_sdd_softmax_kernel_matches_plain(cuda, dtype, dh):
    """The score pass (scores, m, l) and ops.sdd_softmax against their plain
    versions, 2 heads, causal band."""
    topo = attention.causal_block_topology(512, window_blocks=2, dtype=dtype, device=cuda)
    rng = np.random.default_rng(32)
    q, k = (_randn(rng, (2, 512, dh), cuda, dtype) for _ in range(2))
    got = bsm.scores(q, k, topo, scale=dh ** -0.5, causal=True)
    want = bsm.scores_reference(q, k, topo, scale=dh ** -0.5, causal=True)
    for g, w in zip(got, want):
        live = w > -1e29
        assert torch.equal(g > -1e29, live)
        _close(g[live], w[live], torch.float32)
    probs = ops.sdd_softmax(q, k, topo, scale=dh ** -0.5, causal=True)
    with registry.forced_variant("torch_reference"):
        plain = ops.sdd_softmax(q, k, topo, scale=dh ** -0.5, causal=True)
    _close(probs.data.float(), plain.data.float(), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", fm.HEAD_DIMS)
def test_flash_head_dims_match_plain(cuda, dh, dtype):
    """Every instantiated head dim: the three flash kernels and the score
    pass of sdd_softmax against their plain versions (fp32 outputs), on a
    causal band of 2 heads."""
    topo = attention.causal_block_topology(512, window_blocks=2, dtype=dtype, device=cuda).with_transpose_metadata()
    rng = np.random.default_rng(37)
    q, k, v, do = (_randn(rng, (2, 512, dh), cuda, dtype) for _ in range(4))
    kw = dict(causal=True, scale=dh ** -0.5, out_dtype=torch.float32)
    out, lse = fm.fwd(q, k, v, topo, **kw)
    ref_out, ref_lse = fm.fwd_reference(q, k, v, topo, **kw)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    args = (q, k, v, do, ref_lse, (do.float() * ref_out).sum(-1), topo)
    torch.testing.assert_close(fm.dq(*args, **kw), fm.dq_reference(*args, **kw), atol=ATOL, rtol=0)
    for got, want in zip(fm.dkv(*args, **kw), fm.dkv_reference(*args, **kw)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    got = bsm.scores(q, k, topo, scale=dh ** -0.5, causal=True)
    want = bsm.scores_reference(q, k, topo, scale=dh ** -0.5, causal=True)
    for g, w in zip(got, want):
        live = w > -1e29
        assert torch.equal(g > -1e29, live)
        _close(g[live], w[live], torch.float32)


@pytest.mark.parametrize("fused_backward", [True, False])
def test_flash_block_attention_on_card(cuda, fused_backward):
    """flash_block_attention (the flash kernels at one head) on metadata
    built on the card, fp32: output and gradients against the plain path,
    and the launches of each backward route."""
    topo = dss_bench.card_built(attention.causal_block_topology(512, window_blocks=2, dtype=torch.float32,
                                                                device=cuda))
    rng = np.random.default_rng(33)
    xs0 = [_randn(rng, (512, 128), cuda, torch.float32) for _ in range(3)]
    g = _randn(rng, (512, 128), cuda, torch.float32)
    results = []
    for plain in (False, True):
        xs = [x.clone().requires_grad_() for x in xs0]
        before = dict(fm.LAUNCHES), bsr_sdd.LAUNCHES, bsr_dsd.LAUNCHES, dict(bsm.LAUNCHES)
        with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
            out = fa.flash_block_attention(*xs, topo, causal=True, fused_backward=fused_backward)
            (out * g).sum().backward()
        torch.cuda.synchronize()
        flash = {n: fm.LAUNCHES[n] - before[0][n] for n in fm.LAUNCHES}
        chain = (bsr_sdd.LAUNCHES - before[1], bsr_dsd.LAUNCHES - before[2],
                 bsm.LAUNCHES["bsr_softmax_stats"] - before[3]["bsr_softmax_stats"])
        if plain:
            assert flash == dict.fromkeys(flash, 0) and chain == (0, 0, 0)
        elif fused_backward:
            assert flash == dict.fromkeys(flash, 1) and chain == (0, 0, 0)
        else:  # forward; the chain's forward (SDD, softmax, DSD) and its VJPs
            assert flash == {"flash_mha_fwd": 1, "flash_mha_dq": 0, "flash_mha_dkv": 0}
            assert chain == (2, 4, 1)
        results.append([out.detach()] + [x.grad for x in xs])
    for got, want in zip(*results):
        _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fused", [False, True])
def test_default_config_lm_on_card(cuda, fused, dtype):
    """TransformerConfig() (d_head 64) trains on the card on both attention
    routes: lm_loss and backward() through the kernels (flash at head dim
    64; unfused the softmax kernels, SDD / DSD at K or N = 64 on the densify
    detour) against the same weights on the plain path: the loss within
    1e-5 relative (bf16: 1e-2) and every gradient within 1e-3 * max|g|
    (bf16: finite)."""
    cfg = dataclasses.replace(tr.TransformerConfig(), fused_attention=fused, dtype=dtype)
    assert cfg.d_head == 64
    lm = tr.init_lm_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(34).integers(0, cfg.vocab, cfg.seq_len)).to(cuda)
    losses, grads = [], []
    for plain in (False, True):
        lm.zero_grad(set_to_none=True)
        before = dict(fm.LAUNCHES), dict(bsm.LAUNCHES), bsr_sdd.LAUNCHES, bsr_dsd.LAUNCHES
        with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
            loss = tr.lm_loss(lm, tokens, cfg)
            loss.backward()
        torch.cuda.synchronize()
        counts = ({n: fm.LAUNCHES[n] - before[0][n] for n in fm.LAUNCHES},
                  {n: bsm.LAUNCHES[n] - before[1][n] for n in bsm.LAUNCHES},
                  bsr_sdd.LAUNCHES - before[2], bsr_dsd.LAUNCHES - before[3])
        n = 0 if plain else cfg.n_layers
        assert counts[0] == dict.fromkeys(fm.LAUNCHES, n if fused else 0)
        assert counts[1] == {"bsr_softmax_stats": 0 if fused else n, "bsr_softmax_normalize": 0 if fused else n,
                             "sdd_softmax": 0}
        assert counts[2:] == (0, 0)
        losses.append(loss.item())
        grads.append({name: p.grad.detach().float().clone() for name, p in lm.named_parameters()})
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= (1e-5 if dtype == torch.float32 else 1e-2) * abs(losses[1])
    for name, g in grads[1].items():
        assert bool(torch.isfinite(grads[0][name]).all()), name
        if dtype == torch.float32:
            assert float((grads[0][name] - g).abs().max()) <= 1e-3 * float(g.abs().max()) + 1e-6, name


def test_topk_attention_on_card_reads_nothing_back(cuda):
    """topk_block_topology built on the card and the fused attention over it
    run under set_sync_debug_mode("error"); the metadata equals the CPU
    build's; fused and unfused attention against the plain path, fp32, with
    the launches of each route."""
    rng = np.random.default_rng(35)
    q, k, v = (_randn(rng, (512, 128), cuda, torch.float32) for _ in range(3))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        topo = attention.topk_block_topology(q, k, 2)
        fused = attention.block_sparse_attention(q, k, v, topo, causal=True, fused=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = attention.topk_block_topology(q.cpu(), k.cpu(), 2)
    assert not topo.host_known and (topo.max_row_nnz, topo.max_col_nnz) == (2, 4)
    for name in ("offsets", "indices", "row_indices"):
        assert torch.equal(getattr(topo, name).cpu(), getattr(cpu, name)), name
    before = bsr_sdd.LAUNCHES, bsr_dsd.LAUNCHES, dict(bsm.LAUNCHES)
    unfused = attention.block_sparse_attention(q, k, v, topo, causal=True)
    assert (bsr_sdd.LAUNCHES - before[0], bsr_dsd.LAUNCHES - before[1]) == (1, 1)
    assert {n: bsm.LAUNCHES[n] - before[2][n] for n in bsm.LAUNCHES} == \
        {"bsr_softmax_stats": 1, "bsr_softmax_normalize": 1, "sdd_softmax": 0}
    with registry.forced_variant("torch_reference"):
        plain = attention.block_sparse_attention(q, k, v, topo, causal=True)
    _close(fused, plain, torch.float32)
    _close(unfused, plain, torch.float32)


def test_generate_topk_on_card_matches_cpu(cuda):
    """The small LM, fp32: greedy top-k tokens on the card equal the CPU's;
    sampling at temperature 0.8 is reproducible from a seeded generator on
    the card."""
    cfg = tr.TransformerConfig(d_model=256, n_heads=2, seq_len=512, window_blocks=2, n_experts=2,
                               d_ff=128, n_layers=2, vocab=128, dtype=torch.float32)
    cpu = tr.init_lm_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = tr.SparseLM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(36).integers(0, cfg.vocab, (2, 256)))
    got = tr.lm_generate_batched(gpu, tokens.to(cuda), cfg, 8, mode="topk", k_pages=2)
    assert torch.equal(got.cpu(), tr.lm_generate_batched(cpu, tokens, cfg, 8, mode="topk", k_pages=2))
    draws = [tr.lm_generate_batched(gpu, tokens.to(cuda), cfg, 8, mode="topk", k_pages=2, temperature=0.8,
                                    generator=torch.Generator(device=cuda).manual_seed(5)) for _ in range(2)]
    assert torch.equal(*draws) and bool(((draws[0] >= 0) & (draws[0] < cfg.vocab)).all())


# ------------------------------------------ small blocks and int8 serving --
def _twice_close(kernel, plain, dtype):
    """Two runs bitwise equal, then within tolerance of the plain version
    (int32 sums equal)."""
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if dtype == torch.int32:
        assert got.dtype == torch.int32 and torch.equal(got, want)
    else:
        _close(got, want.to(got.dtype), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ta,tb", MODES)
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_small_kernels_match_plain(cuda, bs, ta, tb, dtype):
    """bsr_small_dsd (DSD and, transposed, DDS) and bsr_small_sdd against
    their plain versions on the same plans, unordered columns and ragged
    rows; each launched once per call."""
    rng = np.random.default_rng(40 + bs)
    m, k, n = 512, 384, 256
    kw = dict(transpose_a=ta, transpose_b=tb)
    a = testing.random_bsr(rng, *_dims(m, k, n, ta, tb)[0], m * k // 4, bs, unordered=True, dtype=dtype,
                           device=cuda)
    b = _randn(rng, _dims(m, k, n, ta, tb)[1], cuda, dtype)
    plan = bsr_small.plan_smallblock(a, transposed=ta)
    before = dict(bsr_small.LAUNCHES)
    _twice_close(lambda: bsr_small.dsd_smallblock(a, b, schedule=plan, **kw),
                 lambda: bsr_small.dsd_small_reference(plan, a.data, b, n_rows=m // bs, out_dtype=dtype, **kw), dtype)
    x = _randn(rng, _dims(n, m, k, tb, ta)[0], cuda, dtype)  # op(x): (n, m) against op(a): (m, k)
    _twice_close(lambda: bsr_small.dds_smallblock(x, a, transpose_a=tb, transpose_b=ta),
                 lambda: reference.dds(x, a, transpose_a=tb, transpose_b=ta), dtype)
    topo = testing.random_bsr(rng, m, n, m * n // 4, bs, unordered=True, dtype=dtype, device=cuda)
    y = _randn(rng, _dims(m, k, n, ta, tb)[0], cuda, dtype)
    splan = bsr_small.plan_sdd_smallblock(topo)
    _twice_close(lambda: bsr_small.sdd_smallblock(y, b, topo, schedule=splan, **kw).data,
                 lambda: bsr_small.sdd_small_reference(splan, y, b, out_dtype=dtype, **kw), dtype)
    assert {k: bsr_small.LAUNCHES[k] - before[k] for k in before} == {"bsr_small_dsd": 4, "bsr_small_sdd": 2}


@pytest.mark.parametrize("ta,tb", MODES)
def test_int8_stream_and_bres_match_plain(cuda, ta, tb):
    """bsr_dsd_stream on int8 operands (DSD and DDS) and bsr_bres (int8,
    bf16, fp32; q 8 and 4): int32 sums equal, scaled outputs within
    tolerance, two runs bitwise equal; int8 launches counted apart."""
    rng = np.random.default_rng(50)
    m, k, n = 512, 384, 256
    kw = dict(transpose_a=ta, transpose_b=tb)
    a = testing.random_bsr(rng, *_dims(m, k, n, ta, tb)[0], m * k // 4, BS, unordered=True, device=cuda)
    aq = a.with_data(torch.from_numpy(rng.integers(-127, 128, tuple(a.data.shape), dtype=np.int8)).to(cuda))
    bq = torch.from_numpy(rng.integers(-127, 128, _dims(m, k, n, ta, tb)[1], dtype=np.int8)).to(cuda)
    xq = torch.from_numpy(rng.integers(-127, 128, _dims(n, m, k, tb, ta)[0], dtype=np.int8)).to(cuda)
    before = bsr_dsd.LAUNCHES, bsr_dsd.LAUNCHES_Q8, bsr_qstream.LAUNCHES
    for od, sc in ((torch.int32, None), (torch.float32, 0.0123), (torch.bfloat16, 0.0123)):
        _twice_close(lambda: bsr_dsd.dsd(aq, bq, out_dtype=od, out_scale=sc, **kw),
                     lambda: bsr_dsd.dsd_reference(aq, bq, out_dtype=od, out_scale=sc, **kw), od)
        _twice_close(lambda: bsr_dsd.dds(xq, aq, out_dtype=od, out_scale=sc, transpose_a=tb, transpose_b=ta),
                     lambda: bsr_dsd.dds_reference(xq, aq, out_dtype=od, out_scale=sc, transpose_a=tb,
                                                   transpose_b=ta), od)
        for q in (8, 4):
            _twice_close(lambda: bsr_qstream.dsd_bres(aq, bq, out_dtype=od, out_scale=sc, q=q, **kw),
                         lambda: bsr_dsd.dsd_reference(aq, bq, out_dtype=od, out_scale=sc, **kw), od)
    assert (bsr_dsd.LAUNCHES - before[0], bsr_dsd.LAUNCHES_Q8 - before[1]) == (0, 12)
    for dtype in (torch.bfloat16, torch.float32):
        af = a.astype(dtype)
        b = _randn(rng, _dims(m, k, n, ta, tb)[1], cuda, dtype)
        x = _randn(rng, _dims(n, m, k, tb, ta)[0], cuda, dtype)
        _twice_close(lambda: bsr_qstream.dsd_bres(af, b, **kw), lambda: reference.dsd(af, b, **kw), dtype)
        _twice_close(lambda: bsr_qstream.dds_bres(x, af, transpose_a=tb, transpose_b=ta),
                     lambda: reference.dds(x, af, transpose_a=tb, transpose_b=ta), dtype)
    assert bsr_qstream.LAUNCHES - before[2] == 2 * 3 * 2 + 2 * 2 * 2


def test_bres_plan_on_card_built_metadata(cuda):
    """Metadata built on the card: the bres plan is built there (no read
    back) and the kernel matches plain, DSD and DDS."""
    rng = np.random.default_rng(51)
    a = testing.random_bsr(rng, 512, 512, 512 * 512 // 4, BS, unordered=True, device=cuda)
    card = dss_bench.card_built(a, False)
    assert not card.host_known
    x = _randn(rng, (512, 256), cuda, torch.float32)
    torch.cuda.synchronize()
    bsr_qstream.dsd_bres(card, x)  # plans (on the card) and launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = bsr_qstream.dsd_bres(card, x)
        out_t = bsr_qstream.dds_bres(x.T.contiguous(), card, transpose_b=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _close(out, reference.dsd(a, x), torch.float32)
    _close(out_t, reference.dds(x.T.contiguous(), a, transpose_b=True), torch.float32)


@pytest.mark.parametrize("op", ["ssd", "sds", "dss", "sss"])
def test_sparse_out_small_blocks_on_card(cuda, op):
    """SSD / SDS / DSS / SSS at bs 32 run on the card on
    host-known metadata (cuda_smallblock) and on metadata built there
    (jnp_fallback; SSS: dss_extract) and match the plain version."""
    rng = np.random.default_rng(52)
    d, bs, f32 = 512, 32, torch.float32
    mats = [testing.random_bsr(rng, d, d, d * d // 4, bs, unordered=True, device=cuda) for _ in range(3)]
    x = _randn(rng, (d, d), cuda, f32)
    for card in (False, True):
        a, b, t = (dss_bench.card_built(m, False) if card else m for m in mats)
        args = {"ssd": (a, x, t), "sds": (x, b, t), "dss": (a, b), "sss": (a, b, t)}[op]
        route = registry.dispatch_name(op, *args)
        assert route == ({"sss": "dss_extract"}.get(op, "jnp_fallback") if card else
                         {"sss": "dss_extract"}.get(op, "cuda_smallblock"))
        out = getattr(ops, op)(*args)
        with registry.forced_variant("torch_reference"):
            plain = getattr(ops, op)(*args)
        if op != "dss":
            out, plain = out.data, plain.data
        _close(out, plain, f32)


def test_small_block_training_step_on_card(cuda):
    """A pruned bs-32 weight: forward and backward through ops.dsd launch
    one bsr_small_dsd and one bsr_small_sdd, the gradients match the plain
    path, a RigL refresh keeps the budget and the host copy, and a warm
    step reads nothing back."""
    rng = np.random.default_rng(53)
    w = _randn(rng, (256, 512), cuda, torch.float32)
    x = _randn(rng, (512, 384), cuda, torch.float32)
    m = prune.block_magnitude_prune(w, 32, sparsity=0.75)
    assert m.host_known

    def grad(topo, plain=False):
        leaf = topo.data.clone().requires_grad_()
        with registry.forced_variant("torch_reference") if plain else contextlib.nullcontext():
            (ops.dsd(topo.with_data(leaf), x) ** 2).mean().backward()
        return leaf.grad

    before = dict(bsr_small.LAUNCHES)
    g = grad(m)
    assert {k: bsr_small.LAUNCHES[k] - before[k] for k in before} == {"bsr_small_dsd": 1, "bsr_small_sdd": 1}
    _close(g, grad(m, plain=True), torch.float32)
    r = prune.rigl_block_update(m, w, drop_fraction=0.3)
    assert r.host_known and r.nnz_blocks == m.nnz_blocks
    grad(r)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grad(r)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_quantized_serving_on_card_matches_cpu(cuda):
    """quantize / quantize_bsr on the card equal the CPU's bit for bit, and
    matmul_dds_q8 / matmul_dsd_q8 on the card (both kernels) equal the
    CPU's plain versions: int32 exactly, fp32 within 1e-6 relative."""
    rng = np.random.default_rng(54)
    w = testing.random_bsr(rng, 512, 1024, 512 * 1024 // 4, BS, device="cpu")
    x = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32))
    wq_c, sw_c = quant.quantize_bsr(w)
    xq_c, sx_c = quant.quantize(x)
    wq, sw = quant.quantize_bsr(w.to(cuda))
    xq, sx = quant.quantize(x.to(cuda))
    assert (sw, sx) == (sw_c, sx_c)
    assert torch.equal(wq.data.cpu(), wq_c.data) and torch.equal(xq.cpu(), xq_c)
    for kernel in ("stream", "bres"):
        got = quant.matmul_dds_q8(xq, wq, scale_a=sx, scale_b=sw, out_dtype=torch.float32, kernel=kernel)
        want = quant.matmul_dds_q8(xq_c, wq_c, scale_a=sx, scale_b=sw, out_dtype=torch.float32, kernel=kernel)
        assert float((got.cpu() - want).abs().max()) <= 1e-6 * float(want.abs().max())
        wr, sr = quant.quantize_bsr(w.to(cuda), per="block_row")
        wr_c, sr_c = quant.quantize_bsr(w, per="block_row")
        assert torch.equal(sr.cpu(), sr_c) and torch.equal(wr.data.cpu(), wr_c.data)
        bq_c, sb = quant.quantize(torch.from_numpy(rng.standard_normal((1024, 256)).astype(np.float32)))
        got = quant.matmul_dsd_q8(wr, bq_c.to(cuda), scale_a=sr, scale_b=sb, out_dtype=torch.float32, kernel=kernel)
        want = quant.matmul_dsd_q8(wr_c, bq_c, scale_a=sr_c, scale_b=sb, out_dtype=torch.float32, kernel=kernel)
        assert torch.equal(got.cpu(), want)


def test_small_bres_wrappers_raise_on_cuda(cuda):
    """What the new kernels do not take raises; it never falls back."""
    rng = np.random.default_rng(55)
    big = testing.random_bsr(rng, 256, 256, 256 * 256 // 2, BS, device=cuda)
    small = testing.random_bsr(rng, 256, 256, 256 * 256 // 2, 32, device=cuda)
    x = torch.zeros(256, 256, device=cuda)
    with pytest.raises(ValueError, match="block size"):
        bsr_small._dsd_launch(bsr_small.plan_smallblock(small), big, x, torch.empty(256, 256, device=cuda),
                              transpose_sparse=False, transpose_dense=False, out_transposed=False)
    with pytest.raises(ValueError, match="small-block plans"):
        bsr_small.dsd_smallblock(big, x)
    with pytest.raises(ValueError, match="one dtype"):
        bsr_small.dsd_smallblock(small, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="aligned"):
        bsr_small.sdd_smallblock(x[:, 1:129], torch.zeros(128, 256, device=cuda), small)
    with pytest.raises(ValueError, match="K="):
        bsr_small.sdd_smallblock(torch.zeros(256, 8, device=cuda), torch.zeros(8, 256, device=cuda), small)
    with pytest.raises(ValueError, match="block size"):
        bsr_qstream.dsd_bres(small, x)
    with pytest.raises(ValueError, match="one dtype"):
        bsr_qstream.dsd_bres(big, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="out_scale"):
        bsr_dsd.dsd(big.with_data(big.data.to(torch.int8)), x.to(torch.int8), out_dtype=torch.int32, out_scale=2.0)
    with pytest.raises(ValueError, match="int8"):
        quant.matmul_dsd_q8(big, x, scale_a=1.0, scale_b=1.0)


def _held(got, want):
    """fp32 within 1e-4 * max|plain|, bf16 within one bf16 ulp."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    else:
        assert testing.bf16_ulp_excess(got, want) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ta,tb", MODES)
def test_pipelined_matches_plain(cuda, dtype, ta, tb):
    """bsr_dsd_pipelined, DSD and DDS, against the plain versions and twice
    bitwise equal: unordered indices with a batch of 2 sharing one
    topology, and a BSR with empty block-rows and an empty block-column."""
    rng = np.random.default_rng(60)
    m, k, n = 512, 768, 256
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    a = testing.random_bsr(rng, *a_shape, m * k // 3, BS, unordered=True, device=cuda)
    a = a.with_data(_randn(rng, (2,) + tuple(a.data.shape), cuda, dtype))
    b = _randn(rng, (2,) + b_shape, cuda, dtype)
    got = pipe_dsd(a, b, transpose_a=ta, transpose_b=tb)
    assert torch.equal(got, pipe_dsd(a, b, transpose_a=ta, transpose_b=tb))
    _held(got, bsr_dsd.dsd_reference(a, b, transpose_a=ta, transpose_b=tb))
    d = _randn(rng, (2,) + ((k, 384) if ta else (384, k)), cuda, dtype)
    sp = testing.random_bsr(rng, *((n, k) if tb else (k, n)), n * k // 3, BS, unordered=True, device=cuda)
    sp = sp.with_data(_randn(rng, tuple(sp.data.shape), cuda, dtype))
    got = pipe_dds(d, sp, transpose_a=ta, transpose_b=tb, out_dtype=torch.float32)
    assert torch.equal(got, pipe_dds(d, sp, transpose_a=ta, transpose_b=tb, out_dtype=torch.float32))
    _held(got, bsr_dsd.dds_reference(d, sp, transpose_a=ta, transpose_b=tb, out_dtype=torch.float32))
    ragged = testing.bsr_from_blocks(768, 768, [0, 0, 2, 5], [3, 0, 1, 4], rng.standard_normal((4, BS, BS)),
                                     dtype=dtype, device=cuda)
    x = _randn(rng, (256, 768) if tb else (768, 256), cuda, dtype)
    got = pipe_dsd(ragged, x, transpose_a=ta, transpose_b=tb)
    _held(got, bsr_dsd.dsd_reference(ragged, x, transpose_a=ta, transpose_b=tb))
    empty = [2] if ta else [1, 3, 4]
    assert not got.reshape(6, BS, 256)[empty].any()


def test_pipelined_routes_and_first_fit(cuda):
    """variant= and forced_variant launch bsr_dsd_pipelined; the first fit
    keeps the stream kernel."""
    rng = np.random.default_rng(61)
    a = testing.random_bsr(rng, 512, 512, 512 * 512 // 4, BS, dtype=torch.bfloat16, device=cuda)
    b = _randn(rng, (512, 256), cuda, torch.bfloat16)
    bt = b.T.contiguous()
    assert registry.dispatch_name("dsd", a, b) == registry.dispatch_name("dds", bt, a) == "cuda_stream"
    launches = bsr_pipe.LAUNCHES, bsr_dsd.LAUNCHES
    out = ops.matmul_dsd(a, b, variant="cuda_pipelined")
    with registry.forced_variant("cuda_pipelined"):
        out_t = ops.matmul_dds(bt, a)
    torch.cuda.synchronize()
    assert (bsr_pipe.LAUNCHES, bsr_dsd.LAUNCHES) == (launches[0] + 2, launches[1])
    _held(out, reference.dsd(a, b))
    _held(out_t, reference.dds(bt, a))
    ops.matmul_dsd(a, b)
    assert (bsr_pipe.LAUNCHES, bsr_dsd.LAUNCHES) == (launches[0] + 2, launches[1] + 1)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pipe_dsd(a.astype(torch.int8), b.to(torch.int8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_probes_match_plain(cuda, dtype):
    """The three mxu probes against their plain versions, twice bitwise
    equal: dense_stream with and without accumulate (the last step's
    product), resident_stream at two m-tiles, tiled_matmul at every tile."""
    rng = np.random.default_rng(62)
    a, b = _randn(rng, (512, 1024), cuda, dtype), _randn(rng, (1024, 512), cuda, dtype)
    full = mxu_probe.product_reference(a, b)
    runs = [(lambda: mxu_probe.dense_stream(a, b, depth=256), full),
            (lambda: mxu_probe.dense_stream(a, b, depth=256, n_tile=256), full),
            (lambda: mxu_probe.dense_stream(a, b, depth=256, accumulate=False),
             mxu_probe.dense_stream_reference(a, b, depth=256, accumulate=False)),
            (lambda: mxu_probe.resident_stream(a, b, depth=512, mt=128), full),
            (lambda: mxu_probe.resident_stream(a, b, depth=128, mt=256), full)]
    runs += [(lambda c=c: mxu_probe.tiled_matmul(a, b, bm=c[0], bk=c[1], bn=c[2]), full)
             for c in mxu_probe.SWEEP_CONFIGS]
    before = dict(mxu_probe.LAUNCHES)
    for fn, want in runs:
        got = fn()
        assert torch.equal(got, fn())
        _held(got, want)
    assert {k: mxu_probe.LAUNCHES[k] - before[k] for k in before} == {
        "mxu_dense_stream": 6, "mxu_resident_stream": 4, "mxu_tiled_matmul": 2 * len(mxu_probe.SWEEP_CONFIGS)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ta,tb", MODES)
def test_resident_kernels_match_plain(cuda, dtype, ta, tb):
    """bsr_qstream (dsd_q at q 1 / 4 / 8, dds_q, dds_ct), bsr_cres and
    bsr_gres (DSD and DDS) and bsr_sdd_bres (pack 1 and 4) against their
    plain versions, twice bitwise equal: unordered indices, and a BSR with
    empty block-rows, its metadata rebuilt on the card for the q-stream and
    C-resident kernels."""
    rng = np.random.default_rng(63)
    m, k, n = 640, 384, 512
    a_shape, b_shape = _dims(m, k, n, ta, tb)
    a = testing.random_bsr(rng, *a_shape, m * k // 3, BS, unordered=True, device=cuda)
    a = a.with_data(_randn(rng, tuple(a.data.shape), cuda, dtype))
    b = _randn(rng, b_shape, cuda, dtype)
    kw = dict(transpose_a=ta, transpose_b=tb)
    want = bsr_dsd.dsd_reference(a, b, **kw)
    for fn in (lambda: bsr_qstream.dsd_q(a, b, q=1, **kw), lambda: bsr_qstream.dsd_q(a, b, accum="kcat", **kw),
               lambda: bsr_qstream.dsd_q(a, b, q=8, **kw), lambda: bsr_cres.dsd_cres(a, b, **kw),
               lambda: bsr_cres.dsd_gres(a, b, **kw), lambda: bsr_cres.dsd_gres(a, b, group_rows=2, **kw)):
        got = fn()
        assert torch.equal(got, fn())
        _held(got, want)
    sp = testing.random_bsr(rng, *((n, k) if tb else (k, n)), n * k // 3, BS, unordered=True, device=cuda)
    sp = sp.with_data(_randn(rng, tuple(sp.data.shape), cuda, dtype))
    d = _randn(rng, (k, m) if ta else (m, k), cuda, dtype)
    want = bsr_dsd.dds_reference(d, sp, **kw)
    for fn in (bsr_qstream.dds_q, bsr_qstream.dds_ct, bsr_cres.dds_cres, bsr_cres.dds_gres):
        got = fn(d, sp, **kw)
        assert torch.equal(got, fn(d, sp, **kw))
        _held(got, want)
    ragged = testing.bsr_from_blocks(768, 768, [0, 0, 2, 5], [3, 0, 1, 4], rng.standard_normal((4, BS, BS)),
                                     dtype=dtype, device=cuda)
    card = dss_bench.card_built(ragged, False)
    x = _randn(rng, (256, 768) if tb else (768, 256), cuda, dtype)
    want = bsr_dsd.dsd_reference(ragged, x, **kw)
    empty = [2] if ta else [1, 3, 4]
    for got in (bsr_qstream.dsd_q(card, x, **kw), bsr_cres.dsd_cres(card, x, **kw), bsr_cres.dsd_gres(ragged, x, **kw)):
        _held(got, want)
        assert not got.reshape(6, BS, 256)[empty].any()
    t = testing.random_bsr(rng, 384, 512, 384 * 512 // 3, BS, unordered=True, device=cuda)
    xa = _randn(rng, (k, 384) if ta else (384, k), cuda, dtype)
    xb = _randn(rng, (512, k) if tb else (k, 512), cuda, dtype)
    want = reference.sdd(xa, xb, t, **kw).data
    for pack in (1, 4):
        got = bsr_sdd.sdd_bres(xa, xb, t, pack=pack, **kw).data
        assert torch.equal(got, bsr_sdd.sdd_bres(xa, xb, t, pack=pack, **kw).data)
        _held(got, want)


def test_resident_routes_and_autotune(cuda, tmp_path, monkeypatch):
    """Every new variant= name launches its kernel once; the first fits of
    DSD and SDD are unchanged; a winner tuned into a cache under tmp_path
    is dispatched, and clear_cache restores the first fit."""
    monkeypatch.setenv("SPUTNIK_TPU_TORCH_TUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune._reset()  # read the cache from tmp_path, not the one an earlier test's dispatch loaded
    rng = np.random.default_rng(64)
    a = testing.random_bsr(rng, 512, 512, 512 * 512 // 4, BS, dtype=torch.bfloat16, device=cuda)
    b = _randn(rng, (512, 512), cuda, torch.bfloat16)
    t = testing.random_bsr(rng, 512, 512, 512 * 512 // 4, BS, dtype=torch.bfloat16, device=cuda)
    before = (bsr_qstream.QSTREAM_LAUNCHES, dict(bsr_cres.LAUNCHES), bsr_sdd.BRES_LAUNCHES)
    for name in ("cuda_qstream", "cuda_qstream_q2", "cuda_qstream_kcat_q8", "cuda_cres", "cuda_gres"):
        _held(ops.matmul_dsd(a, b, variant=name), reference.dsd(a, b))
    for name in ("cuda_ct", "cuda_qstream_vacc", "cuda_cres", "cuda_gres"):
        _held(ops.matmul_dds(b, a, variant=name), reference.dds(b, a))
    _held(ops.matmul_sdd(b, b, t, transpose_b=True, variant="cuda_bres").data,
          reference.sdd(b, b, t, transpose_b=True).data)
    assert bsr_qstream.QSTREAM_LAUNCHES - before[0] == 5 and bsr_sdd.BRES_LAUNCHES - before[2] == 1
    assert {k: bsr_cres.LAUNCHES[k] - before[1][k] for k in before[1]} == {"bsr_cres": 2, "bsr_gres": 2}
    assert registry.dispatch_name("dsd", a, b) == "cuda_stream"
    assert registry.dispatch_name("sdd", b, b, t, transpose_b=True) == "cuda_output_stationary"
    ops.autotune("dsd", a, b, timings={"cuda_gres": 1.0, "cuda_stream": 2.0})
    assert registry.dispatch_name("dsd", a, b) == "cuda_gres"
    gres = bsr_cres.LAUNCHES["bsr_gres"]
    ops.matmul_dsd(a, b)
    assert bsr_cres.LAUNCHES["bsr_gres"] == gres + 1
    ops.clear_cache()
    assert registry.dispatch_name("dsd", a, b) == "cuda_stream"
    autotune._reset()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ta,tb", MODES)
def test_schedule_kernels_match_plain(cuda, dtype, ta, tb):
    """bsr_panel (DSD and DDS) and bsr_cstack (q 4 / 8, n_tile 256 and the
    default; no transposed A) against their plain versions, twice bitwise
    equal, at JAX's test shapes with unordered indices, and on a BSR with
    empty block-rows and an empty block-column (cstack also on its metadata
    rebuilt on the card); then at the contractions that give the narrow
    panel widths (bf16: 16 at the headline's 4096^2, where cstack runs too,
    8 at K = 8192; fp32: 32 at K = 1024, 8 at 4096)."""
    rng = np.random.default_rng(65)
    kw = dict(transpose_a=ta, transpose_b=tb)
    for (m, k, n), kernels in (((512, 384, 256), [bsr_panel.dsd_panel]),
                               ((640, 384, 512), [] if ta else [
                                   functools.partial(bsr_cstack.dsd_cstack, q=q, n_tile=nt)
                                   for q in (4, 8) for nt in (256, 8192)])):
        a_shape, b_shape = _dims(m, k, n, ta, tb)
        a = testing.random_bsr(rng, *a_shape, m * k // 3, BS, unordered=True, device=cuda)
        a = a.with_data(_randn(rng, tuple(a.data.shape), cuda, dtype))
        b = _randn(rng, b_shape, cuda, dtype)
        want = bsr_dsd.dsd_reference(a, b, **kw)
        for fn in kernels:
            got = fn(a, b, **kw)
            assert torch.equal(got, fn(a, b, **kw))
            _held(got, want)
    sp = testing.random_bsr(rng, *((256, 384) if tb else (384, 256)), 256 * 384 // 3, BS, unordered=True, device=cuda)
    sp = sp.with_data(_randn(rng, tuple(sp.data.shape), cuda, dtype))
    d = _randn(rng, (384, 512) if ta else (512, 384), cuda, dtype)
    got = bsr_panel.dds_panel(d, sp, **kw)
    assert torch.equal(got, bsr_panel.dds_panel(d, sp, **kw))
    _held(got, bsr_dsd.dds_reference(d, sp, **kw))
    ragged = testing.bsr_from_blocks(768, 768, [0, 0, 2, 5], [3, 0, 1, 4], rng.standard_normal((4, BS, BS)),
                                     dtype=dtype, device=cuda)
    x = _randn(rng, (256, 768) if tb else (768, 256), cuda, dtype)
    want = bsr_dsd.dsd_reference(ragged, x, **kw)
    empty = [2] if ta else [1, 3, 4]
    outs = [bsr_panel.dsd_panel(ragged, x, **kw)]
    if not ta:
        outs += [bsr_cstack.dsd_cstack(ragged, x, q=4, **kw),
                 bsr_cstack.dsd_cstack(dss_bench.card_built(ragged, False), x, **kw)]
    for got in outs:
        _held(got, want)
        assert not got.reshape(6, BS, 256)[empty].any()
    y = _randn(rng, (768, 256) if ta else (256, 768), cuda, dtype)
    got = bsr_panel.dds_panel(y, ragged, **kw)
    _held(got, bsr_dsd.dds_reference(y, ragged, **kw))
    assert not got.reshape(256, 6, BS)[:, [1, 3, 4] if tb else [2, 5]].any()
    kind = 0 if dtype == torch.bfloat16 else 1
    wide = [((4096, 4096, 4096), 16), ((1024, 8192, 512), 8)] if kind == 0 else [((512, 1024, 256), 32),
                                                                                   ((1024, 4096, 512), 8)]
    for (m, k, n), width in wide:
        assert bsr_panel._panel_width(kind, n, k, ta, tb) == width == bsr_panel._panel_width(kind, m, k, not tb, not ta)
        a_shape, b_shape = _dims(m, k, n, ta, tb)
        a = testing.random_bsr(rng, *a_shape, m * k // 4, BS, unordered=True, device=cuda)
        a = a.with_data(_randn(rng, tuple(a.data.shape), cuda, dtype))
        b = _randn(rng, b_shape, cuda, dtype)
        want = bsr_dsd.dsd_reference(a, b, **kw)
        kernels = [bsr_panel.dsd_panel]
        if m == 4096 and not ta:
            kernels += [functools.partial(bsr_cstack.dsd_cstack, q=q) for q in (4, 8)]
        for fn in kernels:
            got = fn(a, b, **kw)
            assert torch.equal(got, fn(a, b, **kw))
            _held(got, want)
        sp = testing.random_bsr(rng, *((n, k) if tb else (k, n)), n * k // 4, BS, unordered=True, device=cuda)
        sp = sp.with_data(_randn(rng, tuple(sp.data.shape), cuda, dtype))
        d = _randn(rng, (k, m) if ta else (m, k), cuda, dtype)
        got = bsr_panel.dds_panel(d, sp, **kw)
        assert torch.equal(got, bsr_panel.dds_panel(d, sp, **kw))
        _held(got, bsr_dsd.dds_reference(d, sp, **kw))


def test_schedule_routes_and_tools(cuda, tmp_path, monkeypatch):
    """Each new variant= name launches its kernel exactly once (cuda_panel
    bsr_panel, cuda_cstack* bsr_cstack, cuda_stream_at bsr_dsd_stream,
    xla_gather_bmm none), the first fits are unchanged, and bench.tune and
    bench.headline run with no failure and persist into a cache under
    tmp_path."""
    monkeypatch.setenv("SPUTNIK_TPU_TORCH_TUNE_CACHE", str(tmp_path / "autotune.json"))
    autotune._reset()
    rng = np.random.default_rng(66)
    a = testing.random_bsr(rng, 512, 512, 512 * 512 // 4, BS, dtype=torch.bfloat16, device=cuda)
    b = _randn(rng, (512, 512), cuda, torch.bfloat16)

    def counts():
        return (bsr_panel.LAUNCHES, bsr_cstack.LAUNCHES, bsr_dsd.LAUNCHES)

    for op, args, name, launched in (("dsd", (a, b), "cuda_panel", (1, 0, 0)), ("dds", (b, a), "cuda_panel", (1, 0, 0)),
                                     ("dsd", (a, b), "cuda_cstack", (0, 1, 0)),
                                     ("dsd", (a, b), "cuda_cstack_q4", (0, 1, 0)),
                                     ("dds", (b, a), "cuda_stream_at", (0, 0, 1)),
                                     ("dsd", (a, b), "xla_gather_bmm", (0, 0, 0))):
        before = counts()
        got = registry.dispatch(op, *args, variant=name)
        assert tuple(x - y for x, y in zip(counts(), before)) == launched, name
        _held(got, (reference.dsd if op == "dsd" else reference.dds)(*args))
    assert registry.dispatch_name("dsd", a, b) == "cuda_stream" and registry.dispatch_name("dds", b, a) == "cuda_stream"
    assert tune.run(ds=(512,), ops_=("dsd", "dds")) == 0
    assert len(json.loads((tmp_path / "autotune.json").read_text())["entries"]) == 2
    rows, failures = headline.run(d=512, persist=True)
    assert not failures and {"cuda_panel", "cuda_cstack", "xla_gather_bmm", "cstack_q16"} <= {r["variant"] for r in rows}
    autotune.clear_cache()
    autotune._reset()


# ------------------------------------------------------- distributed slice --
def _ring(topo, s=4):
    from sputnik_tpu_torch import parallel

    return parallel.partition_topology_ring(topo, s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_fold_kernel_matches_plain(cuda, dtype, dh, causal):
    """Every (rank, step) fold of a 4-band ring, the state carried, against
    the plain version (fp32 within 1e-4 * max|plain|; bf16 inputs within
    ATOL, the flash kernels' bound, since p is rounded to bf16 before P V):
    padding-only cells, nonzero block offsets, lanes 1-127 of m / l passed
    through, rows without a real slot kept, twice bitwise equal, and no
    read back from the card."""
    from sputnik_tpu_torch.parallel import attention as pattn

    rng = np.random.default_rng(70 + dh)
    t = 4096
    topo = (attention.causal_block_topology(t, window_blocks=4, dtype=dtype, device=cuda) if causal
            else attention.band_topology(t, 3, dtype=dtype, device=cuda))
    rt = _ring(topo)
    q, k, v = (_randn(rng, (t, dh), cuda, dtype) for _ in range(3))
    qs, ks, vs = q.chunk(4), k.chunk(4), v.chunk(4)
    empty = 0
    for i in range(4):
        state = pattn.initial_state(t // 4, dh, cuda)
        for r in range(4):
            j = (i - r) % 4
            flags = (torch.arange(rt.rows.shape[-1], device=cuda) < rt.valid[i, j]).to(torch.int32)
            args = (qs[i].contiguous(), ks[j].contiguous(), vs[j].contiguous(), rt.rows[i, j], rt.cols[i, j], flags)
            kw = dict(bs=BS, scale=dh ** -0.5, causal=causal, row_offset_blocks=i * rt.band_blocks,
                      col_offset_blocks=j * rt.band_blocks)
            before = fa.LAUNCHES["flash_band_fold"]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = fa.flash_band_fold(*args, state, **kw)
                again = fa.flash_band_fold(*args, state, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert fa.LAUNCHES["flash_band_fold"] == before + 2
            want = fa.flash_band_fold_reference(*args, state, **kw)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            live = want[1][:, 0] > -5e29
            for x, y in ((got[0], want[0]), (got[2][:, 0], want[2][:, 0]), (got[1][live, 0], want[1][live, 0])):
                bound = 1e-4 * max(float(y.abs().max()), 1e-30) if dtype == torch.float32 else ATOL
                assert float((x - y).abs().max()) <= bound
            for x, x0 in zip(got[1:], state[1:]):
                assert torch.equal(x[:, 1:], x0[:, 1:])
            empty += int(int(rt.valid[i, j]) == 0)
            state = got
    assert empty > 0 or not causal  # the window leaves padding-only cells


def test_fold_kernel_refuses(cuda):
    state = tuple(torch.zeros(256, w, device=cuda) for w in (24, 128, 128))
    x = torch.zeros(256, 24, device=cuda)
    slots = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="flash_band_fold: head dim"):
        fa.flash_band_fold(x, x, x, slots, slots, slots, state, bs=BS, scale=1.0)
    y = torch.zeros(256, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="flash_band_fold takes bf16 or fp32"):
        fa.flash_band_fold(y, y, y, slots, slots, slots, state, bs=BS, scale=1.0)


def test_ring_and_sharded_attention_on_card(cuda):
    """The per-rank bodies of ring and sequence-parallel attention, driven
    in turn at S = 4, against single-device flash_block_attention."""
    from sputnik_tpu_torch import parallel
    from sputnik_tpu_torch.parallel import attention as pattn
    from sputnik_tpu_torch.parallel import ring_attention as pring

    rng = np.random.default_rng(75)
    for causal in (True, False):
        topo = (attention.causal_block_topology(2048, window_blocks=4, device=cuda) if causal
                else attention.band_topology(2048, 3, device=cuda))
        q, k, v = (_randn(rng, (2048, 128), cuda, torch.bfloat16) for _ in range(3))
        want = attention.flash_block_attention(q, k, v, topo, causal=causal)
        outs = [pring.ring_block_sparse_attention_sequential(q, k, v, _ring(topo), causal=causal)]
        if not causal:
            outs.append(pring.ring_block_sparse_attention_sequential(q, k, v, _ring(topo), fused=False))
        st = parallel.partition_topology_rows(topo, 4)
        for fused in (True, False):
            outs.append(pattn.sharded_block_sparse_attention_sequential(q, k, v, st, causal=causal, fused=fused))
        for out in outs:
            assert float((torch.cat(out).float() - want.float()).abs().max()) <= ATOL


def test_csr_softmax_on_card_built_transpose(cuda):
    """The raw-CSR softmax of a transpose built on the card (no max_row_nnz
    hint) equals the same softmax on the CPU."""
    from sputnik_tpu_torch.formats import csr_from_dense

    rng = np.random.default_rng(76)
    x = rng.standard_normal((300, 200)).astype(np.float32) * (rng.random((300, 200)) < 0.05)
    x[:, 7] = 0.0  # an empty row of the transpose
    t = csr_from_dense(x, device=cuda).transpose()
    assert t.max_row_nnz is None
    got = csr_ops.sparse_softmax(t, scale=0.5).values
    want = csr_ops.sparse_softmax(csr_from_dense(x, device="cpu").transpose(), scale=0.5).values
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


def test_spans_on_card_share_the_profilers_clock(cuda):
    """The port's spans under a CUDA profiler: every ``sputnik.*``
    annotation starts within 0.5 ms of its stored span's host start, every
    span's device interval is positive and the layers' lie inside their
    parent's, the first token follows the prefills on the card, the device
    counter of kept tokens equals _route's count, and the registry's
    dispatches reach the kernels (``cuda_*``) at d_head 128."""
    import collections

    from sputnik_tpu_torch.utils import tracing

    cfg = tr.TransformerConfig(d_model=256, n_heads=2, seq_len=512, window_blocks=2, n_experts=2,
                               d_ff=128, n_layers=2, vocab=128)
    model = tr.init_lm_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (cfg.seq_len,), generator=g, device=cuda)
    prompts = torch.randint(0, cfg.vocab, (2, 256), generator=g, device=cuda)
    tr.lm_loss(model, tokens, cfg).backward()
    kept = []
    route = moe._route

    def counting_route(logits, c):
        out = route(logits, c)
        kept.append(out[1].sum())
        return out

    start = tracing.position()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    moe._route = counting_route
    try:
        with torch.profiler.profile(activities=acts) as prof:
            tr.lm_loss(model, tokens, cfg).backward()
            tr.lm_generate_batched(model, prompts, cfg, 4, max_len=512)
            torch.cuda.synchronize()
    finally:
        moe._route = route
    w = tracing.since(start)
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX) and e.device_type() == torch.autograd.DeviceType.CPU:
            events[e.name()[len(tracing.PREFIX):]].append(e.start_ns())
    stored = collections.defaultdict(list)
    for s in w.spans:
        stored[s.name].append(s.start.ns)
    assert set(stored) == {"loss", "attention", "moe", "attention.backward", "moe.backward", "generate",
                           "prefill", "decode_step"}
    for name, starts in stored.items():
        assert len(events[name]) == len(starts), name
        worst = max(abs(a - b) for a, b in zip(sorted(starts), sorted(events[name])))
        assert worst <= 0.5e6, (name, worst)
    by_id = {s.id: s for s in w.spans}
    for s in w.spans:
        assert s.device_ms() > 0, s.name
        up = by_id.get(s.parent)
        if up is not None and not s.name.endswith(".backward"):
            assert tracing.elapsed_ms(up.start, s.start) >= 0 and tracing.elapsed_ms(s.end, up.end) >= 0
    gen, = [s for s in w.spans if s.name == "generate"]
    mark, = w.marks
    prefill_ms = sum(s.device_ms() for s in w.spans if s.name == "prefill")
    assert prefill_ms <= tracing.elapsed_ms(gen.start, mark.at) <= gen.device_ms()
    assert w.counters["moe.tokens_kept"] == int(sum(kept))
    assert any(k.startswith("dispatch.") and k.rsplit(".", 1)[1].startswith("cuda_") for k in w.counters)
