"""The port on a CUDA card: the Hopper kernels against their plain versions,
the registry's CUDA routing, the small LM through the kernels against
the same LM on the CPU (serving logits, and training gradients on both
attention routes), and the MoE paths: the fused FFN kernels, metadata
built on the card without a device read, and every MoE forward and the
fused paths' gradients against the CPU.

Every test here is marked ``gpu`` and skips without a card. The file imports
no jax, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_ffn, bsr_sdd, reference
from sputnik_tpu_torch.kernels import flash_mha as fm
from sputnik_tpu_torch.models import attention, moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.models.convert import grads_to_numpy
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing
from sputnik_tpu_torch.utils.testing import ATOL

pytestmark = pytest.mark.gpu

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]


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


def test_registry_routes_cuda_to_kernels(cuda):
    rng = np.random.default_rng(1)
    a = testing.random_bsr(rng, 512, 512, 512 * 512 // 4, BS, dtype=torch.bfloat16, device=cuda)
    b = _randn(rng, (512, 256), cuda, torch.bfloat16)
    assert registry.dispatch_name("dsd", a, b) == "cuda_stream"
    assert registry.dispatch_name("dds", b.T.contiguous(), a) == "cuda_stream"
    assert registry.dispatch_name("sdd", b.T.contiguous(), b.T.contiguous(), a, transpose_b=True) \
        == "cuda_output_stationary"
    # A CUDA problem the kernel does not take raises; it never falls back.
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.dsd(a, b[:, :64].contiguous())
    with pytest.raises(ValueError, match="one dtype"):
        ops.dsd(a, b.float())


def test_small_lm_on_card_matches_cpu(cuda):
    """The small LM through the kernels on the card against the same weights
    through the plain versions on the CPU, fp32: logits and greedy tokens."""
    cfg = tr.TransformerConfig(d_model=256, n_heads=2, seq_len=512, window_blocks=2, n_experts=2,
                               d_ff=128, n_layers=2, vocab=128, dtype=torch.float32)
    cpu = tr.init_lm_params(cfg, torch.Generator().manual_seed(0))
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
    q = torch.zeros(2, 256, 64, device=cuda, dtype=torch.bfloat16)
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
    cpu = tr.init_lm_params(cfg, torch.Generator().manual_seed(0))
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
    cpu = moe.init_moe_params(cfg, torch.Generator().manual_seed(0))
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
