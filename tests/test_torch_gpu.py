"""The port on a CUDA card: the Hopper kernels against their plain versions,
the registry's CUDA routing, and the small LM through the kernels against
the same LM on the CPU.

Every test here is marked ``gpu`` and skips without a card. The file imports
no jax, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from sputnik_tpu_torch import ops
from sputnik_tpu_torch.kernels import bsr_dsd, bsr_sdd, reference
from sputnik_tpu_torch.models import transformer as tr
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
