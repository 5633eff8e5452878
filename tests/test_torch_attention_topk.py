"""The port's content-routed attention, single-head flash attention and
top-k / sampled serving against the JAX package, in fp32 on the CPU.

The same numpy inputs go through both packages; JAX's Pallas kernels run
in interpret mode. Topology metadata and greedy tokens must be equal;
attention outputs and gradients agree within 1e-4 (ROADMAP.md section 3).
Sampling cannot draw JAX's bits from a ``torch.Generator``, so it is held
by its properties: the same seed gives the same tokens, a temperature
going to 0 gives the greedy tokens, and the draws' frequencies match
``softmax(logits / T)``.

A duplicated (row, column) block: JAX's ``flash_mha`` counts it once (its
pair plan takes ``np.unique``), its ``flash_block_attention`` and unfused
chain count every stored block. The port's ``flash_mha`` equals the
former, its ``flash_block_attention`` and chain the latter.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.kernels.flash_attention import flash_block_attention as jflash_block
from sputnik_tpu.kernels.flash_mha import flash_mha as jflash_mha
from sputnik_tpu.models import attention as jattn
from sputnik_tpu.models import transformer as jtr
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch.kernels import flash_mha as fm
from sputnik_tpu_torch.models import attention
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.models.convert import params_from_numpy
from sputnik_tpu_torch.utils import testing

BS = 128
TOL = 1e-4
# The modules (each package's ``ops.matmul`` name is its function).
jmatmul = importlib.import_module("sputnik_tpu.ops.matmul")
matmul = importlib.import_module("sputnik_tpu_torch.ops.matmul")


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("include_local", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,tk", [(512, 512), (256, 512)])
def test_topk_block_topology_matches_jax(t, tk, causal, include_local):
    rng = np.random.default_rng(t + tk + 2 * causal + include_local)
    q, k = rng.standard_normal((t, 64)).astype(np.float32), rng.standard_normal((tk, 64)).astype(np.float32)
    want = jattn.topk_block_topology(jnp.asarray(q), jnp.asarray(k), 2, causal=causal, include_local=include_local)
    got = attention.topk_block_topology(_t(q), _t(k), 2, causal=causal, include_local=include_local)
    for name in ("offsets", "indices", "row_indices"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert got.shape == tuple(want.shape) and tuple(got.data.shape) == tuple(want.data.shape)
    assert (got.max_row_nnz, got.max_col_nnz) == (want.max_row_nnz, want.max_col_nnz) == (2, t // BS)
    assert got.dtype == torch.float32 and not got.data.any()


@pytest.mark.parametrize("valid_len", [None, 300])
def test_decode_topk_attention_matches_jax(valid_len):
    """Two heads, each choosing its own pages from its own cache."""
    rng = np.random.default_rng(6)
    h, t, dh = 2, 512, 64
    q = rng.standard_normal((h, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((h, t, dh)).astype(np.float32) for _ in range(2))
    for k_blocks in (1, 2, 4):
        want = jattn.decode_topk_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), k_blocks,
                                           valid_len=valid_len)
        got = attention.decode_topk_attention(_t(q), _t(kc), _t(vc), k_blocks, valid_len=valid_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=1e-5)
    # A batch axis in front of the heads: each query on its own cache.
    got = attention.decode_topk_attention(_t(np.stack([q, q[::-1]])), _t(np.stack([kc, kc[::-1]])),
                                          _t(np.stack([vc, vc[::-1]])), 2, valid_len=valid_len)
    one = attention.decode_topk_attention(_t(q[::-1].copy()), _t(kc[::-1].copy()), _t(vc[::-1].copy()), 2,
                                          valid_len=valid_len)
    torch.testing.assert_close(got[1], one, atol=1e-6, rtol=0)


@pytest.mark.parametrize("block", [64, 128])
def test_kernel_predicates_match_jax(block):
    """Fault 1: the CUDA DSD / DDS / SDD predicates take what the JAX
    package's Pallas predicate (``_pallas_ok``) takes, so a head dim of 64
    goes to the densify detour as in JAX; the flash kernels are built for
    the repo's head dims 64 and 128."""
    jm = jtesting.random_bsr(np.random.default_rng(1), 512, 512, 512 * 512 // 4, block)
    tm = testing.random_bsr(np.random.default_rng(1), 512, 512, 512 * 512 // 4, block, device="cpu")
    for dim in (64, 128, 192, 256):
        for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)):
            want = jmatmul._pallas_ok(jm, dense_dims=(dim,), dtypes=(jdt, jnp.float32))
            assert matmul._kernel_ok(tm, dim, tdt, torch.float32) == want, (block, dim, tdt)
    assert {64, 128} <= set(fm.HEAD_DIMS)


def _flash_cases(kind):
    """(jax topology, port topology, causal)."""
    if kind == "causal_band":
        return (jattn.causal_block_topology(512, BS, window_blocks=2, dtype=jnp.float32),
                attention.causal_block_topology(512, BS, window_blocks=2, dtype=torch.float32, device="cpu"), True)
    args = (384, 512, [0, 0, 2], [3, 0, 0], np.ones((3, BS, BS), np.float32))  # an empty row, empty columns
    return jtesting.bsr_from_blocks(*args), testing.bsr_from_blocks(*args, device="cpu"), False


def _card_style(m):
    """``m`` as metadata built on the card holds it: no host copies."""
    return dataclasses.replace(m, host_offsets=None, host_indices=None)


@pytest.mark.parametrize("fused_backward", [True, False])
@pytest.mark.parametrize("kind", ["causal_band", "empty_row_col"])
def test_flash_block_attention_matches_jax(kind, fused_backward):
    jtopo, ttopo, causal = _flash_cases(kind)
    rng = np.random.default_rng(7)
    t, tk = ttopo.shape
    q, g = (rng.standard_normal((t, 128)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((tk, 128)).astype(np.float32) for _ in range(2))

    def jloss(*xs):
        out = jflash_block(*xs, jtopo, causal=causal, fused_backward=fused_backward)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = attention.flash_block_attention(*xs, _card_style(ttopo), causal=causal, fused_backward=fused_backward)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL)
    for x, want in zip(xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=TOL)


def test_fused_attention_routes_by_host_metadata():
    """block_sparse_attention(fused=True) on card-style metadata (not
    host-known) runs flash_block_attention and equals JAX's traced route
    (flash_block_attention); on host-known metadata it runs flash_mha."""
    jtopo, ttopo, _ = _flash_cases("causal_band")
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((512, 128)).astype(np.float32) for _ in range(3))
    want = jflash_block(*(jnp.asarray(x) for x in (q, k, v)), jtopo, causal=True)
    for topo in (_card_style(ttopo), ttopo):
        got = attention.block_sparse_attention(_t(q), _t(k), _t(v), topo, causal=True, fused=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    heads = attention.multihead_block_sparse_attention(_t(np.stack([q, v])), _t(np.stack([k, k])),
                                                       _t(np.stack([v, q])), _card_style(ttopo), causal=True,
                                                       fused=True)
    np.testing.assert_allclose(heads[0].numpy(), np.asarray(want), atol=TOL)


def test_duplicated_block_flash_mha_matches_jax():
    """One (row, column) block stored twice. JAX's flash_mha counts it once;
    its flash_block_attention and unfused chain count it twice, and so do
    the port's. The port's flash_mha equals JAX's forward, and its gradient
    is the gradient of the chain on the topology with the duplicate merged."""
    rows, cols = [0, 0, 1, 1, 1], [0, 1, 0, 1, 1]  # (1, 1) twice
    dup_args = (256, 256, rows, cols, np.ones((5, BS, BS), np.float32))
    merged_args = (256, 256, rows[:4], cols[:4], np.ones((4, BS, BS), np.float32))
    jdup, tdup = jtesting.bsr_from_blocks(*dup_args), testing.bsr_from_blocks(*dup_args, device="cpu")
    jmerged = jtesting.bsr_from_blocks(*merged_args)
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.standard_normal((256, 128)).astype(np.float32) for _ in range(4))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jax_mha = np.asarray(jflash_mha(jq[None], jk[None], jv[None], jdup)[0])
    jax_block = np.asarray(jflash_block(jq, jk, jv, jdup))
    jax_chain = np.asarray(jattn.block_sparse_attention(jq, jk, jv, jdup))
    assert np.abs(jax_mha - jax_chain).max() > 1e-2  # the duplicate matters
    np.testing.assert_allclose(jax_block, jax_chain, atol=TOL)
    np.testing.assert_allclose(jax_mha, np.asarray(jattn.block_sparse_attention(jq, jk, jv, jmerged)), atol=TOL)

    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    got = fm.flash_mha(*(x[None] for x in xs), tdup)[0]
    np.testing.assert_allclose(got.detach().numpy(), jax_mha, atol=TOL)
    (got * _t(g)).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(jattn.block_sparse_attention(*a, jmerged) * g), argnums=(0, 1, 2))(jq, jk, jv)
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=TOL)
    port_chain = attention.block_sparse_attention(_t(q), _t(k), _t(v), tdup)
    np.testing.assert_allclose(port_chain.numpy(), jax_chain, atol=TOL)
    np.testing.assert_allclose(attention.flash_block_attention(_t(q), _t(k), _t(v), tdup).numpy(), jax_block,
                               atol=TOL)


# -------------------------------------------------------------- serving --
CFG = dict(d_model=128, n_heads=2, seq_len=512, window_blocks=2, n_experts=2, d_ff=128, n_layers=1, vocab=64)
PROMPT = 256


@pytest.fixture(scope="module")
def lm():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **CFG)
    tcfg = tr.TransformerConfig(dtype=torch.float32, **CFG)
    jparams = jtr.init_lm_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    prompts = np.random.default_rng(13).integers(0, CFG["vocab"], (2, PROMPT)).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, prompts


def test_generate_topk_matches_jax(lm):
    """Greedy top-k serving (k_pages 2 among the valid cache pages): the
    tokens equal JAX's, batched and for one prompt."""
    jcfg, jparams, tcfg, tparams, prompts = lm
    want = np.asarray(jtr.lm_generate_batched(jparams, jnp.asarray(prompts), jcfg, 6, mode="topk", k_pages=2))
    got = tr.lm_generate_batched(tparams, _t(prompts), tcfg, 6, mode="topk", k_pages=2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tr.lm_generate(tparams, _t(prompts[1]), tcfg, 6, mode="topk",
                                                 k_pages=2).numpy(), want[1])
    with pytest.raises(ValueError, match="'band' or 'topk'"):
        tr.lm_generate(tparams, _t(prompts[0]), tcfg, 2, mode="pages")


def test_topk_decode_step_matches_jax(lm):
    """One top-k decode step's logits (k_pages defaults to window_blocks)."""
    jcfg, jparams, tcfg, tparams, prompts = lm
    jcaches, _ = jtr.lm_prefill(jparams, jnp.asarray(prompts[0]), jcfg, CFG["seq_len"])
    tcaches, _ = tr.lm_prefill(tparams, _t(prompts[0]), tcfg, CFG["seq_len"])
    jlogits, _ = jtr.lm_decode_step(jparams, jnp.int32(5), jcaches, jnp.int32(PROMPT), jcfg, mode="topk")
    logits, _ = tr.lm_decode_step(tparams, torch.tensor(5), tcaches, PROMPT, tcfg, mode="topk")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-3)


def test_sampling_properties(lm):
    """Sampling at temperature > 0: the same seed gives the same tokens, a
    temperature going to 0 gives the greedy tokens, and sampling without a
    generator raises (JAX raises without a key)."""
    _, _, tcfg, tparams, prompts = lm
    p = _t(prompts)

    def run(seed, temperature, mode="band"):
        return tr.lm_generate_batched(tparams, p, tcfg, 6, mode=mode, k_pages=2, temperature=temperature,
                                      generator=torch.Generator().manual_seed(seed))

    for mode in ("band", "topk"):
        greedy = tr.lm_generate_batched(tparams, p, tcfg, 6, mode=mode, k_pages=2)
        assert torch.equal(run(0, 0.8, mode), run(0, 0.8, mode))
        assert torch.equal(run(1, 1e-6, mode), greedy)
    assert not torch.equal(run(0, 5.0), run(1, 5.0))
    with pytest.raises(ValueError, match="Generator"):
        tr.lm_generate_batched(tparams, p, tcfg, 2, temperature=0.8)


def test_sample_frequencies_match_softmax():
    """20000 draws from fixed logits over 8 tokens: each token's frequency
    within 0.015 of softmax(logits / T) (about 5 standard deviations)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2])
    gen = torch.Generator().manual_seed(4)
    for temperature in (0.5, 1.0, 2.0):
        draws = tr.sample_tokens(logits.expand(20000, 8), temperature, gen)
        freq = torch.bincount(draws, minlength=8).float() / 20000
        want = torch.softmax(logits / temperature, dim=0)
        assert float((freq - want).abs().max()) <= 0.015, (temperature, freq, want)
