"""The port's attention and MoE modules against the JAX package, in fp32 on
the CPU, with numpy-seeded inputs fed to both. JAX's attention reaches its
Pallas SDD / DSD kernels (interpret mode) at these shapes: d_head = 128 and
band density below the densify threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.models import attention as jattn
from sputnik_tpu.models import moe as jmoe
from sputnik_tpu_torch.models import attention, moe
from sputnik_tpu_torch.models.convert import load_numpy_


def _same_topology(t, j):
    for name in ("offsets", "indices", "row_indices"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.shape == j.shape and t.nnz_blocks == j.nnz_blocks


@pytest.mark.parametrize("kind", ["causal", "band", "band_global"])
def test_topologies_match_jax(kind):
    if kind == "causal":
        t = attention.causal_block_topology(1024, window_blocks=4, device="cpu")
        j = jattn.causal_block_topology(1024, window_blocks=4)
    else:
        g = 1 if kind == "band_global" else 0
        t = attention.band_topology(1024, 2, global_blocks=g, device="cpu")
        j = jattn.band_topology(1024, 2, global_blocks=g)
    _same_topology(t, j)


def test_block_diag_topology_matches_jax():
    kw = dict(d_model=256, d_ff=256, n_experts=4, capacity=256)
    _same_topology(moe.block_diag_topology(moe.MoEConfig(**kw), device="cpu"),
                   jmoe.block_diag_topology(jmoe.MoEConfig(**kw)))


def test_multihead_attention_matches_jax(rng):
    h, t, dh = 2, 512, 128
    q, k, v = (rng.standard_normal((h, t, dh)).astype(np.float32) for _ in range(3))
    jt = jattn.causal_block_topology(t, window_blocks=2, dtype=jnp.float32)
    tt = attention.causal_block_topology(t, window_blocks=2, dtype=torch.float32, device="cpu")
    expected = np.asarray(jattn.multihead_block_sparse_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jt, causal=True))
    out = attention.multihead_block_sparse_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tt, causal=True)
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-5)
    one = attention.block_sparse_attention(
        torch.from_numpy(q[0]), torch.from_numpy(k[0]), torch.from_numpy(v[0]), tt, causal=True)
    np.testing.assert_allclose(one.numpy(), expected[0], atol=1e-5)


@pytest.mark.parametrize("pos", [0, 130, 383, 511])
def test_decode_band_attention_matches_jax(rng, pos):
    b, h, t, dh = 2, 2, 512, 128
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(2))
    jfn = jax.vmap(lambda q1, k1, v1: jattn.decode_band_attention(q1, k1, v1, 2, pos))
    expected = np.asarray(jfn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc)))
    out = attention.decode_band_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), 2, pos)
    np.testing.assert_allclose(out.numpy(), expected, atol=1e-5)


@pytest.fixture(scope="module")
def moe_pair():
    kw = dict(d_model=256, d_ff=128, n_experts=4, capacity=128)
    jcfg = jmoe.MoEConfig(dtype=jnp.float32, **kw)
    tcfg = moe.MoEConfig(dtype=torch.float32, **kw)
    jparams = jmoe.init_moe_params(jax.random.PRNGKey(3), jcfg)
    tparams = load_numpy_(moe.MoE(tcfg, device="cpu"), jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("tokens", [256, 640])  # 640 overflows capacity: drops
def test_moe_forward_matches_jax(rng, moe_pair, tokens):
    jcfg, jparams, tcfg, tparams = moe_pair
    x = rng.standard_normal((tokens, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg, jmoe.block_diag_topology(jcfg))
    ty, taux = moe.moe_forward(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_moe_one_matches_routed_forward(rng, moe_pair):
    """Per-token decode MoE equals moe_forward when nothing is dropped."""
    _, _, tcfg, tparams = moe_pair
    x = torch.from_numpy(rng.standard_normal((64, tcfg.d_model)).astype(np.float32))
    y, _ = moe.moe_forward(tparams, x, tcfg)
    torch.testing.assert_close(moe.moe_one(tparams, x.reshape(8, 8, -1), tcfg).reshape(64, -1), y)


def test_load_numpy_rejects_wrong_keys(moe_pair):
    _, jparams, tcfg, _ = moe_pair
    tree = dict(jax.tree.map(np.asarray, jparams))
    tree.pop("router")
    with pytest.raises(ValueError, match="missing"):
        load_numpy_(moe.MoE(tcfg, device="cpu"), tree)
