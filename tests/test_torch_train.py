"""The port's training step against the JAX package, in fp32 on the CPU.

The JAX parameters go to the port through ``params_from_numpy``, at
tests/test_torch_lm.py's configuration (d_head 128, so JAX's attention
reaches its Pallas kernels in interpret mode). For both attention routes
(unfused SDD -> softmax -> DSD, and ``fused_attention`` through flash_mha):
``lm_loss`` within 1e-5 relative, and every parameter's gradient within
1e-3 * max|g_jax| + 1e-6 of ``jax.value_and_grad(lm_loss)``. Adam steps
are checked to lower the loss (tests/test_transformer.py's claim), not
compared with optax element-wise: Adam's first step is about +-lr per
element whatever the gradient's size, so summation-order noise in
near-zero gradients would show at full scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.models import moe as jmoe
from sputnik_tpu.models import transformer as jtr
from sputnik_tpu_torch.models import moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.models.convert import flatten_tree, grads_to_numpy, load_numpy_, params_from_numpy

CFG = dict(d_model=256, n_heads=2, seq_len=512, window_blocks=2, n_experts=2,
           d_ff=128, n_layers=2, vocab=128)


def _assert_grads_match(port: dict, jax_tree) -> None:
    want = {k: np.asarray(v) for k, v in flatten_tree(jax_tree).items()}
    assert set(port) == set(want)
    for name, g in want.items():
        bound = 1e-3 * float(np.abs(g).max()) + 1e-6
        err = float(np.abs(port[name] - g).max())
        assert err <= bound, f"{name}: max |port - jax| = {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **CFG)
    jparams = jtr.init_lm_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(12).integers(0, CFG["vocab"], CFG["seq_len"]).astype(np.int32)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams), tokens


@pytest.mark.parametrize("fused", [False, True])
def test_lm_loss_and_grads_match_jax(lm_setup, fused):
    jcfg, jparams, np_params, tokens = lm_setup
    jcfg = dataclasses.replace(jcfg, fused_attention=fused)
    tcfg = tr.TransformerConfig(dtype=torch.float32, fused_attention=fused, **CFG)
    jloss, jgrads = jax.value_and_grad(jtr.lm_loss)(jparams, jnp.asarray(tokens), jcfg)
    lm = params_from_numpy(np_params, tcfg)
    loss = tr.lm_loss(lm, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    _assert_grads_match(grads_to_numpy(lm), jgrads)


@pytest.mark.parametrize("tokens", [256, 640])  # 640 overflows capacity: drops
def test_moe_loss_grads_match_jax(tokens):
    kw = dict(d_model=256, d_ff=128, n_experts=4, capacity=128)
    jcfg, tcfg = jmoe.MoEConfig(dtype=jnp.float32, **kw), moe.MoEConfig(dtype=torch.float32, **kw)
    jparams = jmoe.init_moe_params(jax.random.PRNGKey(1), jcfg)
    tparams = load_numpy_(moe.MoE(tcfg), jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(13)
    x, target = (rng.standard_normal((tokens, 256)).astype(np.float32) for _ in range(2))
    jloss, (jgp, jgx) = jax.value_and_grad(jmoe.moe_loss, argnums=(0, 1))(
        jparams, jnp.asarray(x), jnp.asarray(target), jcfg, jmoe.block_diag_topology(jcfg))
    tx = torch.from_numpy(x).requires_grad_()
    loss = moe.moe_loss(tparams, tx, torch.from_numpy(target), tcfg)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    _assert_grads_match(grads_to_numpy(tparams), jgp)
    _assert_grads_match({"x": tx.grad.numpy()}, {"x": jgx})


@pytest.mark.parametrize("fused", [False, True])
def test_adam_steps_lower_the_loss(lm_setup, fused):
    """examples/sparse_transformer_lm.py's loop with torch.optim.Adam (the
    update rule of optax.adam), lr 3e-3, five steps."""
    _, _, np_params, tokens = lm_setup
    tcfg = tr.TransformerConfig(dtype=torch.float32, fused_attention=fused, **CFG)
    lm = params_from_numpy(np_params, tcfg)
    topos = tr.lm_topologies(tcfg)
    opt = torch.optim.Adam(lm.parameters(), lr=3e-3)
    toks = torch.from_numpy(tokens)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = tr.lm_loss(lm, toks, tcfg, topos)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_serving_builds_no_graph(lm_setup):
    """Parameters are trainable, but prefill, decoding and batched
    generation run under no_grad."""
    _, _, np_params, tokens = lm_setup
    tcfg = tr.TransformerConfig(dtype=torch.float32, fused_attention=True, **CFG)
    lm = params_from_numpy(np_params, tcfg)
    assert all(p.requires_grad for p in lm.parameters())
    prompt = torch.from_numpy(tokens[:256])
    caches, logits = tr.lm_prefill(lm, prompt, tcfg, CFG["seq_len"])
    assert not logits.requires_grad and not caches[0]["k"].requires_grad
    logits, _ = tr.lm_decode_step(lm, prompt[-1], caches, 256, tcfg)
    assert not logits.requires_grad
    out = tr.lm_generate_batched(lm, prompt[None], tcfg, 2)
    assert out.shape == (1, 2) and out.grad_fn is None
