"""The port's sparse LM serving slice against the JAX package.

One configuration with d_head = 128 and prompt density 0.75, so that the JAX
side dispatches its Pallas SDD / DSD kernels (interpret mode) at the
sequence and prompt lengths: the JAX parameters are carried over through
``params_from_numpy`` and both packages run in fp32 on the CPU. Logits are
held at atol 2e-3 (tests/test_transformer.py's decode bound); greedy tokens
must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.models import transformer as jtr
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.models.convert import params_from_numpy

CFG = dict(d_model=256, n_heads=2, seq_len=512, window_blocks=2, n_experts=2,
           d_ff=128, n_layers=2, vocab=128)
PROMPT = 256


@pytest.fixture(scope="module")
def models():
    jcfg = jtr.TransformerConfig(dtype=jnp.float32, **CFG)
    tcfg = tr.TransformerConfig(dtype=torch.float32, **CFG)
    jparams = jtr.init_lm_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    tokens = np.random.default_rng(11).integers(0, CFG["vocab"], (2, CFG["seq_len"])).astype(np.int32)
    return jcfg, jparams, tcfg, tparams, tokens


def test_lm_forward_matches_jax(models):
    jcfg, jparams, tcfg, tparams, tokens = models
    jlogits, jaux = jtr.lm_forward(jparams, jnp.asarray(tokens[0]), jcfg)
    tlogits, taux = tr.lm_forward(tparams, torch.from_numpy(tokens[0]), tcfg)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (CFG["seq_len"], CFG["vocab"])
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=2e-3)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_lm_prefill_matches_jax(models):
    jcfg, jparams, tcfg, tparams, tokens = models
    jcaches, jlogits = jtr.lm_prefill(jparams, jnp.asarray(tokens[0, :PROMPT]), jcfg, CFG["seq_len"])
    tcaches, tlogits = tr.lm_prefill(tparams, torch.from_numpy(tokens[0, :PROMPT]), tcfg, CFG["seq_len"])
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=2e-3)
    for tc, jc in zip(tcaches, jcaches):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), atol=1e-4)


def test_lm_generate_batched_matches_jax(models):
    jcfg, jparams, tcfg, tparams, tokens = models
    prompts = tokens[:, :PROMPT]
    expected = np.asarray(jtr.lm_generate_batched(jparams, jnp.asarray(prompts), jcfg, 8))
    out = tr.lm_generate_batched(tparams, torch.from_numpy(prompts), tcfg, 8)
    assert out.shape == (2, 8)
    np.testing.assert_array_equal(out.numpy(), expected)
    np.testing.assert_array_equal(tr.lm_generate(tparams, torch.from_numpy(prompts[1]), tcfg, 8).numpy(),
                                  expected[1])


def test_decode_step_matches_full_forward(models):
    """Teacher-forced band decoding reproduces the full forward's logits
    (the JAX package's decode == forward contract, in the port alone). The
    capacity holds every token, so the full forward drops none."""
    _, _, tcfg, tparams, tokens = models
    tcfg = dataclasses.replace(tcfg, capacity=CFG["seq_len"])
    seq = torch.from_numpy(tokens[1])
    full, _ = tr.lm_forward(tparams, seq, tcfg)
    caches, _ = tr.lm_prefill(tparams, seq[:PROMPT], tcfg, CFG["seq_len"])
    for pos in range(PROMPT, PROMPT + 4):
        logits, caches = tr.lm_decode_step(tparams, seq[pos], caches, pos, tcfg)
        np.testing.assert_allclose(logits.numpy(), full[pos].detach().numpy(), atol=2e-3)
