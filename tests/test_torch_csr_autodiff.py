"""Gradients through the port's CSR engine (the autograd Functions of
``ops/csr.py``) against ``jax.grad`` through the JAX package's custom VJPs,
in fp32 on the CPU with numpy-seeded inputs fed to both. JAX runs its SELL
Pallas kernels in interpret mode; the port's backwards run the kernels'
plain versions on CPU tensors. Every gradient within 1e-3 * max|g| + 1e-6
of JAX's (fp32, different summation orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import formats as jformats
from sputnik_tpu.ops import csr as jcsr
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import formats
from sputnik_tpu_torch.ops import csr
from sputnik_tpu_torch.utils import testing


def _sell_pair(seed, rows, cols, density, **kw):
    nnz = int(rows * cols * density)
    jm = jtesting.random_csr(np.random.default_rng(seed), rows, cols, nnz)
    tm = testing.random_csr(np.random.default_rng(seed), rows, cols, nnz, device="cpu")
    return jformats.SellMatrix.from_csr(jm, **kw), formats.SellMatrix.from_csr(tm, **kw)


def _inputs(rng, *shapes):
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a).requires_grad_() for a in arrays]


def _grad_close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3 * float(np.abs(want).max()) + 1e-6, rtol=0)


@pytest.mark.parametrize("sort_rows,chunk", [(False, 128), (True, 64)])
def test_spmm_grads_match_jax(sort_rows, chunk):
    j, t = _sell_pair(1, 256, 200, 0.1, chunk=chunk, sort_rows=sort_rows)
    (jb, jw), (tb, tw) = _inputs(np.random.default_rng(2), (200, 64), (256, 64))
    gs, gb = jax.grad(lambda s, b: jnp.sum(jcsr.spmm(s, b) * jw), argnums=(0, 1), allow_int=True)(j, jb)
    values = t.values.clone().requires_grad_()
    (csr.spmm(t.with_values(values), tb) * tw.detach()).sum().backward()
    _grad_close(values.grad, gs.values)
    _grad_close(tb.grad, gb)
    assert not values.grad[~t.valid_mask()].any()  # the pattern keeps its zeros


def test_sddmm_grads_match_jax():
    j, t = _sell_pair(3, 256, 200, 0.08, sort_rows=True)
    (ja, jb), (ta, tb) = _inputs(np.random.default_rng(4), (256, 64), (200, 64))
    ga, gb = jax.grad(lambda a, b: jnp.sum(jcsr.sddmm(a, b, j).values ** 2), argnums=(0, 1))(ja, jb)
    (csr.sddmm(ta, tb, t).values ** 2).sum().backward()
    _grad_close(ta.grad, ga)
    _grad_close(tb.grad, gb)


@pytest.mark.parametrize("variant", ["jnp", "pallas"])
def test_attention_chain_grads_match_jax(variant):
    """sddmm -> sparse_softmax -> spmm, through both softmax variants."""
    j, t = _sell_pair(5, 256, 256, 0.08)
    (jq, jk, jv), (tq, tk, tv) = _inputs(np.random.default_rng(6), *[(256, 64)] * 3)
    if variant == "pallas":
        # JAX's pallas softmax leaks a tracer under jax.grad when it reads
        # slot_counts of sddmm's output; its sentinel kernel computes the
        # same function (the port's kernel reads slot_counts).
        j = dataclasses.replace(j, slot_counts=None)

    def jloss(q, k, v):
        p = jcsr.sparse_softmax(jcsr.sddmm(q, k, j), scale=0.125, variant=variant)
        return jnp.sum(jcsr.spmm(p, v) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    p = csr.sparse_softmax(csr.sddmm(tq, tk, t), scale=0.125, variant=variant)
    (csr.spmm(p, tv) ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _grad_close(got, w)


@pytest.mark.parametrize("variant", ["jnp", "pallas"])
def test_softmax_grads_match_jax(variant):
    """The softmax alone: the pallas variant's hand-written backward and the
    chain's autograd, on values with padding slots."""
    j, t = _sell_pair(7, 200, 300, 0.1, sort_rows=True)
    w = np.random.default_rng(8).standard_normal(tuple(t.values.shape)).astype(np.float32)
    gv = jax.grad(lambda v: jnp.sum(jcsr.sparse_softmax(j.with_values(v), scale=0.5, variant=variant).values
                                    * jnp.asarray(w)))(j.values)
    values = t.values.clone().requires_grad_()
    (csr.sparse_softmax(t.with_values(values), scale=0.5, variant=variant).values * torch.from_numpy(w)).sum().backward()
    _grad_close(values.grad, gv)
    assert not values.grad[~t.valid_mask()].any()


def test_finetune_steps_keep_the_pattern():
    """examples/sparse_finetune.py part 1 in small: SGD on the values through
    spmm lowers the loss at every step and keeps the sparsity pattern."""
    _, t = _sell_pair(9, 128, 256, 0.1, chunk="auto", sort_rows=True)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    teacher = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32)) @ x
    values = t.values.clone().requires_grad_()
    losses = []
    for _ in range(5):
        loss = torch.mean((csr.spmm(t.with_values(values), x) - teacher) ** 2)
        loss.backward()
        with torch.no_grad():
            values -= 0.5 * values.grad
        values.grad = None
        losses.append(loss.item())
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert not values.detach()[~t.valid_mask()].any()
