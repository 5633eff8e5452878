"""Gradients of the port's DSD, DDS, SDD and BSR softmax against the JAX
package's custom VJPs (``sputnik_tpu.ops.grad``), in fp32 on the CPU.

The same numpy inputs and the same random cotangent go through both; the
sparse operand has unordered block indices and an empty block-row. JAX's
backward reaches its Pallas kernels in interpret mode, the port's its plain
versions through the registry. Tolerance 1e-4 absolute: fp32 products of
up to 512 terms summed in another order, gradients of order 10-40.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import ops as jops
from sputnik_tpu.models import attention as jattn
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.models import attention
from sputnik_tpu_torch.utils import testing

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
M, K, N = 512, 384, 256
TOL = dict(atol=1e-4, rtol=0)


def _blocks(rng, rows, cols):
    """(block_rows, block_cols) of a random pattern on a (rows, cols)
    matrix: block-row 1 empty, every other row 1-2 blocks in shuffled order."""
    br, bc = rows // BS, cols // BS
    r_ids, c_ids = [], []
    for r in range(br):
        if r == 1:
            continue
        cs = rng.permutation(bc)[: 1 + r % 2]
        r_ids += [r] * len(cs)
        c_ids += list(cs)
    return np.asarray(r_ids), np.asarray(c_ids)


def _sparse_pair(rng, rows, cols):
    r_ids, c_ids = _blocks(rng, rows, cols)
    blocks = rng.standard_normal((len(r_ids), BS, BS)).astype(np.float32)
    jm = jtesting.bsr_from_blocks(rows, cols, r_ids, c_ids, blocks)
    tm = testing.bsr_from_blocks(rows, cols, r_ids, c_ids, blocks)
    return jm, tm


def _dense(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _stored(m, k, transposed):
    return (k, m) if transposed else (m, k)


def _leaf(x):
    return torch.from_numpy(x).requires_grad_()


@pytest.mark.parametrize("ta,tb", MODES)
def test_dsd_grads_match_jax(ta, tb):
    rng = np.random.default_rng(1)
    ja, ta_ = _sparse_pair(rng, *_stored(M, K, ta))
    b = _dense(rng, _stored(K, N, tb))
    g = _dense(rng, (M, N))
    jda, jdb = jops.grad(
        lambda a_, b_: jnp.sum(jops.dsd(a_, b_, transpose_a=ta, transpose_b=tb) * g), argnums=(0, 1)
    )(ja, jnp.asarray(b))
    a_data, tb_ = _leaf(ta_.data.numpy()), _leaf(b)
    (ops.dsd(ta_.with_data(a_data), tb_, transpose_a=ta, transpose_b=tb) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(a_data.grad.numpy(), np.asarray(jda.data), **TOL)
    np.testing.assert_allclose(tb_.grad.numpy(), np.asarray(jdb), **TOL)


@pytest.mark.parametrize("ta,tb", MODES)
def test_dds_grads_match_jax(ta, tb):
    rng = np.random.default_rng(2)
    a = _dense(rng, _stored(M, K, ta))
    jb, tb_ = _sparse_pair(rng, *_stored(K, N, tb))
    g = _dense(rng, (M, N))
    jda, jdb = jops.grad(
        lambda a_, b_: jnp.sum(jops.dds(a_, b_, transpose_a=ta, transpose_b=tb) * g), argnums=(0, 1)
    )(jnp.asarray(a), jb)
    ta_, b_data = _leaf(a), _leaf(tb_.data.numpy())
    (ops.dds(ta_, tb_.with_data(b_data), transpose_a=ta, transpose_b=tb) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ta_.grad.numpy(), np.asarray(jda), **TOL)
    np.testing.assert_allclose(b_data.grad.numpy(), np.asarray(jdb.data), **TOL)


@pytest.mark.parametrize("ta,tb", MODES)
def test_sdd_grads_match_jax(ta, tb):
    rng = np.random.default_rng(3)
    a = _dense(rng, _stored(M, K, ta))
    b = _dense(rng, _stored(K, N, tb))
    jtopo, ttopo = _sparse_pair(rng, M, N)
    g = _dense(rng, tuple(ttopo.data.shape))
    jda, jdb = jops.grad(
        lambda a_, b_: jnp.sum(jops.sdd(a_, b_, jtopo, transpose_a=ta, transpose_b=tb).data * g),
        argnums=(0, 1),
    )(jnp.asarray(a), jnp.asarray(b))
    ta_, tb_ = _leaf(a), _leaf(b)
    out = ops.sdd(ta_, tb_, ttopo, transpose_a=ta, transpose_b=tb)
    assert out.data.grad_fn is not None and out.indices is ttopo.indices
    (out.data * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ta_.grad.numpy(), np.asarray(jda), **TOL)
    np.testing.assert_allclose(tb_.grad.numpy(), np.asarray(jdb), **TOL)


def test_grads_keep_operand_dtypes_and_sum_broadcast_batch():
    """da comes back in a's dtype and db in b's (JAX's VJP dtypes); a dense
    operand shared by a batch of sparse matrices gets the batch's sum."""
    rng = np.random.default_rng(4)
    _, a = _sparse_pair(rng, M, K)
    a_data = torch.from_numpy(rng.standard_normal((2,) + tuple(a.data.shape)).astype(np.float32))
    a_data = a_data.to(torch.bfloat16).requires_grad_()
    b = _leaf(_dense(rng, (K, N)))
    ops.dsd(a.with_data(a_data), b).sum().backward()
    assert a_data.grad.dtype == torch.bfloat16 and a_data.grad.shape == a_data.shape
    assert b.grad.dtype == torch.float32 and b.grad.shape == b.shape
    want = sum(ops.matmul_dsd(a.with_data(a_data.detach()[i]), torch.ones(M, N), transpose_a=True,
                              out_dtype=torch.float32) for i in range(2))
    torch.testing.assert_close(b.grad, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("topo_kind", ["causal_band", "random"])
def test_bsr_softmax_causal_grad_matches_jax(topo_kind):
    """bsr_softmax is plain torch in the port; its gradient (causal mask,
    empty rows) against JAX's autodiff of its jnp softmax."""
    rng = np.random.default_rng(5)
    t = 512
    if topo_kind == "causal_band":
        jtopo = jattn.causal_block_topology(t, BS, window_blocks=3, dtype=jnp.float32)
        ttopo = attention.causal_block_topology(t, BS, window_blocks=3, dtype=torch.float32)
    else:  # above-diagonal blocks are fully masked; block-row 1 is empty
        jtopo, ttopo = _sparse_pair(rng, t, t)
    x = _dense(rng, tuple(ttopo.data.shape))
    g = _dense(rng, x.shape)
    jgrad = jops.grad(
        lambda d: jnp.sum(jops.bsr_softmax(jtopo.with_data(d), scale=0.5, causal=True).data * g)
    )(jnp.asarray(x))
    tx = _leaf(x)
    (ops.bsr_softmax(ttopo.with_data(tx), scale=0.5, causal=True).data * torch.from_numpy(g)).sum().backward()
    assert np.isfinite(tx.grad.numpy()).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=0)
