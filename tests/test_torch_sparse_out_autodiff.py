"""Gradients of the port's SSD, SDS, DSS and SSS against the JAX package,
in fp32 on the CPU, and the device rule of ``bsr_from_dense``.

The same numpy inputs and random cotangent go through both. SSD, SDS and
SSS are held against ``jax.grad`` of the JAX package's ``ops.ssd`` /
``ops.sds`` / ``ops.sss`` (their custom VJPs, Pallas in interpret mode).
The JAX package's DSS VJP passes its cotangent products to ssd / sds the
other way round and raises, so DSS is held against ``jax.grad`` of the same
product computed densely in JAX, its blocks gathered at the operands'
topologies. Two patterns: "sparse" (block-rows with no or one block: the
exact work-list routes) and "denser" (one or two blocks per row, block-row
1 empty: the dense detours). Tolerance 1e-4 absolute and 1e-5 relative:
fp32 products of up to 512 terms summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import ops as jops
from sputnik_tpu.kernels import reference as jreference
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import formats, ops
from sputnik_tpu_torch.utils import testing

BS = 128
MODES = [(False, False), (False, True), (True, False), (True, True)]
M, K, N = 512, 384, 256
TOL = dict(atol=1e-4, rtol=1e-5)


def _blocks(rng, rows, cols, pattern):
    """(block_rows, block_cols) of a pattern on (rows, cols): "sparse" gives
    block-rows 0 and 2 one block each, "denser" every block-row but 1 one or
    two blocks; columns in shuffled order."""
    br, bc = rows // BS, cols // BS
    r_ids, c_ids = [], []
    for r in range(br):
        if r == 1 or (pattern == "sparse" and r % 2):
            continue
        cs = rng.permutation(bc)[: 1 if pattern == "sparse" else 1 + r % 2]
        r_ids += [r] * len(cs)
        c_ids += list(cs)
    return np.asarray(r_ids), np.asarray(c_ids)


def _sparse_pair(rng, rows, cols, pattern):
    r_ids, c_ids = _blocks(rng, rows, cols, pattern)
    blocks = rng.standard_normal((len(r_ids), BS, BS)).astype(np.float32)
    return (jtesting.bsr_from_blocks(rows, cols, r_ids, c_ids, blocks),
            testing.bsr_from_blocks(rows, cols, r_ids, c_ids, blocks, device="cpu"))


def _dense(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _stored(m, k, transposed):
    return (k, m) if transposed else (m, k)


def _leaf(x):
    return torch.from_numpy(np.array(x)).requires_grad_()


@pytest.mark.parametrize("pattern", ["sparse", "denser"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_ssd_grads_match_jax(ta, tb, pattern):
    rng = np.random.default_rng(1)
    ja, a = _sparse_pair(rng, *_stored(M, K, ta), pattern)
    b = _dense(rng, _stored(K, N, tb))
    jt, t = _sparse_pair(rng, M, N, pattern)
    g = _dense(rng, tuple(t.data.shape))
    jda, jdb = jops.grad(
        lambda a_, b_: jnp.sum(jops.ssd(a_, b_, jt, transpose_a=ta, transpose_b=tb).data * g), argnums=(0, 1)
    )(ja, jnp.asarray(b))
    a_data, b_ = _leaf(a.data.numpy()), _leaf(b)
    out = ops.ssd(a.with_data(a_data), b_, t, transpose_a=ta, transpose_b=tb)
    assert out.indices is t.indices
    (out.data * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(a_data.grad.numpy(), np.asarray(jda.data), **TOL)
    np.testing.assert_allclose(b_.grad.numpy(), np.asarray(jdb), **TOL)


@pytest.mark.parametrize("pattern", ["sparse", "denser"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_sds_grads_match_jax(ta, tb, pattern):
    rng = np.random.default_rng(2)
    a = _dense(rng, _stored(M, K, ta))
    jb, b = _sparse_pair(rng, *_stored(K, N, tb), pattern)
    jt, t = _sparse_pair(rng, M, N, pattern)
    g = _dense(rng, tuple(t.data.shape))
    jda, jdb = jops.grad(
        lambda a_, b_: jnp.sum(jops.sds(a_, b_, jt, transpose_a=ta, transpose_b=tb).data * g), argnums=(0, 1)
    )(jnp.asarray(a), jb)
    a_, b_data = _leaf(a), _leaf(b.data.numpy())
    (ops.sds(a_, b.with_data(b_data), t, transpose_a=ta, transpose_b=tb).data * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(a_.grad.numpy(), np.asarray(jda), **TOL)
    np.testing.assert_allclose(b_data.grad.numpy(), np.asarray(jdb.data), **TOL)


@pytest.mark.parametrize("pattern", ["sparse", "denser"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_dss_grads_match_jax(ta, tb, pattern):
    rng = np.random.default_rng(3)
    ja, a = _sparse_pair(rng, *_stored(M, K, ta), pattern)
    jb, b = _sparse_pair(rng, *_stored(K, N, tb), pattern)
    g = _dense(rng, (M, N))

    def loss(ad, bd):
        lhs = ad.T if ta else ad
        rhs = bd.T if tb else bd
        return jnp.sum((lhs @ rhs) * g)

    jda, jdb = jax.grad(loss, argnums=(0, 1))(ja.to_dense(), jb.to_dense())
    a_data, b_data = _leaf(a.data.numpy()), _leaf(b.data.numpy())
    out = ops.dss(a.with_data(a_data), b.with_data(b_data), transpose_a=ta, transpose_b=tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jops.matmul_dss(ja, jb, transpose_a=ta,
                                                                                 transpose_b=tb)), **TOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(a_data.grad.numpy(), np.asarray(jreference.extract_blocks(jda, ja)), **TOL)
    np.testing.assert_allclose(b_data.grad.numpy(), np.asarray(jreference.extract_blocks(jdb, jb)), **TOL)


@pytest.mark.parametrize("pattern", ["sparse", "denser"])
@pytest.mark.parametrize("ta,tb", MODES)
def test_sss_grads_match_jax(ta, tb, pattern):
    rng = np.random.default_rng(4)
    ja, a = _sparse_pair(rng, *_stored(M, K, ta), pattern)
    jb, b = _sparse_pair(rng, *_stored(K, N, tb), pattern)
    jt, t = _sparse_pair(rng, M, N, pattern)
    g = _dense(rng, tuple(t.data.shape))
    jda, jdb = jops.grad(
        lambda a_, b_: jnp.sum(jops.sss(a_, b_, jt, transpose_a=ta, transpose_b=tb).data * g), argnums=(0, 1)
    )(ja, jb)
    a_data, b_data = _leaf(a.data.numpy()), _leaf(b.data.numpy())
    out = ops.sss(a.with_data(a_data), b.with_data(b_data), t, transpose_a=ta, transpose_b=tb)
    (out.data * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(a_data.grad.numpy(), np.asarray(jda.data), **TOL)
    np.testing.assert_allclose(b_data.grad.numpy(), np.asarray(jdb.data), **TOL)


def test_bsr_from_dense_builds_numpy_on_the_card(monkeypatch):
    """A numpy input builds where ``device`` says, the card by default:
    without a card ``device=None`` raises (it built on the CPU before); a
    tensor keeps its own device unless ``device`` is given. The metadata is
    known on the host either way."""
    x = np.zeros((256, 384), np.float32)
    x[:128, 128:256] = 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        formats.bsr_from_dense(x, BS)
    m = formats.bsr_from_dense(x, BS, device="cpu")
    assert m.device.type == "cpu" and m.offsets.device.type == "cpu" and m.host_known
    assert m.nnz_blocks == 1 and m.indices.tolist() == [1]
    t = formats.bsr_from_dense(torch.from_numpy(x), BS)
    assert t.device.type == "cpu" and t.host_known
    moved = formats.bsr_from_dense(torch.from_numpy(x), BS, device="meta")
    assert moved.device.type == "meta" and moved.indices.device.type == "meta"
