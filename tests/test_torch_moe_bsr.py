"""The port's block-sparse MoE paths against the JAX package's, in fp32 on
the CPU with numpy-seeded inputs fed to both: ``moe_forward`` with
``impl="bsr"`` (the fused group FFN) and ``"bsr_unfused"``, the dropless
forward with all three impls, its on-device topology and routing glue
(exact integer equality), gradients against ``jax.grad``, and the two
repairs of this slice (``BlockSparseMatrix.create`` hints, the LM's MoE
topology). JAX runs its Pallas FFN, SDD and DSD kernels in interpret
mode; the port runs their plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.models import moe as jmoe
from sputnik_tpu.models import transformer as jtr
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_ffn
from sputnik_tpu_torch.models import moe
from sputnik_tpu_torch.models import transformer as tr
from sputnik_tpu_torch.models.convert import load_numpy_
from sputnik_tpu_torch.ops import bsr_softmax

D = 256


def _moe_pair(d_ff=256, n_experts=4, capacity=128, seed=3, empty_expert=None):
    """JAX parameters and the same values in a port MoE. ``empty_expert``
    gets a router weight that, with ``_tokens``' constant feature, keeps
    every token away from it."""
    kw = dict(d_model=D, d_ff=d_ff, n_experts=n_experts, capacity=capacity)
    jcfg = jmoe.MoEConfig(dtype=jnp.float32, **kw)
    tcfg = moe.MoEConfig(dtype=torch.float32, **kw)
    jparams = jmoe.init_moe_params(jax.random.PRNGKey(seed), jcfg)
    if empty_expert is not None:
        jparams = dict(jparams, router=jparams["router"].at[0, empty_expert].set(-100.0))
    tparams = load_numpy_(moe.MoE(tcfg, device="cpu"), jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _tokens(rng, t):
    x = rng.standard_normal((t, D)).astype(np.float32)
    x[:, 0] = 10.0  # a constant feature (see _moe_pair's empty_expert)
    return x


@pytest.mark.parametrize("impl", ["bsr", "bsr_unfused"])
@pytest.mark.parametrize("tokens", [256, 640])  # 640 overflows capacity: drops
def test_moe_forward_bsr_matches_jax(rng, impl, tokens):
    jcfg, jparams, tcfg, tparams = _moe_pair()
    x = rng.standard_normal((tokens, D)).astype(np.float32)
    jy, jaux = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg, jmoe.block_diag_topology(jcfg), impl=impl)
    ty, taux = moe.moe_forward(tparams, torch.from_numpy(x), tcfg, moe.block_diag_topology(tcfg, device="cpu"),
                                impl=impl)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    if tokens == 640:  # dropped tokens give zero rows in both
        assert (np.abs(np.asarray(jy)).max(axis=1) == 0).sum() > 0


def test_moe_forward_checks_impl_and_topology(rng):
    _, _, tcfg, tparams = _moe_pair()
    x = torch.from_numpy(rng.standard_normal((128, D)).astype(np.float32))
    with pytest.raises(ValueError, match="impl"):
        moe.moe_forward(tparams, x, tcfg, impl="dense")
    with pytest.raises(ValueError, match="topology"):
        moe.moe_forward(tparams, x, tcfg, impl="bsr")
    with pytest.raises(ValueError, match="impl"):
        moe.dropless_moe_forward(tparams, x, tcfg, impl="grouped")


@pytest.mark.parametrize("expert_rows", [[2, 0, 1, 3], [0, 0, 5, 0], [1, 1, 1, 1]])
def test_dropless_topology_matches_jax(expert_rows):
    kw = dict(d_model=D, d_ff=256, n_experts=4, capacity=128)
    jcfg, tcfg = jmoe.MoEConfig(dtype=jnp.float32, **kw), moe.MoEConfig(dtype=torch.float32, **kw)
    max_block_rows = 9  # more rows than the groups fill: the tail clamps to E-1
    j = jmoe.dropless_topology(jnp.asarray(expert_rows, jnp.int32), jcfg, max_block_rows)
    t = moe.dropless_topology(torch.tensor(expert_rows), tcfg, max_block_rows)
    for name in ("offsets", "indices", "row_indices"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        assert getattr(t, name).dtype == torch.int32
    assert (t.shape, t.nnz_blocks, t.max_row_nnz) == (j.shape, j.nnz_blocks, j.max_row_nnz)
    assert t.dtype == torch.float32 and float(t.data.abs().max()) == 0.0


@pytest.mark.parametrize("row_group", [1, 2])
def test_dropless_routing_glue_matches_jax(rng, row_group):
    """max_block_rows, t_pad, expert_rows, group_start, dest, src and the
    fused path's live tiles, against JAX's lines (moe.py:354-391, :298)."""
    _, _, tcfg, _ = _moe_pair()
    t, bs, e = 300, tcfg.block_size, tcfg.n_experts
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[:, 1] -= 100.0  # expert 1 gets no token
    # JAX, as dropless_moe_forward writes it.
    max_block_rows = (-(-t // bs) // row_group + e) * row_group
    t_pad = max_block_rows * bs
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, e, dtype=jnp.int32)
    counts = jnp.sum(onehot, axis=0)
    j_rows = -(-counts // bs)
    if row_group > 1:
        j_rows = -(-j_rows // row_group) * row_group
    j_start = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(j_rows[:-1]).astype(jnp.int32)]) * bs
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    j_dest = j_start[expert] + pos
    j_src = jnp.full((t_pad,), t - 1, jnp.int32).at[j_dest].set(jnp.arange(t, dtype=jnp.int32))
    j_live = (jnp.sum(j_rows) * bs) // (row_group * bs)

    mbr, _, prob, t_expert, _, t_rows, dest, src = moe._dropless_route(
        torch.from_numpy(logits), t, tcfg, row_group)
    assert mbr == max_block_rows and src.shape == (t_pad,)
    assert int(t_rows[1]) == 0
    np.testing.assert_array_equal(t_expert.numpy(), np.asarray(expert))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(((torch.cumsum(t_rows, 0) - t_rows) * bs).numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(j_dest))
    np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
    assert int((t_rows.sum() * bs) // (row_group * bs)) == int(j_live)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jnp.max(probs, axis=-1)), rtol=1e-6)


@pytest.mark.parametrize("row_group", [1, 2])
@pytest.mark.parametrize("impl", ["ragged", "bsr", "bsr_fused"])
def test_dropless_moe_forward_matches_jax(rng, impl, row_group):
    """640 tokens over 4 experts, expert 2 routed no token."""
    jcfg, jparams, tcfg, tparams = _moe_pair(empty_expert=2)
    x = _tokens(rng, 640)
    jy, jaux = jmoe.dropless_moe_forward(jparams, jnp.asarray(x), jcfg, impl=impl, row_group=row_group)
    ty, taux = moe.dropless_moe_forward(tparams, torch.from_numpy(x), tcfg, impl=impl, row_group=row_group)
    logits = x @ np.asarray(jparams["router"])
    assert 2 not in logits.argmax(axis=1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)


def _grads(path, impl):
    """(loss, {router, w1, w2, x} gradients) of sum(y^2) * 1e-3 + 0.01 * aux
    in both packages, 150 tokens over 2 experts."""
    jcfg, jparams, tcfg, tparams = _moe_pair(d_ff=128, n_experts=2)
    x = np.random.default_rng(7).standard_normal((150, D)).astype(np.float32)
    if path == "capacity":
        jtopo, ttopo = jmoe.block_diag_topology(jcfg), moe.block_diag_topology(tcfg, device="cpu")
        jfwd = lambda p, x_: jmoe.moe_forward(p, x_, jcfg, jtopo, impl=impl)  # noqa: E731
        tfwd = lambda p, x_: moe.moe_forward(p, x_, tcfg, ttopo, impl=impl)  # noqa: E731
    else:
        jfwd = lambda p, x_: jmoe.dropless_moe_forward(p, x_, jcfg, impl=impl)  # noqa: E731
        tfwd = lambda p, x_: moe.dropless_moe_forward(p, x_, tcfg, impl=impl)  # noqa: E731

    def jloss(p, x_):
        y, aux = jfwd(p, x_)
        return jnp.sum(y ** 2) * 1e-3 + 0.01 * aux

    jl, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tfwd(tparams, tx)
    tl = torch.sum(y ** 2) * 1e-3 + 0.01 * aux
    tl.backward()
    want = {k: np.asarray(v) for k, v in jg.items()} | {"x": np.asarray(jgx)}
    got = {n: p.grad.numpy() for n, p in tparams.named_parameters()} | {"x": tx.grad.numpy()}
    return (float(tl.detach()), got), (float(jl), want)


@pytest.mark.parametrize("path,impl", [("capacity", "bsr"), ("dropless", "bsr"), ("dropless", "bsr_fused")])
def test_moe_grads_match_jax(path, impl):
    """Every parameter's gradient and dx within 1e-3 * max|g| + 1e-6. For
    the dropless paths a leak through the padding slots (clamped onto the
    last token) would show in dx of that token."""
    (tl, got), (jl, want) = _grads(path, impl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(got) == set(want)
    for name, g in want.items():
        assert np.abs(g).max() > 0, name
        np.testing.assert_allclose(got[name], g, atol=1e-3 * np.abs(g).max() + 1e-6, rtol=0, err_msg=name)


def test_create_hints_from_host_metadata():
    """numpy and CPU-tensor metadata give the hints create always computed;
    hints the caller passes are kept as given; the BSR softmax reads the
    offsets and needs no hint."""
    offsets = np.array([0, 2, 2, 5], np.int32)  # rows of 2, 0 and 3 blocks
    indices = np.array([0, 3, 0, 1, 3], np.int32)  # columns hit 2, 1, 0, 2 times
    data = torch.zeros(5, 128, 128)
    shape = (3 * 128, 4 * 128)
    for off, idx in ((offsets, indices), (torch.from_numpy(offsets), torch.from_numpy(indices))):
        m = BlockSparseMatrix.create(data, off, idx, shape)
        assert (m.max_row_nnz, m.min_row_nnz, m.max_col_nnz, m.min_col_nnz) == (3, 0, 2, 0)
    m = BlockSparseMatrix.create(data, offsets, indices, shape, max_row_nnz=7, max_col_nnz=9)
    assert (m.max_row_nnz, m.min_row_nnz, m.max_col_nnz, m.min_col_nnz) == (7, 0, 9, 0)
    # The softmax gives the same probabilities without the hint.
    m = m.with_data(torch.randn(5, 128, 128, generator=torch.Generator().manual_seed(0)))
    want = bsr_softmax(m, causal=True).data
    torch.testing.assert_close(bsr_softmax(dataclasses.replace(m, max_row_nnz=None), causal=True).data, want,
                               atol=0, rtol=0)


def test_lm_topologies_carry_the_moe_topology():
    """The LM's second topology is JAX's block-diagonal MoE topology, and
    the fused FFN plans it without reading its metadata again."""
    kw = dict(d_model=256, n_heads=2, seq_len=512, n_experts=4, d_ff=256, n_layers=1, vocab=256)
    _, j = jtr.lm_topologies(jtr.TransformerConfig(dtype=jnp.float32, **kw))
    _, t = tr.lm_topologies(tr.TransformerConfig(dtype=torch.float32, **kw), device="cpu")
    for name in ("offsets", "indices", "row_indices"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert t.shape == j.shape and t.nnz_blocks == j.nnz_blocks
    assert bsr_ffn._entry(t) is not None and bsr_ffn.plan_group_ffn(t)[1] == 1
