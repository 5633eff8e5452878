"""The port's block pruning and RigL refresh against the JAX package, on
the CPU.

The same numpy inputs go through both packages. Metadata must be exactly
equal (offsets, indices, row indices, the budget-stable hints of a
refresh), block data equal, and ``gradual_sparsity`` equal; the port's
result is host-known, so the small-block kernels take it. A five-step RigL
fine-tune at bs 32 (``examples/sparse_finetune.py::block_rigl_demo`` at a
small width) gives the same loss as JAX's at every step within 1e-5
relative (fp32 sums in another order), through the port's small-block route
and JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import ops as jops
from sputnik_tpu import prune as jprune
from sputnik_tpu_torch import ops, prune
from sputnik_tpu_torch.ops import registry


def _assert_same(tm, jm):
    for f in ("offsets", "indices", "row_indices", "data"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)), err_msg=f)
    assert tm.shape == jm.shape and tm.block_size == jm.block_size
    assert (tm.max_row_nnz, tm.max_col_nnz) == (jm.max_row_nnz, jm.max_col_nnz)
    assert tm.host_known


@pytest.mark.parametrize("score", ["l2", "l1"])
@pytest.mark.parametrize("bs", [16, 32, 128])
def test_block_magnitude_prune_matches_jax(rng, bs, score):
    w = rng.standard_normal((256, 512)).astype(np.float32)
    for kw in (dict(sparsity=0.75), dict(nnz_blocks=5)):
        jm = jprune.block_magnitude_prune(jnp.asarray(w), bs, score=score, **kw)
        tm = prune.block_magnitude_prune(torch.from_numpy(w), bs, score=score, **kw)
        _assert_same(tm, jm)
    # fp32 sums of up to bs^2 terms, in another order.
    np.testing.assert_allclose(prune.block_scores(torch.from_numpy(w), bs, score=score).numpy(),
                               np.asarray(jprune.block_scores(jnp.asarray(w), bs, score=score)), rtol=1e-5)


def test_tied_scores_break_by_lower_index():
    """Every block of equal norm: both keep the lowest flat ids."""
    w = np.ones((128, 256), np.float32)
    jm = jprune.block_magnitude_prune(jnp.asarray(w), 32, nnz_blocks=9)
    tm = prune.block_magnitude_prune(torch.from_numpy(w), 32, nnz_blocks=9)
    _assert_same(tm, jm)
    assert tm.indices.tolist() == list(range(8)) + [0]
    # A refresh with tied value norms and tied gradient scores.
    jr = jprune.rigl_block_update(jm, jnp.ones((128, 256)), drop_fraction=0.4)
    tr = prune.rigl_block_update(tm, torch.ones(128, 256), drop_fraction=0.4)
    _assert_same(tr, jr)


@pytest.mark.parametrize("drop", [0.2, 0.5, 1.0])
def test_rigl_update_matches_jax(rng, drop):
    w = rng.standard_normal((256, 512)).astype(np.float32)
    g = rng.standard_normal((256, 512)).astype(np.float32)
    jm = jprune.block_magnitude_prune(jnp.asarray(w), 32, sparsity=0.75)
    tm = prune.block_magnitude_prune(torch.from_numpy(w), 32, sparsity=0.75)
    jr = jprune.rigl_block_update(jm, jnp.asarray(g), drop_fraction=drop)
    tr = prune.rigl_block_update(tm, torch.from_numpy(g), drop_fraction=drop)
    _assert_same(tr, jr)
    assert tr.nnz_blocks == tm.nnz_blocks


def test_gradual_sparsity_and_errors():
    for step in (-5, 0, 3, 50, 99, 100, 1000):
        kw = dict(final_sparsity=0.9, initial_sparsity=0.1, begin_step=0, end_step=100)
        assert prune.gradual_sparsity(step, **kw) == jprune.gradual_sparsity(step, **kw)
    w = torch.zeros(128, 128)
    with pytest.raises(ValueError, match="exactly one"):
        prune.block_magnitude_prune(w, 32)
    with pytest.raises(ValueError, match="sparsity"):
        prune.block_magnitude_prune(w, 32, sparsity=1.0)
    with pytest.raises(ValueError, match="score"):
        prune.block_scores(w, 32, score="linf")
    with pytest.raises(ValueError, match="end_step"):
        prune.gradual_sparsity(1, final_sparsity=0.5, end_step=0)
    m = prune.block_magnitude_prune(w + 1, 32, sparsity=0.5)
    with pytest.raises(ValueError, match="dense_grad"):
        prune.rigl_block_update(m, torch.zeros(64, 128))
    assert prune.rigl_block_update(m, w, drop_fraction=0.0) is m


def test_rigl_finetune_matches_jax():
    """Five SGD steps (lr 0.5) on a bs-32 pruned weight against a dense
    teacher with one RigL refresh after step 2; the loss at every step
    within 1e-5 relative of JAX's, both on their small-block routes."""
    rng = np.random.default_rng(1)
    rows, cols, bs, batch = 128, 256, 32, 128
    w = (rng.standard_normal((rows, cols)) * 0.05).astype(np.float32)
    x = rng.standard_normal((cols, batch)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jteacher, tteacher = jnp.asarray(w) @ jx, torch.from_numpy(w) @ tx
    jm = jprune.block_magnitude_prune(jnp.asarray(w), bs, sparsity=0.75)
    tm = prune.block_magnitude_prune(torch.from_numpy(w), bs, sparsity=0.75)
    assert registry.dispatch_name("dsd", tm, tx) == "cuda_smallblock"

    def jloss(data, topo):
        return jnp.mean((jops.dsd(topo.with_data(data), jx) - jteacher) ** 2)

    jdata, tdata = jm.data, tm.data.clone()
    for step in range(5):
        jl, jg = jax.value_and_grad(jloss)(jdata, jm)
        jdata = jdata - 0.5 * jg
        leaf = tdata.clone().requires_grad_()
        tl = torch.mean((ops.dsd(tm.with_data(leaf), tx) - tteacher) ** 2)
        tl.backward()
        tdata = (leaf - 0.5 * leaf.grad).detach()
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        if step == 2:
            jgrad = jax.grad(lambda wd: jnp.mean((wd @ jx - jteacher) ** 2))(jm.with_data(jdata).to_dense())
            wd = tm.with_data(tdata).to_dense().requires_grad_()
            torch.mean((wd @ tx - tteacher) ** 2).backward()
            jm = jprune.rigl_block_update(jm.with_data(jdata), jgrad, drop_fraction=0.2)
            tm = prune.rigl_block_update(tm.with_data(tdata), wd.grad, drop_fraction=0.2)
            np.testing.assert_array_equal(tm.indices.numpy(), np.asarray(jm.indices))
            jdata, tdata = jm.data, tm.data.clone()
            assert tm.host_known and registry.dispatch_name("dsd", tm, tx) == "cuda_smallblock"
