"""The port's fused block-sparse FFN (``kernels/bsr_ffn.py``) against the
JAX package's, in fp32 on the CPU with numpy-seeded inputs fed to both.
JAX runs its Pallas kernels ``_ffn_kernel`` and ``_dropless_kernel`` in
interpret mode; the port runs their plain versions, which its kernel
wrappers take for CPU tensors. Values within atol 1e-4 (fp32, different
summation orders); plans and metadata exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu.formats import BlockSparseMatrix as JBsr
from sputnik_tpu.kernels import bsr_ffn as jffn
from sputnik_tpu.models import moe as jmoe
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_ffn
from sputnik_tpu_torch.models import moe
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing

BS = 128
D = 256
ACTS = ["gelu", "relu", "identity"]


def _pair(offsets, indices, shape):
    """The same topology in both packages, built from numpy."""
    offsets = np.asarray(offsets, np.int32)
    indices = np.asarray(indices, np.int32)
    jt = JBsr.create(jnp.zeros((len(indices), BS, BS), jnp.float32), jnp.asarray(offsets),
                     jnp.asarray(indices), shape)
    tt = BlockSparseMatrix.create(torch.zeros(len(indices), BS, BS), offsets, indices, shape)
    return jt, tt


def _group_layout(rng, n_groups, rows_per_group, f_blocks, permuted):
    """Group-structured metadata: group g's block-rows share one run of
    f_blocks column ids; ``permuted`` shuffles the runs across groups and
    the ids inside each run."""
    runs = np.arange(n_groups * f_blocks).reshape(n_groups, f_blocks)
    if permuted:
        runs = np.stack([rng.permutation(r) for r in runs[rng.permutation(n_groups)]])
    indices = np.repeat(runs, rows_per_group, axis=0).reshape(-1)
    offsets = np.arange(n_groups * rows_per_group + 1) * f_blocks
    shape = (n_groups * rows_per_group * BS, n_groups * f_blocks * BS)
    return offsets, indices, shape


def _plans_equal(tp, jp):
    if jp is None:
        assert tp is None
        return
    np.testing.assert_array_equal(tp[0], np.asarray(jp[0]))
    assert tp[1] == jp[1] and tp[0].dtype == np.int32


@pytest.mark.parametrize("kind", ["block_diag", "permuted", "random", "unequal_groups", "empty_first_row"])
def test_plan_group_ffn_matches_jax(kind):
    rng = np.random.default_rng(1)
    if kind == "block_diag":
        kw = dict(d_model=128, d_ff=256, n_experts=2, capacity=256)
        jt = jmoe.block_diag_topology(jmoe.MoEConfig(dtype=jnp.float32, **kw))
        tt = moe.block_diag_topology(moe.MoEConfig(dtype=torch.float32, **kw), device="cpu")
    elif kind == "permuted":
        jt, tt = _pair(*_group_layout(rng, 4, 2, 3, permuted=True))
    elif kind == "random":
        # The packages draw identically from one seed: rows that do not
        # share column runs.
        jt = jtesting.random_bsr(np.random.default_rng(5), 512, 512, 512 * 512 // 4, BS)
        tt = testing.random_bsr(np.random.default_rng(5), 512, 512, 512 * 512 // 4, BS, device="cpu")
    elif kind == "unequal_groups":
        jt, tt = _pair([0, 2, 4, 6], [0, 1, 0, 1, 2, 3], (3 * BS, 4 * BS))
    else:
        jt, tt = _pair([0, 0, 0], np.zeros(0), (2 * BS, 2 * BS))
    jp, tp = jffn.plan_group_ffn(jt), bsr_ffn.plan_group_ffn(tt)
    _plans_equal(tp, jp)
    if kind in ("block_diag", "random"):
        assert (tp is None) == (kind == "random")
    # A second call hits the per-topology cache and gives the same object.
    assert bsr_ffn.plan_group_ffn(tt) is tp


def _ffn_inputs(rng, rows, ff_total):
    x = rng.standard_normal((rows, D)).astype(np.float32)
    w1 = (rng.standard_normal((D, ff_total)) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.standard_normal((ff_total, D)) / np.sqrt(ff_total)).astype(np.float32)
    return x, w1, w2


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("layout", ["block_diag", "permuted"])
def test_fused_group_ffn_matches_jax(activation, layout):
    rng = np.random.default_rng(2)
    n_groups, rows_per_group, f_blocks = 3, 2 if layout == "permuted" else 1, 2
    offsets, indices, shape = _group_layout(rng, n_groups, rows_per_group, f_blocks, layout == "permuted")
    jt, tt = _pair(offsets, indices, shape)
    x, w1, w2 = _ffn_inputs(rng, shape[0], shape[1])
    want = np.asarray(jffn.fused_group_ffn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jt,
                                           activation=activation))
    got = bsr_ffn.fused_group_ffn(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2), tt,
                                  activation=activation)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert float(np.abs(want).max()) > 0.1


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("tile_rows", [128, 256])
def test_fused_dropless_ffn_matches_jax(activation, tile_rows):
    """Ragged groups with one expert left empty, and live_rows below the
    tile count: the live rows agree; dead rows are never read."""
    rng = np.random.default_rng(3)
    n_experts, d_ff, n_tiles, live = 3, 256, 5, 3
    x, w1, w2 = _ffn_inputs(rng, n_tiles * tile_rows, n_experts * d_ff)
    expert_of_row = np.array([0, 0, 2, 2, 2], np.int32)  # expert 1 has no tile
    kw = dict(tile_rows=tile_rows, activation=activation)
    want = np.asarray(jffn.fused_dropless_ffn(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(expert_of_row), d_ff,
        live_rows=jnp.int32(live), **kw))
    got = bsr_ffn.fused_dropless_ffn(
        torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(expert_of_row),
        d_ff, live_rows=torch.tensor(live), **kw)
    n_live = live * tile_rows
    np.testing.assert_allclose(got.numpy()[:n_live], want[:n_live], atol=1e-4, rtol=0)
    assert float(np.abs(want[:n_live]).max()) > 0.1


@pytest.mark.parametrize("case", ["ragged_topology", "x_rows", "w1_shape", "w2_rows", "ff_group",
                                  "dropless_d_ff", "dropless_rows", "dropless_ff_group"])
def test_ffn_raises_like_jax(case):
    rng = np.random.default_rng(4)
    offsets, indices, shape = _group_layout(rng, 2, 1, 2, permuted=False)
    jt, tt = _pair(offsets, indices, shape)
    x, w1, w2 = _ffn_inputs(rng, shape[0], shape[1])
    kw = {}
    if case == "ragged_topology":
        jt, tt = _pair([0, 2, 4, 6], [0, 1, 0, 1, 2, 3], (3 * BS, 4 * BS))
        x, w1, w2 = _ffn_inputs(rng, 3 * BS, 4 * BS)
    elif case == "x_rows":
        x = x[:BS]
    elif case == "w1_shape":
        w1 = w1[:, :BS]
    elif case == "w2_rows":
        w2 = w2[:BS]
    elif case == "ff_group":
        kw = dict(ff_group=3)
    if case.startswith("dropless"):
        d_ff = 192 if case == "dropless_d_ff" else 256
        rows = 3 * BS if case == "dropless_rows" else 2 * BS
        kw = dict(ff_group=3) if case == "dropless_ff_group" else {}
        x, w1, w2 = _ffn_inputs(rng, rows, 2 * d_ff)
        e_row = np.zeros(rows // (2 * BS), np.int32)
        calls = [
            lambda: jffn.fused_dropless_ffn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2),
                                            jnp.asarray(e_row), d_ff, tile_rows=2 * BS, **kw),
            lambda: bsr_ffn.fused_dropless_ffn(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(w2),
                                               torch.from_numpy(e_row), d_ff, tile_rows=2 * BS, **kw),
        ]
    else:
        calls = [
            lambda: jffn.fused_group_ffn(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), jt, **kw),
            lambda: bsr_ffn.fused_group_ffn(torch.from_numpy(x), torch.from_numpy(w1),
                                            torch.from_numpy(w2), tt, **kw),
        ]
    for call in calls:
        with pytest.raises(ValueError):
            call()


def test_ffn_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the kernel wrappers compute the plain versions and
    launch nothing; the registry routes CPU problems, and forced_variant
    names the plain one."""
    rng = np.random.default_rng(6)
    offsets, indices, shape = _group_layout(rng, 2, 1, 2, permuted=True)
    _, tt = _pair(offsets, indices, shape)
    x, w1, w2 = (torch.from_numpy(a) for a in _ffn_inputs(rng, shape[0], shape[1]))
    plan = bsr_ffn.plan_group_ffn(tt)
    cols = bsr_ffn.plan_cols(tt, plan, "cpu")
    assert cols.dtype == torch.int32 and cols.tolist() == plan[0].reshape(-1).tolist()
    before = dict(bsr_ffn.LAUNCHES)
    want = bsr_ffn.fused_group_ffn_reference(x, w1, w2, cols, plan[1])
    torch.testing.assert_close(bsr_ffn.group_ffn(x, w1, w2, cols, plan[1]), want, rtol=0, atol=0)
    torch.testing.assert_close(bsr_ffn.fused_group_ffn(x, w1, w2, tt), want, rtol=0, atol=0)
    with registry.forced_variant("torch_reference"):
        torch.testing.assert_close(bsr_ffn.fused_group_ffn(x, w1, w2, tt), want, rtol=0, atol=0)
    assert registry.dispatch_name("fused_group_ffn", x, w1, w2, cols, plan[1]) == "torch_reference"
    e_row = torch.tensor([1, 0], dtype=torch.int32)
    want = bsr_ffn.fused_dropless_ffn_reference(x, w1, w2, e_row, 256, tile_rows=BS, live_rows=1)
    got = bsr_ffn.dropless_ffn(x, w1, w2, e_row, 256, tile_rows=BS, live_rows=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got[BS:].abs().max()) == 0.0  # the plain version zeroes dead tiles
    assert bsr_ffn.LAUNCHES == before
