"""The port's small-block (16 / 32 / 64) products, their planners and the
sparse-output routes against the JAX package, on the CPU.

The same numpy inputs go through both packages. JAX runs its packed
small-block kernels as its own tests run them (Pallas in interpret mode,
``variant="pallas_smallblock"``); the port runs ``cuda_smallblock``, which
on CPU tensors computes its kernels' plain versions from the same plans.
Plans must equal JAX's element for element. Tolerances: fp32 atol 1e-4 and
rtol 1e-5 (the same fp32 products summed in another order, K <= 256); the
gradients of DSD likewise.

The route test reads both registries' first fit for the same problems with
the port's device predicates reporting CUDA: host-known metadata is the
JAX package's concrete metadata, metadata built on the card its traced
metadata. The CUDA kernels are held against their plain versions on the
card in tests/test_torch_gpu.py.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sputnik_tpu import native as jnative
from sputnik_tpu import ops as jops
from sputnik_tpu.kernels import bsr_small as jbsr_small
from sputnik_tpu.utils import testing as jtesting
from sputnik_tpu_torch import ops
from sputnik_tpu_torch.formats import BlockSparseMatrix
from sputnik_tpu_torch.kernels import bsr_small
from sputnik_tpu_torch.ops import registry
from sputnik_tpu_torch.utils import testing

# The module (the package's ``ops.matmul`` is the generic function).
matmul_mod = importlib.import_module("sputnik_tpu_torch.ops.matmul")

MODES = [(False, False), (False, True), (True, False), (True, True)]
JAX_TOL = dict(atol=1e-4, rtol=1e-5)
M, K, N = 256, 128, 128


def _pair(seed, rows, cols, density, bs, **kw):
    """The same random BSR in both packages (host-known in the port)."""
    nnz = max(int(rows * cols * density), bs * bs)
    jm = jtesting.random_bsr(np.random.default_rng(seed), rows, cols, nnz, bs, **kw)
    tm = testing.random_bsr(np.random.default_rng(seed), rows, cols, nnz, bs, device="cpu", **kw)
    return jm, tm


def _dense(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _stored(shape, transposed):
    return shape[::-1] if transposed else shape


def _card_built(m):
    return dataclasses.replace(m, host_offsets=None, host_indices=None)


# ------------------------------------------------------------- planners --
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_plans_match_jax(bs, transposed):
    """Ragged rows (not a multiple of pack), an empty block-row, unordered
    columns: the DSD plan and the SDD plan equal JAX's."""
    ja, ta = _pair(1, 512, 384, 0.3, bs, unordered=True)
    tp = bsr_small.plan_smallblock(ta, transposed=transposed)
    jp = jbsr_small.plan_smallblock(ja, transposed=transposed)
    for name, got, want in zip(("out_ids", "subs", "deps", "datas"), (tp.out_ids, tp.subs, tp.deps, tp.datas), jp):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert tp.n_steps == jp[4]
    np.testing.assert_array_equal(tp.row_counts, jp[5])
    assert (tp.datas == ta.nnz_blocks).any()  # ragged rows leave padding slots
    ts, js = bsr_small.plan_sdd_smallblock(ta), jbsr_small.plan_sdd_smallblock(ja)
    for name, got, want in zip(("rows", "cols", "src"), (ts.rows, ts.cols, ts.src), js):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert ts.n_steps == js[3]


def test_pack_rows_matches_jax_native():
    """The numpy pack_rows against the JAX package's (C++ when built) on
    ragged rows with unordered columns and empty rows."""
    offsets = np.array([0, 3, 3, 4, 11, 11, 16], np.int32)
    indices = np.array([5, 1, 3, 2, 9, 0, 7, 4, 8, 6, 1, 3, 0, 2, 7, 5], np.int32)
    for pack in (1, 2, 4, 8):
        got = bsr_small.pack_rows(offsets, indices, pack)
        want = jnative.pack_rows(offsets, indices, pack)
        for name, g, w in zip(("rows", "cols", "src"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} pack {pack}")
        assert got[3] == want[3]
    empty = np.zeros(4, np.int32)
    assert bsr_small.pack_rows(empty, np.zeros(0, np.int32), 4)[3] == jnative.pack_rows(empty, np.zeros(0, np.int32),
                                                                                        4)[3] == 0


def test_plans_are_cached_per_topology(rng):
    _, a = _pair(2, M, K, 0.3, 32)
    b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    first = ops.matmul_dsd(a, b)
    again = ops.matmul_dsd(a.with_data(2 * a.data), b)
    torch.testing.assert_close(again, 2 * first)
    assert (("small", False), (id(a.indices),)) in matmul_mod._PLANS


# ------------------------------------------------------------- the ops --
def _problem(op, bs, ta, tb, rng):
    """(jax args, torch args) of ``op`` at (M, K, N) and block size bs."""
    sa, sb = _stored((M, K), ta), _stored((K, N), tb)
    sparse_a = op in ("dsd", "ssd", "dss")
    sparse_b = op in ("dds", "sds", "dss")
    ja, a = _pair(10, *sa, 0.3, bs, unordered=True) if sparse_a else _dense(rng, sa)
    jb, b = _pair(11, *sb, 0.3, bs, unordered=True) if sparse_b else _dense(rng, sb)
    if op in ("dsd", "dds", "dss"):
        return (ja, jb), (a, b)
    jt, t = _pair(12, M, N, 0.3, bs, unordered=True)
    return (ja, jb, jt), (a, b, t)


@pytest.mark.parametrize("ta,tb", MODES)
@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("op", ["dsd", "dds", "sdd", "ssd", "sds", "dss"])
def test_ops_match_jax_smallblock(rng, op, bs, ta, tb):
    jargs, targs = _problem(op, bs, ta, tb, rng)
    kw = dict(transpose_a=ta, transpose_b=tb)
    assert registry.dispatch_name(op, *targs, **kw) == "cuda_smallblock"
    expected = getattr(jops, f"matmul_{op}")(*jargs, variant="pallas_smallblock", **kw)
    out = getattr(ops, f"matmul_{op}")(*targs, **kw)
    if op in ("sdd", "ssd", "sds"):
        expected, out = expected.data, out.data
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), **JAX_TOL)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, True)])
def test_dsd_gradients_match_jax(rng, ta, tb):
    """Gradients of sum(dsd(A, B) * W) at bs 32: both through the
    small-block kernels (DSD forward, SDD and DSD backward)."""
    bs = 32
    (ja, jb), (a, b) = _problem("dsd", bs, ta, tb, rng)
    w = rng.standard_normal((M, N)).astype(np.float32)

    def jloss(data, dense):
        return jnp.sum(jops.dsd(ja.with_data(data), dense, transpose_a=ta, transpose_b=tb) * w)

    jda, jdb = jax.grad(jloss, argnums=(0, 1))(ja.data, jb)
    da = a.data.clone().requires_grad_()
    db = b.clone().requires_grad_()
    launches = dict(bsr_small.LAUNCHES)
    (ops.dsd(a.with_data(da), db, transpose_a=ta, transpose_b=tb) * torch.from_numpy(w)).sum().backward()
    assert launches == bsr_small.LAUNCHES  # CPU tensors: the plain versions, no launch
    np.testing.assert_allclose(da.grad.numpy(), np.asarray(jda), **JAX_TOL)
    np.testing.assert_allclose(db.grad.numpy(), np.asarray(jdb), **JAX_TOL)


def test_empty_rows_and_padding_slots(rng):
    """Block-rows with no block, and rows whose count is not a multiple of
    pack (padding slots on the zero block), against JAX's kernel."""
    bs = 64
    ones = np.ones((bs, bs), np.float32)
    blocks = np.stack([ones, 2 * ones, 3 * ones, 4 * ones])
    ja = jtesting.bsr_from_blocks(8 * bs, 8 * bs, [0, 0, 0, 5], [6, 1, 3, 2], blocks)
    a = testing.bsr_from_blocks(8 * bs, 8 * bs, [0, 0, 0, 5], [6, 1, 3, 2], blocks, device="cpu")
    jb, b = _dense(rng, (8 * bs, 128))
    out = ops.matmul_dsd(a, b)
    np.testing.assert_allclose(out.numpy(), np.asarray(jops.matmul_dsd(ja, jb, variant="pallas_smallblock")),
                               **JAX_TOL)
    assert not out[bs:5 * bs].any()


# ------------------------------------------- first fit on the card --
# The JAX package's first-fit names and the port's for the same route.
JAX_ROUTE = {
    "pallas_flat_schedule": "cuda_flat", "pallas_dsd_extract": "dense_extract",
    "pallas_dds_extract": "dense_extract", "pallas_densify_stream": "densify",
    "pallas_output_stationary": "cuda_output_stationary", "pallas_worklist": "cuda_worklist",
    "pallas_masked_stream": "cuda_masked_stream", "pallas_smallblock": "cuda_smallblock",
    "jnp_fallback": "jnp_fallback", "dss_extract": "dss_extract", "xla_dense_detour": "xla_dense_detour",
    # DSD / DDS / SDD at 128-blocks: the JAX package's first fit picks one
    # of its schedules (stream, C-resident, group-resident, panel); the
    # port has one kernel per op for all of them.
    "pallas_stream": "cuda_stream", "pallas_cres": "cuda_stream", "pallas_gres": "cuda_stream",
    "pallas_panel": {"dsd": "cuda_stream", "dds": "cuda_stream", "sdd": "cuda_output_stationary"},
}


def _jax_name(op, jargs, traced: bool) -> str:
    if not traced:
        return jops.registry.dispatch_name(op, *jargs)
    names = []

    def trace(*args):
        names.append(jops.registry.dispatch_name(op, *args))
        return 0

    jax.make_jaxpr(trace)(*jargs)
    return names[0]


@pytest.mark.parametrize("traced", [False, True], ids=["host", "card"])
@pytest.mark.parametrize("density", [0.1, 0.5])
@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("op", ["dsd", "dds", "sdd", "ssd", "sds", "dss", "sss"])
def test_first_fit_names_jax_route_on_cuda(monkeypatch, rng, op, bs, density, traced):
    """With the device predicates reporting CUDA, the port's first fit names
    the counterpart of the JAX package's variant for the same problem: on
    host-known metadata (JAX: concrete) and card-built (JAX: traced). The
    128-block kernels raise on small blocks, so no op may name one for
    them."""
    monkeypatch.setattr(matmul_mod, "_on_cuda", lambda *xs: True)
    d = 512
    sparse_a = op in ("dsd", "ssd", "dss", "sss")
    sparse_b = op in ("dds", "sds", "dss", "sss")
    ja, a = _pair(40, d, d, density, bs) if sparse_a else _dense(rng, (d, d))
    jb, b = _pair(41, d, d, density, bs) if sparse_b else _dense(rng, (d, d))
    if traced:
        a, b = (_card_built(x) if isinstance(x, BlockSparseMatrix) else x for x in (a, b))
    jargs, targs = [ja, jb], [a, b]
    if op not in ("dsd", "dds", "dss"):
        jt, t = _pair(42, d, d, density, bs)
        jargs.append(jt)
        targs.append(_card_built(t) if traced else t)
    jname = _jax_name(op, jargs, traced)
    want = JAX_ROUTE[jname]
    want = want[op] if isinstance(want, dict) else want
    assert registry.dispatch_name(op, *targs) == want, jname
